"""Device selection for the port: which devices a verify mesh may take,
and where the CUDA kernels are built.

The JAX package fakes an N-device host with
``--xla_force_host_platform_device_count`` so its mesh tests run on the
CPU.  Here :func:`force_cpu` does the same for the port: the visible
device list becomes N CPU devices (``torch.device("cpu", i)``, which all
hold their tensors in host memory), so a mesh of N tiles runs one plain
launch a tile.  Without it the visible devices are the CUDA cards.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

#: the virtual CPU device count :func:`force_cpu` set (None: the cards)
_virtual: Optional[int] = None

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_dir() -> str:
    """Where ``csrc`` builds the CUDA kernel libraries.

    ``SMARTBFT_TORCH_BUILD_DIR`` overrides the location outright; else
    ``_build/cuda`` inside the package (git-ignored), so a checkout builds
    into itself and nowhere else."""
    override = os.environ.get("SMARTBFT_TORCH_BUILD_DIR")
    if override:
        return os.path.expanduser(override)
    return os.path.join(_PKG, "_build", "cuda")


def force_cpu(virtual_devices: Optional[int] = None) -> Optional[int]:
    """Make the visible device list ``virtual_devices`` CPU devices (one
    when None), whatever cards the host has.  Returns the previous
    setting; pass it to :func:`restore` to put the previous list back."""
    global _virtual
    n = 1 if virtual_devices is None else int(virtual_devices)
    if n < 1:
        raise ValueError(f"force_cpu: need at least one device, got {n}")
    previous, _virtual = _virtual, n
    return previous


def restore(previous: Optional[int]) -> None:
    """Undo :func:`force_cpu`: ``previous`` is what it returned."""
    global _virtual
    _virtual = previous


def visible_devices() -> list:
    """The devices a mesh may take, in order: the virtual CPU devices when
    :func:`force_cpu` set them, else every CUDA card (none without one)."""
    if _virtual is not None:
        return [torch.device("cpu", i) for i in range(_virtual)]
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
