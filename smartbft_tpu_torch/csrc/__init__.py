"""Build and load the hand-written CUDA kernels.

Each ``*.cu`` source here is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into its own shared library
with a plain C interface, and loaded with :mod:`ctypes`.  The sources
include no PyTorch header, so a build takes seconds.  Builds happen at
first use, never at import, into ``smartbft_tpu_torch/_build/cuda``
(git-ignored; ``SMARTBFT_TORCH_BUILD_DIR`` moves it, see
:func:`smartbft_tpu_torch.utils.torchenv.build_dir`); all sources compile in parallel, one
``nvcc`` each.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
import time

from ..utils.torchenv import build_dir

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = build_dir()
#: kernel library name -> its source in this directory
SOURCES = {"cuda_comb": "cuda_comb.cu", "cuda_ecdsa": "cuda_ecdsa.cu",
           "cuda_ed25519": "cuda_ed25519.cu", "cuda_eddsa": "cuda_eddsa.cu",
           "cuda_bls": "cuda_bls.cu"}
#: builds of a source with another compile-time constant, which no wrapper
#: loads (``chip_smoke.py`` times them beside the library): the P-256 comb
#: and generic kernels at 4 threads a signature, the Ed25519 comb and
#: generic ones at 2, the pairing kernel at 6 threads a lane, and the
#: pairing kernel stopped after its Miller loop (a timing of the split, no
#: verify)
VARIANTS = {"cuda_comb_g4": ("cuda_comb.cu", ("-DCOMB_GROUP=4",)),
            "cuda_ecdsa_g4": ("cuda_ecdsa.cu", ("-DECDSA_GROUP=4",)),
            "cuda_ed25519_g2": ("cuda_ed25519.cu", ("-DED_COMB_GROUP=2",)),
            "cuda_eddsa_g2": ("cuda_eddsa.cu", ("-DEDDSA_GROUP=2",)),
            "cuda_bls_g6": ("cuda_bls.cu", ("-DBLS_GROUP=6",)),
            "cuda_bls_miller": ("cuda_bls.cu", ("-DBLS_MILLER_ONLY=1",))}
#: every header; an edit to any of them rebuilds every kernel
HEADERS = ("field256.cuh", "p256_field.cuh", "p256_group.cuh",
           "p256_comb_group.cuh", "ed25519_field.cuh", "ed25519_group.cuh",
           "ed25519_comb_group.cuh", "bls381_field.cuh", "bls381_group.cuh",
           "bls381_pairing.cuh")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}
#: per library: build seconds and ptxas' register/spill report
build_report: dict = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _source(name: str) -> tuple:
    """(source file, extra nvcc flags) of a library or variant name."""
    return VARIANTS[name] if name in VARIANTS else (SOURCES[name], ())


def _stale(name: str) -> bool:
    try:
        built = os.path.getmtime(_lib_path(name))
    except OSError:
        return True
    deps = (_source(name)[0],) + HEADERS
    return any(os.path.getmtime(os.path.join(_DIR, d)) > built for d in deps)


def parse_ptxas(text: str) -> dict:
    """Registers, stack, spill and static shared-memory bytes of the
    ``__global__`` kernel in an ``-Xptxas -v`` log (the last function
    reported with registers, whose stack line precedes its register line;
    the stack lines of the device functions it calls follow it and are
    summed into ``callee_spill_store_bytes`` / ``callee_spill_load_bytes``
    where there are any)."""
    out, frame, callee = {}, {}, [0, 0]
    for line in text.splitlines():
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = dict(stack_bytes=int(m.group(1)),
                         spill_store_bytes=int(m.group(2)),
                         spill_load_bytes=int(m.group(3)))
            if "registers" in out:
                callee[0] += frame["spill_store_bytes"]
                callee[1] += frame["spill_load_bytes"]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.update(frame)
            callee = [0, 0]
            out["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                out["shared_bytes"] = int(m.group(1))
    if any(callee):
        out.update(callee_spill_store_bytes=callee[0],
                   callee_spill_load_bytes=callee[1])
    return out


def build(names=None, force: bool = False) -> dict:
    """Compile the named kernel libraries (all of :data:`SOURCES` by
    default; :data:`VARIANTS` by name), in parallel.

    Returns :data:`build_report`.  ``force`` rebuilds even when the
    library is newer than its sources."""
    names = list(SOURCES) if names is None else list(names)
    with _lock:
        todo = [n for n in names if force or _stale(n)]
        if not todo:
            return build_report
        nvcc = nvcc_path()
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        t0 = time.perf_counter()
        for name in todo:
            tmp = _lib_path(name) + f".tmp.{os.getpid()}"
            src, flags = _source(name)
            cmd = [nvcc, *NVCC_FLAGS, *flags, "-o", tmp,
                   os.path.join(_DIR, src)]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
                continue
            os.replace(tmp, _lib_path(name))
            _libs.pop(name, None)
            build_report[name] = dict(
                parse_ptxas(log), seconds=time.perf_counter() - t0,
                ptxas=log.strip())
        if failed:
            raise KernelBuildError("\n".join(failed))
    return build_report


def load(name: str) -> ctypes.CDLL:
    """The named kernel library, building it first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(_lib_path(name))
    return lib


class LaunchCounter:
    """Launches and lanes of one kernel, counted where the wrapper launches
    it (thread-safe: the verify plane launches from worker threads)."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.lanes = 0
        self._lock = threading.Lock()

    def add(self, lanes: int) -> None:
        with self._lock:
            self.launches += 1
            self.lanes += lanes

    def reset(self) -> None:
        with self._lock:
            self.launches = 0
            self.lanes = 0


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def check(rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launcher."""
    if rc != 0:
        raise KernelLaunchError(f"{what}: CUDA launch failed (cudaError {rc})")
