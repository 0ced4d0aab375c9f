"""Shared fixtures of the benchmark's tests.

Tests that need the card carry the ``gpu`` marker and take the ``card``
fixture, which decides there (never at import) whether a card is visible.
On the card: ``python3 -m pytest -q portbench/tests -m gpu``."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card (runs the cells at their size)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run on the chip with -m gpu")
    return "cuda"


@pytest.fixture(scope="session")
def bench():
    from portbench import run

    return run.manifest()


@pytest.fixture(scope="session")
def cells(bench):
    """The manifest with every cell file of ``workloads/`` in it: the cells
    of ``BENCHMARK.json`` and those kept for a later benchmark, out of it
    until their runs are steady enough for a bound (PERF.md, Open
    questions)."""
    import glob
    import json

    named = {w["name"] for w in bench["workloads"]}
    kept = []
    for path in sorted(glob.glob(os.path.join(ROOT, "portbench", "workloads",
                                              "*.json"))):
        with open(path) as f:
            cell = json.load(f)
        if cell["name"] not in named:
            kept.append({k: cell[k] for k in ("name", "config", "traffic",
                                              "chips", "why")})
    return dict(bench, workloads=bench["workloads"] + kept)
