"""The command as the driver runs it, where it cannot measure."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import run


def _run(cwd, *args):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", *args], cwd=cwd,
        capture_output=True, text=True, timeout=120)


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the card-less exit is not testable")


def test_a_cardless_run_exits_nonzero_with_one_line(no_card):
    p = _run(run.ROOT, "--workload", "n64-p256.sidecar", "--seed",
             str(2**33 + 9), "--seconds", "1", "--trace", "0")
    assert p.returncode != 0
    lines = p.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["ok"] is False and "card" in line["error"]
    assert "correct" not in line


def test_an_unknown_cell_exits_nonzero(no_card):
    p = _run(run.ROOT, "--workload", "nope", "--seed", "1", "--seconds",
             "1", "--trace", "0")
    assert p.returncode != 0 and "nope" in p.stdout


def test_the_benchmark_alone_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(run.ROOT, "portbench"),
                    tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path, "--workload", "n16-ed25519.sidecar", "--seed", "3",
             "--seconds", "1", "--trace", "0")
    assert p.returncode != 0
    assert all("correct" not in json.loads(line)
               for line in p.stdout.strip().splitlines())
