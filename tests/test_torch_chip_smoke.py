"""``chip_smoke.py`` names its failure on stdout.

A failed smoke run prints one JSON line ``{"phase": ..., "ok": false,
"error": ...}`` on stdout before it exits non-zero: ``fail`` with its
message, an exception that escapes a phase with the last frames of its
traceback, and each early exit (no torch, no card, no port package) with
its reason.  Each case runs the script in a subprocess of its own, on
this machine's CPU build of torch; no case needs a card."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMOKE = ROOT / "chip_smoke.py"


def _run(code: str, cwd=ROOT) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=str(cwd),
                          env=env, capture_output=True, text=True,
                          timeout=120)


def _lines(stdout: str) -> list:
    return [json.loads(line) for line in stdout.splitlines()
            if line.startswith("{")]


def test_fail_names_the_running_phase_on_stdout():
    out = _run("import chip_smoke\n"
               "chip_smoke.CURRENT['phase'] = 'byzantine'\n"
               "chip_smoke.fail('byzantine y3: a replica committed 7 of 8')")
    assert out.returncode == 1, out.stderr
    assert _lines(out.stdout) == [{
        "phase": "byzantine", "ok": False,
        "error": "byzantine y3: a replica committed 7 of 8"}]
    assert "chip_smoke: FAILED: byzantine y3" in out.stderr


def test_a_failure_inside_a_phase_names_that_phase():
    """``run_phase`` sets the phase ``fail`` reports, and puts the outer
    phase back once it returns."""
    out = _run("import chip_smoke\n"
               "chip_smoke.run_phase('build', lambda: None)\n"
               "chip_smoke.run_phase('device', chip_smoke.run_phase, 'mesh',"
               " chip_smoke.fail, 'mesh M2: parity')")
    assert out.returncode == 1, out.stderr
    assert _lines(out.stdout) == [{"phase": "mesh", "ok": False,
                                   "error": "mesh M2: parity"}]


def test_an_exception_is_reported_once_with_its_traceback_and_raised():
    out = _run("import chip_smoke\n"
               "def sockets():\n"
               "    return {}['t2']\n"
               "chip_smoke.run_phase('device', chip_smoke.run_phase,"
               " 'sockets', sockets)")
    assert out.returncode == 1
    [line] = _lines(out.stdout)
    assert line["phase"] == "sockets" and line["ok"] is False
    assert line["error"] == "KeyError: 't2'"
    assert any("in sockets" in f for f in line["traceback"])
    assert line["traceback"][-1] == "KeyError: 't2'"
    # raised again: the interpreter's own traceback ends the run
    assert out.stderr.rstrip().endswith("KeyError: 't2'")


def test_the_error_line_is_bounded():
    out = _run("import chip_smoke\n"
               "chip_smoke.fail('x' * 10 ** 6)")
    [line] = _lines(out.stdout)
    assert len(line["error"]) == 4000 and out.returncode == 1


def test_without_a_card_the_smoke_says_so_on_stdout_and_exits_2():
    out = subprocess.run([sys.executable, str(SMOKE)], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert _lines(out.stdout) == [{
        "phase": "setup", "ok": False,
        "error": "CUDA is not available; this smoke needs an NVIDIA card"}]
    assert "CUDA is not available" in out.stderr


def test_alone_in_a_directory_the_smoke_names_the_missing_port(tmp_path):
    """The script with no repository around it, on a machine that has a
    card (the check is stubbed here), exits 2 naming the missing port."""
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    out = _run("import runpy, sys, torch\n"
               "torch.cuda.is_available = lambda: True\n"
               "sys.argv = ['chip_smoke.py']\n"
               "runpy.run_path('chip_smoke.py', run_name='__main__')",
               cwd=tmp_path)
    assert out.returncode == 2, out.stderr
    [line] = _lines(out.stdout)
    assert line["phase"] == "setup" and line["ok"] is False
    assert line["error"].startswith("the port package is missing")
    assert "the port package is missing" in out.stderr
