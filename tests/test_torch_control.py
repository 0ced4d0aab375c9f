"""The port's control plane (``smartbft_tpu_torch.control``) held against
the JAX package's.

First a differential run: a numpy-seeded stream of health verdicts and
occupancy / RTT / commit-gap / drain samples on an injected clock, fed to
both packages' ``ControlPolicy`` (with the retunes each one decides
applied to its own current configuration, the reshards to its shard
count, and seeded execution outcomes), and the same samples through both
packages' ``derive_knobs``: the ``Remediation`` sequences, the policies'
snapshots and the derived knobs (``verify_flush_hold`` among them) must
be identical.  Then the reference's own cases of ``tests/test_control.py``,
compiled against the port by :mod:`torch_reference`, under an exact count
guard.  Every case runs under a time limit of its own.
"""

import dataclasses
import importlib

import numpy as np
import pytest

from torch_reference import case_time_limit, check_matrices, reference_tests

PACKAGES = ("smartbft_tpu", "smartbft_tpu_torch")
SLOS = ("latency.commit_p99_ms", "viewchange.detection_seconds",
        "pool.fill", "verify.breaker_open")

time_limit = case_time_limit(60)


def _stream(seed: int, ticks: int = 400):
    """Per tick: (clock step, verdict, signals, in_transition,
    breaker_open, execution ok)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(ticks):
        status = str(rng.choice(["healthy", "healthy", "degraded",
                                 "critical"]))
        reasons = [] if status == "healthy" else [
            {"slo": str(s)} for s in
            rng.choice(SLOS, size=int(rng.integers(0, 3)), replace=False)]
        occ = {"fill": float(rng.random()),
               "total_waiters": int(rng.integers(0, 3)) * int(
                   rng.random() < 0.2),
               "shed_admission": int(rng.integers(0, 4)),
               "shed_timeout": int(rng.integers(0, 2)),
               "total_capacity": int(rng.choice([0, 4096, 4096]))}
        signals = {
            "occupancy": occ,
            "rtt_s": None if rng.random() < 0.3
            else float(rng.random()) * 0.5,
            "commit_gap_s": None if rng.random() < 0.3
            else float(rng.random()) * 0.2,
            "drain_rate": None if rng.random() < 0.3
            else float(rng.random()) * 50000.0,
        }
        out.append((float(rng.choice([0.5, 1.0, 2.0, 7.0, 31.0])),
                    {"status": status, "reasons": reasons}, signals,
                    bool(rng.random() < 0.05), bool(rng.random() < 0.05),
                    bool(rng.random() < 0.9)))
    return out


def _drive(pkg: str, stream):
    control = importlib.import_module(f"{pkg}.control")
    config = importlib.import_module(f"{pkg}.config")
    now = [0.0]
    base = config.Configuration(self_id=1)
    current = base
    policy = control.ControlPolicy.from_config(
        dataclasses.replace(base, control_cooldown=10.0,
                            control_hysteresis=30.0, control_idle_hold=5.0,
                            control_budget_window=100.0,
                            autoscale_max_shards=4),
        clock=lambda: now[0])
    shards, trace = 2, []
    for dt, verdict, signals, in_transition, breaker_open, ok in stream:
        now[0] += dt
        rem = policy.decide(verdict, signals, num_shards=shards,
                            in_transition=in_transition,
                            breaker_open=breaker_open,
                            current_config=current, base_config=base)
        trace.append(rem.as_dict())
        if rem.status == "act":
            policy.note_result(rem, ok)
            if ok and rem.action == "retune":
                current = dataclasses.replace(current, **rem.knobs)
            elif ok:
                shards = rem.target_shards
    return trace, policy.snapshot(), policy.reversals(), shards


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_control_policy_matches_the_jax_package(seed):
    stream = _stream(seed)
    want = _drive("smartbft_tpu", stream)
    assert _drive("smartbft_tpu_torch", stream) == want
    trace = want[0]
    acted = {r["action"] for r in trace if r["status"] == "act"}
    assert {"scale_out", "retune"} <= acted
    assert any(r["status"] == "veto" for r in trace)
    assert any("verify_flush_hold" in r["knobs"] for r in trace
               if r["action"] == "retune")


@pytest.mark.parametrize("seed", [4, 5])
def test_derive_knobs_matches_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    mods = {pkg: (importlib.import_module(f"{pkg}.control"),
                  importlib.import_module(f"{pkg}.config"))
            for pkg in PACKAGES}
    seen = set()
    for _ in range(300):
        base_kw = dict(
            request_forward_timeout=float(rng.choice([0.5, 2.0, 20.0])),
            request_batch_max_interval=float(rng.choice([0.01, 0.05, 0.5])),
            control_knob_deadband=float(rng.choice([0.0, 0.05, 0.2])))
        cur_kw = dict(verify_flush_hold=float(rng.choice([0.0, 0.004,
                                                          0.02])),
                      request_forward_timeout=float(rng.random()) * 2.0)
        sample = dict(
            rtt_s=None if rng.random() < 0.2 else float(rng.random()) * 0.3,
            commit_gap_s=None if rng.random() < 0.2
            else float(rng.random()) * 0.1,
            drain_rate=None if rng.random() < 0.2
            else float(rng.random()) * 1e5)
        got = {}
        for pkg, (control, config) in mods.items():
            base = config.Configuration(self_id=1, **base_kw)
            current = dataclasses.replace(base, **cur_kw)
            got[pkg] = control.derive_knobs(base, current, **sample)
        assert got["smartbft_tpu_torch"] == got["smartbft_tpu"]
        seen.update(got["smartbft_tpu"])
    assert {"verify_flush_hold", "request_forward_timeout",
            "transport_outbox_cap"} <= seen


# ------------------------------------------------ the reference's own cases

CASES = {"test_control.py": 24}
LEFT_OUT: dict = {}

globals().update(reference_tests("test_control.py"))


def test_reference_cases_are_whole_and_ported():
    """Every case runs on the port: the socket control client
    (``net.cluster``), the chaos harness's remediation-storm round, and
    the selfdrive rows through the port's bench-row schema and baseline
    guard (``obs.benchschema``, ``obs.baseline``)."""
    check_matrices(CASES, LEFT_OUT)
    got = reference_tests("test_control.py")
    assert got["test_control__test_derive_knobs_clamps_and_quantizes"] \
        .__globals__["derive_knobs"].__module__ \
        == "smartbft_tpu_torch.control.policy"
