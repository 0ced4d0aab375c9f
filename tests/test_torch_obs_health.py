"""The port's health plane (``obs/slo.py``, ``obs/health.py``) and
per-request critical path (``obs/critpath.py``) held against the JAX
package's on the same seeded inputs: the default objective sheet, the
burn-rate verdicts over seeded signal sequences, every signal source,
the monitor's verdicts, transitions and breach events, the cluster
roll-up, and the critical-path block over seeded span events.  Then the
reference's own case matrices (``tests/test_health_slo.py`` and
``tests/test_critpath.py``, every case that needs only ported modules)
run against the port."""

import dataclasses
import random

import pytest

from smartbft_tpu.obs import critpath as j_critpath
from smartbft_tpu.obs import health as j_health
from smartbft_tpu.obs import recorder as j_recorder
from smartbft_tpu.obs import slo as j_slo
from smartbft_tpu.obs import vcphases as j_vcphases
from smartbft_tpu_torch.obs import critpath as t_critpath
from smartbft_tpu_torch.obs import health as t_health
from smartbft_tpu_torch.obs import recorder as t_recorder
from smartbft_tpu_torch.obs import slo as t_slo
from smartbft_tpu_torch.obs import vcphases as t_vcphases
from torch_reference import reference_tests

BOTH = (("jax", j_slo, j_health, j_recorder, j_vcphases),
        ("torch", t_slo, t_health, t_recorder, t_vcphases))


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _rules(spec):
    """A spec's rules as comparable dicts.  Descriptions are prose for the
    operator and differ only in wording, so they are left out."""
    return [{k: v for k, v in dataclasses.asdict(r).items()
             if k != "description"} for r in spec.rules]


def test_default_slo_spec_matches():
    for kw in ({}, {"fast_window_s": 1.0, "slow_window_s": 9.0}):
        j, t = j_slo.default_slo_spec(**kw), t_slo.default_slo_spec(**kw)
        assert t.name == j.name
        assert _rules(t) == _rules(j)
        assert len(t.rules) == 13
    assert _rules(t_slo.default_slo_spec().with_overrides(
        **{"pool.fill": 0.5})) == _rules(
        j_slo.default_slo_spec().with_overrides(**{"pool.fill": 0.5}))


@pytest.mark.parametrize("rule", [
    dict(kind="median"), dict(budget=0.0), dict(fast_window_s=0.0),
    dict(fast_window_s=90.0), dict(critical_bound=0.5),
    dict(kind="floor", critical_bound=2.0)])
def test_rule_validation_errors_match(rule):
    errs = []
    for mod in (j_slo, t_slo):
        r = mod.SLORule("x", "x", 1.0, **rule)
        with pytest.raises(ValueError) as exc:
            r.validate()
        errs.append(str(exc.value))
    assert errs[0] == errs[1]


def _signal_trace(spec, seed, n=240):
    """Seeded samples around each rule's bounds, with gaps (absent
    signals) and quiet spells, on irregular ticks."""
    rng = random.Random(seed)
    trace, t = [], 0.0
    phase = 0
    for k in range(n):
        t += rng.choice([0.1, 0.25, 0.5, 1.0, 3.0])
        if k % 40 == 0:
            phase = rng.randrange(3)
        sig = {}
        for r in spec.rules:
            if rng.random() < 0.15:
                continue
            lo = r.bound * 0.5
            hi = (r.critical_bound if r.critical_bound is not None
                  else r.bound * 2 + 1.0) * 1.5
            sig[r.signal] = (rng.uniform(lo, r.bound) if phase == 0
                             else rng.uniform(r.bound, hi) if phase == 1
                             else rng.choice([0.0, r.bound, hi]))
        trace.append((t, sig))
    return trace


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_burn_rate_verdicts_match_over_seeded_signals(seed):
    spec = j_slo.default_slo_spec(fast_window_s=2.0, slow_window_s=15.0)
    trace = _signal_trace(spec, seed)
    out = {}
    for name, slo, *_ in BOTH:
        ev = slo.SLOEvaluator(
            slo.default_slo_spec(fast_window_s=2.0, slow_window_s=15.0),
            clock=lambda: 0.0)
        got = []
        for t, sig in trace:
            ev.observe(sig, t=t)
            got.append(ev.evaluate(t=t).as_dict())
        out[name] = got
    assert out["torch"] == out["jax"]
    statuses = {v["status"] for v in out["jax"]}
    assert statuses == {"healthy", "degraded", "critical"}


def test_signal_sources_match():
    """Every source over the same scripted inputs: the event latch, pool,
    view-change, coalescer, WAL, snapshot, read and latency sources."""
    out = {}
    for name, slo, health, recorder, vcphases in BOTH:
        clock = Clock()
        rng = random.Random(9)
        occ = {"size": 0, "waiters": 0, "capacity": 100,
               "shed_admission": 0, "shed_timeout": 0}
        tracker = vcphases.ViewChangePhaseTracker(clock=clock, node="n1")
        co = type("Co", (), {})()
        co.breaker_open = False
        mesh = {"enabled": False}
        co.mesh_snapshot = lambda: mesh
        wal = type("Wal", (), {})()
        span = {}
        wal.span_block = lambda: span
        disk = {"snapshot_interval": 0}
        reads = {}
        srcs = [health.pool_signal_source(lambda: occ, clock=clock),
                health.vc_signal_source(tracker, clock=clock),
                health.coalescer_signal_source(co),
                health.wal_signal_source(wal),
                health.snapshot_signal_source(lambda: disk),
                health.read_signal_source(lambda: reads, clock=clock)]
        latch = health.EventLatch(2.0)
        got = []
        for k in range(120):
            clock.t += rng.choice([0.2, 0.7, 1.5, 4.0])
            occ["size"] = rng.randrange(0, 100)
            occ["waiters"] = rng.randrange(0, 3)
            occ["shed_admission"] += rng.random() < 0.1
            if k % 17 == 3:
                tracker.detection(rng.uniform(0.1, 9.0))
            if k % 23 == 5:
                tracker.armed(k)
                tracker.joined(k)
            co.breaker_open = rng.random() < 0.2
            mesh = {"enabled": k > 60, "launches": k % 3,
                    "device_fill_pct_last": [rng.uniform(0, 100)
                                             for _ in range(k % 4)]}
            span = {"fsync": {"count": k % 5, "p99_ms": rng.uniform(0, 20)}}
            disk = {"snapshot_interval": k % 4,
                    "snapshot_age_decisions": rng.randrange(0, 40)}
            reads = {"served": k % 6, "sheds": k // 10, "base_refused": k // 30,
                     "served_base": k // 7, "lag_max": rng.randrange(0, 99)}
            got.append([src() for src in srcs]
                       + [latch.update(k // 9 - (k == 50), k, clock.t)])
        out[name] = got
    assert out["torch"] == out["jax"]


def test_latency_source_matches():
    from smartbft_tpu.metrics import CommitLatencyTracker as JTracker
    from smartbft_tpu_torch.metrics import CommitLatencyTracker as TTracker

    out = {}
    for name, health, Tracker in (("jax", j_health, JTracker),
                                  ("torch", t_health, TTracker)):
        clock = Clock()
        tr = Tracker(clock=clock)
        src = health.latency_signal_source(tr)
        rng = random.Random(3)
        got = [src()]
        for k in range(60):
            for j in range(k % 4):
                key = f"c:{k}-{j}"
                tr.on_submitted(key)
                clock.t += rng.uniform(0.001, 0.5)
                tr.on_committed(key, k % 2)
            got.append(src())
        out[name] = got
    assert out["torch"] == out["jax"]
    assert any(out["jax"])


@pytest.mark.parametrize("seed", [5, 6])
def test_monitor_verdicts_transitions_and_events_match(seed):
    spec_kw = dict(fast_window_s=2.0, slow_window_s=15.0)
    trace = _signal_trace(j_slo.default_slo_spec(**spec_kw), seed, n=160)
    out = {}
    for name, slo, health, recorder, _ in BOTH:
        clock = Clock()
        rec = recorder.TraceRecorder(clock=clock, node="n1", capacity=512)
        mon = health.HealthMonitor(slo.default_slo_spec(**spec_kw),
                                   clock=clock, recorder=rec, node="n1")
        cur = {"sig": {}}
        mon.add_source(lambda: cur["sig"])
        mon.add_source(lambda: 1 / 0 if clock.t % 7 < 0.5 else {})
        got = []
        for t, sig in trace:
            clock.t = 100.0 + t
            cur["sig"] = sig
            got.append(mon.tick())
        out[name] = (got, mon.transition_log(),
                     [(e.kind, e.t, e.extra) for e in rec.events()])
    assert out["torch"] == out["jax"]
    assert len(out["jax"][1]) >= 2
    assert out["jax"][0][-1]["source_errors"] > 0


@pytest.mark.parametrize("seed", [7, 8])
def test_aggregate_cluster_verdict_matches(seed):
    rng = random.Random(seed)
    for _ in range(50):
        verdicts = {}
        for i in range(rng.randrange(0, 7)):
            status = rng.choice(["healthy", "degraded", "critical"])
            reasons = [{"slo": rng.choice(["pool.fill", "wal.fsync_p99_ms"]),
                        "severity": status, "value": rng.random()}
                       for _ in range(rng.randrange(0, 3))]
            verdicts[f"n{i}"] = {"status": status, "reasons": reasons}
        gone = [f"n{9 + k}" for k in range(rng.randrange(0, 4))]
        assert t_health.aggregate_cluster_verdict(verdicts, gone) == \
            j_health.aggregate_cluster_verdict(verdicts, gone)


# ---------------------------------------------------------- critical path

_MARKS = ("req.submit", "req.pool", "batch.propose", "quorum.prepare",
          "wal.persist", "quorum.commit", "req.deliver")


def _span_events(seed, n_req=60):
    """Seeded request pipelines over two shards and a reborn generation,
    leader and follower marks, with dropped marks, clock skew and two
    phases of request keys."""
    rng = random.Random(seed)
    events = []
    for k in range(n_req):
        node = rng.choice(["s0n1", "s1n1", "s0g1n1"])
        key = f"c{k % 5}:{rng.choice(['healthy', 'view_change'])}-{k}"
        view, seq = rng.randrange(2), k + 1
        t = 10.0 + k * 0.5
        for kind in _MARKS:
            t += rng.uniform(0.001, 0.03)
            if kind not in ("req.submit", "req.deliver") \
                    and rng.random() < 0.1:
                continue
            skew = -0.004 if rng.random() < 0.05 else 0.0
            ev = {"t": t + skew, "kind": kind, "node": node}
            if kind.startswith("req."):
                ev["key"] = key
            if kind not in ("req.submit", "req.pool"):
                ev["view"], ev["seq"] = view, seq
            if kind.startswith("quorum."):
                ev["extra"] = {"slowest_voter": rng.randrange(1, 5)}
            events.append(ev)
            if kind == "quorum.commit" and rng.random() < 0.3:
                follower = node[:-1] + "2"
                events.append({"t": t + 0.2, "kind": kind, "node": follower,
                               "view": view, "seq": seq})
    events.sort(key=lambda e: e["t"])
    return events


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_critical_path_block_matches(seed):
    events = _span_events(seed)
    for kw in ({}, {"phases": ["healthy", "view_change"], "sample": 3},
               {"residual_tolerance_ms": 10.0}):
        want = j_critpath.assemble_critical_path_block(events, **kw)
        assert t_critpath.assemble_critical_path_block(events, **kw) == want
    assert want["requests_decomposed"] > 0
    assert t_critpath.SEGMENTS == j_critpath.SEGMENTS


# -------------------------------------------- the reference's case matrices

globals().update(reference_tests("test_health_slo.py"))
globals().update(reference_tests("test_critpath.py"))


def test_reference_cases_leave_out_only_unported_needs():
    """Every case runs on the port, the chaos-harness cases of
    test_health_slo.py included, and test_critpath.py's single-node case
    on the port-compiled copy of the test file whose helpers it
    borrows."""
    ids = reference_tests("test_health_slo.py")
    assert len(ids) == 16
    assert "test_health_slo__test_sharded_cluster_health_surface" in ids
    ids = reference_tests("test_critpath.py")
    assert len(ids) == 9
    assert "test_critpath__test_live_cluster_decomposes_every_request" in ids
