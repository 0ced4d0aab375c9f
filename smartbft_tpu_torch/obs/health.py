"""Live health verdicts over the SLO spec: the judgment layer's top half.

:class:`HealthMonitor` ties the declarative :mod:`~smartbft_tpu_torch.obs.slo`
rules to the signal surfaces that already exist — the request pool's
occupancy snapshot, the per-Consensus
:class:`~smartbft_tpu_torch.obs.vcphases.ViewChangePhaseTracker`, the verify
coalescer's breaker/mesh state, the WAL's always-on fsync histograms,
and the sharded front door's latency tracker — and renders a
``healthy`` / ``degraded(reasons[])`` / ``critical`` verdict an operator
(or the chaos harness) can poll.

Event-shaped signals (a heartbeat detection, a shed, a backlog reading
at the view flip) are **latched**: the monitor holds the value live for
``latch_s`` seconds after the underlying counter moved, then releases it
to 0 — so a 20-second detection reads as a violation while it is recent
and ages out of the verdict as the fast burn window drains, instead of a
stale gauge pinning the cluster degraded forever.

Verdict **transitions** are first-class: every status change is appended
to ``transitions`` and recorded into the flight recorder as
``slo.breach`` / ``slo.clear`` span events carrying the breaching rule
names, so an SLO violation lands on the merged cluster timeline next to
the fault that caused it.

:func:`aggregate_cluster_verdict` folds n per-replica verdicts (plus the
unreachable set) into ONE cluster verdict — what
``SocketCluster.cluster_health()`` returns from a single control-channel
sweep.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

from .recorder import NOP_RECORDER
from .slo import (
    CRITICAL,
    DEGRADED,
    HEALTHY,
    SLOEvaluator,
    SLOSpec,
    default_slo_spec,
    worse,
)

__all__ = [
    "HealthMonitor",
    "aggregate_cluster_verdict",
    "vc_signal_source",
    "pool_signal_source",
    "coalescer_signal_source",
    "wal_signal_source",
    "snapshot_signal_source",
    "latency_signal_source",
    "EventLatch",
]


class EventLatch:
    """Hold an event value live for ``hold_s`` after its counter moved."""

    __slots__ = ("hold_s", "prev_count", "value", "since")

    def __init__(self, hold_s: float):
        self.hold_s = hold_s
        self.prev_count: Optional[float] = None
        self.value = 0.0
        self.since: Optional[float] = None

    def update(self, count: float, value: float, now: float) -> float:
        if self.prev_count is None:
            # first sight: pre-existing history is not a fresh event
            self.prev_count = count
        elif count > self.prev_count:
            self.prev_count = count
            self.value = value
            self.since = now
        elif count < self.prev_count:
            # the counter DROPPED (a restart reset it, or an aggregate
            # lost a member to a scale-in): that is not a fresh event —
            # latching here would report a violation nothing produced.
            # Re-anchor so the NEXT increase latches correctly.
            self.prev_count = count
        if self.since is not None and now - self.since <= self.hold_s:
            return self.value
        return 0.0


def vc_signal_source(tracker, *, clock, latch_s: float = 5.0) -> Callable:
    """Signals from one ViewChangePhaseTracker:

    - ``viewchange.active_seconds`` — time the current round has been
      open (0 when none is);
    - ``viewchange.detection_seconds`` — the latest heartbeat
      arm-to-fire sample, latched for ``latch_s`` after it fired;
    - ``viewchange.backlog_at_flip`` — the latest completed round's
      flip backlog, latched the same way."""
    det = EventLatch(latch_s)
    backlog = EventLatch(latch_s)

    def signals() -> dict:
        now = clock()
        out = {}
        # active = a view change actually IN PROGRESS: anchored at the
        # complaint-quorum mark ("joined"), not at the arm — a lone
        # complainer against a healthy leader keeps its armed round open
        # indefinitely by design (nobody joins), and that suspicion must
        # not pin the verdict degraded while commits flow; the detection
        # signal below already surfaces the suspicion itself.  The delta
        # is computed on the TRACKER's clock: its marks live in the
        # consensus scheduler's domain, which on a wall-driven replica is
        # NOT the monitor's time.monotonic (different epoch).
        joined = tracker._marks.get("joined") if tracker.open else None
        out["viewchange.active_seconds"] = \
            max(tracker._clock() - joined, 0.0) if joined is not None \
            else 0.0
        last_det = (tracker._detections[-1] / 1e3
                    if tracker._detections else 0.0)
        out["viewchange.detection_seconds"] = det.update(
            tracker.detections_total, last_det, now
        )
        recs = tracker.records()
        last_backlog = float(recs[-1].get("backlog_at_flip", 0)) \
            if recs else 0.0
        out["viewchange.backlog_at_flip"] = backlog.update(
            tracker.completed_total, last_backlog, now
        )
        return out

    return signals


def pool_signal_source(occupancy_fn: Callable[[], dict], *, clock,
                       latch_s: float = 5.0) -> Callable:
    """Signals from a pool/front-door occupancy snapshot:
    ``pool.fill`` (system size / capacity) and ``pool.shed_recent``
    (1.0 while sheds happened within ``latch_s``)."""
    sheds = EventLatch(latch_s)

    def signals() -> dict:
        occ = occupancy_fn() or {}
        cap = occ.get("capacity", 0) or 0
        size = (occ.get("size", 0) or 0) + (occ.get("waiters", 0) or 0)
        out = {}
        if cap:
            out["pool.fill"] = size / cap
        shed_total = (occ.get("shed_admission", 0) or 0) \
            + (occ.get("shed_timeout", 0) or 0)
        out["pool.shed_recent"] = 1.0 if sheds.update(
            shed_total, 1.0, clock()
        ) else 0.0
        return out

    return signals


def coalescer_signal_source(coalescer) -> Callable:
    """Signals from the shared verify coalescer: breaker state and the
    mesh's minimum per-device fill (when a mesh is installed)."""

    def signals() -> dict:
        out = {"verify.breaker_open":
               1.0 if getattr(coalescer, "breaker_open", False) else 0.0}
        snap_fn = getattr(coalescer, "mesh_snapshot", None)
        if snap_fn is not None:
            try:
                snap = snap_fn() or {}
            except Exception:  # noqa: BLE001 — telemetry only
                snap = {}
            if snap.get("enabled") and snap.get("launches"):
                fills = snap.get("device_fill_pct_last") or []
                if fills:
                    out["mesh.device_fill_pct"] = float(min(fills))
        return out

    return signals


def wal_signal_source(wal) -> Callable:
    """``wal.fsync_p99_ms`` from the WAL's always-on span histograms."""

    def signals() -> dict:
        span_fn = getattr(wal, "span_block", None)
        if span_fn is None:
            return {}
        try:
            block = span_fn() or {}
        except Exception:  # noqa: BLE001 — telemetry only
            return {}
        fsync = block.get("fsync") or {}
        if fsync.get("count"):
            return {"wal.fsync_p99_ms": float(fsync.get("p99_ms", 0.0))}
        return {}

    return signals


def snapshot_signal_source(disk_fn: Callable[[], dict]) -> Callable:
    """``snapshot.lag_intervals`` from an embedder's disk snapshot dict
    (``ReplicaApp.disk_snapshot`` / ``testing.app.App.disk_snapshot``):
    decisions committed since the last snapshot, normalized by the
    configured interval so the SLO bound is static across deployments.
    Emits nothing when snapshots are disabled (interval 0) — an absent
    signal never breaches, matching the spec's opt-in contract."""

    def signals() -> dict:
        try:
            disk = disk_fn() or {}
        except Exception:  # noqa: BLE001 — telemetry only
            return {}
        interval = disk.get("snapshot_interval", 0) or 0
        if interval <= 0:
            return {}
        age = disk.get("snapshot_age_decisions", 0) or 0
        return {"snapshot.lag_intervals": float(age) / float(interval)}

    return signals


def read_signal_source(stats_fn: Callable[[], dict], *, clock=None,
                       latch_s: float = 5.0) -> Callable:
    """Read-plane signals from a ``ReadStats.snapshot`` dict:

    - ``read.shed_recent`` — 1.0 while the read gate shed within the
      latch window (a read storm being absorbed: degraded by design,
      and proof the storm is NOT reaching the write path);
    - ``read.base_refused_recent`` — 1.0 while a read-at-base was
      refused over a torn/tampered snapshot within the window (an
      integrity event, not load);
    - ``read.staleness_decisions`` — the worst anchor lag served,
      latched while snapshot-anchored reads are actively landing.

    An idle read plane emits nothing — absent signals never breach,
    matching the snapshot source's opt-in contract."""
    import time

    clk = clock if clock is not None else time.monotonic
    shed = EventLatch(latch_s)
    refused = EventLatch(latch_s)
    staleness = EventLatch(latch_s)

    def signals() -> dict:
        try:
            stats = stats_fn() or {}
        except Exception:  # noqa: BLE001 — telemetry only
            return {}
        now = clk()
        shed_live = shed.update(float(stats.get("sheds", 0)), 1.0, now)
        refused_live = refused.update(
            float(stats.get("base_refused", 0)), 1.0, now)
        stale_live = staleness.update(
            float(stats.get("served_base", 0)),
            float(stats.get("lag_max", 0)), now)
        if not (stats.get("served", 0) or stats.get("sheds", 0)
                or stats.get("base_refused", 0)):
            return {}
        out = {"read.shed_recent": shed_live,
               "read.base_refused_recent": refused_live}
        if stats.get("served_base", 0):
            out["read.staleness_decisions"] = stale_live
        return out

    return signals


def latency_signal_source(tracker) -> Callable:
    """``latency.commit_p99_ms`` from a CommitLatencyTracker — the p99 of
    commits landed SINCE THE LAST TICK.  The lifetime
    aggregate is the wrong verdict input: one bad spell dominates its
    p99 forever, so a breach could never clear and the control plane
    would remediate history.  Per-tick deltas give the SLO evaluator
    fresh samples; its own fast/slow windows provide the smoothing.  A
    tick with no new commits emits nothing (no signal ≠ zero latency)."""
    state = {"buckets": None}

    def signals() -> dict:
        hist = tracker.aggregate
        if not hist.count:
            return {}
        if state["buckets"] is None:
            # first sight: lifetime p99 seeds the window (no baseline yet)
            state["buckets"] = list(hist.buckets)
            return {"latency.commit_p99_ms": hist.quantile(0.99) * 1e3}
        p99 = hist.delta_quantile(0.99, state["buckets"])
        if p99 <= 0.0:
            return {}
        state["buckets"] = list(hist.buckets)
        return {"latency.commit_p99_ms": p99 * 1e3}

    return signals


class HealthMonitor:
    """One replica's (or one cluster's) live verdict machine.

    ``sources`` are zero-arg callables returning partial signal dicts;
    the monitor unions them per tick, feeds the
    :class:`~smartbft_tpu_torch.obs.slo.SLOEvaluator`, and tracks verdict
    transitions.  A failing source is counted, never fatal — a health
    plane that can crash the thing it judges is worse than no health
    plane."""

    def __init__(self, spec: Optional[SLOSpec] = None, *, clock=None,
                 recorder=None, node: str = "", max_transitions: int = 256):
        self._clock = clock if clock is not None else time.monotonic
        self.spec = spec if spec is not None else default_slo_spec()
        self.node = node
        self.recorder = recorder if recorder is not None else NOP_RECORDER
        self.evaluator = SLOEvaluator(self.spec, clock=self._clock)
        self._sources: list[Callable[[], dict]] = []
        self.source_errors = 0
        self.status = HEALTHY
        self.reasons: list[dict] = []
        self._since = self._clock()
        #: bounded (t, status, [rule names]) history, oldest dropped
        self.transitions: list[tuple] = []
        self.max_transitions = max_transitions
        self.ticks = 0

    # -- wiring -------------------------------------------------------------

    def add_source(self, fn: Callable[[], dict]) -> "HealthMonitor":
        self._sources.append(fn)
        return self

    def watch_consensus(self, consensus, *, latch_s: float = 5.0
                        ) -> "HealthMonitor":
        """Wire the standard per-replica surfaces of one Consensus: the
        VC phase tracker and the request pool."""
        self.add_source(vc_signal_source(
            consensus.vc_phases, clock=self._clock, latch_s=latch_s
        ))
        self.add_source(pool_signal_source(
            consensus.pool_occupancy, clock=self._clock, latch_s=latch_s
        ))
        return self

    # -- ticking ------------------------------------------------------------

    def tick(self) -> dict:
        """Sample every source, evaluate, record any transition.
        Returns the current verdict dict."""
        now = self._clock()
        self.ticks += 1
        signals: dict = {}
        for fn in self._sources:
            try:
                signals.update(fn() or {})
            except Exception:  # noqa: BLE001 — judged, never judging
                self.source_errors += 1
        self.evaluator.observe(signals, t=now)
        verdict = self.evaluator.evaluate(t=now)
        if verdict.status != self.status:
            self._transition(verdict, now)
        self.status = verdict.status
        self.reasons = [b.as_dict() for b in verdict.breaches]
        return self.verdict()

    def _transition(self, verdict, now: float) -> None:
        names = verdict.reasons
        self.transitions.append((now, verdict.status, names))
        if len(self.transitions) > self.max_transitions:
            del self.transitions[0]
        self._since = now
        rec = self.recorder
        if rec.enabled:
            kind = "slo.clear" if verdict.status == HEALTHY else "slo.breach"
            rec.record(kind, node=self.node,
                       extra={"status": verdict.status,
                              "slos": names[:8]})

    # -- reading ------------------------------------------------------------

    def verdict(self) -> dict:
        """The JSON-able verdict a control channel serves."""
        return {
            "status": self.status,
            "reasons": self.reasons,
            "since": round(self._clock() - self._since, 3),
            "spec": self.spec.name,
            "ticks": self.ticks,
            "transitions": len(self.transitions),
            "source_errors": self.source_errors,
        }

    def transition_log(self) -> list[dict]:
        return [
            {"t": round(t, 4), "status": status, "slos": list(names)}
            for t, status, names in self.transitions
        ]


def aggregate_cluster_verdict(replica_verdicts: dict,
                              unreachable: Sequence[str] = ()) -> dict:
    """Fold per-replica verdicts into ONE cluster verdict.

    The cluster is as sick as its sickest replica; replicas that did not
    answer the sweep are a degradation in themselves (one unreachable)
    and critical when a majority is gone — an operator must never read
    "healthy" off a sweep that reached one node out of four."""
    status = HEALTHY
    reasons: list[dict] = []
    for node, v in sorted(replica_verdicts.items()):
        status = worse(status, v.get("status", HEALTHY))
        for r in v.get("reasons", []):
            reasons.append(dict(r, node=node))
    unreachable = list(unreachable)
    if unreachable:
        total = len(replica_verdicts) + len(unreachable)
        majority_gone = len(unreachable) * 2 > total
        status = worse(status, CRITICAL if majority_gone else DEGRADED)
        reasons.append({
            "slo": "replica.unreachable",
            "severity": CRITICAL if majority_gone else DEGRADED,
            "value": float(len(unreachable)),
            "bound": 0.0,
            "nodes": unreachable,
        })
    return {
        "status": status,
        "replicas": {n: v.get("status", HEALTHY)
                     for n, v in sorted(replica_verdicts.items())},
        "reasons": reasons,
        "unreachable": unreachable,
    }
