"""Declarative SLOs with Google-SRE multi-window burn-rate evaluation.

The observability PRs gave the system eyes (flight recorder, merged
cluster timelines, per-request critical paths) but no *judgment*: nothing
machine-readable said whether what the instruments measure is acceptable.
This module is the judgment layer's bottom half:

* :class:`SLORule` — one declarative objective over a named **signal**
  (a float the health plane samples each tick: per-phase p99s, shed
  rates, mesh fill, view-change detection time, backlog at the view
  flip, WAL fsync latency).  A rule bounds the signal with a ceiling or
  a floor, carries a ``degraded`` bound and an optional ``critical``
  bound, and an **error budget**: the fraction of samples allowed to
  violate the bound before the objective is considered breached.

* :class:`SLOEvaluator` — evaluates the rules with the multi-window
  burn-rate method (Google SRE workbook, ch. 5): a rule only breaches
  when the budget burn rate is >= 1 in BOTH a fast window (catches the
  incident quickly, clears quickly on recovery) and a slow window
  (ignores one-sample blips), so transient noise cannot flap the
  verdict.  The clock is injectable — logical ``Scheduler.now`` in
  deterministic tests, ``time.monotonic`` in live replicas — the same
  idiom as :class:`~smartbft_tpu_torch.metrics.CommitLatencyTracker` and the
  flight recorder.

Memory is bounded: each rule keeps only the samples inside its slow
window (older samples are dropped on observe), and a sample is two
floats.  Signals absent from an observation contribute no sample — a
rule over a surface the embedder did not wire simply never breaches.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence

__all__ = [
    "SLORule",
    "SLOSpec",
    "SLOEvaluator",
    "default_slo_spec",
    "HEALTHY",
    "DEGRADED",
    "CRITICAL",
]

HEALTHY = "healthy"
DEGRADED = "degraded"
CRITICAL = "critical"

#: verdict severity order (index = badness)
STATUS_ORDER = (HEALTHY, DEGRADED, CRITICAL)


def worse(a: str, b: str) -> str:
    """The worse of two verdict statuses."""
    return a if STATUS_ORDER.index(a) >= STATUS_ORDER.index(b) else b


@dataclass(frozen=True)
class SLORule:
    """One declarative objective over a named signal.

    ``kind`` is ``"ceiling"`` (signal must stay at or below ``bound``)
    or ``"floor"`` (at or above — mesh fill, goodput).  ``critical_bound``
    (optional) is a second, worse bound whose breach escalates the
    verdict to ``critical``.  ``budget`` is the allowed violating-sample
    fraction per window (the error budget); ``fast_window_s`` /
    ``slow_window_s`` are the two burn-rate windows."""

    name: str
    signal: str
    bound: float
    kind: str = "ceiling"  # "ceiling" | "floor"
    critical_bound: Optional[float] = None
    budget: float = 0.01
    fast_window_s: float = 5.0
    slow_window_s: float = 60.0
    description: str = ""

    def violates(self, value: float, bound: Optional[float] = None) -> bool:
        b = self.bound if bound is None else bound
        return value > b if self.kind == "ceiling" else value < b

    def validate(self) -> None:
        if self.kind not in ("ceiling", "floor"):
            raise ValueError(f"SLO {self.name}: kind must be ceiling|floor")
        if not (0.0 < self.budget <= 1.0):
            raise ValueError(f"SLO {self.name}: budget must be in (0, 1]")
        if self.fast_window_s <= 0 or self.slow_window_s <= 0:
            raise ValueError(f"SLO {self.name}: windows must be positive")
        if self.fast_window_s > self.slow_window_s:
            raise ValueError(
                f"SLO {self.name}: fast window exceeds slow window"
            )
        if self.critical_bound is not None:
            if self.kind == "ceiling" and self.critical_bound < self.bound:
                raise ValueError(
                    f"SLO {self.name}: critical ceiling below degraded one"
                )
            if self.kind == "floor" and self.critical_bound > self.bound:
                raise ValueError(
                    f"SLO {self.name}: critical floor above degraded one"
                )


@dataclass(frozen=True)
class SLOSpec:
    """A named set of rules — the service's whole objective sheet."""

    name: str = "default"
    rules: tuple = ()

    def validate(self) -> None:
        seen: set[str] = set()
        for r in self.rules:
            r.validate()
            if r.name in seen:
                raise ValueError(f"duplicate SLO rule name {r.name!r}")
            seen.add(r.name)

    def rule(self, name: str) -> Optional[SLORule]:
        return next((r for r in self.rules if r.name == name), None)

    def with_overrides(self, **bounds: float) -> "SLOSpec":
        """A copy with per-rule bound overrides (``{rule_name: bound}``)
        — how a chaos/soak harness tightens the production spec to its
        own timescale without redeclaring it."""
        rules = tuple(
            replace(r, bound=bounds[r.name]) if r.name in bounds else r
            for r in self.rules
        )
        return replace(self, rules=rules)


def default_slo_spec(*, fast_window_s: float = 5.0,
                     slow_window_s: float = 60.0) -> SLOSpec:
    """The service's default objective sheet, grounded in the measured
    rounds: detection time and backlog-at-flip are the view-change
    gauges (detections of tens of seconds and flip backlogs a hundred
    deep under a muted leader), pool fill and shed pressure are the
    admission surface, WAL fsync is the durability budget, mesh fill the
    wave-deepening floor.  Bounds are production aspirations, not
    descriptions of today: a healthy cluster emits none of the failure
    signals, and a failing one is judged against where the roadmap says
    it must land (sub-second detection, bounded backlog)."""
    w = {"fast_window_s": fast_window_s, "slow_window_s": slow_window_s}
    return SLOSpec(name="default", rules=(
        SLORule(
            name="viewchange.detection_seconds",
            signal="viewchange.detection_seconds",
            bound=1.0, critical_bound=30.0, kind="ceiling", **w,
            description="complain-timer arm-to-fire on a leader failure "
                        "(ROADMAP 1: sub-second failover detection)",
        ),
        SLORule(
            name="viewchange.backlog_at_flip",
            signal="viewchange.backlog_at_flip",
            bound=64.0, kind="ceiling", **w,
            description="request-pool depth at the view flip (the stalled "
                        "work the new view must drain)",
        ),
        SLORule(
            name="viewchange.active_seconds",
            signal="viewchange.active_seconds",
            bound=2.0, critical_bound=60.0, kind="ceiling", **w,
            description="wall/logical seconds the current view change has "
                        "been open (armed and not yet completed)",
        ),
        SLORule(
            name="pool.fill",
            signal="pool.fill",
            bound=0.9, critical_bound=1.0, kind="ceiling", budget=0.2, **w,
            description="request-pool occupancy fraction (sustained "
                        "near-capacity fill precedes shedding)",
        ),
        SLORule(
            name="pool.shed_recent",
            signal="pool.shed_recent",
            bound=0.0, kind="ceiling", budget=0.2, **w,
            description="1.0 while the admission gate shed requests within "
                        "the recent window (client-visible overload)",
        ),
        SLORule(
            name="latency.commit_p99_ms",
            signal="latency.commit_p99_ms",
            bound=2000.0, critical_bound=30000.0, kind="ceiling", **w,
            description="submit->commit p99 over the live tracker window",
        ),
        SLORule(
            name="verify.breaker_open",
            signal="verify.breaker_open",
            bound=0.0, kind="ceiling", budget=0.2, **w,
            description="1.0 while the verify plane serves on the host "
                        "fallback (device outage; degraded by definition)",
        ),
        SLORule(
            name="mesh.device_fill_pct",
            signal="mesh.device_fill_pct",
            bound=10.0, kind="floor", budget=0.5, **w,
            description="minimum per-device fill of mesh launches (a "
                        "starved mesh wastes its devices)",
        ),
        SLORule(
            name="wal.fsync_p99_ms",
            signal="wal.fsync_p99_ms",
            bound=250.0, critical_bound=2000.0, kind="ceiling", **w,
            description="group-commit fsync p99 (the durability budget)",
        ),
        SLORule(
            name="snapshot.lag_intervals",
            signal="snapshot.lag_intervals",
            bound=3.0, critical_bound=10.0, kind="ceiling", budget=0.2, **w,
            description="decisions since the last snapshot, in units of the "
                        "configured snapshot interval (the "
                        "disk-bound objective — a stuck capture loop lets "
                        "the ledger/WAL prefix grow without bound; only "
                        "emitted when snapshots are enabled, so replicas "
                        "running without compaction never breach it)",
        ),
        SLORule(
            name="read.shed_recent",
            signal="read.shed_recent",
            bound=0.0, kind="ceiling", budget=0.2, **w,
            description="1.0 while the read gate shed reads within the "
                        "recent window (a read storm being "
                        "absorbed — degraded for readers, and proof the "
                        "storm never reached the write path)",
        ),
        SLORule(
            name="read.base_refused_recent",
            signal="read.base_refused_recent",
            bound=0.0, critical_bound=0.5, kind="ceiling", budget=0.2, **w,
            description="1.0 while a snapshot-anchored read was refused "
                        "over a torn/tampered base within the window — an "
                        "integrity event, critical on repetition",
        ),
        SLORule(
            name="read.staleness_decisions",
            signal="read.staleness_decisions",
            bound=1024.0, critical_bound=8192.0, kind="ceiling",
            budget=0.2, **w,
            description="worst anchor lag (decisions behind the live "
                        "frontier) served by snapshot-anchored reads while "
                        "they are actively landing — bounded by the capture "
                        "cadence on a healthy replica",
        ),
    ))


class _RuleState:
    __slots__ = ("rule", "samples")

    def __init__(self, rule: SLORule):
        self.rule = rule
        #: (t, value) samples inside the slow window, oldest first
        self.samples: deque = deque()


@dataclass
class SLOBreach:
    """One breached rule in a verdict, with its burn evidence."""

    slo: str
    severity: str
    value: float
    bound: float
    burn_fast: float
    burn_slow: float

    def as_dict(self) -> dict:
        return {
            "slo": self.slo,
            "severity": self.severity,
            "value": round(self.value, 4),
            "bound": self.bound,
            "burn_fast": round(self.burn_fast, 2),
            "burn_slow": round(self.burn_slow, 2),
        }


@dataclass
class SLOVerdict:
    status: str = HEALTHY
    breaches: list = field(default_factory=list)

    @property
    def reasons(self) -> list[str]:
        return [b.slo for b in self.breaches]

    def as_dict(self) -> dict:
        return {
            "status": self.status,
            "reasons": [b.as_dict() for b in self.breaches],
        }


class SLOEvaluator:
    """Samples signals against a spec and renders burn-rate verdicts.

    ``observe(signals)`` appends one sample per rule whose signal is
    present; ``evaluate()`` computes per-rule budget burn over the fast
    and slow windows and returns the :class:`SLOVerdict` (breached rules
    ranked worst burn first).  Stateless consumers call
    ``observe`` + ``evaluate`` from one tick loop; everything is O(rules
    x window samples) with windows bounded by time."""

    def __init__(self, spec: SLOSpec, *, clock=None):
        spec.validate()
        self.spec = spec
        self._clock = clock if clock is not None else time.monotonic
        self._states = {r.name: _RuleState(r) for r in spec.rules}
        self.observations = 0

    def observe(self, signals: dict, t: Optional[float] = None) -> None:
        now = self._clock() if t is None else t
        self.observations += 1
        for st in self._states.values():
            value = signals.get(st.rule.signal)
            if value is None:
                continue
            st.samples.append((now, float(value)))
            horizon = now - st.rule.slow_window_s
            while st.samples and st.samples[0][0] < horizon:
                st.samples.popleft()

    @staticmethod
    def _burn(rule: SLORule, samples: Sequence, now: float,
              window: float, bound: float) -> tuple[float, float]:
        """(burn, worst_violating_value) over the trailing ``window``:
        burn = violating-sample fraction / error budget."""
        lo = now - window
        total = violating = 0
        worst: Optional[float] = None
        for t, v in samples:
            if t < lo:
                continue
            total += 1
            if rule.violates(v, bound):
                violating += 1
                if worst is None:
                    worst = v
                elif rule.kind == "ceiling":
                    worst = max(worst, v)
                else:
                    worst = min(worst, v)
        if not total:
            return 0.0, 0.0
        return (violating / total) / rule.budget, (worst or 0.0)

    def evaluate(self, t: Optional[float] = None) -> SLOVerdict:
        now = self._clock() if t is None else t
        breaches: list[SLOBreach] = []
        for st in self._states.values():
            rule = st.rule
            if not st.samples:
                continue
            # fast window first: in the healthy steady state it misses,
            # and the slow-window sweep (the expensive one) is skipped
            fast, worst_f = self._burn(rule, st.samples, now,
                                       rule.fast_window_s, rule.bound)
            if fast < 1.0:
                continue
            slow, _ = self._burn(rule, st.samples, now,
                                 rule.slow_window_s, rule.bound)
            if slow < 1.0:
                continue
            severity = DEGRADED
            if rule.critical_bound is not None:
                cfast, cworst = self._burn(rule, st.samples, now,
                                           rule.fast_window_s,
                                           rule.critical_bound)
                cslow, _ = self._burn(rule, st.samples, now,
                                      rule.slow_window_s,
                                      rule.critical_bound)
                if cfast >= 1.0 and cslow >= 1.0:
                    severity = CRITICAL
                    worst_f = cworst
            breaches.append(SLOBreach(
                slo=rule.name, severity=severity, value=worst_f,
                bound=rule.bound, burn_fast=fast, burn_slow=slow,
            ))
        breaches.sort(key=lambda b: (b.severity != CRITICAL, -b.burn_fast))
        status = HEALTHY
        for b in breaches:
            status = worse(status, b.severity)
        return SLOVerdict(status=status, breaches=breaches)
