"""Pure decision core for the self-driving control plane.

Verdict stream in, typed :class:`Remediation` out.  No I/O, no awaits,
injectable clock — the same discipline as
:class:`~smartbft_tpu_torch.shard.autoscale.OccupancyAutoscaler`, which this
core folds in (occupancy saturation is one of its scale-out causes).

The anti-thrash machinery layers four independent guards, applied to a
*candidate* action (so the veto counters measure suppressed real actions,
not idle ticks):

1. transition/breaker veto — never act mid-reshard or while the verify
   host-fallback breaker is open (the system is already remediating);
2. per-action cooldown — re-armed on failure as well as success, so a
   reshard that errors out does not get retried in a tight loop;
3. global budget — at most ``control_budget_actions`` actions per
   ``control_budget_window`` seconds across ALL action kinds;
4. hysteresis reversal guard — an action that undoes a recent one
   (scale-in after scale-out, a knob flipped back to its previous value)
   is vetoed inside ``control_hysteresis`` seconds.  This is the Mir-BFT
   thrash lesson: oscillation is worse than either steady state.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "Remediation",
    "TransitionArbiter",
    "ControlPolicy",
    "derive_knobs",
    "count_reversals",
]

# Derived forward timeouts below this are noise: a non-trivial quorum
# round trip cannot complete faster regardless of measured RTT.
FORWARD_FLOOR_S = 0.010

# Never derive an outbox cap below this; a tiny cap would wedge the
# transport the controller is trying to tune.
OUTBOX_FLOOR = 256


@dataclass
class Remediation:
    """One decision: what to do (or why nothing was done) and why.

    ``status`` is ``"act"`` for an executable decision, ``"veto"`` when a
    candidate action was suppressed by a guard, and ``"idle"`` when no
    candidate existed.  Only ``"act"`` entries consume cooldown/budget.
    """

    action: str  # "scale_out" | "scale_in" | "retune" | "none"
    cause: str  # triggering SLO/signal name, e.g. "latency.commit_p99_ms"
    status: str  # "act" | "veto" | "idle"
    reason: str
    at: float
    target_shards: int = 0
    knobs: Dict[str, Any] = field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "action": self.action,
            "cause": self.cause,
            "status": self.status,
            "reason": self.reason,
            "at": round(self.at, 3),
            "target_shards": self.target_shards,
            "knobs": dict(self.knobs),
        }


class TransitionArbiter:
    """Mutual exclusion between topology-transition initiators.

    The legacy ``run_autoscaler`` loop and the control loop can both
    decide to reshard; whichever acquires the arbiter first owns the
    transition and the other's attempt is counted and dropped (it will
    re-evaluate on its next tick against the post-transition topology).
    Strictly non-reentrant: a second ``try_acquire`` by the SAME owner
    while held also fails, which turns any accounting bug into a loud
    stall instead of a silent double transition.
    """

    def __init__(self) -> None:
        self._holder: Optional[str] = None
        self.acquired = 0
        self.contended = 0

    @property
    def holder(self) -> Optional[str]:
        return self._holder

    def try_acquire(self, owner: str) -> bool:
        if self._holder is not None:
            self.contended += 1
            return False
        self._holder = owner
        self.acquired += 1
        return True

    def release(self, owner: str) -> None:
        if self._holder == owner:
            self._holder = None


def _quantize_s(x: float) -> float:
    # Millisecond quantization: reconfig mirrors carry *_ms ints, so
    # sub-ms drift in a derived value would otherwise retune forever.
    return round(x, 3)


def derive_knobs(
    base,
    current,
    *,
    rtt_s: Optional[float] = None,
    commit_gap_s: Optional[float] = None,
    drain_rate: Optional[float] = None,
) -> Dict[str, Any]:
    """Recompute timer/hold/cap knobs from measured EWMAs.

    The RTT-derived timer pattern generalized: each knob is
    ``multiplier x EWMA`` clamped to ``[floor, BASE-config value]``.
    Ceilings come from the *base* (boot-time) config, never the current
    one, so repeated retunes can only move within the operator's
    envelope — they cannot ratchet it.

    A knob is included only when it moved by more than
    ``control_knob_deadband`` (relative) from ``current``; the deadband
    plus ms quantization is what makes a retune converge in one commit
    instead of livelocking on EWMA jitter.
    """
    candidates: Dict[str, Any] = {}
    if rtt_s is not None and rtt_s > 0.0:
        fwd = base.control_forward_rtt_multiplier * rtt_s
        fwd = min(max(fwd, FORWARD_FLOOR_S), base.request_forward_timeout)
        candidates["request_forward_timeout"] = _quantize_s(fwd)
    if commit_gap_s is not None and commit_gap_s > 0.0:
        hold = base.control_hold_commit_multiplier * commit_gap_s
        hold = min(max(hold, 0.0), base.request_batch_max_interval)
        candidates["verify_flush_hold"] = _quantize_s(hold)
    if drain_rate is not None and drain_rate > 0.0:
        cap = int(drain_rate * base.control_outbox_drain_window)
        cap = min(max(cap, OUTBOX_FLOOR), base.transport_outbox_cap)
        candidates["transport_outbox_cap"] = cap

    deadband = base.control_knob_deadband
    knobs: Dict[str, Any] = {}
    for name, new in candidates.items():
        cur = getattr(current, name)
        if abs(new - cur) / max(abs(cur), 1e-9) > deadband:
            knobs[name] = new
    return knobs


def count_reversals(
    decisions: List[Tuple[float, str, str]], window: float
) -> int:
    """Count A→B→A flips within ``window`` in a policy decision log.

    A reversal is a ``scale_in`` within ``window`` of a ``scale_out`` (or
    vice versa).  Pure so the chaos invariant and the bench row share one
    definition of "oscillation".
    """
    reversals = 0
    opposite = {"scale_out": "scale_in", "scale_in": "scale_out"}
    acts = [(t, a) for (t, a, _why) in decisions if a in opposite]
    for i, (t, a) in enumerate(acts):
        for (t2, a2) in acts[i + 1 :]:
            if t2 - t > window:
                break
            if a2 == opposite[a]:
                reversals += 1
    return reversals


class ControlPolicy:
    """Verdicts + live signals in, :class:`Remediation` out.

    Candidate first, veto second: each tick we first determine what the
    signals *call for* (scale-out on a commit-latency burn or occupancy
    saturation, scale-in on sustained idle, a knob retune while
    unhealthy), and only then run the candidate through the guard chain.
    Retunes are gated on an unhealthy verdict on purpose: a healthy
    steady state produces zero actions, which is exactly the
    "zero actions outside fault windows" chaos invariant.
    """

    def __init__(
        self,
        *,
        interval: float = 1.0,
        cooldown: float = 30.0,
        hysteresis: float = 120.0,
        idle_hold: float = 60.0,
        budget_actions: int = 4,
        budget_window: float = 300.0,
        min_shards: int = 1,
        max_shards: int = 8,
        high_occupancy: float = 0.85,
        low_occupancy: float = 0.25,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.interval = float(interval)
        self.cooldown = float(cooldown)
        self.hysteresis = float(hysteresis)
        self.idle_hold = float(idle_hold)
        self.budget_actions = int(budget_actions)
        self.budget_window = float(budget_window)
        self.min_shards = int(min_shards)
        self.max_shards = int(max_shards)
        self.high_occupancy = float(high_occupancy)
        self.low_occupancy = float(low_occupancy)
        self.clock = clock

        self._cooldown_until: Dict[str, float] = {}
        self._actions: List[Tuple[float, str]] = []  # acted only
        self._knob_history: List[Tuple[float, str, Any, Any]] = []
        self._idle_since: Optional[float] = None
        self._last_shed = 0
        self.decisions: List[Tuple[float, str, str]] = []  # acted only
        self.counters: Dict[str, int] = {
            "ticks": 0,
            "decisions": 0,
            "succeeded": 0,
            "failed": 0,
            "veto_transition": 0,
            "veto_breaker": 0,
            "veto_cooldown": 0,
            "veto_budget": 0,
            "veto_reversal": 0,
            "scale_out": 0,
            "scale_in": 0,
            "retune": 0,
        }

    @classmethod
    def from_config(cls, config, *, clock: Callable[[], float] = time.monotonic) -> "ControlPolicy":
        return cls(
            interval=config.control_interval,
            cooldown=config.control_cooldown,
            hysteresis=config.control_hysteresis,
            idle_hold=config.control_idle_hold,
            budget_actions=config.control_budget_actions,
            budget_window=config.control_budget_window,
            min_shards=config.autoscale_min_shards,
            max_shards=config.autoscale_max_shards,
            high_occupancy=config.autoscale_high_occupancy,
            low_occupancy=config.autoscale_low_occupancy,
            clock=clock,
        )

    # ------------------------------------------------------------------
    # candidate detection

    def _breach_names(self, verdict: Dict[str, Any]) -> List[str]:
        return [r.get("slo", "") for r in verdict.get("reasons", ())]

    def _saturated(self, occ: Dict[str, Any]) -> bool:
        # Folded OccupancyAutoscaler saturation test: pressure shows up
        # as fill, parked waiters, or fresh admission shedding.
        if occ.get("total_capacity", 0) == 0:
            return False
        shed = int(occ.get("shed_admission", 0)) + int(occ.get("shed_timeout", 0))
        shed_delta = shed - self._last_shed
        self._last_shed = shed
        return (
            occ.get("fill", 0.0) >= self.high_occupancy
            or occ.get("total_waiters", 0) > 0
            or shed_delta > 0
        )

    def _idle(self, occ: Dict[str, Any], healthy: bool) -> bool:
        return (
            healthy
            and occ.get("total_capacity", 0) != 0
            and occ.get("fill", 1.0) <= self.low_occupancy
            and occ.get("total_waiters", 0) == 0
        )

    def _candidate(
        self,
        verdict: Dict[str, Any],
        signals: Dict[str, Any],
        *,
        num_shards: int,
        current_config,
        base_config,
        now: float,
    ) -> Optional[Remediation]:
        breaches = self._breach_names(verdict)
        healthy = verdict.get("status") == "healthy"
        occ = signals.get("occupancy", {}) or {}
        saturated = self._saturated(occ)

        # Scale out BEFORE the knee: the commit-latency burn fires while
        # queueing delay grows but occupancy has not yet pinned.
        if "latency.commit_p99_ms" in breaches and num_shards < self.max_shards:
            return Remediation(
                action="scale_out",
                cause="latency.commit_p99_ms",
                status="act",
                reason="commit p99 burn-rate breach",
                at=now,
                target_shards=min(num_shards + 1, self.max_shards),
            )
        if saturated and num_shards < self.max_shards:
            return Remediation(
                action="scale_out",
                cause="pool.fill",
                status="act",
                reason="occupancy saturated (fill/waiters/shed)",
                at=now,
                target_shards=min(num_shards + 1, self.max_shards),
            )

        # Sustained idle → scale in (tracked across ticks; any
        # non-idle tick resets the hold timer).
        if self._idle(occ, healthy):
            if self._idle_since is None:
                self._idle_since = now
            if (
                now - self._idle_since >= self.idle_hold
                and num_shards > self.min_shards
            ):
                return Remediation(
                    action="scale_in",
                    cause="pool.fill",
                    status="act",
                    reason="sustained idle >= %.0fs" % self.idle_hold,
                    at=now,
                    target_shards=max(num_shards - 1, self.min_shards),
                )
        else:
            self._idle_since = None

        # Retune only while unhealthy: derive timer/hold/cap knobs from
        # the measured EWMAs and commit whatever cleared the deadband.
        if not healthy and current_config is not None and base_config is not None:
            knobs = derive_knobs(
                base_config,
                current_config,
                rtt_s=signals.get("rtt_s"),
                commit_gap_s=signals.get("commit_gap_s"),
                drain_rate=signals.get("drain_rate"),
            )
            knobs = self._filter_knob_reversals(knobs, current_config, now)
            if knobs:
                cause = breaches[0] if breaches else "health.degraded"
                return Remediation(
                    action="retune",
                    cause=cause,
                    status="act",
                    reason="re-derive knobs from RTT/commit-gap/drain EWMAs",
                    at=now,
                    knobs=knobs,
                )
        return None

    def _filter_knob_reversals(
        self, knobs: Dict[str, Any], current_config, now: float
    ) -> Dict[str, Any]:
        # Drop any knob that would flip back to the value it held before
        # the most recent change inside the hysteresis window (A→B→A).
        kept: Dict[str, Any] = {}
        for name, new in knobs.items():
            reverted = False
            for (t, field_name, old, _new) in reversed(self._knob_history):
                if now - t > self.hysteresis:
                    break
                if field_name == name and old == new:
                    reverted = True
                    break
            if not reverted:
                kept[name] = new
        return kept

    # ------------------------------------------------------------------
    # veto chain

    def _veto(
        self,
        cand: Remediation,
        *,
        in_transition: bool,
        breaker_open: bool,
        now: float,
    ) -> Optional[Remediation]:
        def vetoed(counter: str, reason: str) -> Remediation:
            self.counters[counter] += 1
            return Remediation(
                action=cand.action,
                cause=cand.cause,
                status="veto",
                reason=reason,
                at=now,
                target_shards=cand.target_shards,
                knobs=dict(cand.knobs),
            )

        if in_transition:
            return vetoed("veto_transition", "reshard/reconfig transition in progress")
        if breaker_open:
            return vetoed("veto_breaker", "verify breaker open (host fallback active)")
        until = self._cooldown_until.get(cand.action, 0.0)
        if now < until:
            return vetoed(
                "veto_cooldown", "%s cooldown until t=%.1f" % (cand.action, until)
            )
        recent = [t for (t, _a) in self._actions if now - t <= self.budget_window]
        if len(recent) >= self.budget_actions:
            return vetoed(
                "veto_budget",
                "anti-thrash budget: %d actions within %.0fs"
                % (len(recent), self.budget_window),
            )
        if cand.action in ("scale_out", "scale_in"):
            opposite = "scale_in" if cand.action == "scale_out" else "scale_out"
            for (t, a) in reversed(self._actions):
                if now - t > self.hysteresis:
                    break
                if a == opposite:
                    return vetoed(
                        "veto_reversal",
                        "would reverse %s from t=%.1f within hysteresis" % (a, t),
                    )
        return None

    # ------------------------------------------------------------------
    # public surface

    def decide(
        self,
        verdict: Dict[str, Any],
        signals: Dict[str, Any],
        *,
        num_shards: int,
        in_transition: bool = False,
        breaker_open: bool = False,
        current_config=None,
        base_config=None,
    ) -> Remediation:
        now = self.clock()
        self.counters["ticks"] += 1
        cand = self._candidate(
            verdict,
            signals,
            num_shards=num_shards,
            current_config=current_config,
            base_config=base_config,
            now=now,
        )
        if cand is None:
            return Remediation(
                action="none", cause="", status="idle", reason="no candidate", at=now
            )
        veto = self._veto(
            cand, in_transition=in_transition, breaker_open=breaker_open, now=now
        )
        if veto is not None:
            return veto

        # Commit the decision to history: cooldown, budget window,
        # per-knob hysteresis bookkeeping.
        self.counters["decisions"] += 1
        self.counters[cand.action] += 1
        self._cooldown_until[cand.action] = now + self.cooldown
        self._actions.append((now, cand.action))
        self.decisions.append((now, cand.action, cand.reason))
        if cand.action == "retune" and current_config is not None:
            for name, new in cand.knobs.items():
                self._knob_history.append(
                    (now, name, getattr(current_config, name), new)
                )
        if cand.action in ("scale_out", "scale_in"):
            self._idle_since = None
        return cand

    def note_result(self, rem: Remediation, ok: bool) -> None:
        """Record execution outcome; failure re-arms the cooldown.

        Re-arming from *completion* time matters: a reshard that takes
        20s to fail would otherwise have burned most of its cooldown
        before the failure was even known.
        """
        if rem.status != "act":
            return
        if ok:
            self.counters["succeeded"] += 1
        else:
            self.counters["failed"] += 1
            self._cooldown_until[rem.action] = self.clock() + self.cooldown

    def reversals(self) -> int:
        return count_reversals(self.decisions, self.hysteresis)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "counters": dict(self.counters),
            "decisions": list(self.decisions),
            "reversals": self.reversals(),
            "cooldowns": dict(self._cooldown_until),
        }
