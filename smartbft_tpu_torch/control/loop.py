"""Driver for the self-driving control plane.

Connects one cluster's verdict stream to the pure policy core and
executes its decisions through EXISTING seams only:

* scale-out / scale-in → ``ShardSet.reshard`` (epoch-fenced, drains and
  re-parks in-flight work — the reshard machinery, untouched);
* knob retunes → ``App.submit_reconfig`` on every shard, i.e. an
  ordered, internal, pool-deduplicated reconfig request.  The Vertical
  Paxos rule: an automated action IS an ordered decision, so remediation
  inherits fork-freedom and exactly-once from the stream it rides.

Every executed (or failed) action lands as a ``ctl.remediate``
flight-recorder span carrying cause → verdict → action, adjacent to the
``slo.breach`` span that triggered it on the merged timeline; the
matching ``ctl.clear`` span closes the arc when the verdict returns to
healthy.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
from typing import Any, Dict, List, Optional

from .policy import ControlPolicy, Remediation, TransitionArbiter

__all__ = ["ControlLoop", "run_control_loop"]

OWNER = "controller"


class ControlLoop:
    """Tick-driven reflex arc for one :class:`ShardedCluster`.

    ``tick()`` is synchronous decision + bookkeeping; ``step()`` is
    ``tick()`` plus execution of whatever it decided.  The split keeps
    the decision path testable without an event loop and lets the chaos
    harness drive ticks on the logical clock.
    """

    def __init__(
        self,
        cluster,
        *,
        policy: Optional[ControlPolicy] = None,
        arbiter: Optional[TransitionArbiter] = None,
        recorder=None,
        logger: Optional[logging.Logger] = None,
    ) -> None:
        self.cluster = cluster
        self.base_config = cluster.base_config
        self.current_config = self.base_config
        self.policy = policy or ControlPolicy.from_config(
            self.base_config, clock=cluster.scheduler.now
        )
        self.arbiter = arbiter or TransitionArbiter()
        if recorder is None:
            recorder = cluster._recorder_for("ctl")
        if recorder is None:  # trace=False clusters hand out None
            from ..obs import NOP_RECORDER

            recorder = NOP_RECORDER
        self.recorder = recorder
        self.logger = logger or logging.getLogger("smartbft.control")
        self.executed: List[Dict[str, Any]] = []
        self._awaiting_clear: Optional[str] = None
        self._retune_seq = 0

    # ------------------------------------------------------------------
    # signal sampling

    def sample(self) -> Dict[str, Any]:
        """Live EWMAs from the cluster: occupancy, RTT, commit gap, drain.

        RTT/commit-gap take the max over live nodes (the slowest link is
        what forward timeouts must cover); drain rate sums over shards
        (the outbox cap serves aggregate throughput).  In-process comms
        have no RTT estimator — ``rtt_s`` is then ``None`` and the
        forward-timeout knob simply is not derived.
        """
        occ = self.cluster.set.occupancy()
        rtt: Optional[float] = None
        gap: Optional[float] = None
        drain = 0.0
        for shard in self.cluster.shard_list:
            for app in shard.live_apps():
                cons = app.consensus
                if cons is not None:
                    frontier = cons.delivery_frontier()
                    g = frontier.get("commit_gap_s")
                    if g is not None and g > 0.0:
                        gap = g if gap is None else max(gap, g)
                comm = getattr(app, "comm", None)
                rtt_fn = getattr(comm, "rtt_seconds", None)
                if rtt_fn is not None:
                    r = rtt_fn()
                    if r is not None and r > 0.0:
                        rtt = r if rtt is None else max(rtt, r)
            pocc = shard.pool_occupancy()
            drain += float(pocc.get("drain_rate", 0.0) or 0.0)
        return {
            "occupancy": occ,
            "rtt_s": rtt,
            "commit_gap_s": gap,
            "drain_rate": drain if drain > 0.0 else None,
        }

    # ------------------------------------------------------------------
    # decision

    def tick(self) -> Remediation:
        verdict = self.cluster.health.tick()
        signals = self.sample()
        in_transition = (
            self.cluster.set.reshard_in_progress or self.arbiter.holder is not None
        )
        breaker_open = bool(getattr(self.cluster.coalescer, "breaker_open", False))
        rem = self.policy.decide(
            verdict,
            signals,
            num_shards=self.cluster.set.num_shards,
            in_transition=in_transition,
            breaker_open=breaker_open,
            current_config=self.current_config,
            base_config=self.base_config,
        )
        status = verdict.get("status")
        if self._awaiting_clear is not None and status == "healthy":
            if self.recorder.enabled:
                self.recorder.record(
                    "ctl.clear",
                    node="ctl",
                    extra={"after": self._awaiting_clear},
                )
            self._awaiting_clear = None
        rem.__dict__["_verdict_status"] = status  # carried for the span
        return rem

    # ------------------------------------------------------------------
    # execution

    async def _execute_scale(self, rem: Remediation) -> bool:
        if not self.arbiter.try_acquire(OWNER):
            # Legacy autoscaler (or a prior action) owns the transition;
            # treat as failed so the cooldown re-arms and we re-evaluate
            # against the post-transition topology.
            return False
        try:
            await self.cluster.reshard(rem.target_shards)
            return True
        except Exception:
            self.logger.exception("controller reshard to %d failed", rem.target_shards)
            return False
        finally:
            self.arbiter.release(OWNER)

    async def _execute_retune(self, rem: Remediation) -> bool:
        new_cfg = dataclasses.replace(self.current_config, **rem.knobs)
        self._retune_seq += 1
        rid = "ctl-retune-%d" % self._retune_seq
        ok = True
        for shard in self.cluster.shard_list:
            try:
                app = shard._submit_app()
                await app.submit_reconfig(
                    "%s-s%d" % (rid, shard.shard_id),
                    [a.id for a in shard.apps],
                    new_cfg,
                )
            except Exception:
                self.logger.exception(
                    "retune reconfig on shard %d failed", shard.shard_id
                )
                ok = False
        if ok:
            self.current_config = new_cfg
        return ok

    async def execute(self, rem: Remediation) -> bool:
        if rem.status != "act":
            return False
        t0 = self.cluster.scheduler.now()
        if rem.action in ("scale_out", "scale_in"):
            ok = await self._execute_scale(rem)
        elif rem.action == "retune":
            ok = await self._execute_retune(rem)
        else:
            return False
        self.policy.note_result(rem, ok)
        self._awaiting_clear = rem.action
        if self.recorder.enabled:
            self.recorder.record(
                "ctl.remediate",
                node="ctl",
                dur=self.cluster.scheduler.now() - t0,
                extra={
                    "cause": rem.cause,
                    "verdict": rem.__dict__.get("_verdict_status", ""),
                    "action": rem.action,
                    "ok": ok,
                    "target": rem.target_shards,
                    "knobs": dict(rem.knobs),
                    "reason": rem.reason,
                },
            )
        self.executed.append({**rem.as_dict(), "ok": ok})
        return ok

    async def step(self) -> Remediation:
        rem = self.tick()
        if rem.status == "act":
            await self.execute(rem)
        return rem

    def snapshot(self) -> Dict[str, Any]:
        return {
            "policy": self.policy.snapshot(),
            "executed": list(self.executed),
            "arbiter": {
                "holder": self.arbiter.holder,
                "acquired": self.arbiter.acquired,
                "contended": self.arbiter.contended,
            },
        }


async def run_control_loop(
    cluster,
    *,
    loop: Optional[ControlLoop] = None,
    interval: Optional[float] = None,
    stop: Optional[asyncio.Event] = None,
) -> ControlLoop:
    """Wall-clock driver mirroring ``run_autoscaler``: tick every
    ``interval`` seconds until ``stop`` is set.  Returns the loop so the
    caller can read its snapshot."""
    ctl = loop or ControlLoop(cluster)
    period = interval if interval is not None else ctl.policy.interval
    stop = stop or asyncio.Event()
    while not stop.is_set():
        try:
            await asyncio.wait_for(stop.wait(), timeout=period)
        except asyncio.TimeoutError:
            pass
        if stop.is_set():
            break
        await ctl.step()
    return ctl
