"""Occupancy-driven shard autoscaler.

Capacity follows load: the one backpressure signal the sharded front door
already exposes — ``Pool.occupancy()`` rolled up by
``ShardSet.occupancy()`` — drives the shard count.  When the combined
pool fill saturates (or submitters are parked waiting for space), the
deployment is under-provisioned and the autoscaler asks for one more
shard; when fill idles near zero it asks for one fewer.  Every decision
is clamped to ``[min_shards, max_shards]`` and gated by a cooldown: a
reshard is an epoch transition with a real drain, so the scaler must
never flap — scale-out and scale-in both re-arm the same cooldown clock,
and no evaluation fires while a transition is still in flight.

Two layers, separable on purpose:

* :class:`OccupancyAutoscaler` — the pure DECISION function
  (``evaluate(occupancy, num_shards) -> target | None``), unit-testable
  with synthetic occupancy snapshots and an injected clock;
* :func:`run_autoscaler` — the LOOP, polling a ShardSet and executing
  decisions through ``ShardSet.reshard`` (scale-out needs the embedder's
  ``make_shard`` factory).  Transition failures (drain-deadline aborts)
  count, re-arm the cooldown, and never kill the loop.

Thresholds live in :class:`~smartbft_tpu_torch.config.Configuration`
(``autoscale_high_occupancy`` / ``autoscale_low_occupancy`` /
``autoscale_cooldown`` / ``autoscale_min_shards`` /
``autoscale_max_shards``) and ride reconfigurations through ConfigMirror
like every other knob; :meth:`OccupancyAutoscaler.from_config` reads
them.
"""

from __future__ import annotations

import asyncio
import time
from typing import Callable, Optional

__all__ = ["OccupancyAutoscaler", "run_autoscaler"]


class OccupancyAutoscaler:
    """Pure scale-out/in decision over combined occupancy snapshots."""

    def __init__(self, *, high: float = 0.85, low: float = 0.15,
                 cooldown: float = 60.0, min_shards: int = 1,
                 max_shards: int = 8, step: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        if not (0.0 < low < high <= 1.0):
            raise ValueError(
                f"need 0 < low < high <= 1, got low={low} high={high}"
            )
        if not (1 <= min_shards <= max_shards):
            raise ValueError(
                f"need 1 <= min_shards <= max_shards, got "
                f"{min_shards}..{max_shards}"
            )
        if step < 1:
            raise ValueError(f"step must be >= 1, got {step}")
        self.high = high
        self.low = low
        self.cooldown = cooldown
        self.min_shards = min_shards
        self.max_shards = max_shards
        self.step = step
        self._clock = clock
        self._last_action: Optional[float] = None
        #: cumulative front-door sheds at the last evaluate — an increase
        #: is a saturation signal in its own right (see evaluate)
        self._last_shed: Optional[int] = None
        #: decision log for benches/tests: (monotonic, from_s, to_s, why)
        self.decisions: list[tuple] = []

    @classmethod
    def from_config(cls, config, **overrides) -> "OccupancyAutoscaler":
        kw = dict(
            high=config.autoscale_high_occupancy,
            low=config.autoscale_low_occupancy,
            cooldown=config.autoscale_cooldown,
            min_shards=config.autoscale_min_shards,
            max_shards=config.autoscale_max_shards,
        )
        kw.update(overrides)
        return cls(**kw)

    def in_cooldown(self) -> bool:
        return (self._last_action is not None
                and self._clock() - self._last_action < self.cooldown)

    def note_action(self) -> None:
        """Re-arm the cooldown (called for executed AND failed reshards —
        a failed drain is the strongest possible signal to back off)."""
        self._last_action = self._clock()

    def evaluate(self, occupancy: dict, num_shards: int) -> Optional[int]:
        """The target shard count, or None to hold.

        ``occupancy`` is a ``ShardSet.occupancy()`` snapshot: ``fill`` is
        the combined filled fraction, ``total_waiters`` counts submitters
        already parked on a full pool (saturation even when a race just
        freed a slot), and ``shed_admission``/``shed_timeout`` are the
        front door's cumulative sheds.  Shedding since the last
        evaluation is a saturation signal in its own right — with an
        admission gate armed below ``high`` (e.g. hw 0.8 vs high 0.85)
        fill can NEVER reach the threshold and waiters never form (the
        gate sheds before the pool fills), so without this signal the
        autoscaler would watch a shedding cluster forever and never
        scale out the one remedy it owns."""
        if self.in_cooldown():
            return None
        # baseline advances only on ACTIONABLE evaluations: sheds that
        # land mid-cooldown still read as saturation once it expires,
        # instead of being silently consumed by a held evaluation
        sheds = int(occupancy.get("shed_admission", 0)) \
            + int(occupancy.get("shed_timeout", 0))
        shedding = self._last_shed is not None and sheds > self._last_shed
        self._last_shed = sheds
        fill = float(occupancy.get("fill", 0.0))
        waiters = int(occupancy.get("total_waiters", 0))
        saturated = fill >= self.high or waiters > 0 or shedding
        # "nothing reporting" (explicit zero combined capacity — e.g. the
        # pools have not started yet) is indistinguishable from idle by
        # fill alone; hold rather than shrink a deployment that has not
        # come up.  Absent capacity (embedder snapshots without the key)
        # keeps plain fill semantics.
        idle = (fill <= self.low and waiters == 0 and not shedding
                and occupancy.get("total_capacity") != 0)
        if saturated and num_shards < self.max_shards:
            target = min(num_shards + self.step, self.max_shards)
            self.decisions.append(
                (self._clock(), num_shards, target,
                 f"fill={fill:.2f} waiters={waiters} shedding={shedding}")
            )
            return target
        if idle and num_shards > self.min_shards:
            target = max(num_shards - self.step, self.min_shards)
            self.decisions.append(
                (self._clock(), num_shards, target, f"fill={fill:.2f} idle")
            )
            return target
        return None


async def run_autoscaler(shard_set, autoscaler: OccupancyAutoscaler, *,
                         make_shard: Optional[Callable] = None,
                         interval: float = 1.0,
                         stop: Optional[asyncio.Event] = None,
                         on_reshard: Optional[Callable] = None,
                         arbiter=None,
                         logger=None) -> int:
    """The autoscaler loop: poll occupancy, execute decisions, never die.

    ``make_shard(shard_id, epoch)`` builds new groups on scale-out (the
    embedder's factory, same as ``ShardSet.reshard``).  ``on_reshard``
    (optional, sync) observes each completed transition summary — the
    harness uses it to refresh its shard list.  ``arbiter`` (a
    :class:`~smartbft_tpu_torch.control.TransitionArbiter`, shared with any
    :class:`~smartbft_tpu_torch.control.ControlLoop` on the same set) makes the
    two transition initiators mutually exclusive: the old
    check-``reshard_in_progress``-then-reshard sequence was a TOCTOU —
    the controller could start a reshard between this loop's check and
    its own ``reshard`` call, double-transitioning the epoch.  The
    arbiter is acquired BEFORE evaluate and released after the
    transition completes (or fails), closing that window.  Runs until
    ``stop`` is set (required for bounded runs; pass ``asyncio.Event()``),
    returning the number of reshards executed."""
    stop = stop or asyncio.Event()
    executed = 0
    while not stop.is_set():
        held = arbiter is None or arbiter.try_acquire("autoscaler")
        if held:
            try:
                if not shard_set.reshard_in_progress:
                    target = autoscaler.evaluate(
                        shard_set.occupancy(), shard_set.num_shards
                    )
                    if target is not None:
                        autoscaler.note_action()
                        try:
                            summary = await shard_set.reshard(
                                target, make_shard=make_shard
                            )
                            executed += 1
                            if on_reshard is not None:
                                on_reshard(summary)
                        except asyncio.CancelledError:
                            raise
                        except Exception as e:  # noqa: BLE001 — the loop's
                            # contract is "execute decisions, never die": a
                            # drain abort (ShardEpochError), a missing
                            # make_shard (ValueError on scale-out), or a
                            # transient group-start failure must not kill
                            # future evaluations; the cooldown is already
                            # re-armed above
                            if logger is not None:
                                logger.warnf(
                                    "autoscale reshard to %d failed: %r",
                                    target, e)
            finally:
                if arbiter is not None:
                    arbiter.release("autoscaler")
        # wake promptly on stop, tick on interval otherwise
        try:
            await asyncio.wait_for(stop.wait(), timeout=interval)
        except asyncio.TimeoutError:
            pass
    return executed
