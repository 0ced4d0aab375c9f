"""Open-loop load generation: Poisson arrivals over Zipf-skewed clients.

Every bench before round 12 was CLOSED-loop: the pump waits for its own
submits, so the system's slowness throttles the offered load and the
measured "throughput" is really the burst service rate.  A service
serving millions of users sees OPEN-loop arrivals — requests keep coming
at the offered rate whether or not the system keeps up — and is judged on
tail latency and shed rate under that pressure, not on burst tx/s.  This
module is the shared arrival machinery for everything that measures that:

* :class:`OpenLoopPump` — a Poisson arrival schedule (exponential gaps)
  against an EXTERNAL clock, so the same pump paces wall-clock benches
  (``benchmarks/openloop.py``) and logical-clock tier-1 tests (advance
  the scheduler, ask the pump what is due);
* :class:`ZipfClients` — client ids drawn from a Zipf(s) popularity
  distribution, the canonical skewed-workload shape (Mir-BFT treats
  client bucketing under exactly this skew as a first-class hazard): a
  hot client's whole key concentrates on ONE shard, so overload arrives
  per-shard long before the aggregate saturates;
* :func:`run_open_loop` — the driver that pumps a ShardedCluster's
  routed front door for a fixed span, spawning one background submit
  task per arrival (an open-loop client never waits for the previous
  request), counting acks and the two shed shapes, and polling the
  combined committed stream so the set's CommitLatencyTracker resolves
  stamps as commits land.

The chaos harness reuses the pump directly for its ``load_spike`` /
``load_stop`` timeline actions (an overload burst as a schedulable fault
— see ``testing.chaos``).
"""

from __future__ import annotations

import asyncio
import bisect
import random
import types
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..core.pool import AdmissionRejected, SubmitTimeoutError
from ..utils.tasks import create_logged_task

__all__ = ["OpenLoopPump", "OpenLoopStats", "ZipfClients", "run_open_loop"]


class ZipfClients:
    """Client ids under a Zipf(s) popularity law: client rank r carries
    weight 1/r^s.  At the default s=1.1 over 512 clients the hottest
    client alone draws ~14% of all traffic — which lands on exactly one
    shard of the routed front door, the hot-shard pressure the admission
    gate exists for."""

    def __init__(self, n_clients: int = 512, skew: float = 1.1,
                 prefix: str = "zipf"):
        if n_clients < 1:
            raise ValueError(f"need at least one client, got {n_clients}")
        self.n_clients = n_clients
        self.skew = skew
        self.prefix = prefix
        self._cdf: list[float] = []
        acc = 0.0
        for rank in range(1, n_clients + 1):
            acc += 1.0 / (rank ** skew)
            self._cdf.append(acc)
        self._total = acc

    def sample(self, rng: random.Random) -> str:
        """One client id, hot ranks proportionally more often."""
        x = rng.random() * self._total
        idx = bisect.bisect_left(self._cdf, x)
        return f"{self.prefix}{min(idx, self.n_clients - 1)}"

    def hot_fraction(self, top: int = 1) -> float:
        """The traffic share of the ``top`` hottest clients (row metadata
        for bench output — how skewed was this run, exactly)."""
        return self._cdf[min(top, self.n_clients) - 1] / self._total


class OpenLoopPump:
    """Poisson arrival schedule driven by an external clock.

    ``due(now)`` returns how many arrivals have their (pre-drawn,
    exponentially-gapped) arrival times at or before ``now``, advancing
    the schedule — the caller's loop decides what an arrival does.  The
    pump never skips backlog: if the caller's loop stalls, every missed
    arrival is returned on the next call, which is precisely the
    open-loop property (the world does not pause because the server
    did)."""

    def __init__(self, rate: float, rng: random.Random, start: float = 0.0):
        if rate <= 0:
            raise ValueError(f"arrival rate must be positive, got {rate}")
        self.rate = float(rate)
        self._rng = rng
        self._next = start + rng.expovariate(self.rate)

    def set_rate(self, rate: float, now: float) -> None:
        """Change the offered load mid-run (saturation sweeps reuse one
        pump); the next gap is drawn at the new rate from ``now``."""
        if rate <= 0:
            raise ValueError(f"arrival rate must be positive, got {rate}")
        self.rate = float(rate)
        self._next = now + self._rng.expovariate(self.rate)

    def due(self, now: float) -> int:
        n = 0
        while self._next <= now:
            n += 1
            self._next += self._rng.expovariate(self.rate)
        return n


@dataclass
class OpenLoopStats:
    """What one open-loop span observed at the front door."""

    offered: int = 0          # arrivals the pump generated
    acked: int = 0            # submits accepted into a pool
    shed_admission: int = 0   # AdmissionRejected fast-fails
    shed_timeout: int = 0     # SubmitTimeoutError space-wait sheds
    failed: int = 0           # any other submit error (no leader, closed)
    retry_after_hints: list = field(default_factory=list)  # sampled (<=64)
    peak_occupancy: int = 0   # max combined size+waiters seen at the door
    peak_fill: float = 0.0    # max combined fill fraction seen
    elapsed: float = 0.0      # span length on the driving clock

    @property
    def shed(self) -> int:
        return self.shed_admission + self.shed_timeout

    def block(self) -> dict:
        """JSON-able row fragment."""
        return {
            "offered": self.offered,
            "acked": self.acked,
            "shed_admission": self.shed_admission,
            "shed_timeout": self.shed_timeout,
            "failed": self.failed,
            "shed_rate": round(self.shed / self.offered, 4)
            if self.offered else 0.0,
            "peak_occupancy": self.peak_occupancy,
            "peak_fill": round(self.peak_fill, 3),
            "retry_after_p50": round(
                sorted(self.retry_after_hints)[len(self.retry_after_hints) // 2],
                4,
            ) if self.retry_after_hints else None,
        }


async def run_open_loop(
    cluster,
    *,
    rate: float,
    duration: float,
    clients: Optional[ZipfClients] = None,
    seed: int = 0,
    step: float = 0.02,
    wall: bool = False,
    request_prefix: str = "ol",
    drain: float = 0.0,
    on_tick: Optional[Callable[[float], None]] = None,
) -> OpenLoopStats:
    """Pump a ShardedCluster's front door open-loop for ``duration``.

    One background task per arrival (clients do not wait for each other);
    accepted submits are counted as acks, ``AdmissionRejected`` /
    ``SubmitTimeoutError`` as sheds (with the rejection's retry-after
    hint sampled), anything else as a failure.  The loop polls the
    committed stream each tick so the set's latency tracker resolves
    stamps as commits land, and samples the combined occupancy for the
    bounded-growth assertion the tier-1 gate makes.

    ``wall=False`` (tests): the loop advances the cluster's logical
    scheduler by ``step`` per iteration — seconds of offered load cost
    milliseconds of real time.  ``wall=True`` (benches): the loop sleeps
    ``step`` real seconds and reads the scheduler's clock, which a
    WallClockDriver must be advancing.

    ``drain``: extra span after the last arrival during which the loop
    keeps polling (and timing) so in-flight requests commit; sheds during
    the drain are possible (parked submitters timing out) and counted.
    ``on_tick(now)`` is the caller's per-iteration hook (phase switches,
    chaos injection)."""
    rng = random.Random(seed)
    zipf = clients or ZipfClients()
    now_fn = cluster.scheduler.now
    pump = OpenLoopPump(rate, rng, start=now_fn())
    stats = OpenLoopStats()
    # a done-callback counter instead of a retained task list: scanning
    # O(offered) tasks every 5ms tick would run ON the event loop whose
    # tail latency this harness exists to measure
    pending = {"n": 0}
    arrivals = 0

    async def _submit(cid: str, rid: str) -> None:
        try:
            await cluster.submit(cid, rid)
            stats.acked += 1
        except AdmissionRejected as e:
            stats.shed_admission += 1
            if len(stats.retry_after_hints) < 64:
                stats.retry_after_hints.append(e.retry_after)
        except SubmitTimeoutError:
            stats.shed_timeout += 1
        except Exception:  # noqa: BLE001 — shed accounting must not die
            stats.failed += 1

    # Eager-submit fast path (round 18): in the healthy regime a routed
    # submit never suspends (no space wait, leader is local), so driving
    # the coroutine ONE step completes it inline — skipping the Task +
    # call_soon + done-callback machinery asyncio charges per spawned
    # submit, a measurable slice of the single-core loop budget at the
    # knee.  A submit that actually PARKS (yields a future it is waiting
    # on) is promoted to a real background task that re-yields that same
    # future and then drives the rest of the coroutine to completion —
    # open-loop semantics are unchanged, the parked client still never
    # blocks the pump.  (_submit swallows all exceptions, so the only
    # way out of send() on a completed submit is StopIteration.)
    @types.coroutine
    def _repark(step):
        yield step

    async def _drive(coro, step) -> None:
        try:
            while True:
                await _repark(step)
                try:
                    step = coro.send(None)
                except StopIteration:
                    return
        finally:
            coro.close()

    t0 = now_fn()
    end = t0 + duration
    drain_end = end + drain
    while True:
        now = now_fn()
        if now < end:
            for _ in range(pump.due(now)):
                cid = zipf.sample(rng)
                rid = f"{request_prefix}-{arrivals}"
                arrivals += 1
                coro = _submit(cid, rid)
                try:
                    parked_on = coro.send(None)
                except StopIteration:
                    continue  # completed inline (the common case)
                pending["n"] += 1
                task = create_logged_task(
                    _drive(coro, parked_on), name=f"openloop-{rid}"
                )
                task.add_done_callback(
                    lambda _t: pending.__setitem__("n", pending["n"] - 1)
                )
        cluster.poll()
        occ = cluster.set.occupancy()
        pressure = occ["total_size"] + occ["total_waiters"]
        if pressure > stats.peak_occupancy:
            stats.peak_occupancy = pressure
        if occ["fill"] > stats.peak_fill:
            stats.peak_fill = occ["fill"]
        if on_tick is not None:
            on_tick(now)
        if now >= drain_end and pending["n"] == 0:
            break
        if wall:
            await asyncio.sleep(step)
        else:
            await asyncio.sleep(0)
            cluster.scheduler.advance_by(step)
            await asyncio.sleep(0.001)
    stats.offered = arrivals
    stats.elapsed = now_fn() - t0
    cluster.poll()
    return stats
