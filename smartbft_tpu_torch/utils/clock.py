"""Tick-driven logical time: scheduler + tickers, injectable for tests.

The reference mixes three timing mechanisms: ``time.AfterFunc`` request
timers (upstream SmartBFT internal/bft/requestpool.go:493-567), external tick
channels driving HeartbeatMonitor/ViewChanger
(heartbeatmonitor.go:119-137, viewchanger.go:210-229), and a dormant
heap-based task scheduler (sched.go:60-139) that sched_test.go exercises but
nothing wires in.  Here that design is unified: *all* timing flows through
one heap-based :class:`Scheduler` driven by an external time source — the
dormant component made load-bearing.  Production drives it from an asyncio
ticker task; tests advance it manually for full determinism (the "fake
clock" pattern of test_app.go:479-486).
"""

from __future__ import annotations

import asyncio
import heapq
import itertools
import time
from typing import Awaitable, Callable, Optional

from .tasks import create_logged_task


class TaskHandle:
    """Cancelable handle for a scheduled callback (sched.go's Task)."""

    __slots__ = ("deadline", "_seq", "_callback", "_cancelled")

    def __init__(self, deadline: float, seq: int, callback: Callable[[], None]):
        self.deadline = deadline
        self._seq = seq
        self._callback = callback
        self._cancelled = False

    def cancel(self) -> None:
        self._cancelled = True

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    def __lt__(self, other: "TaskHandle") -> bool:
        return (self.deadline, self._seq) < (other.deadline, other._seq)


class Scheduler:
    """Deadline-ordered callback heap driven by :meth:`advance_to`.

    Not thread-safe by design: owned by the consensus event loop, like every
    other core component (single-owner discipline, SURVEY §2.4).
    """

    def __init__(self, start_time: float = 0.0):
        self._heap: list[TaskHandle] = []
        self._now = start_time
        self._counter = itertools.count()

    def now(self) -> float:
        return self._now

    def schedule(self, delay: float, callback: Callable[[], None]) -> TaskHandle:
        handle = TaskHandle(self._now + delay, next(self._counter), callback)
        heapq.heappush(self._heap, handle)
        return handle

    def advance_to(self, t: float) -> int:
        """Advance logical time, firing every due, uncancelled callback.

        Returns the number of callbacks fired.  Callbacks may schedule new
        tasks; a task scheduled with zero delay during the same advance fires
        within it (deadline <= t).
        """
        if t < self._now:
            t = self._now
        fired = 0
        # advance logical time task-by-task so callbacks that reschedule
        # (tickers) observe the correct "now" — a single large jump must
        # fire a periodic task once per period, not once per jump
        while self._heap and self._heap[0].deadline <= t:
            task = heapq.heappop(self._heap)
            if task.cancelled:
                continue
            if task.deadline > self._now:
                self._now = task.deadline
            fired += 1
            task._callback()
        self._now = t
        return fired

    def advance_by(self, dt: float) -> int:
        return self.advance_to(self._now + dt)

    async def sleep(self, delay: float) -> None:
        """``asyncio.sleep`` on this clock: returns once an advance has
        reached ``delay`` seconds from now."""
        fut = asyncio.get_running_loop().create_future()
        self.schedule(delay, lambda: fut.done() or fut.set_result(None))
        await fut

    def pending(self) -> int:
        return sum(1 for t in self._heap if not t.cancelled)


class Ticker:
    """Periodic callback built on :class:`Scheduler` (reference tick channels).

    ``interval_fn`` (optional) makes the cadence ADAPTIVE: each re-arm asks
    it for the next interval, falling back to the static ``interval`` when
    it is absent, fails, or returns a non-positive value.  The heartbeat
    monitor uses this to derive its check cadence from the effective
    (possibly RTT-shrunk) complain timer — a fixed cadence lets detection
    overshoot a shrunk timer by multiples."""

    def __init__(self, scheduler: Scheduler, interval: float,
                 callback: Callable[[], None],
                 interval_fn: Optional[Callable[[], float]] = None):
        if interval <= 0:
            raise ValueError(f"ticker interval must be positive, got {interval}")
        self._scheduler = scheduler
        self._interval = interval
        self._interval_fn = interval_fn
        self._callback = callback
        self._stopped = False
        self._handle: Optional[TaskHandle] = None
        self._arm()

    def _arm(self) -> None:
        interval = self._interval
        if self._interval_fn is not None:
            try:
                derived = self._interval_fn()
            except Exception:  # noqa: BLE001 — cadence derivation is advisory
                derived = None
            if derived is not None and derived > 0:
                interval = derived
        self._handle = self._scheduler.schedule(interval, self._fire)

    def _fire(self) -> None:
        if self._stopped:
            return
        self._arm()  # rearm first so the callback can stop() us
        self._callback()

    def stop(self) -> None:
        self._stopped = True
        if self._handle is not None:
            self._handle.cancel()


class WallClockDriver:
    """Asyncio task that advances a Scheduler with wall-clock time.

    ``tick_interval`` bounds timer-firing latency; protocol timeouts are
    hundreds of ms and up, so the default 10ms tick is far below protocol
    resolution.
    """

    def __init__(self, scheduler: Scheduler, tick_interval: float = 0.01):
        self._scheduler = scheduler
        self._tick_interval = tick_interval
        self._task: Optional[asyncio.Task] = None
        self._stop: Optional[asyncio.Event] = None  # created in start()

    async def _run(self) -> None:
        base_wall = time.monotonic()
        base_logical = self._scheduler.now()
        while not self._stop.is_set():
            try:
                await asyncio.wait_for(self._stop.wait(), timeout=self._tick_interval)
            except asyncio.TimeoutError:
                pass
            self._scheduler.advance_to(base_logical + (time.monotonic() - base_wall))

    def start(self) -> None:
        self._stop = asyncio.Event()
        self._task = create_logged_task(self._run(), name="wallclock-driver")

    async def stop(self) -> None:
        self._stop.set()
        if self._task is not None:
            await self._task
            self._task = None
