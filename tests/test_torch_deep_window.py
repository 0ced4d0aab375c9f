"""Deep-window launch amortization on the port, without the wall clock.

``tests/test_message_plane.py::test_launches_much_fewer_than_decisions_
deep_windows`` commits 16 decisions at pipeline depth 16 and 32 through
one shared coalescer and holds launches <= decisions // 4.  Its
coalescer waits its 0.02 s window on the wall clock and verifies on a
worker thread while the protocol runs on the logical clock, so the count
depends on how the host's speed lines up with the logical ticks: alone it
launches twice, and on a loaded host a stall longer than the logical
request timers sets off forwarding and complaints, which add waves (once
43 launches for 16 decisions, on both packages).  The port's copy of that
case is left out of collection (``UNSTEADY`` in
``tests/test_torch_ref_plane.py``).

Here the same deployment runs with both clocks pinned: the coalescer's
window waits on the logical scheduler (``AsyncBatchCoalescer(sleep=
scheduler.sleep)``), and the driver advances the logical clock only when
no task is ready to run and no launch is in flight.  The count is then a
function of the protocol alone: one launch for the 16 decisions on every
run, and the same when each engine call is made 20 ms slower."""

import asyncio
import dataclasses
import os
import time

import pytest

from smartbft_tpu_torch.crypto.provider import (
    AsyncBatchCoalescer,
    HostVerifyEngine,
    Keyring,
    P256CryptoProvider,
)
from smartbft_tpu_torch.testing.app import App, SharedLedgers, fast_config
from smartbft_tpu_torch.testing.network import Network
from smartbft_tpu_torch.utils.clock import Scheduler
from torch_reference import case_time_limit

time_limit = case_time_limit(60)

#: the reference case's burst: 16 decisions at batch 2
REQUESTS = 32
#: the burst with both clocks pinned, by pipeline depth: one launch of
#: every decision's votes, two logical ticks, no view change
PINNED = {depth: {"decisions": 16, "launches": 1, "waves": [192],
                  "ticks": 2, "views": [0, 0, 0, 0]} for depth in (16, 32)}


class _SlowEngine(HostVerifyEngine):
    """The host engine with ``delay`` seconds of wall time a call."""

    def __init__(self, delay: float):
        super().__init__()
        self.delay = delay

    def verify(self, items):
        time.sleep(self.delay)
        return super().verify(items)


async def _settle(coalescer) -> None:
    """Return once no task is ready to run and the coalescer has no launch
    in flight (a launch runs on a worker thread, so it is waited for)."""
    loop = asyncio.get_running_loop()
    while True:
        await asyncio.sleep(0)
        if coalescer._launch_inflight:
            await asyncio.sleep(0.001)
        elif not loop._ready:
            return


async def _burst(root, depth: int, engine) -> dict:
    """The reference case's deployment and burst, both clocks pinned."""
    scheduler = Scheduler()
    network = Network(seed=17)
    shared = SharedLedgers()
    node_ids = [1, 2, 3, 4]
    rings = Keyring.generate(node_ids, seed=b"kgate")
    coalescer = AsyncBatchCoalescer(engine, window=0.02, max_batch=4096,
                                    dedupe=True, sleep=scheduler.sleep)
    waves = []
    launch = coalescer._launch_wave

    async def counted(pending):
        waves.append(len(pending))
        return await launch(pending)

    coalescer._launch_wave = counted

    def cfg(i):
        return dataclasses.replace(
            fast_config(i), leader_rotation=False, decisions_per_leader=0,
            pipeline_depth=depth, request_batch_max_count=2,
            request_batch_max_interval=0.02)

    apps = [App(i, network, shared, scheduler,
                wal_dir=os.path.join(root, f"wal-{depth}-{i}"), config=cfg(i),
                crypto=P256CryptoProvider(rings[i], coalescer=coalescer))
            for i in node_ids]
    for a in apps:
        await a.start()

    def committed(a):
        return sum(len(a.requests_from_proposal(d.proposal))
                   for d in a.ledger())

    try:
        for k in range(REQUESTS):
            await apps[0].submit("c", f"r{k}")
        ticks = 0
        while not all(committed(a) >= REQUESTS for a in apps):
            assert ticks < 4800, "the burst did not commit in 240 logical s"
            await _settle(coalescer)
            scheduler.advance_by(0.05)
            ticks += 1
        views = [a.consensus.controller.curr_view_number for a in apps]
    finally:
        for a in apps:
            await a.stop()
    return {"decisions": len(apps[0].ledger()),
            "launches": engine.stats.launches, "waves": waves,
            "ticks": ticks, "views": views}


@pytest.mark.parametrize("depth", [16, 32])
def test_launches_much_fewer_than_decisions_deep_windows(tmp_path, depth):
    """The reference case's bound, launches <= decisions // 4, with both
    clocks pinned, and the pinned run: one coalesced wave of the 16
    decisions' votes, two ticks, no view change."""
    out = asyncio.run(_burst(str(tmp_path), depth, HostVerifyEngine()))
    assert out["decisions"] >= 8, out
    assert out["launches"] <= max(1, out["decisions"] // 4), out
    assert out == PINNED[depth]


@pytest.mark.parametrize("depth", [16, 32])
def test_the_count_does_not_follow_the_host(tmp_path, depth):
    """An engine 20 ms slower a call (a loaded host) gives the same
    decisions, waves and ticks."""
    out = asyncio.run(_burst(str(tmp_path), depth, _SlowEngine(0.02)))
    assert out == PINNED[depth]
