"""The coalescer's occupancy-aware flush hold on the port, held against
the JAX package.

First the differential cases: the same numpy-seeded inputs through both
packages' ``TagRateTracker`` (notes and ``any_imminent`` queries, through
the eviction sweep), ``AsyncBatchCoalescer._rung_exact``,
``configure_hold``'s precedence and ``FlushHoldStats.snapshot``, with
identical answers.  Then the reference's own cases of
``tests/test_flush_gating.py``, all eleven, compiled against the port by
:mod:`torch_reference`: the seven that build an 8-device toy
``MeshVerifyEngine`` run on 8 virtual CPU devices
(``torchenv.force_cpu``), set for this module and put back after it.
Last, six of those mesh cases again on a single-device CPU engine with the
same pad ladder (:class:`PaddedToyEngine`: one call of the toy scheme's
torch kernel per rung), so the hold's behaviour is pinned without the
mesh too.
"""

import asyncio
import time

import numpy as np
import pytest

from smartbft_tpu.crypto import provider as j_provider
from smartbft_tpu_torch.crypto import provider as t_provider
from smartbft_tpu_torch.crypto.provider import (
    AsyncBatchCoalescer,
    HostVerifyEngine,
    VerifyFaultPolicy,
    VerifyStats,
)
from smartbft_tpu_torch.metrics import InMemoryProvider, TPUCryptoMetrics
from smartbft_tpu_torch.testing import toy_scheme
from smartbft_tpu_torch.testing.engine_faults import FaultyEngine
from torch_reference import check_matrices, reference_tests, virtual_devices

PACKAGES = (j_provider, t_provider)


# ------------------------------------------------------------ differential

def _tracker_script(seed: int):
    """A seeded stream of notes and queries over a few dozen live tags,
    then a churn of fresh tags far past EVICT_SWEEP_AT, long after the
    first ones went silent, so the sweep runs."""
    rng = np.random.default_rng(seed)
    ops, now = [], 100.0
    for _ in range(600):
        now += float(rng.choice([1e-4, 5e-4, 0.003, 0.01, 0.05, 0.2]))
        if rng.random() < 0.7:
            tag = int(rng.integers(0, 24)) if rng.random() < 0.9 else None
            ops.append(("note", tag, now))
        else:
            ops.append(("ask", now + float(rng.random()) * 0.3,
                        float(rng.random()) * 0.2,
                        None if rng.random() < 0.2
                        else float(rng.random()) * 0.5))
    now += 2 * t_provider.TagRateTracker.EVICT_AFTER
    for k in range(3 * t_provider.TagRateTracker.EVICT_SWEEP_AT):
        now += float(rng.choice([0.001, 0.01, 0.5]))
        ops.append(("note", f"churn-{k % 150}", now))
        if k % 7 == 0:
            ops.append(("ask", now, 0.05, 0.1))
    return ops


def _run_tracker(mod, ops):
    tr = mod.TagRateTracker(default_gap=0.002, slack=4.0)
    answers, sizes = [], []
    for op in ops:
        if op[0] == "note":
            tr.note(op[1], op[2])
            sizes.append(len(tr._last))
        else:
            answers.append(tr.any_imminent(op[1], op[2], op[3]))
    return answers, sizes, dict(tr._last), dict(tr._ewma)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tag_rate_tracker_matches_the_jax_package(seed):
    ops = _tracker_script(seed)
    want = _run_tracker(j_provider, ops)
    assert _run_tracker(t_provider, ops) == want
    answers, sizes = want[0], want[1]
    assert True in answers and False in answers
    # the sweep ran: the tracker reached EVICT_SWEEP_AT tags, and a new
    # tag then left it smaller than before (the silent ones evicted)
    assert max(sizes) >= t_provider.TagRateTracker.EVICT_SWEEP_AT
    assert any(b < a for a, b in zip(sizes, sizes[1:]))
    assert t_provider.TagRateTracker.EVICT_AFTER \
        == j_provider.TagRateTracker.EVICT_AFTER


class _Ladder:
    """An engine that is only its pad ladder (``_rung_exact`` reads
    nothing else)."""

    def __init__(self, pad_sizes):
        self.pad_sizes = pad_sizes


@pytest.mark.parametrize("seed", [3, 4])
def test_rung_exact_matches_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    ladder = (8, 32, 128, 512, 2048, 4096, 8192, 16384)
    sizes = sorted(set(rng.integers(0, 20000, 400).tolist()) | set(ladder))
    for pad in (ladder, (96,), (), None):
        got = {}
        for mod in PACKAGES:
            co = mod.AsyncBatchCoalescer(_Ladder(pad))
            got[mod] = [co._rung_exact(n) for n in sizes]
        assert got[t_provider] == got[j_provider]
    assert sum(got[t_provider]) == 0  # no ladder: never exact


@pytest.mark.parametrize("seed", [5, 6])
def test_configure_hold_precedence_matches_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    calls = [(None if rng.random() < 0.2 else float(rng.random()) - 0.1,
              bool(rng.random() < 0.15)) for _ in range(60)]
    for start in (None, 0.0, 0.5):
        trace = {}
        for mod in PACKAGES:
            co = mod.AsyncBatchCoalescer(_Ladder((8,)), hold=start)
            seen = [co.hold]
            for hold, explicit in calls:
                co.configure_hold(hold, explicit=explicit)
                seen.append((co.hold, co._hold_explicit))
            trace[mod] = seen
        assert trace[t_provider] == trace[j_provider]


@pytest.mark.parametrize("seed", [7, 8])
def test_flush_hold_stats_snapshot_matches_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        fields = dict(waves_held=int(rng.integers(0, 1000)),
                      held_ms=float(rng.random() * 1e4),
                      depth_gain_items=int(rng.integers(0, 10 ** 6)),
                      deadline_expired=int(rng.integers(0, 50)),
                      breaker_bypass=int(rng.integers(0, 50)))
        hold = float(rng.random())
        want = j_provider.FlushHoldStats(**fields).snapshot(hold)
        assert t_provider.FlushHoldStats(**fields).snapshot(hold) == want
        assert list(want) == ["hold_s", "waves_held", "held_ms",
                              "depth_gain_items", "deadline_expired",
                              "breaker_bypass"]


# ------------------------------------------------- the reference's own cases

_virtual_devices = virtual_devices(8)

CASES = {"test_flush_gating.py": 11}
LEFT_OUT: dict = {}

globals().update(reference_tests("test_flush_gating.py"))


def test_reference_cases_are_whole_and_ported():
    """All eleven cases run, the seven that build ``MeshVerifyEngine``
    (``warm_mesh``) on the port's mesh over 8 virtual CPU devices."""
    check_matrices(CASES, LEFT_OUT)


# ---------------------------------- the mesh cases on a single-device engine

class PaddedToyEngine:
    """A single-device CPU engine with a pad ladder: each chunk pads to
    the next rung of ``pad_sizes`` and runs as ONE call of the toy
    scheme's torch kernel, recorded in :class:`VerifyStats` (launches,
    fill) as the port's device engine records its launches."""

    def __init__(self, pad_sizes=(96,)):
        self.pad_sizes = tuple(sorted(pad_sizes))
        self.scheme = toy_scheme
        self.stats = VerifyStats()

    def verify(self, items) -> list:
        out = []
        top = self.pad_sizes[-1]
        for i in range(0, len(items), top):
            chunk = list(items[i:i + top])
            size = next(s for s in self.pad_sizes if len(chunk) <= s)
            t0 = time.perf_counter()
            padded = chunk + [chunk[0]] * (size - len(chunk))
            mask = toy_scheme.verify_kernel(*toy_scheme.verify_inputs(padded))
            self.stats.record(len(chunk), size, time.perf_counter() - t0)
            out.extend(bool(v) for v in mask[:len(chunk)].tolist())
        return out


def toy_items(n: int, seed: bytes = b"fg", forge_every: int = 5):
    sk, pub = toy_scheme.keygen(seed)
    items, expect = [], []
    for i in range(n):
        msg = seed + b"-%d" % i
        sig = toy_scheme.sign_raw(sk, msg)
        ok = i % forge_every != forge_every - 1
        if not ok:
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        items.append(toy_scheme.make_item(msg, sig, pub))
        expect.append(ok)
    return items, expect


def tight_policy(**kw) -> VerifyFaultPolicy:
    base = dict(launch_timeout=0.08, launch_retries=2, backoff_base=0.01,
                backoff_max=0.04, backoff_jitter=0.0, breaker_threshold=3,
                probe_interval=0.02, probe_backoff_max=0.05)
    base.update(kw)
    return VerifyFaultPolicy(**base)


def warm_engine(pad_sizes=(96,)) -> PaddedToyEngine:
    eng = PaddedToyEngine(pad_sizes)
    for size in eng.pad_sizes:
        eng.verify(toy_items(size)[0])
    eng.stats = VerifyStats()
    return eng


def test_hold_decisions_counted_in_metrics():
    """``test_flush_gating.py::test_hold_decisions_counted_in_metrics``:
    a held wave that a second burst joins feeds ``count_waves_held`` and
    ``count_hold_depth_gain``."""
    mem = InMemoryProvider()

    async def run():
        eng = warm_engine(pad_sizes=(96,))
        co = AsyncBatchCoalescer(eng, window=0.01, hold=0.3,
                                 metrics=TPUCryptoMetrics(mem))

        async def burst(tag, seed, delay):
            await asyncio.sleep(delay)
            items, expect = toy_items(20, seed)
            assert await co.submit(items, tag=tag) == expect

        await asyncio.gather(burst(0, b"ma", 0.0), burst(1, b"mb", 0.04))

    asyncio.run(run())
    assert mem.counters["consensus.tpu.count_waves_held"] >= 1
    assert mem.counters["consensus.tpu.count_hold_depth_gain"] >= 20


def test_rung_exact_wave_flushes_without_waiting_out_the_hold():
    """A wave that lands exactly on a rung flushes far inside a 5 s hold,
    as one launch at 100 % fill."""

    async def run():
        eng = warm_engine(pad_sizes=(32, 96))
        co = AsyncBatchCoalescer(eng, window=0.005, hold=5.0)
        items, expect = toy_items(32, b"rung")
        t0 = time.monotonic()
        assert await co.submit(items, tag=0) == expect
        return time.monotonic() - t0, eng.stats

    elapsed, stats = asyncio.run(run())
    assert elapsed < 1.0, elapsed
    assert stats.launches == 1 and stats.batch_fill_pct == 100.0


def test_hold_deadline_bounds_latency():
    """A tag kept fresh and cold for the whole budget: only the hard
    deadline ends the hold, and its expiry is counted."""

    async def run():
        eng = warm_engine(pad_sizes=(96,))
        co = AsyncBatchCoalescer(eng, window=0.005, hold=0.06)
        items, _ = toy_items(10, b"solo")
        co._pending = list(items)
        co._tag_rates._last[0] = time.monotonic()

        async def keep_fresh():
            while True:
                co._tag_rates._last[0] = time.monotonic()
                await asyncio.sleep(0.002)

        pump = asyncio.ensure_future(keep_fresh())
        try:
            t0 = time.monotonic()
            await co._maybe_hold()
            return time.monotonic() - t0, co
        finally:
            pump.cancel()

    elapsed, co = asyncio.run(run())
    assert 0.06 <= elapsed < 1.0, elapsed
    snap = co.mesh_snapshot()["hold"]
    assert snap["deadline_expired"] == 1
    assert snap["waves_held"] == 1
    assert snap["held_ms"] >= 60.0


def test_breaker_open_bypasses_hold_host_fallback_does_not_wait():
    """With the breaker open, waves go to the caller's host fallback and
    skip the hold outright (counted), never running its 3 s budget."""

    async def run():
        eng = FaultyEngine(warm_engine(pad_sizes=(96,)))
        co = AsyncBatchCoalescer(
            eng, window=0.005, hold=3.0,
            policy=tight_policy(breaker_threshold=1, launch_retries=0,
                                probe_interval=30.0),
            fallback_engine=HostVerifyEngine(scheme=toy_scheme),
        )
        items, expect = toy_items(10, b"brk")
        eng.fail_next(5)
        assert await co.submit(items, tag=0) == expect
        assert co.breaker_open
        held_before = co.hold_stats.held_ms
        t0 = time.monotonic()
        assert await co.submit(items, tag=0) == expect
        return time.monotonic() - t0, co, held_before

    elapsed, co, held_before = asyncio.run(run())
    assert elapsed < 1.0, elapsed
    assert co.hold_stats.breaker_bypass >= 1
    assert co.hold_stats.held_ms == held_before
    assert co.fault_stats.host_fallback_batches >= 2


def test_launch_deadline_fires_on_a_wave_that_was_held():
    """A wave the gate deepened is still under the launch deadline: the
    hung launch is abandoned, retried, the breaker trips and the caller's
    host fallback serves both tags' items of the one held wave."""

    async def run():
        eng = FaultyEngine(warm_engine(pad_sizes=(96,)))
        co = AsyncBatchCoalescer(
            eng, window=0.01, hold=0.12, policy=tight_policy(),
            fallback_engine=HostVerifyEngine(scheme=toy_scheme),
        )
        eng.hang()
        items_a, expect_a = toy_items(12, b"ha")
        items_b, expect_b = toy_items(12, b"hb")

        async def late_burst():
            await asyncio.sleep(0.04)
            return await co.submit(items_b, tag=1)

        ra, rb = await asyncio.gather(co.submit(items_a, tag=0),
                                      late_burst())
        assert ra == expect_a and rb == expect_b
        eng.heal()
        return co, eng

    co, eng = asyncio.run(run())
    try:
        assert co.hold_stats.waves_held >= 1
        assert co.fault_stats.launch_timeouts >= 1
        assert co.fault_stats.breaker_opens >= 1
        assert co.fault_stats.host_fallback_batches >= 1
        assert co.shard_stats.mixed_waves >= 1
    finally:
        eng.heal()


def test_held_wave_survives_mid_hold_device_down():
    """The device goes down while a wave is held: the launch fails,
    retries, the breaker moves the wave to the caller's host fallback
    with exact verdicts; once the device is back the canary closes the
    breaker and traffic lands on the device again."""

    async def run():
        dev = warm_engine(pad_sizes=(96,))
        eng = FaultyEngine(dev)
        co = AsyncBatchCoalescer(
            eng, window=0.01, hold=0.15, policy=tight_policy(),
            fallback_engine=HostVerifyEngine(scheme=toy_scheme),
        )
        items_a, expect_a = toy_items(12, b"da")
        items_b, expect_b = toy_items(12, b"db")

        async def chaos_mid_hold():
            await asyncio.sleep(0.03)
            eng.lose_device(0)
            await asyncio.sleep(0.02)
            return await co.submit(items_b, tag=1)

        ra, rb = await asyncio.gather(co.submit(items_a, tag=0),
                                      chaos_mid_hold())
        assert ra == expect_a and rb == expect_b
        assert co.fault_stats.launch_failures >= 1
        assert co.fault_stats.host_fallback_batches >= 1
        launches_down = dev.stats.launches

        eng.restore_device(0)
        deadline = time.monotonic() + 10.0
        while co.breaker_open and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
        assert not co.breaker_open
        items_c, expect_c = toy_items(10, b"dc")
        assert await co.submit(items_c, tag=0) == expect_c
        assert dev.stats.launches > launches_down
        return co

    co = asyncio.run(run())
    assert co.hold_stats.waves_held >= 1
    assert co.fault_stats.breaker_opens >= 1
    assert co.fault_stats.breaker_closes >= 1
