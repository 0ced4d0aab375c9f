"""The reference's 1D mesh-plane cases against the port:
``tests/test_mesh_plane.py``, compiled against ``smartbft_tpu_torch`` by
:mod:`torch_reference`, on 8 virtual CPU devices (``torchenv.force_cpu``),
under an exact count guard.

Left out, each with its reason (and a port counterpart below where the
case means something in the port):

* the four cases that build ``JaxVerifyEngine`` as the single-device
  engine: verdict parity, strided placement, graduation, graduation in a
  fault wrapper.  The counterparts take ``TorchVerifyEngine(device="cpu")``
  for P-256 and a one-device plane for the toy scheme.  The graduation
  case also asserts the host fallback the JAX package installs at
  graduation (``test_mesh_plane.py:212``); the port installs none, by
  design, and its counterpart pins that.
* ``test_one_lost_mesh_device_degrades_all_shards_then_recovers``: its
  shards commit through the outage on that installed host fallback; the
  counterpart gives the cluster's coalescer the same fallback explicitly,
  as a caller of the port must.
* ``test_mesh_engine_pads_and_partitions_batch_axis``: it imports jax and
  reads a jax array's ``addressable_shards``; its counterpart reads the
  port's per-device tiles.
* ``test_resolve_shard_map_is_memoized``: the memo tracks a jax API drift
  the port does not have (its quorum step is plain torch), so it has no
  counterpart.
* ``test_compile_cache_dir_env_override``: ``utils.jaxenv``'s compile
  cache; its counterpart is ``utils.torchenv.build_dir``'s override.
* ``test_assemble_mesh_row_schema_pinned``: it loads ``bench.py``, whose
  mesh row belongs to the port's benchmark, not yet written.
"""

import asyncio
import dataclasses
import time

import numpy as np
import pytest
import torch

from smartbft_tpu_torch.crypto import p256
from smartbft_tpu_torch.crypto.provider import (
    AsyncBatchCoalescer,
    HostVerifyEngine,
    Keyring,
    P256CryptoProvider,
    TorchVerifyEngine,
)
from smartbft_tpu_torch.metrics import InMemoryProvider, TPUCryptoMetrics
from smartbft_tpu_torch.parallel import (
    MeshVerifyEngine,
    ShardedVerifyEngine,
    build_mesh,
)
from smartbft_tpu_torch.testing import toy_scheme
from smartbft_tpu_torch.testing.app import wait_for
from smartbft_tpu_torch.testing.engine_faults import FaultyEngine
from smartbft_tpu_torch.testing.sharded import ShardedCluster, sharded_config
from smartbft_tpu_torch.utils import torchenv
from torch_reference import check_matrices, reference_tests, virtual_devices

_virtual_devices = virtual_devices(8)

LEAVE_OUT = {
    "test_one_lost_mesh_device_degrades_all_shards_then_recovers":
        "the shards commit through the outage on the host fallback the "
        "JAX package installs at graduation; the port installs none",
    "test_mesh_engine_pads_and_partitions_batch_axis":
        "imports jax and reads a jax array's addressable_shards",
    "test_resolve_shard_map_is_memoized":
        "the shard_map memo tracks a jax API drift the port does not have",
}
CASES = {"test_mesh_plane.py": 9}
LEFT_OUT = {"test_mesh_plane.py": sorted([
    "test_one_lost_mesh_device_degrades_all_shards_then_recovers",
    "test_assemble_mesh_row_schema_pinned",
    "test_compile_cache_dir_env_override",
    "test_configure_verify_mesh_graduates_idempotently_and_downgrades",
    "test_configure_verify_mesh_respects_fault_wrapped_mesh",
    "test_mesh_engine_pads_and_partitions_batch_axis",
    "test_mesh_verdicts_match_single_device_bitwise",
    "test_resolve_shard_map_is_memoized",
    "test_strided_placement_spreads_pad_slots_evenly"])}

globals().update(reference_tests("test_mesh_plane.py", leave_out=LEAVE_OUT))


def test_reference_cases_are_whole_and_ported():
    check_matrices(CASES, LEFT_OUT, leave_out=LEAVE_OUT)


def toy_items(n: int, *, key_seeds=(b"ta", b"tb"), forge_every: int = 4):
    keys = [toy_scheme.keygen(s) for s in key_seeds]
    items, expect = [], []
    for i in range(n):
        sk, pub = keys[i % len(keys)]
        msg = b"toy-%d" % i
        sig = toy_scheme.sign_raw(sk, msg)
        ok = i % forge_every != forge_every - 1
        if not ok:
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        items.append(toy_scheme.make_item(msg, sig, pub))
        expect.append(ok)
    return items, expect


def one_device(pad_sizes, scheme=toy_scheme):
    """A single-device plane of the toy scheme, which has no
    ``TorchVerifyEngine`` route: the sharded engine on a one-device mesh."""
    return ShardedVerifyEngine(mesh=build_mesh((1,)), pad_sizes=pad_sizes,
                               scheme=scheme)


def test_mesh_engine_pads_and_places_one_tile_a_device():
    """``test_mesh_engine_pads_and_partitions_batch_axis``: the batch axis
    splits into 8 equal tiles, one on each device."""
    eng = MeshVerifyEngine(devices=8, pad_sizes=(16,), scheme=p256)
    assert eng.devices == 8
    assert eng.mesh.axis_names == ("batch",)
    assert all(s % 8 == 0 for s in eng.pad_sizes)
    placed = eng._place(np.zeros((64, 16), np.uint32))
    assert len(placed) == 8
    assert [tuple(t.shape) for t in placed] == [(8, 16)] * 8
    assert list(eng.mesh.devices) == [torch.device("cpu", i)
                                      for i in range(8)]
    assert [c.device for c in eng._combs] == list(eng.mesh.devices)


def test_mesh_verdicts_match_single_device_bitwise():
    """``test_mesh_verdicts_match_single_device_bitwise`` on P-256: a
    mixed wave from three signers with forged votes and pad slots verifies
    to the same verdicts on a 4-device mesh and the single-device engine,
    both matching ground truth (one wave on 4 devices: each tile runs the
    comb kernel's plain version, about a second each)."""
    rng = np.random.default_rng(0xE5)
    single = TorchVerifyEngine(device="cpu", pad_sizes=(16,), scheme=p256)
    mesh = MeshVerifyEngine(devices=4, pad_sizes=(16,), scheme=p256)
    keys = [p256.keygen(b"mesh-prop-%d" % t) for t in range(3)]
    pool = []
    for i in range(6):
        sk, pub = keys[i % 3]
        msg = b"prop-msg-%d" % i
        pool.append((msg, p256.sign_raw(sk, msg), pub))
    items, expect = [], []
    for _ in range(11):
        msg, sig, pub = pool[int(rng.integers(len(pool)))]
        ok = rng.random() > 0.3
        if not ok:
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        items.append(p256.make_item(msg, sig, pub))
        expect.append(ok)
    assert mesh.verify(items) == single.verify(items) == expect
    snap = mesh.mesh_snapshot()
    assert snap["devices"] == 4 and snap["launches"] == 1
    assert snap["pad_slots"] == 5 and len(snap["device_fill_pct_last"]) == 4
    assert mesh.route_launches == {"comb": 4, "generic": 0}


def test_strided_placement_spreads_pad_slots_evenly():
    """``test_strided_placement_spreads_pad_slots_evenly`` against a
    one-device plane."""
    eng = MeshVerifyEngine(devices=8, pad_sizes=(64,), scheme=toy_scheme)
    single = one_device((64,))
    for n in (8, 21, 37, 50):
        items, expect = toy_items(n, forge_every=3)
        assert eng.verify(items) == single.verify(items) == expect
        fills = eng.stats.last_device_fill_pct
        assert len(fills) == 8
        per_dev = eng.pad_sizes[0] // 8
        counts = [round(f * per_dev / 100.0) for f in fills]
        assert sum(counts) == n
        assert max(counts) - min(counts) <= 1, (n, counts)
        if n >= 8:
            assert min(counts) >= 1
    assert eng.stats.launches_spanning_all_devices >= 3


def test_configure_verify_mesh_graduates_idempotently_and_downgrades():
    """``test_configure_verify_mesh_graduates_idempotently_and_downgrades``
    on ``TorchVerifyEngine(device="cpu")``: the same graduation,
    idempotence and counted downgrade, and, by design, no host fallback
    engine installed."""
    rings = Keyring.generate([1, 2], seed=b"mesh-wire")
    mem = InMemoryProvider()
    prov = P256CryptoProvider(
        rings[1], engine=TorchVerifyEngine(device="cpu", pad_sizes=(8,)))
    co = prov.coalescer
    prov.configure_verify_mesh(8, metrics=TPUCryptoMetrics(mem))
    assert isinstance(co.engine, MeshVerifyEngine)
    assert co.engine.devices == 8 and co.engine.pad_sizes == (8,)
    assert co.mesh_configured == 8
    assert co.fallback_engine is None
    assert mem.gauges["consensus.tpu.mesh_devices"] == 8.0
    graduated = co.engine
    prov.configure_verify_mesh(8)
    assert co.engine is graduated

    prov.configure_verify_mesh(999)
    assert co.engine is graduated
    assert co.mesh_downgrades == 1 and co.mesh_configured == 999
    assert mem.counters["consensus.tpu.count_mesh_downgrades"] == 1
    snap = co.mesh_snapshot()
    assert snap["configured_devices"] == 999 and snap["devices"] == 8
    assert snap["downgrades"] == 1
    assert snap["shard_map_available"] is True


def test_configure_verify_mesh_respects_fault_wrapped_mesh():
    """``test_configure_verify_mesh_respects_fault_wrapped_mesh`` with
    ``TorchVerifyEngine(device="cpu")`` inside the wrapper."""
    wrapped = FaultyEngine(
        MeshVerifyEngine(devices=8, pad_sizes=(16,), scheme=p256))
    rings = Keyring.generate([1, 2], seed=b"mesh-wrap")
    prov = P256CryptoProvider(
        rings[1], coalescer=AsyncBatchCoalescer(wrapped, window=0.001))
    prov.configure_verify_mesh(8)
    assert prov.coalescer.engine is wrapped

    single_wrapped = FaultyEngine(TorchVerifyEngine(device="cpu",
                                                    pad_sizes=(8,)))
    prov2 = P256CryptoProvider(
        rings[2], coalescer=AsyncBatchCoalescer(single_wrapped, window=0.001))
    prov2.configure_verify_mesh(8)
    assert prov2.coalescer.engine is single_wrapped
    assert isinstance(single_wrapped.inner, MeshVerifyEngine)
    assert single_wrapped.devices == 8
    assert single_wrapped.pad_sizes == single_wrapped.inner.pad_sizes
    assert prov2.coalescer.fallback_engine is None


def test_build_dir_env_override(monkeypatch):
    """``test_compile_cache_dir_env_override``: where the port's kernels
    build, ``SMARTBFT_TORCH_BUILD_DIR`` overriding the in-checkout
    default."""
    monkeypatch.setenv("SMARTBFT_TORCH_BUILD_DIR", "/tmp/rig-build")
    assert torchenv.build_dir() == "/tmp/rig-build"
    monkeypatch.delenv("SMARTBFT_TORCH_BUILD_DIR")
    assert torchenv.build_dir().endswith("smartbft_tpu_torch/_build/cuda")


def test_a_mesh_wave_of_two_tags_is_one_launch_a_device():
    """Two shards' submissions share one mesh wave: one logical launch,
    one kernel launch on each of the 8 devices."""
    eng = MeshVerifyEngine(devices=8, pad_sizes=(64,), scheme=toy_scheme)
    co = AsyncBatchCoalescer(eng, window=0.01)
    items_a, expect_a = toy_items(7, key_seeds=(b"shard-a",))
    items_b, expect_b = toy_items(12, key_seeds=(b"shard-b",), forge_every=3)

    async def run():
        return await asyncio.gather(co.submit(items_a, tag=0),
                                    co.submit(items_b, tag=1))

    assert asyncio.run(run()) == [expect_a, expect_b]
    assert eng.stats.launches == 1
    assert eng.route_launches == {"comb": 0, "generic": 8}
    assert eng.rung_launches == {64: 1}


@pytest.mark.parametrize("n", [1, 7])
def test_tiles_without_an_item_still_launch(n):
    """A wave narrower than the mesh leaves some tiles with pad lanes
    only; they launch all the same, so every chunk is one launch a
    device and the kernel's lanes are the chunk's slots."""
    eng = MeshVerifyEngine(devices=8, pad_sizes=(8,), scheme=toy_scheme)
    items, expect = toy_items(n)
    assert eng.verify(items) == expect
    assert eng.route_launches["generic"] == 8
    fills = eng.stats.last_device_fill_pct
    assert fills == [100.0] * n + [0.0] * (8 - n)


def test_one_lost_mesh_device_degrades_all_shards_then_recovers(tmp_path):
    """``test_one_lost_mesh_device_degrades_all_shards_then_recovers``
    with the host fallback given to the cluster's coalescer by the caller
    (the port's graduation installs none): one lost device of the
    8-device mesh fails every launch, the breaker opens once for both
    shards, they commit through the outage on the fallback, and the
    canary closes the breaker back onto the mesh."""

    def cfg(s, i):
        return dataclasses.replace(
            sharded_config(
                i, depth=4,
                request_forward_timeout=120.0,
                request_complain_timeout=240.0,
                request_auto_remove_timeout=480.0,
                leader_heartbeat_timeout=30.0,
                view_change_resend_interval=15.0,
                view_change_timeout=60.0,
                verify_launch_timeout=0.15, verify_launch_retries=2,
                verify_breaker_threshold=3, verify_probe_interval=0.05,
            ),
            verify_mesh_devices=8,
        )

    async def run():
        engine = FaultyEngine(
            MeshVerifyEngine(devices=8, pad_sizes=(16,), scheme=toy_scheme))
        c = ShardedCluster(tmp_path, shards=2, n=4, depth=4, crypto="toy",
                           engine=engine, config_fn=cfg, seed=37)
        c.coalescer.fallback_engine = HostVerifyEngine(scheme=toy_scheme)
        await c.start()
        try:
            assert c.coalescer.engine is engine
            for s in range(2):
                await c.submit(c.client_for_shard(s), f"warm-{s}a")
                await c.submit(c.client_for_shard(s, 1), f"warm-{s}b")
            await wait_for(
                lambda: all(sh.committed() >= 2 for sh in c.shard_list),
                c.scheduler, 60.0)
            mesh_launches_healthy = engine.inner.stats.launches
            assert mesh_launches_healthy >= 1

            engine.lose_device(3)
            for s in range(2):
                for j in range(4):
                    await c.submit(c.client_for_shard(s, j % 2), f"o-{s}{j}")
            await wait_for(
                lambda: all(sh.committed() >= 6 for sh in c.shard_list),
                c.scheduler, 120.0)
            snap = c.coalescer.fault_snapshot()
            assert snap["opens"] >= 1, snap
            assert snap["host_fallback_batches"] >= 1, snap
            tags = c.coalescer.shard_snapshot()["per_tag"]
            assert set(tags) == {"0", "1"}

            engine.restore_device(3)
            deadline = time.monotonic() + 10.0
            while c.coalescer.breaker_open and time.monotonic() < deadline:
                await asyncio.sleep(0.02)
            assert not c.coalescer.breaker_open
            assert c.coalescer.fault_snapshot()["closes"] >= 1
            for s in range(2):
                await c.submit(c.client_for_shard(s, 2), f"post-{s}")
            await wait_for(
                lambda: all(sh.committed() >= 7 for sh in c.shard_list),
                c.scheduler, 60.0)
            assert engine.inner.stats.launches > mesh_launches_healthy
            c.check_invariants()
            counters = c.verify_metrics_provider.counters
            assert counters["consensus.tpu.count_breaker_open"] >= 1
            assert counters["consensus.tpu.count_breaker_close"] >= 1
        finally:
            await c.stop()

    asyncio.run(run())
