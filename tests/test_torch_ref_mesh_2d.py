"""The reference's 2D (seq x vote) quorum-mesh cases against the port:
``tests/test_mesh_2d.py`` and ``tests/test_mesh_cluster.py``, compiled
against ``smartbft_tpu_torch`` by :mod:`torch_reference`, on 8 virtual CPU
devices (``torchenv.force_cpu``), under an exact count guard.

Left out, each with its reason (and a port counterpart below where the
case means something in the port):

* the cases marked slow (the P-256 2D parity, the n=16 cluster on the
  8-device mesh), as the reference's tier-1 leaves them out;
* the two that build ``JaxVerifyEngine``: the 2D/1D/single-device verdict
  parity and graduation inside a fault wrapper; the counterparts take a
  one-device plane and a host engine;
* ``test_quorum_mesh_unavailable_without_shard_map``: it empties the
  shard_map memo, a jax API drift the port does not have; the counterpart
  is the 2D seam's counted downgrade on a host too narrow for the mesh;
* ``test_sharded_engine_partitions_lanes_across_mesh``: it imports jax
  and reads a jax array's ``addressable_shards``; the counterpart reads
  the port's per-device tiles.
"""

import random

import numpy as np
import torch

from smartbft_tpu_torch.crypto.provider import (
    AsyncBatchCoalescer,
    HostVerifyEngine,
    Keyring,
)
from smartbft_tpu_torch.parallel import (
    MeshVerifyEngine,
    QuorumMeshVerifyEngine,
    ShardedVerifyEngine,
    build_mesh,
)
from smartbft_tpu_torch.testing import toy_scheme
from smartbft_tpu_torch.testing.engine_faults import FaultyEngine
from torch_reference import check_matrices, reference_tests, virtual_devices

_virtual_devices = virtual_devices(8)

LEAVE_OUT = {
    "test_quorum_mesh_unavailable_without_shard_map":
        "empties the shard_map memo, a jax API drift the port does not have",
    "test_sharded_engine_partitions_lanes_across_mesh":
        "imports jax and reads a jax array's addressable_shards",
}
CASES = {"test_mesh_2d.py": 7, "test_mesh_cluster.py": 1}
LEFT_OUT = {
    "test_mesh_2d.py": sorted([
        "test_2d_parity_p256_production_curve",
        "test_2d_verdicts_bit_identical_to_1d_and_single_device",
        "test_configure_verify_mesh_2d_inside_fault_wrapper",
        "test_quorum_mesh_unavailable_without_shard_map"]),
    "test_mesh_cluster.py": sorted([
        "test_consensus_cluster_commits_on_mesh",
        "test_sharded_engine_partitions_lanes_across_mesh"]),
}

for _file in CASES:
    globals().update(reference_tests(_file, leave_out=LEAVE_OUT))


def test_reference_cases_are_whole_and_ported():
    check_matrices(CASES, LEFT_OUT, leave_out=LEAVE_OUT)


def toy_wave(rng, count, n_signers=3, forge_p=0.3, dup_p=0.2):
    """The reference's mixed wave: several signers, forged votes and
    duplicate votes; returns (items, expected verdicts)."""
    keys = [toy_scheme.keygen(b"w2d-%d" % t) for t in range(n_signers)]
    items, expect = [], []
    for i in range(count):
        if items and rng.random() < dup_p:
            j = rng.randrange(len(items))
            items.append(items[j])
            expect.append(expect[j])
            continue
        sk, pub = keys[i % n_signers]
        msg = b"w2d-msg-%d" % rng.randrange(count)
        sig = toy_scheme.sign_raw(sk, msg)
        ok = rng.random() > forge_p
        if not ok:
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        items.append(toy_scheme.make_item(msg, sig, pub))
        expect.append(ok)
    return items, expect


def test_2d_verdicts_bit_identical_to_1d_and_single_device():
    """``test_2d_verdicts_bit_identical_to_1d_and_single_device`` against
    a one-device plane: the same verdicts on the 2D mesh, the 1D mesh and
    one device, and the summed counts are the host's tally of distinct
    valid votes a message."""
    rng = random.Random(0x2D)
    single = ShardedVerifyEngine(mesh=build_mesh((1,)), pad_sizes=(64,),
                                 scheme=toy_scheme)
    mesh_1d = MeshVerifyEngine(devices=8, pad_sizes=(64,), scheme=toy_scheme)
    mesh_2d = QuorumMeshVerifyEngine(devices=8, scheme=toy_scheme, quorum=2)
    for _ in range(4):
        count = rng.choice((5, 17, 33, 50))
        items, expect = toy_wave(rng, count)
        got_2d = mesh_2d.verify(items)
        assert got_2d == mesh_1d.verify(items) == single.verify(items) \
            == expect
        tally: dict = {}
        seen: set = set()
        for it, ok in zip(items, got_2d):
            tally.setdefault(it[0], 0)
            if ok and it not in seen:
                tally[it[0]] += 1
            seen.add(it)
        assert mesh_2d.last_counts == tally
        assert mesh_2d.last_decided == {m: c >= 2 for m, c in tally.items()}


def test_configure_verify_mesh_2d_inside_fault_wrapper():
    """``test_configure_verify_mesh_2d_inside_fault_wrapper`` around a
    host engine: graduation goes inside the wrapper, which then reads as
    the 2D mesh."""
    wrapped = FaultyEngine(HostVerifyEngine(scheme=toy_scheme))
    rings = Keyring.generate([1, 2], seed=b"2dwrap", scheme=toy_scheme)
    prov = toy_scheme.ToyCryptoProvider(
        rings[1], coalescer=AsyncBatchCoalescer(wrapped, window=0.001))
    prov.configure_verify_mesh(8, topology="2d")
    assert prov.coalescer.engine is wrapped
    assert isinstance(wrapped.inner, QuorumMeshVerifyEngine)
    assert wrapped.devices == 8 and wrapped.topology == "2d"
    assert prov.coalescer.fallback_engine is None


def test_2d_mesh_wider_than_the_host_is_a_counted_downgrade():
    """``test_quorum_mesh_unavailable_without_shard_map``'s seam half: a
    2D mesh the host cannot build keeps the engine, with one downgrade
    counted."""
    rings = Keyring.generate([1, 2], seed=b"nosm", scheme=toy_scheme)
    prov = toy_scheme.ToyCryptoProvider(rings[1])
    before = prov.coalescer.engine
    prov.configure_verify_mesh(16, topology="2d")
    assert prov.coalescer.engine is before
    assert prov.coalescer.mesh_downgrades == 1
    assert prov.coalescer.mesh_snapshot()["enabled"] is False


def test_sharded_engine_places_one_tile_a_device():
    """``test_sharded_engine_partitions_lanes_across_mesh``: every pad
    size is a mesh multiple, and a placed operand is one equal tile on
    each of the 8 devices."""
    mesh = build_mesh()
    engine = ShardedVerifyEngine(mesh=mesh, pad_sizes=(8, 64))
    assert engine.lanes == 8
    assert all(s % engine.lanes == 0 for s in engine.pad_sizes)
    placed = engine._place(np.zeros((64, 16), np.uint32))
    assert len(placed) == 8
    assert placed[0].shape[0] == 64 // engine.lanes
    assert list(mesh.devices) == [torch.device("cpu", i) for i in range(8)]


def test_quorum_step_launches_each_tile_on_its_device():
    """Device (i, j) of the (4, 2) mesh verifies its (rows / 4) x
    (votes / 2) tile of every block in one launch, and the counts of a
    row group sum over the vote axis."""
    eng = QuorumMeshVerifyEngine(devices=8, scheme=toy_scheme, quorum=2)
    assert eng.mesh.devices.shape == (4, 2)
    seen = []
    kernel = eng._generic_kernel

    def spy(*arrays):
        seen.append(arrays[0].shape[0])
        return kernel(*arrays)

    eng._generic_kernel = spy
    items, expect = toy_wave(random.Random(5), 40)
    assert eng.verify(items) == expect
    per_tile = (eng.seq_tile // 4) * (eng.vote_tile // 2)
    assert seen == [per_tile] * 8 * eng.psum_steps
    assert eng.route_launches == {"comb": 0, "generic": len(seen)}
    assert eng.rung_launches == {eng.seq_tile * eng.vote_tile: eng.psum_steps}
