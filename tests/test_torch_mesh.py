"""The multi-device verify plane on the port, held against the JAX package.

Both packages run on 8 virtual CPU devices: the JAX package's through
``tests/conftest.py`` (``--xla_force_host_platform_device_count``), the
port's through ``torchenv.force_cpu(virtual_devices=8)``, set for this
module and put back after it.  The same numpy-seeded toy-scheme waves go
through both packages' ``MeshVerifyEngine``, ``QuorumMeshVerifyEngine``
and ``quorum_decide`` and give the same verdicts, counts, decisions,
``mesh_block`` and per-device fill.  Real P-256 and Ed25519 waves go
through the port's mesh (each device tile on its kernel's plain version)
and are held to the JAX package's ``HostVerifyEngine``; the JAX XLA
kernels are not compiled here (minutes a shape).  ``configure_verify_mesh``
and ``mesh_snapshot`` agree between the packages on the same
configuration, but for the two places where the port differs by design:
graduation installs no host fallback engine, and a shared plane counts one
downgrade for a mesh it cannot build, not one per replica wired.
"""

import ast
import asyncio
import pathlib

import numpy as np
import pytest
import torch

from smartbft_tpu import parallel as j_parallel
from smartbft_tpu.crypto import provider as j_provider
from smartbft_tpu.testing import toy_scheme as j_toy
from smartbft_tpu_torch import parallel as t_parallel
from smartbft_tpu_torch.crypto import ed25519, p256
from smartbft_tpu_torch.crypto import provider as t_provider
from smartbft_tpu_torch.crypto.cuda_comb import is_on_curve_int
from smartbft_tpu_torch.metrics import InMemoryProvider, TPUCryptoMetrics
from smartbft_tpu_torch.parallel import engine as t_engine
from smartbft_tpu_torch.testing import toy_scheme as t_toy
from smartbft_tpu_torch.utils import torchenv
from torch_reference import virtual_devices

ROOT = pathlib.Path(__file__).resolve().parent.parent


_virtual_devices = virtual_devices(8)


def toy_wave(rng, count, n_signers=3, n_msgs=6, forge_p=0.3, dup_p=0.2):
    """A seeded mixed toy wave: several signers, forged and duplicate
    votes, messages shared between signers (quorum rows)."""
    keys = [t_toy.keygen(b"mesh-%d" % t) for t in range(n_signers)]
    items = []
    for i in range(count):
        if items and rng.random() < dup_p:
            items.append(items[int(rng.integers(len(items)))])
            continue
        sk, pub = keys[i % n_signers]
        msg = b"mesh-msg-%d" % int(rng.integers(n_msgs))
        sig = t_toy.sign_raw(sk, msg)
        if rng.random() < forge_p:
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        items.append(t_toy.make_item(msg, sig, pub))
    return items


def host_tally(items, verdicts):
    """Distinct valid votes per message, counted on the host."""
    tally, seen = {}, set()
    for it, ok in zip(items, verdicts):
        tally.setdefault(it[0], 0)
        if ok and it not in seen:
            tally[it[0]] += 1
        seen.add(it)
    return tally


# ------------------------------------------------------------ the 1D mesh

@pytest.mark.parametrize("devices", [8, 3])
def test_mesh_engine_matches_the_jax_package(devices):
    """Verdicts, the stats' mesh block and the per-device fill of every
    launch, over waves that pad, fill a rung exactly and span chunks."""
    rng = np.random.default_rng(devices)
    eng = {pkg: pkg.MeshVerifyEngine(devices=devices, pad_sizes=(16, 48),
                                     scheme=toy)
           for pkg, toy in ((j_parallel, j_toy), (t_parallel, t_toy))}
    assert eng[t_parallel].pad_sizes == eng[j_parallel].pad_sizes
    for count in (1, 5, 16, 29, 48, 61, 100):
        items = toy_wave(rng, count)
        want = eng[j_parallel].verify(items)
        assert eng[t_parallel].verify(items) == want
        assert want == [t_toy.verify_item(it) for it in items]
        assert eng[t_parallel].stats.last_device_fill_pct \
            == eng[j_parallel].stats.last_device_fill_pct
    assert eng[t_parallel].mesh_snapshot() == eng[j_parallel].mesh_snapshot()
    assert eng[t_parallel].route_launches["generic"] \
        == devices * eng[t_parallel].stats.launches


def test_mesh_launches_one_tile_a_device_on_its_device():
    """A chunk is one launch a device, each tile placed on its own
    device."""
    eng = t_parallel.MeshVerifyEngine(devices=8, pad_sizes=(16,),
                                      scheme=t_toy)
    seen = []
    kernel = eng._generic_kernel

    def spy(*arrays):
        seen.append(arrays[0].shape[0])
        return kernel(*arrays)

    eng._generic_kernel = spy
    eng.verify(toy_wave(np.random.default_rng(1), 11))
    assert seen == [2] * 8
    assert eng._devices == [torch.device("cpu", i) for i in range(8)]
    placed = eng._place(np.arange(16 * 4, dtype=np.uint32).reshape(16, 4))
    assert [tuple(t.shape) for t in placed] == [(2, 4)] * 8
    assert placed[3][0, 0].item() == 3 * 2 * 4


# ------------------------------------------------------------ the 2D mesh

@pytest.mark.parametrize("devices,quorum", [(8, 2), (3, 3)])
def test_quorum_mesh_engine_matches_the_jax_package(devices, quorum):
    """Verdicts, per-message counts, decisions, quorum steps and the mesh
    block, with rows wider than the vote tile and blocks past one."""
    rng = np.random.default_rng(10 + devices)
    eng = {pkg: pkg.QuorumMeshVerifyEngine(devices=devices, scheme=toy,
                                           quorum=quorum, seq_tile=4,
                                           vote_tile=4)
           for pkg, toy in ((j_parallel, j_toy), (t_parallel, t_toy))}
    assert eng[t_parallel].mesh.devices.shape \
        == eng[j_parallel].mesh.devices.shape
    for count, n_msgs in ((5, 2), (17, 3), (33, 12), (50, 4)):
        items = toy_wave(rng, count, n_signers=5, n_msgs=n_msgs)
        want = eng[j_parallel].verify(items)
        assert eng[t_parallel].verify(items) == want
        for key in ("last_counts", "last_decided", "psum_steps"):
            assert getattr(eng[t_parallel], key) \
                == getattr(eng[j_parallel], key), key
        assert eng[t_parallel].last_counts == host_tally(items, want)
        assert eng[t_parallel].stats.last_device_fill_pct \
            == eng[j_parallel].stats.last_device_fill_pct
    assert eng[t_parallel].mesh_snapshot() == eng[j_parallel].mesh_snapshot()


@pytest.mark.parametrize("shape", [(4, 2), (2, 2), (2, 1)])
def test_quorum_decide_matches_the_jax_package(shape):
    """The bare quorum step over a (S, V) toy block, its key column a
    rank-2 input."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    rng = np.random.default_rng(sum(shape))
    n_seq, n_votes = 4, 4
    keys = [t_toy.keygen(b"qd-%d" % v) for v in range(n_votes)]
    items = []
    for s in range(n_seq):
        msg = b"qd-seq-%d" % s
        # sequence s has s forged votes, at seeded places
        forged = set(rng.permutation(n_votes)[:s].tolist())
        for v, (sk, pub) in enumerate(keys):
            sig = t_toy.sign_raw(sk, msg)
            if v in forged:
                sig = bytes([sig[0] ^ 1]) + sig[1:]
            items.append(t_toy.make_item(msg, sig, pub))
    args = [a.reshape((n_seq, n_votes) + a.shape[1:])
            for a in t_toy.verify_inputs(items)]
    j_mesh = j_parallel.build_mesh(shape, ("seq", "vote"))
    placed = [jax.device_put(a, NamedSharding(
        j_mesh, P("seq", "vote", None) if a.ndim == 3 else P("seq", "vote")))
        for a in args]
    want = np.asarray(j_parallel.quorum_decide(j_mesh, 3, j_toy)(*placed))
    got = t_parallel.quorum_decide(
        t_parallel.build_mesh(shape, ("seq", "vote")), 3, t_toy)(*args)
    assert got.tolist() == want.tolist() == [True, True, False, False]


# --------------------------------------------- real curves through the mesh

def comb_registrable(scheme, item) -> bool:
    """Whether ``item``'s key takes the comb route."""
    return scheme is not p256 or is_on_curve_int(item[-1])


def _p256_wave():
    keys = [p256.keygen(b"mesh-p-%d" % t) for t in range(3)]
    items = []
    for i in range(11):
        sk, pub = keys[i % 3]
        msg = b"mesh-p-msg-%d" % (i % 4)
        sig = p256.sign_raw(sk, msg)
        if i % 4 == 3:
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        items.append(p256.make_item(msg, sig, pub))
    # a key off the curve is unregistrable: its device's tile takes the
    # generic kernel while the others take the comb one
    m, r, s, (qx, qy) = items[5]
    items[5] = (m, r, s, (qx, (qy + 1) % p256.P))
    return items


def _ed25519_wave():
    keys = [ed25519.keygen(b"mesh-e-%d" % t) for t in range(3)]
    items = []
    for i in range(9):
        sk, pub = keys[i % 3]
        msg = b"mesh-e-msg-%d" % (i % 3)
        sig = ed25519.sign_raw(sk, msg)
        if i % 4 == 2:
            sig = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
        items.append(ed25519.make_item(msg, sig, pub))
    return items


@pytest.mark.parametrize("name,make", [("p256", _p256_wave),
                                       ("ed25519", _ed25519_wave)])
def test_curve_waves_on_the_mesh_match_the_jax_host_engine(name, make):
    """Both engines on 2 devices (every tile on its kernel's plain
    version), held to the JAX package's pure-Python verifier."""
    from smartbft_tpu.crypto import ed25519 as j_ed
    from smartbft_tpu.crypto import p256 as j_p256

    scheme = {"p256": p256, "ed25519": ed25519}[name]
    items = make()
    want = j_provider.HostVerifyEngine(
        scheme={"p256": j_p256, "ed25519": j_ed}[name]).verify(items)
    assert True in want and False in want
    mesh = t_parallel.MeshVerifyEngine(devices=2, pad_sizes=(12,),
                                       scheme=scheme)
    assert mesh.verify(items) == want
    # the generic kernel's plain version is the slow one: the quorum mesh
    # runs the wave without the unregistrable key
    items, want = zip(*[(it, ok) for it, ok in zip(items, want)
                        if comb_registrable(scheme, it)])
    items, want = list(items), list(want)
    quorum = t_parallel.QuorumMeshVerifyEngine(devices=2, scheme=scheme,
                                               quorum=2, seq_tile=4,
                                               vote_tile=4)
    assert quorum.verify(items) == want
    assert quorum.last_counts == host_tally(items, want)
    assert quorum.last_decided == {m: c >= 2 for m, c
                                   in host_tally(items, want).items()}
    assert quorum.route_launches == {"comb": 2, "generic": 0}
    launches = mesh.route_launches["comb"] + mesh.route_launches["generic"]
    assert launches == 2 and quorum.psum_steps == 1
    if name == "p256":
        assert mesh.route_launches["generic"] == 1


# -------------------------------------------------------------- the wiring

def _toy_provider(pkg_provider, toy, seed=b"mesh-wire", n=4):
    rings = pkg_provider.Keyring.generate(list(range(1, n + 1)), seed=seed,
                                          scheme=toy)
    return toy.ToyCryptoProvider(rings[1])


def _snapshot(prov):
    snap = dict(prov.coalescer.mesh_snapshot())
    eng = prov.coalescer.engine
    return snap, type(eng).__name__, getattr(eng, "pad_sizes", None), \
        prov.coalescer.max_batch


def test_configure_verify_mesh_and_mesh_snapshot_match_the_jax_package():
    """The same sequence of knob settings on one provider of each
    package: the same engine, ladder, batch cap and snapshot at every
    step, and only the JAX package installs a host fallback."""
    provs = {j_provider: _toy_provider(j_provider, j_toy),
             t_provider: _toy_provider(t_provider, t_toy)}
    steps = [(1, "1d"), (8, "1d"), (8, "1d"), (8, "2d"), (2, "2d"),
             (8, "1d"), (16, "1d"), (9, "2d")]
    for devices, topology in steps:
        for prov in provs.values():
            prov.configure_verify_mesh(devices, topology=topology)
        assert _snapshot(provs[t_provider]) == _snapshot(provs[j_provider]), \
            (devices, topology)
    assert isinstance(provs[j_provider].coalescer.fallback_engine,
                      j_provider.HostVerifyEngine)
    assert provs[t_provider].coalescer.fallback_engine is None
    assert provs[t_provider].coalescer.mesh_snapshot()["downgrades"] == 2


@pytest.mark.parametrize("devices", [1, 8])
@pytest.mark.parametrize("topology", ["1d", "2d"])
def test_graduation_installs_no_host_fallback(devices, topology):
    """The port's one deliberate divergence on graduation: the JAX
    package adds a ``HostVerifyEngine`` as the coalescer's fallback; the
    port adds none, so no device fault hides as a slow commit."""
    mem = InMemoryProvider()
    prov = t_provider.P256CryptoProvider(
        t_provider.Keyring.generate([1, 2, 3, 4], seed=b"nofb")[1],
        engine=t_provider.TorchVerifyEngine(device="cpu", pad_sizes=(8,)))
    prov.configure_verify_mesh(devices, metrics=TPUCryptoMetrics(mem),
                               topology=topology)
    co = prov.coalescer
    want = {"1d": t_parallel.MeshVerifyEngine,
            "2d": t_parallel.QuorumMeshVerifyEngine}[topology]
    assert type(co.engine) is want and co.engine.devices == devices
    assert prov.engine is co.engine
    assert co.fallback_engine is None
    assert co.mesh_downgrades == 0
    assert mem.gauges["consensus.tpu.mesh_devices"] == float(devices)
    assert co.max_batch >= co.engine.pad_sizes[-1]


def test_a_shared_plane_counts_one_downgrade_per_unbuildable_mesh():
    """Replicas sharing one coalescer wire the same unbuildable width:
    the JAX package counts one downgrade a replica, the port one for the
    plane (a new width counts again)."""
    counts = {}
    for pkg, toy in ((j_provider, j_toy), (t_provider, t_toy)):
        rings = pkg.Keyring.generate([1, 2, 3, 4], seed=b"dg", scheme=toy)
        first = toy.ToyCryptoProvider(rings[1])
        provs = [first] + [toy.ToyCryptoProvider(rings[i],
                                                 coalescer=first.coalescer)
                           for i in (2, 3, 4)]
        for prov in provs:
            prov.configure_verify_mesh(12)
        provs[0].configure_verify_mesh(10, topology="2d")
        counts[pkg] = first.coalescer.mesh_downgrades
        assert first.coalescer.mesh_configured == 10
    assert counts == {j_provider: 5, t_provider: 2}


# ------------------------------------------------------ names and devices

def test_parallel_exports_the_jax_packages_names():
    assert t_parallel.__all__ == j_parallel.__all__
    for name in t_parallel.__all__:
        assert getattr(t_parallel, name).__module__ \
            == "smartbft_tpu_torch.parallel.engine"
    assert t_parallel.shard_map_available() is True
    assert t_parallel.mesh_device_count() == 8
    assert t_engine.MESH_PER_DEVICE_LANES \
        == j_parallel.engine.MESH_PER_DEVICE_LANES


def test_force_cpu_sets_and_restores_the_visible_devices():
    assert torchenv.visible_devices() == [torch.device("cpu", i)
                                          for i in range(8)]
    previous = torchenv.force_cpu(virtual_devices=3)
    try:
        assert previous == 8
        assert t_parallel.mesh_device_count() == 3
        with pytest.raises(t_parallel.MeshUnavailable, match="host has 3"):
            t_parallel.MeshVerifyEngine(devices=4, scheme=t_toy)
        assert torchenv.force_cpu() == 3
        assert torchenv.visible_devices() == [torch.device("cpu", 0)]
        with pytest.raises(ValueError):
            torchenv.force_cpu(virtual_devices=0)
    finally:
        torchenv.restore(previous)
    assert t_parallel.mesh_device_count() == 8


def test_no_virtual_devices_and_no_card_is_an_empty_mesh():
    previous = torchenv.force_cpu(virtual_devices=2)
    torchenv.restore(None)
    try:
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is visible")
        assert torchenv.visible_devices() == []
        assert t_parallel.mesh_device_count() == 0
        with pytest.raises(t_parallel.MeshUnavailable, match="host has 0"):
            t_parallel.QuorumMeshVerifyEngine(scheme=t_toy)
    finally:
        torchenv.restore(previous)


def test_every_launcher_makes_its_tensors_device_current():
    """The five kernel launchers take the stream of the tensors' device
    and launch inside ``torch.cuda.device(dev)``: a worker thread starts
    on device 0, so without it a tile on ``cuda:1`` would launch on
    device 0 with a stream of device 1."""
    for mod in ("cuda_comb", "cuda_ecdsa", "cuda_ed25519", "cuda_eddsa",
                "cuda_bls"):
        path = ROOT / "smartbft_tpu_torch" / "crypto" / f"{mod}.py"
        launch = next(n for n in ast.parse(path.read_text()).body
                      if isinstance(n, ast.FunctionDef) and n.name == "launch")
        guarded = [w for w in ast.walk(launch) if isinstance(w, ast.With)
                   and ast.unparse(w.items[0].context_expr)
                   == "torch.cuda.device(dev)"]
        assert len(guarded) == 1, mod
        inside = {id(n) for n in ast.walk(guarded[0])}
        calls = {ast.unparse(n.func): id(n) in inside
                 for n in ast.walk(launch) if isinstance(n, ast.Call)}
        assert calls["torch.cuda.current_stream"], mod
        assert any(k.startswith("_lib(") and v for k, v in calls.items()), mod


def test_mesh_coalescer_wave_on_virtual_devices_runs_every_tile():
    """A coalesced wave through the port's mesh under the default fault
    policy: verdicts exact, no fallback, one launch a device."""
    eng = t_parallel.MeshVerifyEngine(devices=8, pad_sizes=(16, 64),
                                      scheme=t_toy)
    co = t_provider.AsyncBatchCoalescer(
        eng, window=0.005, policy=t_provider.VerifyFaultPolicy())
    items = toy_wave(np.random.default_rng(4), 37)

    async def run():
        return await asyncio.gather(co.submit(items[:20], tag=0),
                                    co.submit(items[20:], tag=1))

    a, b = asyncio.run(run())
    assert a + b == [t_toy.verify_item(it) for it in items]
    assert co.fault_snapshot()["host_fallback_batches"] == 0
    assert eng.route_launches["generic"] == 8 * eng.stats.launches
