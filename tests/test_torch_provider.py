"""The port's verify plane (crypto/provider.py): TorchVerifyEngine routing
and pad ladder, the coalescer's dedupe / tags / breaker, and the provider
SPI — on the CPU, where the engine runs the kernels' plain versions.  Each
verdict is held against the JAX package's integer reference."""

import asyncio
import dataclasses
import importlib
import logging

import pytest
import torch

from smartbft_tpu.crypto import ed25519 as jed
from smartbft_tpu.crypto import p256 as jp256
from smartbft_tpu_torch import csrc
from smartbft_tpu_torch.crypto import cuda_comb as cc
from smartbft_tpu_torch.crypto import ed25519 as ed
from smartbft_tpu_torch.crypto import p256
from smartbft_tpu_torch.crypto.provider import (
    AsyncBatchCoalescer,
    Ed25519CryptoProvider,
    HostVerifyEngine,
    Keyring,
    P256CryptoProvider,
    TorchVerifyEngine,
    VerifyFaultPolicy,
    VerifyResultMismatch,
    prewarm_verify_engine,
)
from smartbft_tpu_torch.messages import Proposal, Signature
from smartbft_tpu_torch.types import VerifyPlaneDown
from torch_reference import virtual_devices

# 8 virtual CPU devices for the mesh knob's cases, as the JAX package has
# through tests/conftest.py; the previous device list comes back after
_virtual_devices = virtual_devices(8)

# small plain-torch tensors gain nothing from intra-op threads, and the
# suite runs in parallel worker processes
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def keyrings():
    return Keyring.generate([1, 2, 3, 4], seed=b"tp")


def _filler_keys(count):
    """``count`` distinct on-curve points G, 2G, ... (cheap registry fill)."""
    g = (p256.GX, p256.GY)
    pts = [g]
    while len(pts) < count:
        pts.append(p256._point_add_int(pts[-1], g))
    return pts


def _item(ring, msg, corrupt=False):
    sig = bytearray(p256.sign_raw(ring.private_key, msg))
    if corrupt:
        sig[5] ^= 1
    return p256.make_item(msg, bytes(sig), ring.public_keys[ring.self_id])


def test_cuda_engine_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default engine is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchVerifyEngine()


def test_engine_routes_registered_keys_to_comb(keyrings):
    eng = TorchVerifyEngine(device="cpu", pad_sizes=(4, 8))
    items = [_item(keyrings[i], b"x%d" % i, corrupt=(i == 2)) for i in (1, 2, 3)]
    assert eng.verify(items) == [jp256.verify_item(it) for it in items] \
        == [True, False, True]
    assert eng.route_launches == {"comb": 1, "generic": 0}
    assert eng.rung_launches == {4: 1}
    assert eng.stats.sigs_verified == 3 and eng.stats.slots_used == 4
    assert eng.stats.batch_fill_pct == 75.0


def test_engine_routes_unregistrable_chunks_to_generic(keyrings):
    eng = TorchVerifyEngine(device="cpu", pad_sizes=(4,))
    eng.prewarm_keys(_filler_keys(cc.CombKeyRegistry().cap - 1))
    items = [_item(keyrings[1], b"a"), _item(keyrings[2], b"b")]
    assert eng.verify(items[:1]) == [True]  # registers key 1: full
    assert eng.route_launches == {"comb": 1, "generic": 0}
    assert eng.verify(items) == [True, True]
    assert eng.route_launches == {"comb": 1, "generic": 1}


def test_engine_chunks_past_the_top_rung(keyrings):
    eng = TorchVerifyEngine(device="cpu", pad_sizes=(2, 4))
    items = [_item(keyrings[1], b"c%d" % i) for i in range(5)]
    assert eng.verify(items) == [True] * 5
    assert eng.stats.launches == 2 and eng.rung_launches == {4: 1, 2: 1}
    assert eng.verify([]) == []


def test_prewarm_runs_every_requested_rung():
    eng = TorchVerifyEngine(device="cpu", pad_sizes=(2, 4))
    prewarm_verify_engine(eng, sizes=(2,))
    assert eng.rung_launches == {2: 1}
    prewarm_verify_engine(HostVerifyEngine())  # no ladder: no-op


def test_provider_sign_and_batch_verify_attributes_forgeries(keyrings):
    eng = TorchVerifyEngine(device="cpu", pad_sizes=(8,))
    provs = {i: P256CryptoProvider(keyrings[i], engine=eng) for i in keyrings}
    prop = Proposal(payload=b"block", metadata=b"md")
    sigs = [provs[i].sign_proposal(prop, b"aux-%d" % i) for i in (1, 2, 3)]
    bad = Signature(signer=3, value=bytes(64), msg=sigs[2].msg)
    auxes = provs[4].verify_consenter_sigs_batch(sigs[:2] + [bad], prop)
    assert auxes == [b"aux-1", b"aux-2", None]
    assert provs[4].invalid_by_signer == {3: {"invalid_sig": 1}}
    auxes = asyncio.run(provs[4].verify_consenter_sigs_batch_async(sigs, prop))
    assert auxes == [b"aux-1", b"aux-2", b"aux-3"]
    assert provs[4].verify_consenter_sig(sigs[0], prop) == b"aux-1"
    with pytest.raises(ValueError):
        provs[4].verify_consenter_sig(bad, prop)


def test_provider_rejects_an_invalid_keyring_key(keyrings):
    ring = Keyring(1, keyrings[1].private_key, {1: (1, 2)})
    with pytest.raises(ValueError, match="invalid key"):
        P256CryptoProvider(ring, engine=TorchVerifyEngine(device="cpu"))


def test_shared_coalescer_dedupes_and_attributes_tags(keyrings):
    eng = TorchVerifyEngine(device="cpu", pad_sizes=(8,))
    co = AsyncBatchCoalescer(eng, window=0.01, max_batch=64, dedupe=True)
    a, b = _item(keyrings[1], b"d1"), _item(keyrings[2], b"d2", corrupt=True)

    async def run():
        return await asyncio.gather(co.submit([a, b], tag="s0"),
                                    co.submit([b, a], tag="s1"))

    assert asyncio.run(run()) == [[True, False], [False, True]]
    assert eng.stats.launches == 1 and eng.stats.sigs_verified == 2
    snap = co.shard_snapshot()
    assert snap["mixed_waves"] == 1 and snap["per_tag"]["s0"]["items"] == 2


class _DeadEngine:
    """Device-shaped engine whose launches fail with ``error``."""

    pad_sizes = (8,)
    scheme = p256

    def __init__(self, error=RuntimeError("device unreachable")):
        self.calls = 0
        self.error = error

    def verify(self, items):
        self.calls += 1
        raise self.error


def test_breaker_degrades_failed_launches_to_the_host(keyrings):
    policy = VerifyFaultPolicy(launch_timeout=5.0, launch_retries=1,
                               backoff_base=0.001, backoff_jitter=0.0,
                               breaker_threshold=2, probe_interval=60.0)
    dead = _DeadEngine()
    co = AsyncBatchCoalescer(dead, window=0.0, policy=policy,
                             fallback_engine=HostVerifyEngine())
    item = _item(keyrings[1], b"fb")

    async def run():
        out = await co.submit([item])
        snap = co.fault_snapshot()
        co._probe_task.cancel()
        return out, snap

    out, snap = asyncio.run(run())
    assert out == [True]
    assert snap["opens"] == 1 and snap["host_fallback_batches"] == 1
    assert snap["launch_failures"] == 2 and dead.calls == 2


def test_coalescer_without_fallback_surfaces_plane_down(keyrings):
    policy = VerifyFaultPolicy(launch_timeout=None, launch_retries=0,
                               breaker_threshold=5)
    co = AsyncBatchCoalescer(_DeadEngine(), window=0.0, policy=policy)
    with pytest.raises(VerifyPlaneDown):
        asyncio.run(co.submit([_item(keyrings[1], b"pd")]))


def test_engine_result_length_is_guarded():
    class Short:
        def verify(self, items):
            return [True]

    with pytest.raises(VerifyResultMismatch):
        AsyncBatchCoalescer._engine_call(Short(), [1, 2])


def test_registry_overflow_degrades_loudly(keyrings, caplog):
    eng = TorchVerifyEngine(device="cpu")
    eng.prewarm_keys(_filler_keys(cc.CombKeyRegistry().cap))
    with caplog.at_level("WARNING"):
        P256CryptoProvider(keyrings[1], engine=eng)
    assert "registry full" in caplog.text
    assert isinstance(eng._comb, cc.CombVerifier)


def test_provider_adds_no_host_fallback(keyrings):
    prov = P256CryptoProvider(keyrings[1], engine=TorchVerifyEngine(device="cpu"))
    assert prov.coalescer.policy is not None  # deadlines + breaker armed
    prov.configure_fault_policy(policy=VerifyFaultPolicy())
    assert prov.coalescer.fallback_engine is None


@pytest.mark.parametrize("error", [csrc.KernelLaunchError, csrc.KernelBuildError])
def test_failing_kernel_surfaces_as_an_error(keyrings, monkeypatch, error):
    """A kernel fault reaches the caller as raised: not retried, no breaker,
    no host wave, even where the caller passed a fallback engine."""
    calls = []

    def broken(*args):
        calls.append(1)
        raise error("comb_verify: CUDA launch failed (cudaError 700)")

    monkeypatch.setattr(cc, "ecdsa_verify_comb", broken)
    prov = P256CryptoProvider(keyrings[1], engine=TorchVerifyEngine(device="cpu"),
                              fallback_engine=HostVerifyEngine())
    prop = Proposal(payload=b"block", metadata=b"md")
    sigs = [prov.sign_proposal(prop, b"aux")]
    with pytest.raises(error):
        asyncio.run(prov.verify_consenter_sigs_batch_async(sigs, prop))
    with pytest.raises(error):
        prov.verify_signature(sigs[0])
    snap = prov.coalescer.fault_snapshot()
    assert snap["host_fallback_batches"] == 0 and snap["opens"] == 0
    assert snap["retries"] == 0 and len(calls) == 2


# ---------------------------------------------------------------------------
# Ed25519 (BASELINE configs[3]) on the same verify plane
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ed_keyrings():
    return Keyring.generate([1, 2, 3, 4], seed=b"ed-t", scheme=ed)


def test_ed25519_keyrings_match_the_jax_package(ed_keyrings):
    from smartbft_tpu.crypto.provider import Keyring as JKeyring

    j = JKeyring.generate([1, 2, 3, 4], seed=b"ed-t", scheme=jed)
    for i in ed_keyrings:
        assert ed_keyrings[i].private_key == j[i].private_key
        assert ed_keyrings[i].public_keys == j[i].public_keys


def test_ed25519_engine_batch(ed_keyrings):
    """The JAX package's ``test_jax_engine_batch`` on TorchVerifyEngine:
    a quorum with one forged (all-zero) signature, one launch."""
    eng = TorchVerifyEngine(device="cpu", pad_sizes=(8,), scheme=ed)
    provs = {i: Ed25519CryptoProvider(ed_keyrings[i], engine=eng)
             for i in (1, 2, 3, 4)}
    prop = Proposal(payload=b"x")
    sigs = [provs[i].sign_proposal(prop, b"a%d" % i) for i in (1, 2, 3, 4)]
    sigs[2] = Signature(signer=3, value=b"\x00" * 64, msg=sigs[2].msg)
    auxes = provs[1].verify_consenter_sigs_batch(sigs, prop)
    assert auxes == [b"a1", b"a2", None, b"a4"]
    # the forged signature decodes, so all 4 items reach the one launch
    assert eng.stats.launches == 1 and eng.stats.sigs_verified == 4
    assert eng.route_launches == {"comb": 1, "generic": 0}
    assert provs[1].invalid_by_signer == {3: {"invalid_sig": 1}}


def test_ed25519_unregistrable_key_routes_to_generic(ed_keyrings):
    """A chunk holding a key the registry cannot take (here one that does
    not decode) runs the generic kernel; verdicts are verify_item's."""
    eng = TorchVerifyEngine(device="cpu", pad_sizes=(4,), scheme=ed)
    ring = ed_keyrings[1]
    good = ed.make_item(b"g", ed.sign_raw(ring.private_key, b"g"),
                        ring.public_keys[1])
    bad = ed.make_item(b"g", good[1], b"\xff" * 32)
    assert eng.verify([good]) == [True]
    assert eng.verify([good, bad]) == [jed.verify_item(good),
                                       jed.verify_item(bad)] == [True, False]
    assert eng.route_launches == {"comb": 1, "generic": 1}
    assert eng.rung_launches == {4: 2}


def test_ed25519_provider_checks_its_engine_and_keys(ed_keyrings):
    with pytest.raises(ValueError, match="scheme"):
        Ed25519CryptoProvider(ed_keyrings[1],
                              engine=TorchVerifyEngine(device="cpu"))
    ring = Keyring(1, ed_keyrings[1].private_key, {1: b"\xff" * 32})
    with pytest.raises(ValueError, match="invalid key"):
        Ed25519CryptoProvider(
            ring, engine=TorchVerifyEngine(device="cpu", scheme=ed))
    with pytest.raises(ValueError, match="no kernels"):
        TorchVerifyEngine(device="cpu", scheme=object())
    # no engine: the scheme's per-replica CPU verifier, not a fallback
    prov = Ed25519CryptoProvider(ed_keyrings[2])
    assert isinstance(prov.engine, HostVerifyEngine)
    assert prov.engine.scheme is ed


def test_ed25519_prewarm_runs_every_requested_rung():
    eng = TorchVerifyEngine(device="cpu", pad_sizes=(2, 4), scheme=ed)
    prewarm_verify_engine(eng, sizes=(2,))
    assert eng.rung_launches == {2: 1}
    assert eng.route_launches == {"comb": 1, "generic": 0}


# ---------------------------------------------------------------------------
# Configuration knobs of the verify plane: the mesh width and the flush
# hold, wired through each package's Configuration
# ---------------------------------------------------------------------------


def _wired_replica(pkg, **knobs):
    """One P-256 replica of ``pkg`` (the port or the JAX package) on host
    crypto, started and stopped on the logical clock with ``knobs`` set in
    its Configuration; returns (its App, its provider)."""
    app_mod = importlib.import_module(f"{pkg}.testing.app")
    network = importlib.import_module(f"{pkg}.testing.network")
    clock = importlib.import_module(f"{pkg}.utils.clock")
    prov_mod = importlib.import_module(f"{pkg}.crypto.provider")
    ring = prov_mod.Keyring.generate([1], seed=b"knobs")[1]
    provider = prov_mod.P256CryptoProvider(ring)
    cfg = dataclasses.replace(app_mod.fast_config(1), **knobs)
    app = app_mod.App(1, network.Network(seed=1), app_mod.SharedLedgers(),
                      clock.Scheduler(), config=cfg, use_metrics=True,
                      crypto=provider)

    async def run():
        await app.start()
        await app.stop()

    asyncio.run(run())
    return app, provider


def test_a_verify_mesh_wider_than_the_host_is_a_counted_downgrade(caplog):
    """verify_mesh_devices=16 over the tests' 8 virtual devices: both
    packages keep their engine, count one downgrade on the coalescer and
    in consensus.tpu.count_mesh_downgrades, and log it."""
    counts = {}
    for pkg in ("smartbft_tpu", "smartbft_tpu_torch"):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            app, provider = _wired_replica(pkg, verify_mesh_devices=16)
        co = provider.coalescer
        counts[pkg] = (co.mesh_downgrades, co.mesh_configured,
                       app.metrics.provider.counters.get(
                           "consensus.tpu.count_mesh_downgrades"),
                       co.mesh_snapshot()["downgrades"])
        assert co.engine is provider.engine
        assert "verify mesh UNBUILDABLE" in caplog.text
        assert "DOWNGRADED" in caplog.text
    assert counts["smartbft_tpu_torch"] == counts["smartbft_tpu"] \
        == (1, 16, 1, 1)


def test_a_verify_flush_hold_is_logged_not_dropped():
    """verify_flush_hold=0.05 reaches the replica's coalescer through its
    Configuration, with no wiring warning in its log, in the port as in
    the JAX package; 0 leaves the coalescer without a hold."""
    for pkg in ("smartbft_tpu", "smartbft_tpu_torch"):
        app, provider = _wired_replica(pkg, verify_flush_hold=0.05)
        assert provider.coalescer.hold == 0.05
        assert provider.coalescer.mesh_snapshot()["hold"]["hold_s"] == 0.05
        assert not app.logger.contains("flush-hold")
        app, provider = _wired_replica(pkg, verify_flush_hold=0.0)
        assert provider.coalescer.hold == 0.0
        assert not app.logger.contains("flush-hold")


@pytest.mark.parametrize("devices", [1, 8])
@pytest.mark.parametrize("topology", ["1d", "2d"])
def test_a_verify_mesh_the_host_has_graduates_in_both_packages(devices,
                                                               topology):
    """verify_mesh_devices=1 and 8 on the 8 virtual devices: both
    packages swap the replica's engine for their mesh engine of that
    width and topology, count no downgrade and report the same mesh
    block; only the JAX package installs a host fallback engine."""
    blocks = {}
    for pkg in ("smartbft_tpu", "smartbft_tpu_torch"):
        app, provider = _wired_replica(pkg, verify_mesh_devices=devices,
                                       verify_mesh_topology=topology)
        co = provider.coalescer
        parallel = importlib.import_module(f"{pkg}.parallel")
        want = {"1d": parallel.MeshVerifyEngine,
                "2d": parallel.QuorumMeshVerifyEngine}[topology]
        assert type(co.engine) is want and provider.engine is co.engine
        assert co.engine.devices == devices
        assert app.metrics.provider.gauges[
            "consensus.tpu.mesh_devices"] == float(devices)
        blocks[pkg] = co.mesh_snapshot()
        fallback = co.fallback_engine
        if pkg == "smartbft_tpu":
            assert type(fallback).__name__ == "HostVerifyEngine"
        else:
            assert fallback is None
    assert blocks["smartbft_tpu_torch"] == blocks["smartbft_tpu"]
    assert blocks["smartbft_tpu"]["downgrades"] == 0
    assert blocks["smartbft_tpu"]["topology"] == topology
