"""The slice as a whole: the port's n=4 cluster (pipeline depth 4, real
P-256 votes through one shared dedupe coalescer onto TorchVerifyEngine's
plain-torch path) against the JAX package's cluster (HostVerifyEngine) on
the same seeded logical-clock workload; then the same for Ed25519 votes
(BASELINE configs[3]) on ``TorchVerifyEngine(scheme=ed25519)``.

What is compared: the ordered committed request ids at every replica of
both clusters, and the chained ledger digest over (payload, metadata) of
every decision.  The digest covers each decision's metadata, which chains
the digest of the previous decision's commit signatures, so it is only
reproducible with deterministic signatures: both clusters sign with RFC
6979 here (SMARTBFT_DETERMINISTIC_SIGN=1), under which two runs of the JAX
cluster give the same digest, and so must the port.  Ed25519 signing
(RFC 8032) is deterministic by construction, so its run needs no
environment variable.
"""

import asyncio
import dataclasses

import pytest
import torch

from smartbft_tpu.crypto import ed25519 as jed
from smartbft_tpu.crypto import provider as jprov
from smartbft_tpu.snapshot import CHAIN_SEED, chain_update
from smartbft_tpu.testing import app as japp
from smartbft_tpu.testing.network import Network as JNetwork
from smartbft_tpu.utils.clock import Scheduler as JScheduler
from smartbft_tpu_torch.crypto import ed25519 as ted
from smartbft_tpu_torch.crypto import provider as tprov
from smartbft_tpu_torch.testing import app as tapp
from smartbft_tpu_torch.testing.network import Network as TNetwork
from smartbft_tpu_torch.utils.clock import Scheduler as TScheduler

# small plain-torch tensors gain nothing from intra-op threads, and the
# suite runs in parallel worker processes
torch.set_num_threads(1)

NODES = [1, 2, 3, 4]
DECISIONS = 8
BATCH = 2


def _cfg(fast_config, i):
    # timeouts scaled ~1000x: the logical clock races ahead of the real
    # time a verify launch takes, and default timeouts would depose a
    # healthy leader mid-verify
    return dataclasses.replace(
        fast_config(i), leader_rotation=False, decisions_per_leader=0,
        pipeline_depth=4, request_batch_max_count=BATCH,
        request_forward_timeout=1000.0, request_complain_timeout=2000.0,
        request_auto_remove_timeout=30000.0,
        view_change_resend_interval=1000.0, view_change_timeout=10000.0,
        leader_heartbeat_timeout=15000.0)


def _run(mod_app, Network, Scheduler, rings, make_crypto, wal_dir):
    async def main():
        sched = Scheduler()
        net = Network(seed=7)
        shared = mod_app.SharedLedgers()
        apps = [mod_app.App(i, net, shared, sched,
                            wal_dir=str(wal_dir / f"wal-{i}"),
                            config=_cfg(mod_app.fast_config, i),
                            crypto=make_crypto(i))
                for i in NODES]
        for a in apps:
            await a.start()
        for k in range(DECISIONS * BATCH):
            await apps[0].submit("client", f"req-{k}")

        def done(a):
            return sum(len(a.requests_from_proposal(d.proposal))
                       for d in a.ledger()) >= DECISIONS * BATCH

        await mod_app.wait_for(lambda: all(done(a) for a in apps), sched,
                               timeout=100000.0)
        out = {}
        for a in apps:
            ids = [[str(r) for r in a.requests_from_proposal(d.proposal)]
                   for d in a.ledger()]
            h = CHAIN_SEED
            for d in a.ledger():
                h = chain_update(h, d.proposal.payload, d.proposal.metadata)
            out[a.id] = (ids, h.hex())
        for a in apps:
            await a.stop()
        return out

    return asyncio.run(main())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("SMARTBFT_DETERMINISTIC_SIGN", "1")
    try:
        jrings = jprov.Keyring.generate(NODES, seed=b"slice")
        jax_run = _run(japp, JNetwork, JScheduler, jrings,
                       lambda i: jprov.P256CryptoProvider(jrings[i]),
                       tmp_path_factory.mktemp("jax"))
        trings = tprov.Keyring.generate(NODES, seed=b"slice")
        engine = tprov.TorchVerifyEngine(device="cpu")
        co = tprov.AsyncBatchCoalescer(engine, window=0.002,
                                       max_batch=2 * 4 * 16384, dedupe=True)
        torch_run = _run(tapp, TNetwork, TScheduler, trings,
                         lambda i: tprov.P256CryptoProvider(
                             trings[i], engine=engine, coalescer=co),
                         tmp_path_factory.mktemp("torch"))
    finally:
        mp.undo()
    return jax_run, torch_run, engine, co


def test_keyrings_match():
    j = jprov.Keyring.generate(NODES, seed=b"slice")
    t = tprov.Keyring.generate(NODES, seed=b"slice")
    for i in NODES:
        assert j[i].private_key == t[i].private_key
        assert j[i].public_keys == t[i].public_keys


@pytest.mark.parametrize("node", NODES)
def test_same_ordered_request_ids_at_every_replica(runs, node):
    jax_run, torch_run, _, _ = runs
    want = [[f"client:req-{k}" for k in range(b * BATCH, (b + 1) * BATCH)]
            for b in range(DECISIONS)]
    assert jax_run[node][0] == want
    assert torch_run[node][0] == jax_run[node][0]


@pytest.mark.parametrize("node", NODES)
def test_same_ledger_digest_at_every_replica(runs, node):
    jax_run, torch_run, _, _ = runs
    assert torch_run[node][1] == jax_run[node][1] == jax_run[NODES[0]][1]


def test_port_cluster_verified_on_the_comb_path(runs):
    _, _, engine, co = runs
    assert engine.route_launches["comb"] >= 1
    assert engine.route_launches["generic"] == 0
    snap = co.fault_snapshot()
    assert snap["opens"] == 0 and snap["host_fallback_batches"] == 0
    assert snap["launch_failures"] == 0


# ---------------------------------------------------------------------------
# Ed25519 (BASELINE configs[3])
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ed_runs(tmp_path_factory):
    jrings = jprov.Keyring.generate(NODES, seed=b"slice-ed", scheme=jed)
    jax_run = _run(japp, JNetwork, JScheduler, jrings,
                   lambda i: jprov.Ed25519CryptoProvider(
                       jrings[i], engine=jprov.HostVerifyEngine(scheme=jed)),
                   tmp_path_factory.mktemp("jax-ed"))
    trings = tprov.Keyring.generate(NODES, seed=b"slice-ed", scheme=ted)
    engine = tprov.TorchVerifyEngine(device="cpu", scheme=ted)
    co = tprov.AsyncBatchCoalescer(engine, window=0.002,
                                   max_batch=2 * 4 * 16384, dedupe=True)
    torch_run = _run(tapp, TNetwork, TScheduler, trings,
                     lambda i: tprov.Ed25519CryptoProvider(
                         trings[i], engine=engine, coalescer=co),
                     tmp_path_factory.mktemp("torch-ed"))
    return jax_run, torch_run, engine, co


@pytest.mark.parametrize("node", NODES)
def test_ed25519_same_ordered_request_ids_at_every_replica(ed_runs, node):
    jax_run, torch_run, _, _ = ed_runs
    want = [[f"client:req-{k}" for k in range(b * BATCH, (b + 1) * BATCH)]
            for b in range(DECISIONS)]
    assert jax_run[node][0] == want
    assert torch_run[node][0] == jax_run[node][0]


@pytest.mark.parametrize("node", NODES)
def test_ed25519_same_ledger_digest_at_every_replica(ed_runs, node):
    jax_run, torch_run, _, _ = ed_runs
    assert torch_run[node][1] == jax_run[node][1] == jax_run[NODES[0]][1]


def test_ed25519_cluster_verified_on_the_comb_path(ed_runs):
    _, _, engine, co = ed_runs
    assert engine.scheme is ted
    assert engine.route_launches["comb"] >= 1
    assert engine.route_launches["generic"] == 0
    assert engine.stats.sigs_verified > 0
    snap = co.fault_snapshot()
    assert snap["opens"] == 0 and snap["host_fallback_batches"] == 0
    assert snap["launch_failures"] == 0
