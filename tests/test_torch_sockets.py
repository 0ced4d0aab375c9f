"""The socket path with real crypto, held against the JAX package.

First n = 4 replicas in one process, each on its own ``SocketComm`` over
Unix-domain sockets, voting with P-256 through one shared dedupe
coalescer onto ``TorchVerifyEngine(device="cpu")`` (the comb kernel's
plain version), against the JAX package's in-process cluster (its
``Network``, host P-256 verifier) fed the same seeded requests.  Frames
cross real kernel sockets, so arrival order, and with it which quorum of
commit signatures each leader chains, is not the in-process network's:
what must match is the committed request set, and within the socket
cluster every replica's ledger.

Then the process-per-replica cluster: four ``python -m
smartbft_tpu_torch.net.launch`` processes over UDS, the leader SIGKILLed
mid-burst and respawned (``kill_rejoin_schedule``).  All 16 requests
commit fork-free, the restarted replica catches up by wire sync, and at
``stop()`` every replica exits with code 0: the graceful close ends
without the SIGKILL that reaps a replica still running at the deadline.
Its wall-clock schedule takes ~9 s, so it is marked slow;
``tests/test_torch_net_shutdown.py`` checks the exit codes of a process
cluster's graceful stop among the cases that are not slow."""

import asyncio
import dataclasses
import shutil
import tempfile

import numpy as np
import pytest
import torch

from smartbft_tpu.crypto import provider as jprov
from smartbft_tpu.testing import app as japp
from smartbft_tpu.testing.network import Network as JNetwork
from smartbft_tpu.utils.clock import Scheduler as JScheduler
from smartbft_tpu_torch.crypto import provider as tprov
from smartbft_tpu_torch.net.cluster import (
    SocketCluster,
    kill_rejoin_schedule,
    run_socket_schedule,
)
from smartbft_tpu_torch.net.transport import SocketComm
from smartbft_tpu_torch.snapshot import CHAIN_SEED, chain_update
from smartbft_tpu_torch.testing import app as tapp
from smartbft_tpu_torch.utils.clock import Scheduler as TScheduler
from torch_reference import case_time_limit

torch.set_num_threads(1)

NODES = [1, 2, 3, 4]
REQUESTS = 8
BATCH = 2

time_limit = case_time_limit(60)


def _requests(seed: int):
    rng = np.random.default_rng(seed)
    return [(f"c{int(rng.integers(0, 4))}", f"r{k}-{int(rng.integers(1 << 30))}",
             rng.bytes(int(rng.integers(1, 24)))) for k in range(REQUESTS)]


def _cfg(fast_config, i):
    # timeouts scaled ~1000x: the logical clock races ahead of the real
    # time a verify launch (and a socket round trip) takes
    return dataclasses.replace(
        fast_config(i), leader_rotation=False, decisions_per_leader=0,
        pipeline_depth=4, request_batch_max_count=BATCH,
        request_forward_timeout=1000.0, request_complain_timeout=2000.0,
        request_auto_remove_timeout=30000.0,
        view_change_resend_interval=1000.0, view_change_timeout=10000.0,
        leader_heartbeat_timeout=15000.0)


async def _commit(mod_app, apps, sched, requests):
    for a in apps:
        await a.start()
    for client, rid, payload in requests:
        await apps[0].submit(client, rid, payload)

    def done(a):
        return sum(len(a.requests_from_proposal(d.proposal))
                   for d in a.ledger()) >= len(requests)

    await mod_app.wait_for(lambda: all(done(a) for a in apps), sched,
                           timeout=100000.0)
    out = {}
    for a in apps:
        ids = [str(r) for d in a.ledger()
               for r in a.requests_from_proposal(d.proposal)]
        h = CHAIN_SEED
        for d in a.ledger():
            h = chain_update(h, d.proposal.payload, d.proposal.metadata)
        out[a.id] = (tuple(ids), h.hex())
    return out


def _jax_inprocess(requests, wal_dir):
    rings = jprov.Keyring.generate(NODES, seed=b"sockets")

    async def main():
        sched = JScheduler()
        net = JNetwork(seed=7)
        shared = japp.SharedLedgers()
        apps = [japp.App(i, net, shared, sched,
                         wal_dir=str(wal_dir / f"wal-{i}"),
                         config=_cfg(japp.fast_config, i),
                         crypto=jprov.P256CryptoProvider(rings[i]))
                for i in NODES]
        out = await _commit(japp, apps, sched, requests)
        for a in apps:
            await a.stop()
        return out

    return asyncio.run(main())


def _port_sockets(requests, wal_dir):
    rings = tprov.Keyring.generate(NODES, seed=b"sockets")
    engine = tprov.TorchVerifyEngine(device="cpu", pad_sizes=(4,))
    co = tprov.AsyncBatchCoalescer(engine, window=0.002,
                                   max_batch=2 * 4 * 16384, dedupe=True)
    sockdir = tempfile.mkdtemp(prefix="sbft-ts-", dir="/tmp")
    addrs = {i: f"uds://{sockdir}/n{i}.sock" for i in NODES}

    async def main():
        sched = TScheduler()
        shared = tapp.SharedLedgers()
        apps = []
        for i in NODES:
            comm = SocketComm(i, addrs[i],
                              {j: a for j, a in addrs.items() if j != i},
                              cluster_key=b"sockets", backoff_base=0.01,
                              backoff_max=0.2)
            apps.append(tapp.App(
                i, None, shared, sched, wal_dir=str(wal_dir / f"wal-{i}"),
                config=_cfg(tapp.fast_config, i), comm=comm,
                crypto=tprov.P256CryptoProvider(rings[i], engine=engine,
                                                coalescer=co)))
        out = await _commit(tapp, apps, sched, requests)
        transport = {a.id: a.comm.transport_snapshot() for a in apps}
        for a in apps:
            await a.stop()
        leftovers = [t.get_name() for t in asyncio.all_tasks()
                     if t is not asyncio.current_task()]
        return out, transport, leftovers

    try:
        out, transport, leftovers = asyncio.run(main())
    finally:
        shutil.rmtree(sockdir, ignore_errors=True)
    return out, transport, leftovers, engine, co


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    requests = _requests(13)
    jax_run = _jax_inprocess(requests, tmp_path_factory.mktemp("jax"))
    port = _port_sockets(requests, tmp_path_factory.mktemp("port"))
    return requests, jax_run, port


def test_the_same_requests_commit_over_sockets(runs):
    requests, jax_run, (port_run, *_) = runs
    want = {f"{c}:{r}" for c, r, _ in requests}
    assert len(want) == REQUESTS
    for node in NODES:
        assert sorted(jax_run[node][0]) == sorted(want)
        assert sorted(port_run[node][0]) == sorted(want)
        assert len(port_run[node][0]) == REQUESTS


def test_every_socket_replica_holds_the_same_ledger(runs):
    _, jax_run, (port_run, *_) = runs
    assert len({port_run[n] for n in NODES}) == 1
    assert len({jax_run[n] for n in NODES}) == 1


def test_the_votes_crossed_sockets_and_the_comb_path(runs):
    _, _, (_, transport, leftovers, engine, co) = runs
    for node, snap in transport.items():
        assert snap["flush_batches"] > 0 and snap["frames_sent"] > 0, node
        assert snap["malformed_frames"] == 0 and snap["outbox_dropped"] == 0
        assert snap["peers_connected"] == len(NODES) - 1
    assert not leftovers
    assert engine.route_launches["comb"] >= 1
    assert engine.route_launches["generic"] == 0
    snap = co.fault_snapshot()
    assert snap["opens"] == 0 and snap["launch_failures"] == 0


@pytest.mark.slow
def test_process_cluster_kill_and_rejoin_exits_cleanly(tmp_path):
    cluster = SocketCluster(tmp_path, n=4, transport="uds")
    try:
        cluster.start()
        cluster.wait_leader()
        report = run_socket_schedule(cluster, kill_rejoin_schedule(),
                                     requests=16)
        heights = cluster.heights()
    finally:
        cluster.stop()
    assert [a for a, _ in report.events_fired] == ["crash", "restart"]
    assert report.final_committed >= 16
    assert len(set(heights.values())) == 1, heights
    codes = {i: h.proc.returncode for i, h in cluster.replicas.items()}
    assert codes == {i: 0 for i in NODES}
