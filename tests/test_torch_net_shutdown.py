"""The graceful close of the socket transport and of the replica control
channel, in both packages.

Since Python 3.12, ``asyncio.Server.wait_closed()`` returns only once
every connection the server accepted is closed.  The JAX package's
``SocketComm.close()`` and ``ControlServer.close()`` await it before they
close the connections they accepted, so with a peer's link (or a control
client's pooled connection) open they never return.  The port closes
those connections first and then awaits the server.  Each case below
holds a live connection open, closes, and checks both outcomes: the
port's close returns within 2 s and leaves no task and no socket file;
the JAX package's does not return within 1 s (it is then torn down by
hand, so the case leaves nothing behind).  Last, a port cluster of four
replica processes stops gracefully: every process exits with code 0
well before ``SocketCluster.stop()``'s 10 s deadline, past which it
would SIGKILL the stragglers."""

import asyncio
import contextlib
import os
import random
import shutil
import tempfile
import time
import types

import numpy as np
import pytest

from smartbft_tpu import messages as j_messages
from smartbft_tpu.net import launch as j_launch
from smartbft_tpu.net import transport as j_transport
from smartbft_tpu.net.cluster import ControlClient as JControlClient
from smartbft_tpu_torch import messages as t_messages
from smartbft_tpu_torch.net import launch as t_launch
from smartbft_tpu_torch.net import transport as t_transport
from smartbft_tpu_torch.net.cluster import ControlClient as TControlClient
from smartbft_tpu_torch.net.cluster import SocketCluster
from torch_reference import case_time_limit

PACKAGES = {"port": (t_transport, t_launch, TControlClient, t_messages),
            "jax": (j_transport, j_launch, JControlClient, j_messages)}

time_limit = case_time_limit(60)


class _Sink:
    """The consensus intake of a transport under test."""

    def __init__(self):
        self.batches: list = []

    def handle_message_batch(self, items):
        self.batches.append(list(items))

    async def handle_request(self, sender, req):
        pass


async def _wait(pred, timeout=5.0):
    deadline = asyncio.get_running_loop().time() + timeout
    while not pred():
        assert asyncio.get_running_loop().time() < deadline, "timed out"
        await asyncio.sleep(0.01)


async def _tear_down(comm) -> None:
    """What the port's close does, done by hand to a JAX transport whose
    own close was cut off at the server's wait_closed."""
    for peer in comm._peers.values():
        if peer.wake is not None:
            peer.wake.set()
    await asyncio.gather(*[p.task for p in comm._peers.values() if p.task],
                         return_exceptions=True)
    for task in list(comm._reader_tasks):
        task.cancel()
    await asyncio.gather(*comm._reader_tasks, return_exceptions=True)
    for writer in list(comm._inbound_writers):
        writer.close()


@pytest.mark.parametrize("seed", [5, 23])
@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_socket_comm_close_with_a_live_link(pkg, seed):
    transport, Prepare = PACKAGES[pkg][0], PACKAGES[pkg][3].Prepare
    rng = np.random.default_rng(seed)
    sockdir = tempfile.mkdtemp(prefix="sbft-sd-", dir="/tmp")
    addrs = {1: f"uds://{sockdir}/s1.sock", 2: f"uds://{sockdir}/s2.sock"}

    async def run():
        a, b = (transport.SocketComm(
            i, addrs[i], {j: addrs[j] for j in addrs if j != i},
            cluster_key=b"shutdown", backoff_base=0.01, backoff_max=0.05,
            rng=random.Random(seed + i)) for i in (1, 2))
        sinks = {1: _Sink(), 2: _Sink()}
        a.attach(sinks[1])
        b.attach(sinks[2])
        await a.start()
        await b.start()
        seq = int(rng.integers(1, 1 << 20))
        digest = rng.bytes(16).hex()
        a.send_consensus(2, Prepare(view=1, seq=seq, digest=digest))
        b.send_consensus(1, Prepare(view=1, seq=seq + 1, digest=digest))
        await _wait(lambda: sinks[1].batches and sinks[2].batches)
        assert sinks[2].batches[0][0][1].seq == seq
        # both directed links are up: a holds b's inbound connection open
        assert a._inbound_writers and b._inbound_writers

        close = asyncio.ensure_future(a.close())
        done, _ = await asyncio.wait({close}, timeout=2.0 if pkg == "port"
                                     else 1.0)
        if pkg == "port":
            assert close in done, "the port's close did not return in 2 s"
            await asyncio.wait_for(b.close(), 2.0)
            leftovers = [t for t in asyncio.all_tasks()
                         if t is not asyncio.current_task()]
            assert not leftovers, [t.get_name() for t in leftovers]
            for comm in (a, b):
                assert comm._server is None and not comm._reader_tasks
                assert not comm._inbound_writers
                assert all(p.task is None for p in comm._peers.values())
            assert os.listdir(sockdir) == []
        else:
            assert close not in done, "the JAX package's close returned"
            close.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await close
            await _tear_down(a)
            await asyncio.wait_for(b.close(), 5.0)

    try:
        asyncio.run(run())
    finally:
        shutil.rmtree(sockdir, ignore_errors=True)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_control_server_close_with_a_pooled_client(pkg):
    _, launch, client_cls, _ = PACKAGES[pkg]
    sockdir = tempfile.mkdtemp(prefix="sbft-sc-", dir="/tmp")
    addr = f"uds://{sockdir}/c1.sock"
    replica = types.SimpleNamespace(consensus=None, id=7)

    async def run():
        server = launch.ControlServer(replica, addr, asyncio.Event())
        await server.start()
        client = client_cls(addr, timeout=5.0)
        try:
            for _ in range(2):
                pong = await asyncio.to_thread(client.call, cmd="ping")
                assert pong["node_id"] == 7 and pong["running"] is False
            # one connection, kept open by the client's pool
            assert client.stats["connects"] == 1
            assert client.stats["reuses"] == 1

            close = asyncio.ensure_future(server.close())
            done, _ = await asyncio.wait(
                {close}, timeout=2.0 if pkg == "port" else 1.0)
            if pkg == "port":
                assert close in done, "the port's close did not return in 2 s"
                assert not os.path.exists(f"{sockdir}/c1.sock")
                leftovers = [t for t in asyncio.all_tasks()
                             if t is not asyncio.current_task()]
                assert not leftovers, [t.get_name() for t in leftovers]
            else:
                assert close not in done, "the JAX package's close returned"
                close.cancel()
                with contextlib.suppress(asyncio.CancelledError):
                    await close
                client.close()
                await asyncio.wait_for(server.close(), 5.0)
        finally:
            client.close()

    try:
        asyncio.run(run())
    finally:
        shutil.rmtree(sockdir, ignore_errors=True)


def test_process_cluster_stops_gracefully(tmp_path):
    cluster = SocketCluster(tmp_path, n=4, transport="uds")
    try:
        cluster.start()
        leader = cluster.wait_leader()
        cluster.submit(leader, "stop", "req-0")
        cluster.wait_committed(1, timeout=30.0)
        cluster.check_fork_free()
    finally:
        t0 = time.monotonic()
        cluster.stop()
        stopped_s = time.monotonic() - t0
    codes = {i: h.proc.returncode for i, h in cluster.replicas.items()}
    assert codes == {1: 0, 2: 0, 3: 0, 4: 0}
    assert stopped_s < 8.0, stopped_s
