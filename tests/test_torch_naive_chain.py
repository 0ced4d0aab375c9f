"""The port's standalone embedder (``smartbft_tpu_torch.examples.
naive_chain``) against the cases of ``tests/test_naive_chain.py`` and
against the JAX package's example.

The example implements the whole SPI itself over its own channel mesh
with real P-256 commit votes and imports nothing of the test harness.
The reference's five cases run here as port counterparts: the pipelined
one on ``TorchVerifyEngine(device="cpu", pad_sizes=(4,))``, so the comb
kernel's plain version serves an embedder's quorum; the others on the
port's ``OpenSSLVerifyEngine`` (the plain version costs ~1 s a launch
on the CPU, and a block takes several).  One parity case orders the same
seeded transactions through both packages' examples, one transaction a
block, so block boundaries do not depend on timing: every node of both
must commit the same transactions in the same order into byte-identical
header chains."""

import ast
import asyncio
import hashlib
import pathlib
import sys
import time

import numpy as np

from smartbft_tpu_torch.codec import decode, encode
from smartbft_tpu_torch.crypto import p256
from smartbft_tpu_torch.crypto.openssl_engine import OpenSSLVerifyEngine
from smartbft_tpu_torch.crypto.provider import Keyring, TorchVerifyEngine
from smartbft_tpu_torch.examples import naive_chain
from smartbft_tpu_torch.utils.clock import Scheduler, WallClockDriver
from torch_reference import case_time_limit

ROOT = pathlib.Path(__file__).resolve().parent.parent

time_limit = case_time_limit(60)


def _nodes(mesh, scheduler, seed, tmp_path, engine, pipeline=1, mod=None):
    mod = mod or naive_chain
    rings = Keyring.generate([1, 2, 3, 4], seed=seed) if mod is naive_chain \
        else _jax_keyring().generate([1, 2, 3, 4], seed=seed)
    kw = {"engine": engine} if mod is naive_chain else {}
    return [mod.ChainNode(i, mesh, scheduler, rings[i],
                          str(tmp_path / f"{mod.__name__}-wal-{i}"),
                          pipeline=pipeline, **kw)
            for i in range(1, 5)]


def _jax_keyring():
    from smartbft_tpu.crypto.provider import Keyring as JKeyring

    return JKeyring


def _jax_example():
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import naive_chain as j_chain
    finally:
        sys.path.remove(str(ROOT / "examples"))
    return j_chain


async def _wait_heights(nodes, height, seconds=30.0):
    deadline = time.monotonic() + seconds
    while not all(len(n.blocks) >= height for n in nodes):
        if time.monotonic() > deadline:
            raise TimeoutError(f"heights {[len(n.blocks) for n in nodes]}")
        await asyncio.sleep(0.01)


def test_example_is_standalone():
    """The embedding story: zero imports from the test harness, and none
    of the JAX package."""
    tree = ast.parse(pathlib.Path(naive_chain.__file__).read_text())
    mods = [n.module for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom)] + [
        a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
        for a in n.names]
    assert not [m for m in mods if m and ".testing" in m]
    assert "smartbft_tpu_torch.crypto.provider" in mods
    assert not [m for m in mods if m and m.split(".")[0] == "smartbft_tpu"]


def test_naive_chain_orders_blocks():
    nodes = asyncio.run(naive_chain.main(
        num_blocks=5, engine=OpenSSLVerifyEngine(scheme=p256)))
    assert [len(n.blocks) for n in nodes] == [5, 5, 5, 5]
    for n in nodes:
        naive_chain.verify_chain(n)


def test_main_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    """With no card and no ``device="cpu"``, ``main`` raises as the
    engine does: there is no fallback."""
    import pytest
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        asyncio.run(naive_chain.main(num_blocks=1))


def test_naive_chain_per_block_ordering_all_nodes(tmp_path):
    """Submit blocks one at a time and require EVERY node to emit exactly
    that block — right sequence, right transactions — before the next."""

    async def run():
        scheduler = Scheduler()
        driver = WallClockDriver(scheduler, tick_interval=0.01)
        mesh = naive_chain.ChannelMesh()
        nodes = _nodes(mesh, scheduler, b"chain-e2e", tmp_path,
                       OpenSSLVerifyEngine(scheme=p256))
        listeners = []
        for n in nodes:
            q = asyncio.Queue()
            n.block_listeners.append(q)
            listeners.append(q)
        driver.start()
        for n in nodes:
            await n.start()
        try:
            for seq in range(1, 6):
                await nodes[0].submit("alice", f"tx{seq}", payload=b"")
                for node, q in zip(nodes, listeners):
                    header, txns = await asyncio.wait_for(q.get(), timeout=30)
                    assert header.sequence == seq, (node.id, header)
                    assert [decode(naive_chain.Transaction, t).tx_id
                            for t in txns] == [f"tx{seq}"], node.id
        finally:
            for n in nodes:
                await n.stop()
            await driver.stop()

    asyncio.run(run())


def test_naive_chain_pipelined_on_the_plain_comb_version(tmp_path):
    """The pipelined in-flight window through the public config surface
    alone (``pipeline=4``), every commit quorum verified by the comb
    kernel's plain version: a burst of 20 transactions (two full blocks
    at the example's batch of 10, both in flight at once) chains in order
    on every node, each transaction once."""
    engine = TorchVerifyEngine(device="cpu", pad_sizes=(4,))

    async def run():
        scheduler = Scheduler()
        driver = WallClockDriver(scheduler, tick_interval=0.01)
        mesh = naive_chain.ChannelMesh()
        nodes = _nodes(mesh, scheduler, b"chain-pipe", tmp_path, engine,
                       pipeline=4)
        driver.start()
        for n in nodes:
            await n.start()
        try:
            for k in range(20):
                await nodes[0].submit("bob", f"ptx{k}", payload=b"p")
            await _wait_heights(nodes, 2, seconds=50.0)
            for node in nodes:
                naive_chain.verify_chain(node)
            txs = [raw for _, transactions, _ in nodes[0].blocks
                   for raw in transactions]
            assert len(txs) == len(set(txs)), "duplicate tx across blocks"
        finally:
            for n in nodes:
                await n.stop()
            await driver.stop()

    asyncio.run(run())
    assert engine.route_launches["comb"] > 0
    assert engine.route_launches["generic"] == 0
    assert engine.stats.sigs_verified >= 2 * 3


def test_naive_chain_restart_mid_stream(tmp_path):
    """A follower restarts between blocks (WAL recovery through the real
    ``initialize_and_read_all`` path) and the chain keeps ordering on all
    four nodes afterwards."""

    async def run():
        scheduler = Scheduler()
        driver = WallClockDriver(scheduler, tick_interval=0.01)
        mesh = naive_chain.ChannelMesh()
        nodes = _nodes(mesh, scheduler, b"chain-restart", tmp_path,
                       OpenSSLVerifyEngine(scheme=p256))
        listener: asyncio.Queue = asyncio.Queue()
        nodes[0].block_listeners.append(listener)
        driver.start()
        for n in nodes:
            await n.start()
        try:
            async def order(k: int) -> None:
                await nodes[0].submit("alice", f"tx{k}", payload=b"")
                header, _ = await asyncio.wait_for(listener.get(), timeout=30)
                assert header.sequence == k

            for k in (1, 2, 3):
                await order(k)
            await _wait_heights(nodes, 3)
            follower = nodes[2]
            await follower.stop()
            await follower.start()
            for k in (4, 5):
                await order(k)
            await _wait_heights(nodes, 5)
            assert len(follower.blocks) == 5
            for i in range(1, len(follower.blocks)):
                want = hashlib.sha256(
                    encode(follower.blocks[i - 1][0])).digest()
                assert follower.blocks[i][0].prev_hash == want
            assert all(len(n.blocks) == 5 for n in nodes)
        finally:
            for n in nodes:
                await n.stop()
            await driver.stop()

    asyncio.run(run())


def _order_seeded(mod, tmp_path, txs, engine=None):
    """Order ``txs`` one a block through ``mod``'s example; returns every
    node's (encoded headers, transactions) once all hold them."""

    async def run():
        scheduler = Scheduler() if mod is naive_chain else \
            _jax_clock().Scheduler()
        driver = (WallClockDriver if mod is naive_chain
                  else _jax_clock().WallClockDriver)(scheduler,
                                                     tick_interval=0.01)
        mesh = mod.ChannelMesh()
        nodes = _nodes(mesh, scheduler, b"chain-parity", tmp_path, engine,
                       mod=mod)
        listener: asyncio.Queue = asyncio.Queue()
        nodes[0].block_listeners.append(listener)
        driver.start()
        for n in nodes:
            await n.start()
        try:
            for client, tx_id, payload in txs:
                await nodes[0].submit(client, tx_id, payload=payload)
                await asyncio.wait_for(listener.get(), timeout=30)
            await _wait_heights(nodes, len(txs))
        finally:
            for n in nodes:
                await n.stop()
            await driver.stop()
        return [([mod.encode(h) for h, _, _ in n.blocks],
                 [raw for _, t, _ in n.blocks for raw in t]) for n in nodes]

    return asyncio.run(run())


def _jax_clock():
    from smartbft_tpu.utils import clock

    return clock


def test_both_examples_commit_the_same_seeded_chain(tmp_path):
    rng = np.random.default_rng(2026)
    txs = [(f"client-{rng.integers(4)}", f"tx-{k}-{rng.integers(1 << 20)}",
            rng.bytes(int(rng.integers(0, 48)))) for k in range(3)]
    port = _order_seeded(naive_chain, tmp_path, txs,
                         OpenSSLVerifyEngine(scheme=p256))
    ref = _order_seeded(_jax_example(), tmp_path, txs)
    want = [encode(naive_chain.Transaction(client_id=c, tx_id=t, payload=p))
            for c, t, p in txs]
    for headers, committed in port + ref:
        assert committed == want
    assert {tuple(h) for h, _ in port} == {tuple(h) for h, _ in ref}
    assert len({tuple(h) for h, _ in port + ref}) == 1
    headers = [decode(naive_chain.BlockHeader, h) for h in port[0][0]]
    assert [h.sequence for h in headers] == [1, 2, 3]
    assert headers[0].prev_hash == b"genesis"
    for prev, cur in zip(port[0][0], headers[1:]):
        assert cur.prev_hash == hashlib.sha256(prev).digest()
