"""Sharded mode end to end: the port's ``ShardedCluster`` (S consensus
groups over one shared verify coalescer, ``testing/sharded.py``) against
the JAX package's, on the logical ``Scheduler`` with the same seeds.

What is compared, per shard: the ordered committed request ids at every
replica, the chained ledger digest over (payload, metadata) of every
decision (one per shard, the same in both packages), and the items each
shard submitted to the shared coalescer (``shard_snapshot()``'s per-tag
items).  How those items fall into waves depends on wall-clock arrival
inside the coalescer's window, so wave counts are checked for shape, not
equality.  Crypto modes: ``trivial`` (always-valid host engine),
``p256`` (the port on ``TorchVerifyEngine(device="cpu")``, the comb
kernel's plain version; the JAX package on its ``HostVerifyEngine``),
``ed25519`` and ``toy`` (host engines in both).  Then a live reshard from
2 to 3 shards, the shared breaker's hang -> host fallback -> heal ->
canary cycle over ``FaultyEngine``, ``toy_scheme.verify_kernel`` as a
torch expression against the JAX one, and the reference's cluster cases
(``tests/test_sharded.py`` from its network-namespacing cases on) run
against the port.
"""

import asyncio
import importlib
import time

import numpy as np
import pytest
import torch

from torch_reference import reference_tests

# small plain-torch tensors gain nothing from intra-op threads, and the
# suite runs in parallel worker processes
torch.set_num_threads(1)

PACKAGES = ("smartbft_tpu", "smartbft_tpu_torch")
SHARDS, NODES, DEPTH = 2, 4, 4


def _mods(pkg):
    return (importlib.import_module(f"{pkg}.testing.sharded"),
            importlib.import_module(f"{pkg}.testing.app"),
            importlib.import_module(f"{pkg}.snapshot"))


def _config(sharded):
    # timeouts scaled ~1000x: the logical clock races ahead of the real
    # time a plain-torch verify launch takes, and the default timeouts
    # would depose a healthy leader mid-verify
    return lambda s, i: sharded.sharded_config(
        i, depth=DEPTH, request_forward_timeout=1000.0,
        request_complain_timeout=2000.0, request_auto_remove_timeout=30000.0,
        view_change_resend_interval=1000.0, view_change_timeout=10000.0,
        leader_heartbeat_timeout=15000.0)


def _ledgers(cluster, snapshot):
    """Per shard: each replica's (ordered request ids, ledger digest)."""
    out = {}
    for sh in cluster.shard_list:
        per_app = []
        for a in sh.live_apps():
            ids = [[str(r) for r in a.requests_from_proposal(d.proposal)]
                   for d in a.ledger()]
            h = snapshot.CHAIN_SEED
            for d in a.ledger():
                h = snapshot.chain_update(h, d.proposal.payload,
                                          d.proposal.metadata)
            per_app.append((ids, h.hex()))
        out[sh.shard_id] = per_app
    return out


def _run(pkg, mode, wal_root, per_shard):
    sharded, app, snapshot = _mods(pkg)
    engine = None
    if pkg == "smartbft_tpu_torch" and mode in ("p256", "ed25519"):
        # the port's default engine for these modes runs on the card
        from smartbft_tpu_torch.crypto import ed25519
        from smartbft_tpu_torch.crypto.provider import (
            HostVerifyEngine,
            TorchVerifyEngine,
        )

        engine = TorchVerifyEngine(device="cpu") if mode == "p256" \
            else HostVerifyEngine(scheme=ed25519)

    async def main():
        c = sharded.ShardedCluster(wal_root, shards=SHARDS, n=NODES,
                                   depth=DEPTH, crypto=mode, engine=engine,
                                   config_fn=_config(sharded))
        await c.start()
        try:
            for j in range(per_shard):
                for s in range(SHARDS):
                    await c.submit(c.client_for_shard(s, j % 2), f"r{s}-{j}")
            await app.wait_for(
                lambda: all(sh.committed() >= per_shard
                            for sh in c.shard_list),
                c.scheduler, 100000.0)
            c.check_invariants()
            return {"ledgers": _ledgers(c, snapshot),
                    "tags": c.coalescer.shard_snapshot(),
                    "breaker": c.coalescer.fault_snapshot(),
                    "engine": c.engine}
        finally:
            await c.stop()

    return asyncio.run(main())


#: requests a shard commits per mode (batches of 2 requests a decision);
#: the plain-torch P-256 and the host Ed25519 verifies cost seconds
PER_SHARD = {"trivial": 8, "p256": 4, "ed25519": 2, "toy": 8}


@pytest.fixture(scope="module", params=list(PER_SHARD))
def runs(request, tmp_path_factory):
    mode = request.param
    mp = pytest.MonkeyPatch()
    mp.setenv("SMARTBFT_DETERMINISTIC_SIGN", "1")
    try:
        out = {pkg: _run(pkg, mode, str(tmp_path_factory.mktemp(pkg)),
                         PER_SHARD[mode]) for pkg in PACKAGES}
    finally:
        mp.undo()
    return mode, out


def test_same_committed_ids_and_ledger_digest_per_shard(runs):
    mode, out = runs
    jax_l, torch_l = (out[p]["ledgers"] for p in PACKAGES)
    assert sorted(torch_l) == sorted(jax_l) == list(range(SHARDS))
    for s in range(SHARDS):
        # every request once, in submission order, two a decision
        ids = jax_l[s][0][0]
        assert [r.split(":")[1] for d in ids for r in d] == \
            [f"r{s}-{j}" for j in range(PER_SHARD[mode])]
        assert all(len(d) == 2 for d in ids)
        assert torch_l[s] == jax_l[s]
        # every replica of a shard holds one chained ledger
        assert len(torch_l[s]) == NODES
        assert len({h for _, h in torch_l[s]}) == 1
    # the shards' ledgers are their own
    assert torch_l[0][0][1] != torch_l[1][0][1]


def test_same_items_per_shard_through_the_shared_coalescer(runs):
    mode, out = runs
    jax_t, torch_t = (out[p]["tags"] for p in PACKAGES)
    assert set(torch_t["per_tag"]) == {"0", "1"}
    assert {k: v["items"] for k, v in torch_t["per_tag"].items()} == \
        {k: v["items"] for k, v in jax_t["per_tag"].items()}
    for snap in (jax_t, torch_t):
        assert snap["waves"] >= 1
        assert snap["tagged_waves"] == snap["waves"]
        assert 0 <= snap["mixed_waves"] <= snap["waves"]
        assert sum(v["waves"] for v in snap["per_tag"].values()) \
            == snap["waves"] + snap["mixed_waves"]
    br = out["smartbft_tpu_torch"]["breaker"]
    assert br["opens"] == 0 and br["host_fallback_batches"] == 0
    engine = out["smartbft_tpu_torch"]["engine"]
    if mode == "p256":
        # the port's P-256 mode ran the comb kernel's plain version only,
        # one engine call a wave (dedupe may fold repeats)
        assert engine.route_launches["generic"] == 0
        assert engine.route_launches["comb"] == torch_t["waves"]
        assert 0 < engine.stats.sigs_verified <= sum(
            v["items"] for v in torch_t["per_tag"].values())


# ---------------------------------------------------------- live reshard

def _reshard_run(pkg, wal_root):
    sharded, app, snapshot = _mods(pkg)

    async def main():
        c = sharded.ShardedCluster(wal_root, shards=2, n=4, depth=2, seed=7,
                                   collect_entries=True,
                                   reshard_drain_deadline=120.0)
        await c.start()
        try:
            for j in range(4):
                for s in range(2):
                    await c.submit(c.client_for_shard(s, j % 2), f"a{s}-{j}")
            await app.wait_for(
                lambda: all(sh.committed() >= 4 for sh in c.shard_list),
                c.scheduler, 1000.0)
            task = asyncio.ensure_future(c.reshard(3))
            await app.wait_for(task.done, c.scheduler, 1000.0)
            summary = task.result()
            for j in range(4):
                for s in range(3):
                    await c.submit(c.client_for_shard(s, j % 2), f"b{s}-{j}")
            want = {0: 8, 1: 8, 2: 4}
            await app.wait_for(
                lambda: all(c.committed_requests(s) >= n
                            for s, n in want.items()),
                c.scheduler, 1000.0)
            c.check_invariants()
            per_shard = {}
            for e in c.delivered_entries:
                per_shard.setdefault(e.shard_id, []).append(
                    (e.seq, e.epoch, e.request_ids))
            return {"streams": per_shard,
                    "watermarks": c.set.mux.snapshot()["watermarks"],
                    "summary": {k: v for k, v in summary.items()
                                if not k.endswith("_ms")},
                    "epoch": c.set.epoch, "ledgers": _ledgers(c, snapshot)}
        finally:
            await c.stop()

    return asyncio.run(main())


def test_live_reshard_2_to_3_matches(tmp_path):
    """A live reshard from 2 shards to 3 between two bursts: the same epoch
    watermarks, transition summary, per-shard delivered stream and
    per-shard ledgers in both packages.  (The combined stream interleaves
    shards in wall-clock arrival order, so it is compared shard by shard.)"""
    jax_r, torch_r = (_reshard_run(p, str(tmp_path / p)) for p in PACKAGES)
    assert torch_r["epoch"] == jax_r["epoch"] == 1
    assert torch_r["watermarks"] == jax_r["watermarks"]
    assert jax_r["watermarks"][0]["shards"] == [0, 1, 2]
    assert torch_r["summary"] == jax_r["summary"]
    assert torch_r["summary"]["handoffs"] == {2: 0}
    assert torch_r["streams"] == jax_r["streams"]
    assert sorted(torch_r["streams"]) == [0, 1, 2]
    # the barrier committed in both old shards, under epoch 0
    for s in (0, 1):
        assert any("__reshard__:reshard-e1" in ids and ep == 0
                   for _, ep, ids in torch_r["streams"][s])
    assert torch_r["ledgers"] == jax_r["ledgers"]


# ------------------------------------------------------- the shared breaker

def _breaker_run(pkg, wal_root):
    sharded, app, snapshot = _mods(pkg)

    def cfg(s, i):
        return sharded.sharded_config(
            i, depth=4, request_forward_timeout=120.0,
            request_complain_timeout=240.0, request_auto_remove_timeout=480.0,
            leader_heartbeat_timeout=30.0, view_change_resend_interval=15.0,
            view_change_timeout=60.0, verify_launch_timeout=0.15,
            verify_launch_retries=2, verify_breaker_threshold=3,
            verify_probe_interval=0.05)

    async def main():
        c = sharded.ShardedCluster(wal_root, shards=2, n=4, depth=4,
                                   engine_faults=True, config_fn=cfg, seed=31)
        await c.start()
        try:
            for s in range(2):
                await c.submit(c.client_for_shard(s), f"warm-{s}a")
                await c.submit(c.client_for_shard(s, 1), f"warm-{s}b")
            await app.wait_for(
                lambda: all(sh.committed() >= 2 for sh in c.shard_list),
                c.scheduler, 60.0)
            c.engine.hang()
            for s in range(2):
                for j in range(4):
                    await c.submit(c.client_for_shard(s, j % 2), f"out-{s}-{j}")
            await app.wait_for(
                lambda: all(sh.committed() >= 6 for sh in c.shard_list),
                c.scheduler, 120.0)
            during = c.coalescer.fault_snapshot()
            c.engine.heal()
            deadline = time.monotonic() + 8.0
            while c.coalescer.breaker_open and time.monotonic() < deadline:
                await asyncio.sleep(0.02)
            c.check_invariants()
            committed = {sh.shard_id: sorted(
                str(r) for d in sh.probe_app().ledger()
                for r in sh.probe_app().requests_from_proposal(d.proposal))
                for sh in c.shard_list}
            return {"during": during, "after": c.coalescer.fault_snapshot(),
                    "open": c.coalescer.breaker_open,
                    "tags": c.coalescer.shard_snapshot(),
                    "committed": committed,
                    "hangs": c.engine.injected_hangs}
        finally:
            await c.stop()

    return asyncio.run(main())


def test_breaker_cycle_over_faulty_engine_matches(tmp_path):
    """The shared plane's outage cycle: a hung engine trips the breaker
    once for both shards, both commit through it on the host fallback,
    and after the heal the canary probe closes it.  Both packages commit
    the same requests in each shard (the commit order inside the outage
    follows wall-clock deadlines, so the sets are compared)."""
    jax_r, torch_r = (_breaker_run(p, str(tmp_path / p)) for p in PACKAGES)
    for r in (jax_r, torch_r):
        assert r["hangs"] == 1
        assert r["during"]["opens"] >= 1
        assert r["during"]["host_fallback_batches"] >= 1
        assert r["during"]["launch_timeouts"] >= 1
        assert not r["open"]
        assert r["after"]["closes"] >= 1
        assert r["after"]["probe_successes"] >= 1
        assert set(r["tags"]["per_tag"]) == {"0", "1"}
    assert torch_r["committed"] == jax_r["committed"]
    assert all(len(v) == 6 for v in torch_r["committed"].values())


# ------------------------------------------------------------ toy scheme

def test_toy_verify_kernel_matches_the_jax_one():
    """The toy scheme's batched verify: one torch expression against the
    JAX package's, on a seeded batch with forged lanes (a flipped word, a
    wrong key, a wrong-length signature), on the words ``verify_inputs``
    packs, including sums that wrap mod 2^32."""
    from smartbft_tpu.testing import toy_scheme as jtoy
    from smartbft_tpu_torch.testing import toy_scheme as ttoy

    rng = np.random.default_rng(20261017)
    items, truth = [], []
    for k in range(96):
        sk, pub = ttoy.keygen(b"toy-%d" % k)
        msg = rng.bytes(int(rng.integers(1, 64)))
        sig = bytearray(ttoy.sign_raw(sk, msg))
        forge = k % 4
        if forge == 1:
            sig[int(rng.integers(16))] ^= 1 << int(rng.integers(8))
        elif forge == 2:
            pub = (pub + 1) & 0xFFFFFFFF
        elif forge == 3 and k % 8 == 3:
            sig = sig[:12]
        items.append(ttoy.make_item(msg, bytes(sig), pub))
        truth.append(forge == 0 or (forge == 3 and k % 8 != 3))
    d, s, key = ttoy.verify_inputs(items)
    for a, b in zip((d, s, key), jtoy.verify_inputs(items)):
        assert np.array_equal(a, b)
    key[:8] = 0xFFFFFFFF  # force the wrap on the first lanes
    s[:8] = ((d[:8].astype(np.uint64) + 0xFFFFFFFF) & 0xFFFFFFFF).astype(
        np.uint32)
    truth[:8] = [True] * 8
    got = ttoy.verify_kernel(d, s, key)
    assert got.dtype == torch.bool
    assert got.tolist() == truth
    assert got.tolist() == np.asarray(jtoy.verify_kernel(d, s, key)).tolist()
    # rank-generic: leading batch dims pass through
    got2 = ttoy.verify_kernel(torch.from_numpy(d).reshape(8, 12, 4),
                              torch.from_numpy(s).reshape(8, 12, 4),
                              torch.from_numpy(key).reshape(8, 12))
    assert got2.reshape(-1).tolist() == truth
    assert [ttoy.verify_item(it) for it in items[8:]] == truth[8:]


# ------------------------------------------- the default engine per mode

@pytest.mark.parametrize("mode", ["p256", "ed25519"])
def test_real_crypto_modes_default_to_the_card(mode, tmp_path, monkeypatch):
    """With no engine, "p256" and "ed25519" build a
    ``TorchVerifyEngine`` of their scheme, which asks for the card: with
    none visible the constructor raises instead of verifying on the
    CPU."""
    from smartbft_tpu_torch.testing import sharded

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sharded.ShardedCluster(str(tmp_path), shards=1, n=4, crypto=mode)


def test_toy_mode_defaults_to_a_host_engine(tmp_path):
    from smartbft_tpu_torch.crypto.provider import HostVerifyEngine
    from smartbft_tpu_torch.testing import sharded, toy_scheme

    c = sharded.ShardedCluster(str(tmp_path), shards=1, n=4, crypto="toy")
    assert isinstance(c.engine, HostVerifyEngine)
    assert c.engine.scheme is toy_scheme


# ------------------------------------------------ the reference's clusters

globals().update(reference_tests("test_sharded.py", 222))


def test_reference_cluster_cases_are_all_there():
    """Every cluster case of the reference file from line 222 runs on the
    port but the chaos soak, which the reference marks slow: a renamed
    port module or a new unported import in a case would otherwise drop
    it from the collection without a trace."""
    cases = reference_tests("test_sharded.py", 222)
    assert [name.split("__")[1] for name in cases] == [
        "test_group_namespacing_no_inbox_collisions",
        "test_shard_scoped_mute_and_partition",
        "test_two_shards_commit_combined_stream",
        "test_cross_shard_coalescing_gate",
        "test_shard_isolation_leader_mute",
        "test_per_shard_plane_attribution_sums_into_aggregate",
        "test_plane_registry_prunes_dead_instances",
        "test_tpu_counters_aggregate_rolls_up_per_shard_providers",
        "test_breaker_cycle_affects_all_shards_coherently",
    ]  # left out: test_sharded_chaos_soak (marked slow)
    for fn in cases.values():
        assert fn.__globals__["ShardedCluster"].__module__ == \
            "smartbft_tpu_torch.testing.sharded"
