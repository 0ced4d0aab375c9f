"""The port's BLS12-381 host half and BlsCryptoProvider against the JAX
package's (BASELINE configs[4]).

Host half: keys, signatures and proofs of possession byte for byte;
hash-to-G1, aggregation and serialization; ``verify_int`` on the
reference's case matrix (tests/test_crypto_bls.py); the host Miller loop
and final exponentiation value for value; the kernel inputs of
``verify_inputs`` and the fixed -g2 line tables array for array.

Provider: the canonical lowest-(quorum-1) split gives byte-identical
aggregate items across replicas and across the two packages, proofs of
possession are enforced, and one bad vote is re-attributed alone.  Then an
n=4 cluster of each package on the same seeded logical-clock workload
commits the same ordered request ids and ledger digest.  Both clusters
verify on the host pairing (``HostVerifyEngine``), the port's through one
shared dedupe coalescer; the pairing kernel's plain version costs seconds
a launch on this CPU and is held to the host in
tests/test_torch_bls_kernel.py.
"""

import asyncio
import dataclasses

import numpy as np
import pytest

from smartbft_tpu.crypto import bls12381 as jbls
from smartbft_tpu.crypto import provider as jprov
from smartbft_tpu.messages import Proposal as JProposal
from smartbft_tpu.snapshot import CHAIN_SEED, chain_update
from smartbft_tpu.testing import app as japp
from smartbft_tpu.testing.network import Network as JNetwork
from smartbft_tpu.utils.clock import Scheduler as JScheduler
from smartbft_tpu_torch.crypto import bls12381 as tbls
from smartbft_tpu_torch.crypto import provider as tprov
from smartbft_tpu_torch.messages import Proposal as TProposal
from smartbft_tpu_torch.testing import app as tapp
from smartbft_tpu_torch.testing.network import Network as TNetwork
from smartbft_tpu_torch.utils.clock import Scheduler as TScheduler

SEEDS = [b"node-%d" % i for i in range(4)]
MSG = b"proposal-digest"


@pytest.fixture(scope="module")
def keys():
    return [tbls.keygen(seed) for seed in SEEDS]


@pytest.fixture(scope="module")
def sigs(keys):
    return [tbls.sign(sk, MSG) for sk, _ in keys]


# ---------------------------------------------------------------------------
# host half
# ---------------------------------------------------------------------------


def test_keys_signatures_and_proofs_match(keys):
    for seed, (sk, pk) in zip(SEEDS, keys):
        assert jbls.keygen(seed) == (sk, pk)
        assert tbls.sign(sk, MSG) == jbls.sign(sk, MSG)
        assert tbls.sign_raw(sk, b"other") == jbls.sign_raw(sk, b"other")
        assert tbls.pop_prove(sk, pk) == jbls.pop_prove(sk, pk)
        assert tbls.keygen_with_pop(seed) == jbls.keygen_with_pop(seed)


@pytest.mark.parametrize("msg", [b"", b"m", MSG, bytes(range(256))])
def test_hash_to_g1_matches(msg):
    assert tbls.hash_to_g1(msg) == jbls.hash_to_g1(msg)


def test_aggregation_matches(keys, sigs):
    pubs = [pk for _, pk in keys]
    assert tbls.aggregate_sigs(sigs) == jbls.aggregate_sigs(sigs)
    assert tbls.aggregate_pubs(pubs) == jbls.aggregate_pubs(pubs)
    items = [(MSG, s, pk) for s, pk in zip(sigs, pubs)]
    assert tbls.aggregate_items(items) == jbls.aggregate_items(items)
    for mod in (tbls, jbls):
        with pytest.raises(ValueError):
            mod.aggregate_items([items[0], (b"other",) + items[1][1:]])


def test_serialization_roundtrips(keys, sigs):
    pt = tbls.deserialize_g1(sigs[0])
    assert pt == jbls.deserialize_g1(sigs[0])
    assert tbls.serialize_g1(pt) == sigs[0]
    pk = tbls.deserialize_g2(keys[0][1])
    assert pk == jbls.deserialize_g2(keys[0][1])
    assert tbls.serialize_g2(pk) == keys[0][1]
    for bad in (sigs[0][:-1], b"\xff" * tbls.SIG_BYTES):
        for mod in (tbls, jbls):
            with pytest.raises(ValueError):
                mod.deserialize_g1(bad)


def _not_in_subgroup():
    """An E(Fp) point of order other than r (no cofactor clearing)."""
    x = 1
    while True:
        rhs = (x * x * x + 4) % tbls.P
        y = pow(rhs, (tbls.P + 1) // 4, tbls.P)
        if y * y % tbls.P == rhs and \
                tbls.g1_scalar_mult(tbls.R_ORDER, (x, y)) is not None:
            return tbls.serialize_g1((x, y))
        x += 1


def _case(name, keys, sigs):
    """(verify_int arguments, expected verdict) of the reference's case
    matrix (tests/test_crypto_bls.py TestScheme)."""
    pk0, pk1 = keys[0][1], keys[1][1]
    if name == "valid":
        return (pk0, MSG, sigs[0]), True
    if name == "wrong_message":
        return (pk0, b"other", sigs[0]), False
    if name == "wrong_key":
        return (pk1, MSG, sigs[0]), False
    if name == "corrupt_signature":
        bad = bytearray(sigs[0])
        bad[7] ^= 1
        return (pk0, MSG, bytes(bad)), False
    if name == "not_in_subgroup":
        return (pk0, MSG, _not_in_subgroup()), False
    if name == "aggregate":
        return (tbls.aggregate_pubs([k for _, k in keys]), MSG,
                tbls.aggregate_sigs(sigs)), True
    if name == "aggregate_missing_signer":
        return (tbls.aggregate_pubs([k for _, k in keys]), MSG,
                tbls.aggregate_sigs(sigs[:3])), False
    raise AssertionError(name)


CASES = ["valid", "wrong_message", "wrong_key", "corrupt_signature",
         "not_in_subgroup", "aggregate", "aggregate_missing_signer"]


@pytest.mark.parametrize("name", CASES)
def test_verify_int_case_matrix(name, keys, sigs):
    args, want = _case(name, keys, sigs)
    assert tbls.verify_int(*args) is want
    assert jbls.verify_int(*args) is want
    assert tbls.verify_item(tbls.make_item(args[1], args[2], args[0])) is want


def test_aggregate_verify_and_pops_match(keys, sigs):
    pubs = [pk for _, pk in keys]
    assert tbls.aggregate_verify_int(pubs, MSG, sigs)
    assert not tbls.aggregate_verify_int(pubs, MSG, sigs[:3])
    sk, pk, pop = tbls.keygen_with_pop(b"pop-node")
    assert tbls.pop_verify(pk, pop) and jbls.pop_verify(pk, pop)
    assert not tbls.pop_verify(keys[0][1], pop)
    assert not tbls.verify_int(pk, pk, pop)  # a proof is no message signature


def test_host_pairing_values_match(keys, sigs):
    s = tbls.deserialize_g1(sigs[0])
    pk = tbls.deserialize_g2(keys[0][1])
    f = tbls.host_miller_loop(tbls.hash_to_g1(MSG), pk)
    assert f == jbls.host_miller_loop(jbls.hash_to_g1(MSG), pk)
    assert tbls.host_final_exp(f) == jbls.host_final_exp(f)
    assert tbls.host_pairing_check([(s, tbls.NEG_G2),
                                    (tbls.hash_to_g1(MSG), pk)])


def test_verify_inputs_arrays_match(keys, sigs):
    items = [(MSG, s, pk) for s, (_, pk) in zip(sigs, keys)]
    items.append(tbls.aggregate_items(items))
    items.append((b"m", b"\x00" * tbls.SIG_BYTES, b"\x01" * tbls.PUB_BYTES))
    got, want = tbls.verify_inputs(items), jbls.verify_inputs(items)
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[-1].tolist() == [1, 1, 1, 1, 1, 0]


def test_fixed_line_tables_match():
    np.testing.assert_array_equal(tbls._FIXED_DBL, jbls._FIXED_DBL)
    np.testing.assert_array_equal(tbls._FIXED_ADD, jbls._FIXED_ADD)
    assert tbls._FIXED_DBL.shape == (63, 3, 2, 24)
    assert tbls._X_BITS == jbls._X_BITS and sum(tbls._X_BITS) == 5
    for x in (0, 1, tbls.P - 1, 12345):
        np.testing.assert_array_equal(tbls.encode(x), jbls.CTX.encode(x))
        assert tbls.decode(tbls.encode(x)) == x


# ---------------------------------------------------------------------------
# BlsCryptoProvider
# ---------------------------------------------------------------------------


class LaneRecorder:
    """An engine that records the lanes it is given and accepts them."""

    scheme = tbls

    def __init__(self):
        self.calls = []

    def verify(self, items):
        self.calls.append(list(items))
        return [True] * len(items)


def _votes(mod_prov, mod_bls, Proposal, rings):
    proposal = Proposal(payload=b"decision", metadata=b"")
    engine = LaneRecorder()
    engine.scheme = mod_bls
    return proposal, {
        i: mod_prov.BlsCryptoProvider(rings[i], engine=engine).sign_proposal(
            proposal, b"aux-%d" % i) for i in rings}


def test_canonical_split_is_byte_identical_across_replicas_and_packages():
    """Two replicas holding the same decision's votes (in different
    orders, one with an extra vote) produce the same canonical aggregate
    item, and so does the JAX package's provider."""
    ids = [1, 2, 3, 4]
    lanes = []
    for mod_prov, mod_bls, Proposal in ((tprov, tbls, TProposal),
                                        (jprov, jbls, JProposal)):
        rings = mod_prov.Keyring.generate(ids, seed=b"blsdedupe",
                                          scheme=mod_bls)
        proposal, sigs = _votes(mod_prov, mod_bls, Proposal, rings)
        for mine, batch in ((1, [sigs[2], sigs[3]]),
                            (2, [sigs[4], sigs[3], sigs[2]])):
            engine = LaneRecorder()
            engine.scheme = mod_bls
            prov = mod_prov.BlsCryptoProvider(rings[mine], engine=engine)
            res = prov.verify_consenter_sigs_batch(batch, proposal)
            assert all(r is not None for r in res)
            lanes.append(engine.calls[0][0])
    # n=4 -> quorum 3 -> the lowest 2 signer ids present, {2, 3}
    assert lanes[0] == lanes[1] == lanes[2] == lanes[3]
    assert isinstance(lanes[0][1], bytes) and isinstance(lanes[0][2], bytes)


def test_provider_enforces_pops():
    trips = {n: tbls.keygen_with_pop(b"pop-%d" % n) for n in (1, 2, 3, 4)}
    pubs = {n: pk for n, (_, pk, _) in trips.items()}
    pops = {n: pop for n, (_, _, pop) in trips.items()}
    ring = tprov.Keyring(1, trips[1][0], pubs)
    tprov.BlsCryptoProvider(ring, pops=pops)  # all valid: accepted
    with pytest.raises(ValueError, match="possession"):
        tprov.BlsCryptoProvider(ring, pops={**pops, 3: pops[2]})
    with pytest.raises(ValueError, match="possession"):
        tprov.BlsCryptoProvider(ring, pops={n: pops[n] for n in (1, 2, 3)})


def _corrupt(sig, value):
    return dataclasses.replace(sig, value=value)


def test_one_bad_vote_is_reattributed_alone():
    """A quorum whose canonical lane fails (one vote signed the wrong
    digest) re-verifies the chosen votes one lane each: only the bad one
    is rejected and attributed, in both packages, sync and async."""
    ids = [1, 2, 3, 4]
    results = {}
    for mod_prov, mod_bls, Proposal in ((tprov, tbls, TProposal),
                                        (jprov, jbls, JProposal)):
        rings = mod_prov.Keyring.generate(ids, seed=b"blsbad", scheme=mod_bls)
        proposal, sigs = _votes(mod_prov, mod_bls, Proposal, rings)
        other = mod_prov.BlsCryptoProvider(rings[3]).sign_proposal(
            Proposal(payload=b"other", metadata=b""), b"aux-3")
        batch = [sigs[1], sigs[2], _corrupt(sigs[3], other.value), sigs[4]]
        prov = mod_prov.BlsCryptoProvider(rings[1])
        res = prov.verify_consenter_sigs_batch(batch, proposal)
        res_async = asyncio.run(
            prov.verify_consenter_sigs_batch_async(batch, proposal))
        results[mod_prov.__name__] = (res, res_async, prov.invalid_by_signer)
    port, ref = results[tprov.__name__], results[jprov.__name__]
    want = [b"aux-1", b"aux-2", None, b"aux-4"]
    assert port[0] == port[1] == ref[0] == ref[1] == want
    assert port[2] == {3: {"invalid_sig": 2}}


def test_prewarm_probe_is_a_valid_bls_item():
    """``prewarm_verify_engine`` hands a BLS engine a probe item that
    verifies, for every rung of its ladder."""
    seen = []

    class Ladder:
        scheme = tbls

        def prewarm_shapes(self, item, sizes):
            seen.append((item, sizes))

    tprov.prewarm_verify_engine(Ladder())
    (item, sizes), = seen
    assert sizes is None and tbls.verify_item(item)


# ---------------------------------------------------------------------------
# the slice: an n=4 BLS cluster of each package
# ---------------------------------------------------------------------------

NODES = [1, 2, 3, 4]
DECISIONS = 4
BATCH = 2


def _cfg(fast_config, i):
    # timeouts scaled ~1000x: the logical clock races ahead of the real
    # time a host pairing takes
    return dataclasses.replace(
        fast_config(i), leader_rotation=False, decisions_per_leader=0,
        pipeline_depth=4, request_batch_max_count=BATCH,
        request_forward_timeout=1000.0, request_complain_timeout=2000.0,
        request_auto_remove_timeout=30000.0,
        view_change_resend_interval=1000.0, view_change_timeout=10000.0,
        leader_heartbeat_timeout=15000.0)


def _run(mod_app, Network, Scheduler, make_crypto, wal_dir):
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
def bls_runs(tmp_path_factory):
    jrings = jprov.Keyring.generate(NODES, seed=b"slice-bls", scheme=jbls)
    jpops = {i: jbls.pop_prove(jrings[i].private_key,
                               jrings[i].public_keys[i]) for i in NODES}
    jax_run = _run(japp, JNetwork, JScheduler,
                   lambda i: jprov.BlsCryptoProvider(
                       jrings[i], engine=jprov.HostVerifyEngine(scheme=jbls),
                       pops=jpops),
                   tmp_path_factory.mktemp("jax-bls"))
    trings = tprov.Keyring.generate(NODES, seed=b"slice-bls", scheme=tbls)
    tpops = {i: tbls.pop_prove(trings[i].private_key,
                               trings[i].public_keys[i]) for i in NODES}
    engine = tprov.HostVerifyEngine(scheme=tbls)
    co = tprov.AsyncBatchCoalescer(engine, window=0.002, max_batch=4096,
                                   dedupe=True)
    torch_run = _run(tapp, TNetwork, TScheduler,
                     lambda i: tprov.BlsCryptoProvider(
                         trings[i], engine=engine, coalescer=co, pops=tpops),
                     tmp_path_factory.mktemp("torch-bls"))
    return jax_run, torch_run, engine, co


@pytest.mark.parametrize("node", NODES)
def test_bls_same_ordered_request_ids_at_every_replica(bls_runs, node):
    jax_run, torch_run, _, _ = bls_runs
    want = [[f"client:req-{k}" for k in range(b * BATCH, (b + 1) * BATCH)]
            for b in range(DECISIONS)]
    assert jax_run[node][0][:DECISIONS] == want
    assert torch_run[node][0] == jax_run[node][0]


@pytest.mark.parametrize("node", NODES)
def test_bls_same_ledger_digest_at_every_replica(bls_runs, node):
    jax_run, torch_run, _, _ = bls_runs
    assert torch_run[node][1] == jax_run[node][1] == jax_run[NODES[0]][1]


def test_bls_cluster_verified_aggregate_lanes(bls_runs):
    _, _, engine, co = bls_runs
    assert engine.scheme is tbls
    assert engine.stats.sigs_verified > 0
    snap = co.fault_snapshot()
    assert snap["opens"] == 0 and snap["host_fallback_batches"] == 0
