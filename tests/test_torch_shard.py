"""The port's sharded-mode primitives (``smartbft_tpu_torch.shard``) held
against the JAX package's on the same seeded inputs: routing key for key,
the delivery mux's stream and violations, epoch-journal recovery across
the two packages (torn tails included), the barrier payload bytes and the
autoscaler's decisions.  Then the reference's own case matrices
(``tests/test_sharded.py`` router / mux cases and ``tests/test_reshard.py``
up to its live integration cases) run against the port, compiled by
:mod:`torch_reference` and collected as items of their own
(``<file stem>__<case>``).
"""

import json
import random

import pytest

from smartbft_tpu.shard import autoscale as j_autoscale
from smartbft_tpu.shard import epoch as j_epoch
from smartbft_tpu.shard import mux as j_mux
from smartbft_tpu.shard import router as j_router
from smartbft_tpu.testing import app as j_app
from smartbft_tpu_torch.shard import autoscale as t_autoscale
from smartbft_tpu_torch.shard import epoch as t_epoch
from smartbft_tpu_torch.shard import mux as t_mux
from smartbft_tpu_torch.shard import router as t_router
from smartbft_tpu_torch.testing import app as t_app
from torch_reference import dropped_tests, reference_tests


# ---------------------------------------------------------------- router

KEYS = [f"c{k}" for k in range(10_000)]


@pytest.mark.parametrize("seed", [0, 11, -3])
def test_router_matches_the_jax_package_key_for_key(seed):
    """10,000 client ids x S = 1..8: the same 64-bit key, the same jump
    bucket, the same route through a router built at each S, and the
    same ``moved`` answer for every grow and shrink between them."""
    jr, tr = j_router.ShardRouter(1, seed=seed), t_router.ShardRouter(1, seed=seed)
    keys = [tr.key_of(c) for c in KEYS]
    assert keys == [jr.key_of(c) for c in KEYS]
    routes = {}
    for s in range(1, 9):
        want = [j_router.jump_hash(k, s) for k in keys]
        assert [t_router.jump_hash(k, s) for k in keys] == want
        assert [t_router.ShardRouter(s, seed=seed).route(c)
                for c in KEYS[:2000]] == want[:2000]
        routes[s] = want
    for old in range(1, 9):
        for new in range(1, 9):
            got = [tr.moved(c, old, new) for c in KEYS[:250]]
            assert got == [jr.moved(c, old, new) for c in KEYS[:250]]
            assert got == [a != b for a, b in zip(routes[old][:250],
                                                  routes[new][:250])]
    assert tr.moved_fraction(3, 5) == jr.moved_fraction(3, 5)


def test_router_epochs_match_the_jax_package():
    jr, tr = j_router.ShardRouter(2, seed=5), t_router.ShardRouter(2, seed=5)
    for r in (jr, tr):
        r.reshard(4)
        r.reshard(3, epoch=4)
    assert tr.epochs() == jr.epochs()
    for e in range(6):
        assert [tr.route(c, epoch=e) for c in KEYS[:500]] == \
            [jr.route(c, epoch=e) for c in KEYS[:500]]


# ------------------------------------------------------------------- mux

def _mux_ops(seed: int, n_ops: int = 400):
    """A seeded ingest program over shards 0..2: mostly valid decisions,
    with gaps, repeated ids, unknown shards, a scale-out and a scale-in
    flip, ingest after retirement and prunes mixed in."""
    rng = random.Random(seed)
    next_seq = {0: 1, 1: 1, 2: 1}
    live = [0, 1, 2]
    epoch, rid, ops = 0, 0, []
    for i in range(n_ops):
        roll = rng.random()
        if i in (150, 300):
            epoch += 1 + (i == 300)
            if i == 150:
                live = [0, 1, 2, 3]
                next_seq[3] = 1
                ops.append(("flip", epoch, list(live), [],
                            {s: next_seq[s] - 1 for s in (0, 1, 2)}))
            else:
                ops.append(("flip", epoch, [0, 1], [2, 3], {}))
                live = [0, 1]
            continue
        if roll < 0.04:
            ops.append(("prune", rng.randrange(0, 40 + i)))
            continue
        sid = rng.choice(live) if roll > 0.06 else rng.choice([2, 3, 9])
        seq = next_seq.get(sid, 1)
        if rng.random() < 0.05:
            seq += rng.choice([1, 2, -1])
        ids = [f"c{rng.randrange(4)}:r{rid + k}" for k in range(rng.randrange(0, 4))]
        rid += len(ids)
        if rng.random() < 0.05 and rid > 4:
            ids.append(f"c{rng.randrange(4)}:r{rng.randrange(rid)}")
        if rng.random() < 0.02:
            ids.append("__reshard__:reshard-e1")
        ops.append(("ingest", sid, seq, ids))
        if sid in next_seq and seq == next_seq[sid]:
            next_seq[sid] += 1
    return ops


def _play(mux_mod, ops):
    got = []
    mux = mux_mod.DeliveryMux([0, 1, 2], on_deliver=lambda e: got.append(
        ("cb", e.shard_id, e.seq, e.index, e.request_ids, e.epoch)))
    outcome = []
    for op in ops:
        try:
            if op[0] == "ingest":
                _, sid, seq, ids = op
                e = mux.ingest(sid, f"d{sid}-{seq}", seq=seq, request_ids=ids)
                outcome.append(("ok", e.shard_id, e.seq, e.index,
                                e.request_ids, e.epoch))
            elif op[0] == "prune":
                outcome.append(("pruned", mux.prune(op[1])))
            else:
                _, epoch, shards, retire, barriers = op
                outcome.append(("flip", mux.begin_epoch(
                    epoch, shards, retire=retire, barriers=barriers)))
        except (mux_mod.ShardStreamViolation, ValueError) as exc:
            outcome.append((type(exc).__name__, str(exc)))
    return outcome, got, mux.snapshot(), mux.heights(), mux.requests_total()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_mux_stream_watermarks_and_violations_match(seed):
    ops = _mux_ops(seed)
    want = _play(j_mux, ops)
    got = _play(t_mux, ops)
    kinds = {o[0] for o in want[0]}
    assert {"ok", "ShardStreamViolation", "flip", "pruned"} <= kinds
    assert got == want


# --------------------------------------------------------- epoch journal

_JOURNAL = [
    {"t": "prepare", "epoch": 1, "old": 2, "new": 4},
    {"t": "barrier", "epoch": 1, "shard": 0, "seq": 7},
    {"t": "barrier", "epoch": 1, "shard": 1, "seq": 5},
    {"t": "flip", "epoch": 1, "shards": [0, 1, 2, 3]},
    {"t": "done", "epoch": 1},
    {"t": "prepare", "epoch": 2, "old": 4, "new": 3},
    {"t": "abort", "epoch": 2, "reason": "ShardEpochError: drain deadline"},
    {"t": "prepare", "epoch": 3, "old": 4, "new": 3},
    {"t": "barrier", "epoch": 3, "shard": 2, "seq": 11},
]


def _write(epoch_mod, path, records):
    j = epoch_mod.EpochJournal(str(path))
    for rec in records:
        j.append(rec)
    j.close()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_journal_recovers_the_same_facts_in_either_package(tmp_path, writer):
    """Every prefix of the journal, cut at every byte (torn tails), gives
    the same replay and ``recover_epochs`` facts in both packages, and
    both write the same bytes."""
    w_mod, r_mod = (j_epoch, t_epoch) if writer == "jax" \
        else (t_epoch, j_epoch)
    full = tmp_path / "full.journal"
    _write(w_mod, full, _JOURNAL)
    other = tmp_path / "other.journal"
    _write(r_mod, other, _JOURNAL)
    data = full.read_bytes()
    assert other.read_bytes() == data
    cut = tmp_path / "cut.journal"
    for n in range(len(data) + 1):
        cut.write_bytes(data[:n] + (b"{\"t\": \"fl" if n % 7 == 3 else b""))
        a = r_mod.EpochJournal(str(cut)).replay()
        b = w_mod.EpochJournal(str(cut)).replay()
        assert a == b
        assert r_mod.recover_epochs(a) == w_mod.recover_epochs(b)


def test_journal_seals_a_torn_tail_the_same_way(tmp_path):
    data = b"".join(
        (json.dumps(r, sort_keys=True) + "\n").encode()
        for r in _JOURNAL[:4]) + b"{\"t\": \"do"
    out = {}
    for name, mod in (("jax", j_epoch), ("torch", t_epoch)):
        p = tmp_path / f"{name}.journal"
        p.write_bytes(data)
        _write(mod, p, [{"t": "done", "epoch": 1}])
        out[name] = p.read_bytes()
    assert out["torch"] == out["jax"]
    assert t_epoch.recover_epochs(
        t_epoch.EpochJournal(str(tmp_path / "torch.journal")).replay()) == \
        {"epoch": 1, "shards": 4, "next_epoch": 2, "incomplete": None}


@pytest.mark.parametrize("epoch,old,new", [(1, 2, 3), (2, 4, 1), (77, 8, 5),
                                           (0, 1, 1)])
def test_barrier_payload_bytes_match(epoch, old, new):
    want = j_epoch.reshard_command_payload(epoch, old, new)
    assert t_epoch.reshard_command_payload(epoch, old, new) == want
    cmd = t_epoch.detect_reshard(want)
    assert (cmd.epoch, cmd.old_shards, cmd.new_shards) == (epoch, old, new)
    assert t_epoch.barrier_marker(epoch) == j_epoch.barrier_marker(epoch)
    assert t_app.barrier_request_bytes(epoch, old, new) == \
        j_app.barrier_request_bytes(epoch, old, new)
    assert t_epoch.detect_reshard(b"not a barrier") is None


# ------------------------------------------------------------ autoscaler

def _occupancy_trace(seed: int, n: int = 300):
    rng = random.Random(seed)
    shed = 0
    trace = []
    for _ in range(n):
        shed += rng.random() < 0.1
        occ = {"fill": rng.choice([rng.random(), 0.9, 0.05, 0.5]),
               "total_waiters": rng.choice([0, 0, 0, 2]),
               "shed_admission": shed, "shed_timeout": 0}
        if rng.random() < 0.05:
            occ["total_capacity"] = 0
        trace.append((rng.uniform(0.5, 30.0), occ))
    return trace


@pytest.mark.parametrize("seed", [4, 5])
def test_autoscaler_decisions_match(seed):
    out = {}
    for name, mod in (("jax", j_autoscale), ("torch", t_autoscale)):
        now = [0.0]
        a = mod.OccupancyAutoscaler(cooldown=20.0, max_shards=6,
                                    clock=lambda: now[0])
        shards, got = 3, []
        for dt, occ in _occupancy_trace(seed):
            now[0] += dt
            target = a.evaluate(occ, shards)
            got.append(target)
            if target is not None:
                a.note_action()
                shards = target
        out[name] = (got, a.decisions)
    assert out["torch"] == out["jax"]
    assert any(t is not None for t in out["jax"][0])


# -------------------------------------------- the reference's case matrices

globals().update(reference_tests("test_sharded.py", 41, 221))
globals().update(reference_tests("test_reshard.py", 63))


def test_reference_cases_cover_the_matrices():
    """Every case of the two ranges runs on the port, the live reshard
    cases at the end of test_reshard.py included; only its soak, which
    the reference marks slow, stays out."""
    cases = reference_tests("test_sharded.py", 41, 221) \
        | reference_tests("test_reshard.py", 63)
    assert len(cases) == 9 + 32
    assert dropped_tests("test_reshard.py", 63) == {
        "test_reshard_soak_slow": "marked slow"}
    assert "test_reshard__test_live_reshard_smoke_2_to_3" in cases
    assert "test_reshard__test_reshard_crash_during_handoff_2_4_3" in cases
    # compiled against the port, not the JAX package
    for fn in cases.values():
        assert fn.__globals__["ShardRouter"].__module__ == \
            "smartbft_tpu_torch.shard.router"
    assert "test_reshard__test_router_determinism_across_processes" in cases
    assert "test_reshard__test_run_autoscaler_loop_over_stub_set" in cases
