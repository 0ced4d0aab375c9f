"""The port's fault and load harnesses held against the JAX package's.

``testing/load.py``, ``testing/chaos.py``, ``testing/byzantine.py`` and
``obs/report.py`` are copies: their ASTs must equal the reference's once
docstrings are stripped and ``smartbft_tpu`` is read as
``smartbft_tpu_torch`` (the reference's issue tags in help strings are
dropped in the port, and read so here).  On seeded inputs both packages
must give the same arrivals, client draws, schedules, configurations and
rendered trace reports, and one chaos run (the leader muted mid-run)
must pass the invariants on both and commit the same ledger."""

import ast
import asyncio
import dataclasses
import json
import pathlib
import random
import re
import subprocess
import sys

import pytest

from smartbft_tpu.obs import report as j_report
from smartbft_tpu.snapshot import store as j_store
from smartbft_tpu.testing import chaos as j_chaos
from smartbft_tpu.testing import load as j_load
from smartbft_tpu_torch.obs import report as t_report
from smartbft_tpu_torch.obs.recorder import TraceRecorder
from smartbft_tpu_torch.snapshot import store as t_store
from smartbft_tpu_torch.testing import chaos as t_chaos
from smartbft_tpu_torch.testing import load as t_load

ROOT = pathlib.Path(__file__).resolve().parent.parent
COPIES = ["testing/load.py", "testing/chaos.py", "testing/byzantine.py",
          "obs/report.py"]


# ------------------------------------------------------------ the copies

def _normalised(src: str) -> str:
    """``src`` as an AST dump with docstrings and issue tags gone."""
    tree = ast.parse(src)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and body \
                and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            node.value = re.sub(r" \(ISSUE \d+\)", "", node.value)
    return ast.dump(tree, include_attributes=False)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_differs_only_in_comments_docstrings_and_names(rel):
    ref = (ROOT / "smartbft_tpu" / rel).read_text()
    port = (ROOT / "smartbft_tpu_torch" / rel).read_text()
    mapped = re.sub(r"\bsmartbft_tpu\b", "smartbft_tpu_torch", ref)
    assert _normalised(port) == _normalised(mapped)


def test_the_normaliser_sees_a_changed_statement():
    src = (ROOT / "smartbft_tpu_torch" / "testing" / "load.py").read_text()
    changed = src.replace("n += 1\n", "n += 2\n", 1)
    assert changed != src
    assert _normalised(changed) != _normalised(src)


# ------------------------------------------------------- open-loop load

@pytest.mark.parametrize("n,skew", [(64, 1.1), (512, 1.1), (1000, 0.8)])
def test_zipf_clients_draw_the_same_ids(n, skew):
    j, t = j_load.ZipfClients(n, skew=skew), t_load.ZipfClients(n, skew=skew)
    rj, rt = random.Random(n), random.Random(n)
    draws = [j.sample(rj) for _ in range(3000)]
    assert [t.sample(rt) for _ in range(3000)] == draws
    assert len(set(draws)) > 1
    for top in (1, 5, n, n + 3):
        assert t.hot_fraction(top) == j.hot_fraction(top)


def test_zipf_clients_reject_an_empty_universe():
    for mod in (j_load, t_load):
        with pytest.raises(ValueError, match="at least one client"):
            mod.ZipfClients(0)


@pytest.mark.parametrize("seed", [3, 17, 31])
def test_open_loop_pump_is_due_at_the_same_instants(seed):
    def sweep(mod):
        clock = random.Random(seed + 1000)
        pump = mod.OpenLoopPump(200.0, random.Random(seed), start=0.5)
        now, out = 0.0, []
        for step in range(400):
            now += clock.uniform(0.0, 0.02)
            if step == 200:
                pump.set_rate(1500.0, now)
            out.append(pump.due(now))
        return out, pump.rate

    got = sweep(t_load)
    assert got == sweep(j_load)
    assert sum(got[0][:200]) > 0 and sum(got[0][200:]) > sum(got[0][:200])
    for mod in (j_load, t_load):
        with pytest.raises(ValueError, match="positive"):
            mod.OpenLoopPump(0.0, random.Random(0))
        with pytest.raises(ValueError, match="positive"):
            mod.OpenLoopPump(1.0, random.Random(0)).set_rate(-1.0, 0.0)


def test_open_loop_stats_block():
    rng = random.Random(5)
    fields = dict(offered=1000, acked=900, shed_admission=70,
                  shed_timeout=20, failed=10, peak_occupancy=311,
                  peak_fill=0.83737, elapsed=8.25,
                  retry_after_hints=[rng.uniform(0, 0.5) for _ in range(37)])
    for kw in ({}, fields):
        j, t = j_load.OpenLoopStats(**kw), t_load.OpenLoopStats(**kw)
        assert t.block() == j.block()
        assert t.shed == j.shed
    assert t.block()["shed_rate"] == 0.09


# --------------------------------------------- schedules and configuration

def _events(evs) -> list:
    return [dataclasses.asdict(e) for e in evs]


@pytest.mark.parametrize("engine_faults", [False, True])
def test_random_schedules_are_identical(engine_faults):
    shapes = set()
    for seed in range(20):
        for n in (4, 7):
            want = _events(j_chaos.random_schedule(
                random.Random(seed), n, engine_faults=engine_faults))
            got = _events(t_chaos.random_schedule(
                random.Random(seed), n, engine_faults=engine_faults))
            assert got == want, (seed, n)
            shapes.update(e["action"] for e in got)
    assert len(shapes) >= 6  # the seeds reach most fault shapes


@pytest.mark.parametrize("name,kw", [
    ("mute_leader_schedule", {}),
    ("mute_leader_schedule", {"mute_at": 0.5, "heal_at": 3.25}),
    ("faulty_leader_full_schedule", {}),
    ("faulty_leader_full_schedule",
     {"mute_at": 1.0, "crash_at": 4.0, "restart_at": 9.5}),
    ("engine_fault_schedule", {}),
    ("engine_fault_schedule",
     {"hang_at": 1.0, "fail_at": 5.0, "fail_every": 2.0, "fail_count": 3,
      "heal_at": 12.0}),
    ("reshard_schedule", {}),
    ("reshard_schedule", {"crash_shard": None}),
])
def test_fixed_schedules_are_identical(name, kw):
    want = _events(getattr(j_chaos, name)(**kw))
    assert _events(getattr(t_chaos, name)(**kw)) == want
    assert want


@pytest.mark.parametrize("kw", [
    {},
    {"depth": 4},
    {"depth": 16, "rotation": False},
    {"depth": 4, "decisions_per_leader": 3, "view_change_timeout": 30.0,
     "misbehavior_shun_threshold": 3},
])
def test_chaos_config_is_identical(kw):
    for i in (1, 4):
        want = dataclasses.asdict(j_chaos.chaos_config(i, **kw))
        assert dataclasses.asdict(t_chaos.chaos_config(i, **kw)) == want


def test_the_byzantine_matrix_is_identical():
    assert t_chaos.BYZANTINE_MODES == j_chaos.BYZANTINE_MODES


# ----------------------------------------------------------- obs.report

def _dumps(seed: int) -> list:
    """Flight-recorder dumps of three replicas made from a seed: spans,
    request journeys, and ``net.recv`` hops stamped on each sender's
    clock; n1 and n2 carry clock offsets (n2's negative), n3 none."""
    rng = random.Random(seed)
    offsets = {"n1": 0.5, "n2": -0.25}
    t = {"now": 100.0}
    recs = {f"n{i}": TraceRecorder(clock=lambda: t["now"], node=f"n{i}",
                                   capacity=48)
            for i in (1, 2, 3)}
    for k in range(160):
        t["now"] += rng.uniform(0.0, 0.01)
        node = rng.choice(sorted(recs))
        rec = recs[node]
        kind = rng.choice(["req.submit", "req.pool", "req.deliver",
                           "wave", "net.recv", "vc.phase", "wal.fsync"])
        key = f"c{rng.randrange(6)}:r{rng.randrange(12)}"
        if kind.startswith("req."):
            rec.record(kind, key=key, seq=k)
        elif kind == "net.recv":
            frm = rng.choice([i for i in (1, 2, 3) if f"n{i}" != node])
            sent = t["now"] - rng.uniform(-0.002, 0.01)
            sent_us = int((sent + offsets.get(f"n{frm}", 0.0)) * 1e6)
            rec.record(kind, extra={"from": frm, "sent_us": sent_us,
                                    "hop": 1})
        else:
            rec.record(kind, view=rng.randrange(3), launch=k,
                       dur=rng.uniform(0.0, 0.05),
                       extra={"size": rng.randrange(64)})
    dumps = []
    for node, rec in sorted(recs.items()):
        d = rec.dump()
        if node in offsets:
            d["clock_offset_s"] = offsets[node]
        dumps.append(d)
    return dumps


def _both(fn_name, dumps, *args, **kw):
    want = getattr(j_report, fn_name)(json.loads(json.dumps(dumps)),
                                      *args, **kw)
    got = getattr(t_report, fn_name)(json.loads(json.dumps(dumps)),
                                     *args, **kw)
    return got, want


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_merged_events_and_link_summary(seed):
    dumps = _dumps(seed)
    assert any(d["dropped"] for d in dumps)
    got, want = _both("merged_events", dumps)
    assert got == want
    for offsets in ({}, {"n1": 0.5, "n2": -0.25, "n3": 0.0},
                    {"n1": 0.5, "n2": -0.25}):
        rows, want_rows = _both("link_summary", want, offsets)
        assert rows == want_rows
        assert want_rows


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_render_is_byte_for_byte(seed):
    dumps = _dumps(seed)
    dumps[2]["offset_known"] = False
    for kw in ({}, {"last": 25}, {"last": 0}, {"summary_only": True}):
        got, want = _both("render", dumps, **kw)
        assert got == want
    assert "span summary (ms):" in want and "per-link network time" in want
    assert "WARNING: no clock offset for n3" in _both("render", dumps)[1]
    plain = [dict(d, clock_offset_s=0.0) for d in dumps]
    got, want = _both("render", plain, summary_only=True)
    assert got == want and "skew-adjusted" not in want


def test_report_module_runs_as_the_reference_does(tmp_path):
    dumps = _dumps(7)
    paths = []
    for d in dumps:
        d.pop("clock_offset_s", None)
        paths.append(tmp_path / f"flight-{d['node']}.json")
        paths[-1].write_text(json.dumps(d))
    offsets = tmp_path / "offsets.json"
    offsets.write_text(json.dumps({"n1": {"offset_s": 0.5}, "n2": -0.25}))
    args = [str(p) for p in paths] + ["--offsets", str(offsets),
                                      "--last", "40"]
    procs = [subprocess.Popen([sys.executable, "-m", f"{pkg}.obs.report",
                               *args], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for pkg in ("smartbft_tpu", "smartbft_tpu_torch")]
    (want, err_j), (got, err_t) = (p.communicate(timeout=120) for p in procs)
    assert [p.returncode for p in procs] == [0, 0], err_j + err_t
    assert got == want
    assert "clock-aligned" in got and "n3" in got


# --------------------------------------------------- one chaos run on each

def _chaos_run(chaos, store, wal_root):
    async def go():
        cluster = chaos.ChaosCluster(wal_root, n=4, depth=4, rotation=True,
                                     seed=204)
        await cluster.start()
        try:
            report = await cluster.run_schedule(
                chaos.mute_leader_schedule(), requests=12)
            chaos.Invariants.check_all(cluster, report, expected=12,
                                       blacklisted=cluster.faulty_node)
            out = []
            for a in cluster.live_apps():
                h = store.CHAIN_SEED
                for d in a.ledger():
                    h = store.chain_update(h, d.proposal.payload,
                                           d.proposal.metadata)
                ids = sorted(str(r) for d in a.ledger()
                             for r in a.requests_from_proposal(d.proposal))
                out.append((a.id, ids, h.hex()))
            return out, cluster.faulty_node, sorted(report.leaders_seen)
        finally:
            await cluster.stop()

    return asyncio.run(go())


def test_mute_leader_run_commits_the_same_ledger(tmp_path):
    want = _chaos_run(j_chaos, j_store, str(tmp_path / "jax"))
    got = _chaos_run(t_chaos, t_store, str(tmp_path / "torch"))
    replicas, faulty, leaders = got
    assert len(replicas) == 4 and len(leaders) >= 2
    assert len({tuple(ids) for _, ids, _ in replicas}) == 1
    assert {len(set(ids)) for _, ids, _ in replicas} == {12}
    assert len({h for _, _, h in replicas}) == 1
    assert got == want
