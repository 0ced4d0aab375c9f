"""The port's bench-row schema and baseline guard held against the JAX
package's.

``obs/benchschema.py`` and ``obs/baseline.py`` are copies: their ASTs
must equal the reference's once docstrings are stripped and
``smartbft_tpu`` is read as ``smartbft_tpu_torch``, apart from the tiny
logical row's driver, which ticks the logical clock after a fixed budget
of event-loop passes where the reference's waits 1 ms of host time.  On
numpy-seeded inputs both packages must give the same schema table, the
same ``assemble_*`` rows and ``ValueError``s, the same family and the
same errors for good and drifted rows, the same canonical entries,
baseline files (apart from the ``pinned_at`` date) and check verdicts.
The port's tiny logical-clock row is one value run after run, and lies
within the JAX package's spread."""

import ast
import json
import pathlib
import re

import numpy as np
import pytest

from smartbft_tpu.obs import baseline as j_base
from smartbft_tpu.obs import benchschema as j_schema
from smartbft_tpu_torch.obs import baseline as t_base
from smartbft_tpu_torch.obs import benchschema as t_schema

ROOT = pathlib.Path(__file__).resolve().parent.parent
COPIES = ["obs/benchschema.py", "obs/baseline.py"]
#: top-level names where a copy differs from the reference on purpose:
#: the tiny row's driver and what only it uses
DIFFERS = {"obs/baseline.py": {"TINY_TICK_PASSES", "_tick_until",
                               "_tiny_logical_run"}}
#: the one field of a baseline file that is not a function of its rows
TIMESTAMP = "pinned_at"


# ------------------------------------------------------------ the copies

def _defined(node) -> set:
    """The names a top-level statement defines."""
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return {node.name}
    if isinstance(node, (ast.Assign, ast.AnnAssign)):
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        return {t.id for t in targets if isinstance(t, ast.Name)}
    return set()


def _normalised(src: str, drop: set = frozenset()) -> str:
    """``src`` as an AST dump with docstrings gone, and without the
    top-level statements that define a name in ``drop``."""
    tree = ast.parse(src)
    tree.body = [node for node in tree.body if not _defined(node) & drop]
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and body \
                and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree, include_attributes=False)


def _mapped_reference(rel: str) -> str:
    ref = (ROOT / "smartbft_tpu" / rel).read_text()
    return re.sub(r"\bsmartbft_tpu\b", "smartbft_tpu_torch", ref)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_differs_only_in_comments_docstrings_and_names(rel):
    port = (ROOT / "smartbft_tpu_torch" / rel).read_text()
    drop = DIFFERS.get(rel, frozenset())
    assert _normalised(port, drop) == _normalised(_mapped_reference(rel),
                                                  drop)


class _TickUntil(ast.NodeTransformer):
    """The reference's tiny-row driver as the port writes it: ``wait_for``
    read as ``_tick_until``, and no longer imported."""

    def visit_Name(self, node):
        if node.id == "wait_for":
            node.id = "_tick_until"
        return node

    def visit_ImportFrom(self, node):
        node.names = [a for a in node.names if a.name != "wait_for"]
        return node


def _function(src: str, name: str, transform=None) -> str:
    tree = ast.parse(src)
    fn = next(node for node in tree.body if _defined(node) == {name})
    if transform is not None:
        fn = transform.visit(fn)
    return _normalised(ast.unparse(fn))


def test_the_tiny_row_driver_differs_only_in_how_it_ticks():
    """The port's ``_tiny_logical_run`` is the reference's with
    ``_tick_until`` (a fixed budget of loop passes a tick) in place of
    ``testing.app.wait_for`` (1 ms of host time a tick); the reference
    has no ``_tick_until`` and no ``TINY_TICK_PASSES``."""
    rel = "obs/baseline.py"
    port = (ROOT / "smartbft_tpu_torch" / rel).read_text()
    ref = _mapped_reference(rel)
    assert _function(port, "_tiny_logical_run") == _function(
        ref, "_tiny_logical_run", _TickUntil())
    assert not {"_tick_until", "TINY_TICK_PASSES"} & set(vars(j_base))
    assert t_base.TINY_TICK_PASSES == 6


def _canon(want):
    """A schema entry as plain data: types by name, a ``_list_of`` check
    by its item schema."""
    if isinstance(want, dict):
        return {k: _canon(v) for k, v in want.items()}
    if isinstance(want, tuple):
        return tuple(t.__name__ for t in want)
    if callable(want):
        return ("list_of", _canon(want.__closure__[0].cell_contents))
    raise TypeError(want)


def test_schema_version_and_row_schemas_are_equal():
    assert t_schema.SCHEMA_VERSION == j_schema.SCHEMA_VERSION
    assert _canon(t_schema.ROW_SCHEMAS) == _canon(j_schema.ROW_SCHEMAS)
    assert len(t_schema.ROW_SCHEMAS) >= 19


# ------------------------------------------------------- seeded rows

def _value(want, rng, depth=0):
    """A value that satisfies one schema entry."""
    if isinstance(want, dict):
        return _block(want, rng, depth + 1)
    if isinstance(want, tuple):
        if want == (bool,):
            return bool(rng.random() < 0.5)
        if int in want:
            return float(np.round(rng.random() * 1000, 3)) \
                if rng.random() < 0.5 else int(rng.integers(0, 10 ** 6))
        if str in want:
            return "s%d" % rng.integers(100)
        if dict in want:
            return {"k": int(rng.integers(9))}
        return []
    item = want.__closure__[0].cell_contents
    return [_value(item, rng, depth + 1) for _ in range(int(rng.integers(3)))]


def _block(schema, rng, depth=0):
    out = {k: _value(w, rng, depth) for k, w in schema["required"].items()}
    for k, w in schema.get("optional", {}).items():
        if rng.random() < 0.5:
            out[k] = _value(w, rng, depth)
    return out


def _good_rows(seed):
    rng = np.random.default_rng(seed)
    rows = []
    for family, schema in j_schema.ROW_SCHEMAS.items():
        row = _block(schema, rng)
        row["metric"] = family[:-1] + "x%d" % rng.integers(9) \
            if family.endswith("*") else family
        rows.append(row)
    return rows


def _drifted(rows, seed):
    """Each row three ways: a required key gone, a required key's type
    changed, and (where the row has one) a nested block's required key
    gone."""
    rng = np.random.default_rng(seed)
    out = []
    for row in rows:
        schema = j_schema.ROW_SCHEMAS[j_schema.identify_row(row)]
        keys = [k for k in schema["required"] if k != "metric"]
        gone = dict(row)
        del gone[keys[int(rng.integers(len(keys)))]]
        retyped = dict(row)
        key = keys[int(rng.integers(len(keys)))]
        retyped[key] = [] if isinstance(row[key], str) else "drifted"
        out += [gone, retyped]
        nested = [(k, w) for k, w in {**schema["required"],
                                      **schema.get("optional", {})}.items()
                  if isinstance(w, dict) and w["required"] and k in row]
        if nested:
            key, block = nested[0]
            inner = dict(row[key])
            del inner[next(iter(block["required"]))]
            out.append(dict(row, **{key: inner}))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_identify_and_validate_good_and_drifted_rows(seed):
    good = _good_rows(seed)
    drifted = _drifted(good, seed + 100)
    unpinned = [{"metric": "some_new_family", "value": 1},
                {"bench": "openloop"}, {"metric": 7}]
    for rows in (good, drifted, unpinned):
        assert [t_schema.identify_row(r) for r in rows] \
            == [j_schema.identify_row(r) for r in rows]
        assert t_schema.validate_rows(rows) == j_schema.validate_rows(rows)
        for r in rows:
            assert t_schema.validate_row(r) == j_schema.validate_row(r)
    assert t_schema.validate_rows(good) == []
    errors = t_schema.validate_rows(drifted)
    assert len(errors) >= len(drifted)
    assert any("required key missing" in e for e in errors)
    assert any("expected" in e for e in errors)
    assert any(re.search(r"\w\.\w+: required key missing", e)
               for e in errors), "no nested drift was caught"


def _assemble_calls(seed):
    """Seeded keyword sets for the four assemble functions, the invalid
    ones included."""
    rng = np.random.default_rng(seed)
    f = lambda: float(np.round(rng.random() * 100, 4))  # noqa: E731
    i = lambda: int(rng.integers(1, 10 ** 5))  # noqa: E731
    calls = []
    for mode in ("snapshot", "replay", "teleport"):
        calls.append(("assemble_rejoin_row", dict(
            history=i(), mode=mode, rejoin_s=f(), bytes_transferred=i(),
            decisions_replayed=i(), snapshot_bytes=i(), snap_chunks=i(),
            interval=i(), vs_small_history=f())))
        calls.append(("assemble_rejoin_row", dict(
            history=i(), mode=mode, rejoin_s=f(), bytes_transferred=i())))
    for mode in ("local", "follower", "quorum", "stale"):
        calls.append(("assemble_read_row", dict(
            read_p99_ms=f(), write_p99_ms=f(), nodes=i(), reads=i(),
            writes=i(), mode=mode, local_p99_ms=f(), follower_p99_ms=f(),
            read_sheds=i(), storm={"shed": i()}, read_stats={"n": i()})))
    calls.append(("assemble_read_row", dict(
        read_p99_ms=f(), write_p99_ms=0.0, nodes=4, reads=i())))
    for small, large, rs, rl in ((4, 8, f() + 1, f() + 1), (4, 4, 1.0, 1.0),
                                 (0, 8, 1.0, 1.0), (4, 8, 0.0, 2.0)):
        calls.append(("assemble_read_scaling_row", dict(
            per_replica_rate_small=rs, per_replica_rate_large=rl,
            nodes_small=small, nodes_large=large)))
    for faults, actions in ((3, i() % 9), (0, 1), (2, -1)):
        calls.append(("assemble_selfdrive_rows", dict(stats={
            "faults": faults, "actions": actions,
            "reversals": int(rng.integers(3)), "vetoes": {"veto": i()},
            "final_status": "healthy", "peak_fill": f(), "seed": i(),
            "ctl_spans": i()})))
    return calls


def _run(mod, name, kw):
    try:
        return getattr(mod, name)(**kw)
    except ValueError as exc:
        return ("ValueError", str(exc))


@pytest.mark.parametrize("seed", [3, 4])
def test_assemble_functions_match_the_jax_package(seed):
    calls = _assemble_calls(seed)
    got = [_run(t_schema, name, kw) for name, kw in calls]
    assert got == [_run(j_schema, name, kw) for name, kw in calls]
    errors = [g for g in got if isinstance(g, tuple)]
    assert len(errors) == 8
    rows = [r for g in got if not isinstance(g, tuple)
            for r in (g if isinstance(g, list) else [g])]
    assert t_schema.validate_rows(rows) == []


# -------------------------------------------------------- the baseline

def _bench_rows(seed, n=24):
    rng = np.random.default_rng(seed)
    units = ["ms", "tx/s", "us/sig", "logical_ms", "share", "x", "count",
             "actions/fault", "ratio"]
    rows = []
    for k in range(n):
        row = {"metric": "m%d" % (k % 9),
               "value": float(np.round(rng.random() * 500 + 1, 3)),
               "unit": units[k % 9]}
        if rng.random() < 0.5:
            row["cores"] = int(rng.integers(1, 64))
        if rng.random() < 0.3:
            row["launch_probe_ms"] = float(np.round(rng.random(), 3))
        rows.append(row)
    rows.append({"metric": "no_value"})
    rows.append({"metric": "selfdrive_oscillation_reversals", "value": 0.0,
                 "unit": "count", "faults": 3, "actions": 3})
    rows.append({"metric": "rejoin_flatness_vs_depth", "value": 1.4,
                 "unit": "x"})
    return rows


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_canonicalize_pin_and_check_match_the_jax_package(seed, tmp_path):
    rows = _bench_rows(seed)
    assert t_base.canonicalize_rows(rows) == j_base.canonicalize_rows(rows)
    files = {}
    for name, mod in (("jax", j_base), ("port", t_base)):
        path = tmp_path / f"{name}.json"
        mod.pin(rows, str(path), note=f"seed {seed}")
        files[name] = path.read_text()
    assert files["port"] != ""
    strip = lambda text: re.sub(  # noqa: E731
        rf'"{TIMESTAMP}": "[^"]*"', f'"{TIMESTAMP}": ""', text)
    assert strip(files["port"]) == strip(files["jax"])
    pinned = json.loads(files["port"])
    assert set(pinned) == {"schema_version", TIMESTAMP, "note", "rows"}
    fresh = _bench_rows(seed + 50)
    stale = dict(pinned, schema_version=pinned["schema_version"] + 1)
    drift = fresh + [{"metric": "tiny_logical_commit_ms", "value": 1.0,
                      "unit": "logical_ms"}]
    for base in (t_base.load_baseline(str(tmp_path / "port.json")), stale):
        for rows_in in (fresh, rows, drift, []):
            got = t_base.check_rows(rows_in, base)
            assert got == j_base.check_rows(rows_in, base)
            assert t_base.render_check(got) == j_base.render_check(got)
    verdict = t_base.check_rows(fresh, pinned)
    assert verdict["checked"] and (verdict["regressions"]
                                   or verdict["improvements"])


#: runs of the tiny logical row in each package
TINY_RUNS = 5
#: the commit-paced submitter's scheduler tick (``wait_for``'s 0.05 s) over
#: the requests of a row: one request's latency moving by one tick moves
#: the row's mean by this much
TINY_REQUESTS = 4
TINY_STEP_MS = 50.0 / TINY_REQUESTS


def test_tiny_logical_row_matches_the_jax_package():
    """Each package's row at the same seed, ``TINY_RUNS`` times.  The JAX
    package's row is not reproducible: its driver grants the loop 1 ms of
    host time a tick, so a request's commit can land a scheduler tick
    earlier or later (10 runs at 4 requests gave 112.5-162.5 logical ms).
    The port's driver grants a fixed number of loop passes a tick, and
    its row is one value (112.5 at 4 requests: the JAX package's fastest
    run).  So the two samples are compared as spreads: their means lie
    within three ticks of each other, every row validates, and every
    other field agrees."""
    jax_rows = [j_base.tiny_logical_row(requests=TINY_REQUESTS)
                for _ in range(TINY_RUNS)]
    port_rows = [t_base.tiny_logical_row(requests=TINY_REQUESTS)
                 for _ in range(TINY_RUNS)]
    fixed = ("metric", "unit", "requests", "decisions", "nodes", "seed")
    for row in port_rows:
        assert t_schema.validate_row(row) == []
        assert {k: row[k] for k in fixed} == {k: jax_rows[0][k]
                                              for k in fixed}
        assert row["latency"]["count"] == TINY_REQUESTS
    mean = lambda rows: sum(r["value"] for r in rows) / len(rows)  # noqa: E731
    assert abs(mean(port_rows) - mean(jax_rows)) <= 3 * TINY_STEP_MS, (
        [r["value"] for r in jax_rows], [r["value"] for r in port_rows])


#: the port's tiny row, in logical ms, by request count
TINY_VALUE = {4: 112.5, 10: 105.0}
#: the repository's pinned row (``BASELINE_OBS.json``, the JAX package's)
#: and the most the baseline check lets a row reach at its 100 %
BASELINE_TINY_MS, BASELINE_TINY_LIMIT_MS = 105.0, 210.0


@pytest.mark.parametrize("requests", sorted(TINY_VALUE))
def test_the_tiny_logical_row_is_one_value(requests):
    """Ten runs of the port's row give one value, the same at every
    request count tried, within the repository baseline's limit, and it
    checks clean against ``BASELINE_OBS.json`` as the card's smoke does
    (at the default 10 requests it equals the pinned 105.0)."""
    rows = [t_base.tiny_logical_row(requests=requests) for _ in range(10)]
    assert {r["value"] for r in rows} == {TINY_VALUE[requests]}
    assert TINY_VALUE[requests] <= BASELINE_TINY_LIMIT_MS
    assert {r["decisions"] for r in rows} == {requests}
    base = t_base.load_baseline(str(ROOT / "BASELINE_OBS.json"))
    assert base["rows"]["tiny_logical_commit_ms"]["value"] \
        == BASELINE_TINY_MS
    verdict = t_base.check_rows(rows[:1], base)
    assert verdict["ok"], t_base.render_check(verdict)
    assert verdict["checked"] == ["tiny_logical_commit_ms"]
    assert not verdict["regressions"]
