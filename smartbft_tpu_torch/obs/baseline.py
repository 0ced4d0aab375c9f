"""Longitudinal bench-regression guard: pin a baseline, diff every run.

A copy of the JAX package's guard, so that the port's bench rows are
compared the same way:

* :func:`canonicalize_rows` folds any bench row family (identified by
  its ``metric`` field and validated against
  :mod:`~smartbft_tpu_torch.obs.benchschema`) into ONE canonical entry per
  metric: best-of-reps value (min for lower-is-better units, max for
  higher-is-better), the rep spread, the host-weather fields carried
  verbatim (launch probe, core count) so a future reader can judge
  comparability, and a noise-aware threshold — the allowed regression
  percentage, widened to 1.5x the observed rep spread when the reps
  disagreed more than the family default.

* :func:`pin` writes the canonical entries + ``schema_version`` into a
  baseline file; :func:`check_rows` diffs a fresh run against it and
  reports regressions (worse than baseline by more than the pinned
  threshold), improvements, and schema drift.  A baseline file is read
  only where the caller names one.

* ``python -m smartbft_tpu_torch.obs.baseline pin|check`` is the CLI;
  ``check`` exits non-zero on a regression, a schema drift, or a run
  that compared nothing.

* :func:`tiny_logical_row` produces a deterministic LOGICAL-CLOCK row (a
  4-node in-process cluster commits a fixed workload on the tick-driven
  scheduler; latencies are logical seconds, independent of host speed),
  which checks against the repository's ``BASELINE_OBS.json`` on any
  host.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

from .benchschema import SCHEMA_VERSION, identify_row, validate_rows

__all__ = [
    "canonicalize_rows",
    "pin",
    "load_baseline",
    "check_rows",
    "tiny_logical_row",
    "main",
]

#: units where a SMALLER value is better (latency-shaped, plus critpath
#: segment shares — a segment REGAINING commit-path share is the
#: regression the commit-path guard rows exist to catch)
#: ("x" is the ratio unit of the rejoin flatness guard — deep-history
#: rejoin wall over shallow, where growing IS the regression)
#: ("actions/fault" and "count" are the self-driving controller's guard
#: units — more remediations per fault, or any oscillation reversal,
#: means the control plane got twitchier)
LOWER_IS_BETTER_UNITS = {"ms", "us", "us/sig", "logical_ms", "s", "share",
                         "x", "actions/fault", "count"}

#: host-weather fields carried into the baseline verbatim — the context a
#: future reader needs to judge whether two rounds are comparable at all
WEATHER_FIELDS = ("launch_probe_ms", "baseline_launch_probe_ms", "cores",
                  "devices", "shards", "nodes", "pipeline",
                  "burst_decisions", "offered_per_sec")

#: default allowed-regression percentage per family; wall-clock rows get
#: a wide default (this rig's measured run-to-run weather is 2-3x under
#: contention), the logical row a tight one (the clock is deterministic)
DEFAULT_THRESHOLD_PCT = 35.0
FAMILY_THRESHOLD_PCT = {
    "tiny_logical_commit_ms": 100.0,
    # pinned at the ideal 1.0: fail only when deep-history snapshot
    # rejoin exceeds 2x the shallow one (the acceptance bound)
    "rejoin_flatness_vs_depth": 100.0,
    # single-digit wall ms over connect-per-call sockets: run-to-run
    # weather on the contended 1-core rig dwarfs the 35% default
    "read_p99_ms": 100.0,
    # the acceptance is scaling strictly above 1.0; pinned at
    # the measured ~2.17x for n=8/n=4, 45% still fails below ~1.2x
    "read_scaling_vs_n": 45.0,
    # pinned at the measured 1.0 action/fault; 100% allowance
    # means the guard trips only past 2 actions per injected fault (the
    # anti-thrash acceptance bound)
    "selfdrive_*": 100.0,
    # baseline 0 makes ANY reversal a flat 100% delta; the threshold
    # must sit strictly BELOW 100 (check is delta > threshold) so one
    # flip-flop fails.  Exact family, wins over the wildcard.
    "selfdrive_oscillation_reversals": 50.0,
}


def _direction(row: dict) -> str:
    unit = str(row.get("unit", ""))
    return "lower" if unit in LOWER_IS_BETTER_UNITS else "higher"


def canonicalize_rows(rows: list) -> dict:
    """Fold bench rows (one or more reps per metric) into canonical
    baseline entries keyed by metric name.  Rows without a ``metric`` +
    numeric ``value`` are skipped (sweep-point rows ride inside their
    assembled parent)."""
    groups: dict[str, list[dict]] = {}
    for row in rows:
        metric = row.get("metric")
        value = row.get("value")
        if not isinstance(metric, str) or not isinstance(value, (int, float)) \
                or isinstance(value, bool):
            continue
        groups.setdefault(metric, []).append(row)
    out: dict = {}
    for metric, reps in groups.items():
        direction = _direction(reps[0])
        values = [float(r["value"]) for r in reps]
        best = min(values) if direction == "lower" else max(values)
        worst = max(values) if direction == "lower" else min(values)
        spread_pct = (abs(worst - best) / abs(best) * 100.0) if best else 0.0
        family = identify_row(reps[0]) or metric
        default_pct = FAMILY_THRESHOLD_PCT.get(
            family, FAMILY_THRESHOLD_PCT.get(metric, DEFAULT_THRESHOLD_PCT)
        )
        threshold_pct = round(max(default_pct, spread_pct * 1.5), 1)
        weather = {}
        for r in reps:
            for k in WEATHER_FIELDS:
                if r.get(k) is not None and k not in weather:
                    weather[k] = r[k]
        out[metric] = {
            "value": best,
            "unit": reps[0].get("unit", ""),
            "direction": direction,
            "reps": len(reps),
            "spread_pct": round(spread_pct, 1),
            "threshold_pct": threshold_pct,
            "weather": weather,
        }
    return out


def pin(rows: list, path: str, *, note: str = "") -> dict:
    """Canonicalize ``rows`` and write the pinned baseline file."""
    entries = canonicalize_rows(rows)
    baseline = {
        "schema_version": SCHEMA_VERSION,
        "pinned_at": time.strftime("%Y-%m-%d", time.gmtime()),
        "note": note,
        "rows": entries,
    }
    with open(path, "w") as fh:
        json.dump(baseline, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return baseline


def load_baseline(path: str) -> dict:
    with open(path) as fh:
        baseline = json.load(fh)
    if "rows" not in baseline:
        raise ValueError(f"{path}: not a baseline file (no 'rows')")
    return baseline


def check_rows(rows: list, baseline: dict) -> dict:
    """Diff fresh bench rows against a pinned baseline.

    Returns ``{"checked", "regressions", "improvements", "missing",
    "schema_errors", "ok"}``.  A metric regresses when its fresh value
    is worse than the pinned one by more than the pinned threshold; a
    fresh run missing a pinned metric is reported (``missing``) but not
    fatal — benches are modal, one run rarely produces every family.
    Schema drift in the fresh rows IS fatal: a row that no longer parses
    the way it did when pinned cannot be compared at all."""
    schema_errors = validate_rows(rows)
    pinned_version = baseline.get("schema_version")
    if pinned_version != SCHEMA_VERSION:
        schema_errors.insert(0, (
            f"baseline schema_version {pinned_version} != checker "
            f"{SCHEMA_VERSION}: re-pin before comparing"
        ))
    fresh = canonicalize_rows(rows)
    pinned = baseline.get("rows", {})
    regressions, improvements, checked = [], [], []
    for metric, entry in sorted(pinned.items()):
        got = fresh.get(metric)
        if got is None:
            continue
        checked.append(metric)
        base_v = float(entry["value"])
        new_v = float(got["value"])
        threshold = float(entry.get("threshold_pct", DEFAULT_THRESHOLD_PCT))
        if base_v == 0.0:
            delta_pct = 0.0 if new_v == 0.0 else 100.0
        elif entry.get("direction") == "lower":
            delta_pct = (new_v - base_v) / abs(base_v) * 100.0
        else:
            delta_pct = (base_v - new_v) / abs(base_v) * 100.0
        row = {
            "metric": metric,
            "baseline": base_v,
            "value": new_v,
            "unit": entry.get("unit", ""),
            "direction": entry.get("direction", "higher"),
            "delta_pct": round(delta_pct, 1),   # positive = worse
            "threshold_pct": threshold,
            "weather": {"pinned": entry.get("weather", {}),
                        "fresh": got.get("weather", {})},
        }
        if delta_pct > threshold:
            regressions.append(row)
        elif delta_pct < -threshold:
            improvements.append(row)
    missing = sorted(set(pinned) - set(fresh))
    return {
        "checked": checked,
        "regressions": regressions,
        "improvements": improvements,
        "missing": missing,
        "schema_errors": schema_errors,
        "ok": not regressions and not schema_errors,
    }


def render_check(result: dict) -> str:
    out = [f"baseline check: {len(result['checked'])} metric(s) compared"]
    for r in result["regressions"]:
        out.append(
            f"  REGRESSION {r['metric']}: {r['value']:g} {r['unit']} vs "
            f"baseline {r['baseline']:g} ({r['delta_pct']:+.1f}% worse, "
            f"threshold {r['threshold_pct']:g}%)"
        )
    for r in result["improvements"]:
        out.append(
            f"  improvement {r['metric']}: {r['value']:g} {r['unit']} vs "
            f"baseline {r['baseline']:g} ({-r['delta_pct']:.1f}% better)"
        )
    for e in result["schema_errors"]:
        out.append(f"  SCHEMA DRIFT: {e}")
    if result["missing"]:
        out.append(f"  not produced this run: {', '.join(result['missing'])}")
    out.append("  OK" if result["ok"] else "  FAILED")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# the tier-1 gate row: a deterministic logical-clock micro workload
# ---------------------------------------------------------------------------

#: scheduling passes of the event loop that each logical tick of the tiny
#: row grants the cluster (see :func:`_tick_until`).  Every budget from 5
#: to 8 passes gives the same row: 105.0 logical ms at 10 requests
TINY_TICK_PASSES = 6


async def _tick_until(predicate, scheduler, timeout: float,
                      step: float = 0.05) -> None:
    """Advance ``scheduler`` by ``step`` until ``predicate()`` holds,
    granting the event loop exactly :data:`TINY_TICK_PASSES` scheduling
    passes before each tick.  ``testing.app.wait_for`` grants 1 ms of
    host time instead, and how much of a commit's cascade (each replica's
    inline WAL fsyncs included) fits in 1 ms depends on the host, so a
    request's commit landed a tick earlier or later from run to run.  A
    fixed number of passes makes the row a function of the commit path
    alone: a path that needs more passes lands a tick later."""
    import asyncio

    elapsed = 0.0
    while elapsed < timeout:
        if predicate():
            return
        for _ in range(TINY_TICK_PASSES):
            await asyncio.sleep(0)
        scheduler.advance_by(step)
        elapsed += step
    raise TimeoutError(f"condition not met within {timeout}s of logical time")


async def _tiny_logical_run(*, requests: int, n: int, seed: int) -> dict:
    import dataclasses
    import tempfile

    from ..metrics import CommitLatencyTracker
    from ..testing.app import App, SharedLedgers, fast_config
    from ..testing.network import Network
    from ..utils.clock import Scheduler

    scheduler = Scheduler()
    network = Network(seed=seed)
    shared = SharedLedgers()
    tracker = CommitLatencyTracker(clock=scheduler.now)
    with tempfile.TemporaryDirectory(prefix="sbft-baseline-tiny-") as root:
        cfg = lambda i: dataclasses.replace(
            fast_config(i),
            request_batch_max_count=2,
            request_batch_max_interval=0.05,
            leader_rotation=False,
            decisions_per_leader=0,
        )
        apps = [
            App(i, network, shared, scheduler, wal_dir=f"{root}/wal-{i}",
                config=cfg(i))
            for i in range(1, n + 1)
        ]
        for a in apps:
            await a.start()
        probe = apps[0]
        scanned = 0

        def scan() -> int:
            nonlocal scanned
            ledger = probe.ledger()
            for d in ledger[scanned:]:
                for info in probe.requests_from_proposal(d.proposal):
                    tracker.on_committed(str(info), 0)
            scanned = len(ledger)
            return scanned

        try:
            committed = 0
            for k in range(requests):
                key = f"tiny:t-{k}"
                tracker.on_submitted(key)
                await apps[0].submit("tiny", f"t-{k}")
                committed += 1
                # commit-paced submission: each request's logical latency
                # is the protocol's own commit time, not queueing skew
                await _tick_until(
                    lambda: (scan(), tracker.pending() == 0)[-1],
                    scheduler, 30.0,
                )
            decisions = len(probe.ledger())
        finally:
            for a in apps:
                await a.stop()
    snap = tracker.aggregate.snapshot()
    return {
        # the VALUE is the mean: on the stepped logical clock a p99 is
        # one 0.05 s tick of asyncio interleaving away from flapping a
        # whole bucket, while the mean moves only when the commit path
        # itself changes; the full percentile block rides along
        "metric": "tiny_logical_commit_ms",
        "value": snap["mean_ms"],
        "unit": "logical_ms",
        "requests": requests,
        "decisions": decisions,
        "nodes": n,
        "seed": seed,
        "p50_ms": snap["p50_ms"],
        "latency": snap,
    }


def tiny_logical_row(*, requests: int = 10, n: int = 4, seed: int = 7) -> dict:
    """One deterministic logical-clock bench row: a 4-node in-process
    cluster commits ``requests`` commit-paced requests on the tick-driven
    scheduler, each tick after a fixed budget of event-loop passes
    (:func:`_tick_until`); the row's value is the MEAN submit->commit
    latency in LOGICAL milliseconds (percentiles ride in the ``latency``
    block).  The same value on every run and host (105.0 at the default
    10 requests, 112.5 at 4), so the committed baseline holds on any rig,
    and a protocol regression that stretches the commit path (a timer
    bug, a lost wave needing a retransmit round, an extra hop) moves
    it."""
    import asyncio

    return asyncio.run(_tiny_logical_run(requests=requests, n=n, seed=seed))


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _read_rows(path: str) -> list:
    """Rows from a JSON-lines file, a JSON array, or a dict with rows."""
    with open(path) as fh:
        text = fh.read()
    try:
        data = json.loads(text)
        if isinstance(data, list):
            return data
        if isinstance(data, dict):
            return [data]
    except json.JSONDecodeError:
        pass
    rows = []
    for line in text.splitlines():
        line = line.strip()
        if line:
            rows.append(json.loads(line))
    return rows


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Pin and check longitudinal bench baselines"
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_pin = sub.add_parser("pin", help="canonicalize rows into a baseline")
    p_pin.add_argument("--rows", action="append", required=False, default=[],
                       help="JSON/JSON-lines file(s) of bench rows")
    p_pin.add_argument("--out", required=True, help="baseline file to write")
    p_pin.add_argument("--note", default="")
    p_pin.add_argument("--tiny-logical", action="store_true",
                       help="also run the deterministic logical-clock row "
                            "and pin it")
    p_chk = sub.add_parser("check", help="diff fresh rows against a baseline")
    p_chk.add_argument("--rows", action="append", required=False, default=[],
                       help="JSON/JSON-lines file(s) of fresh bench rows")
    p_chk.add_argument("--baseline", required=True)
    p_chk.add_argument("--tiny-logical", action="store_true",
                       help="also run the deterministic logical-clock row "
                            "and include it in the check")
    args = ap.parse_args(argv)

    rows: list = []
    for path in args.rows:
        rows.extend(_read_rows(path))
    if args.tiny_logical:
        rows.append(tiny_logical_row())

    if args.cmd == "pin":
        baseline = pin(rows, args.out, note=args.note)
        print(f"pinned {len(baseline['rows'])} metric(s) -> {args.out}")
        return 0

    result = check_rows(rows, load_baseline(args.baseline))
    print(render_check(result))
    if not result["checked"]:
        # zero metrics compared = the guard verified nothing; exiting 0
        # here would read as green precisely when every producer broke
        print("  VACUOUS: no pinned metric was produced this run")
        return 1
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
