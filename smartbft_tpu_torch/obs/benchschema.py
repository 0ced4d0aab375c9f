"""Versioned bench-row schema: the cross-run comparability contract.

A copy of the JAX package's schema: a row validates the same way under
both.  Every bench row family (the ``assemble_*_row`` pure functions of
the benches plus the kernel/throughput headline rows) is pinned here as
a small JSON-schema-style description: required keys with types,
optional keys typed when present, nested blocks described recursively.
Two consumers rely on it:

* the drift gate (tests) validates synthetic rows built through the
  SAME pure assemble functions the real benches call, so a row-shape
  change that would break downstream tooling fails in CI;
* the longitudinal baseline guard (:mod:`smartbft_tpu_torch.obs.baseline`)
  validates fresh rows before comparing them against a pinned baseline —
  rows from different runs are only comparable because this schema
  says they still mean the same thing.

Unknown top-level keys are ALLOWED (additive evolution is the norm);
missing required keys and type changes are the drift this gate exists to
catch.  ``SCHEMA_VERSION`` is stamped into every baseline file; a pinned
baseline whose schema version disagrees with the checker's is reported
instead of silently compared.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["SCHEMA_VERSION", "ROW_SCHEMAS", "assemble_rejoin_row",
           "assemble_read_row", "assemble_read_scaling_row",
           "assemble_selfdrive_rows",
           "identify_row", "validate_row", "validate_rows"]

#: bump when a row family's required shape changes incompatibly
SCHEMA_VERSION = 1

_NUM = (int, float)
_STR = (str,)
_DICT = (dict,)
_LIST = (list,)


def _check(obj, schema: dict, path: str, errors: list[str]) -> None:
    if not isinstance(obj, dict):
        errors.append(f"{path or '<row>'}: expected object, got "
                      f"{type(obj).__name__}")
        return
    for key, want in schema.get("required", {}).items():
        if key not in obj or obj[key] is None:
            errors.append(f"{path}{key}: required key missing")
            continue
        _check_value(obj[key], want, f"{path}{key}", errors)
    for key, want in schema.get("optional", {}).items():
        if key in obj and obj[key] is not None:
            _check_value(obj[key], want, f"{path}{key}", errors)


def _check_value(value, want, path: str, errors: list[str]) -> None:
    if isinstance(want, dict):
        _check(value, want, path + ".", errors)
    elif isinstance(want, tuple):
        # bool is an int subclass; a numeric field turning bool is drift
        if isinstance(value, bool) and bool not in want:
            errors.append(f"{path}: expected "
                          f"{'/'.join(t.__name__ for t in want)}, got bool")
        elif not isinstance(value, want):
            errors.append(
                f"{path}: expected {'/'.join(t.__name__ for t in want)}, "
                f"got {type(value).__name__}"
            )
    elif callable(want):
        err = want(value)
        if err:
            errors.append(f"{path}: {err}")


def _list_of(item_schema) -> "callable":
    def check(value):
        if not isinstance(value, list):
            return f"expected list, got {type(value).__name__}"
        errs: list[str] = []
        for i, item in enumerate(value):
            _check_value(item, item_schema, f"[{i}]", errs)
        return "; ".join(errs) if errs else None

    return check


#: the percentile sub-block LogScaleHistogram.snapshot() emits
_PCTS = {"required": {"count": _NUM, "p50_ms": _NUM, "p95_ms": _NUM,
                      "p99_ms": _NUM, "max_ms": _NUM},
         "optional": {"mean_ms": _NUM}}

_LATENCY_BLOCK = {
    "required": {"count": _NUM, "p50_ms": _NUM, "p95_ms": _NUM,
                 "p99_ms": _NUM, "shed": _DICT, "histogram": _DICT},
    "optional": {"mean_ms": _NUM, "max_ms": _NUM, "pending_stamps": _NUM,
                 "dropped_stamps": _NUM, "per_shard": _DICT,
                 "phases": _DICT, "knee": _DICT},
}

_PROTOCOL_PLANE = {
    "required": {"ingest_us": _NUM, "route_us": _NUM, "vote_reg_us": _NUM,
                 "codec_us": _NUM},
    "optional": {"broadcasts": _NUM, "sends": _NUM, "encodes": _NUM,
                 "decodes": _NUM, "batch_ingests": _NUM,
                 "msgs_ingested": _NUM},
}

#: shared shape of the self-driving controller guard rows
_SELFDRIVE_ROW = {
    "required": {"metric": _STR, "value": _NUM, "unit": _STR,
                 "faults": _NUM, "actions": _NUM},
    "optional": {"actions_ok": _NUM, "scale_out": _NUM,
                 "scale_in": _NUM, "retune": _NUM, "vetoes": _DICT,
                 "final_status": _STR, "fill_at_scale_out": _NUM,
                 "peak_fill": _NUM, "ctl_spans": _NUM,
                 "clear_spans": _NUM, "seed": _NUM,
                 "verdict_samples": _NUM},
}

ROW_SCHEMAS: dict = {
    # bench.py e2e_bench / assemble_e2e_row — the north-star row
    "committed_tx_per_sec_n*": {
        "required": {"metric": _STR, "value": _NUM, "unit": _STR,
                     "vs_baseline": _NUM, "baseline_tx_per_sec": _NUM,
                     "pipeline": _NUM, "burst_decisions": _NUM},
        "optional": {"launches": _NUM, "decisions": _NUM,
                     "launches_per_decision": _NUM, "window_launches": _LIST,
                     "batch_fill_pct": _NUM, "launch_probe_ms": _NUM,
                     "baseline_launch_probe_ms": _NUM, "breaker": _DICT,
                     "mesh": _DICT, "protocol_plane": _PROTOCOL_PLANE,
                     "baseline_protocol_plane": _DICT,
                     "tx_per_sec_probe_normalized": _NUM,
                     "vs_baseline_probe_normalized": _NUM},
    },
    # bench.py kernel_bench — the kernel micro headline
    "p256_sig_verify_p50_us": {
        "required": {"metric": _STR, "value": _NUM, "unit": _STR,
                     "vs_baseline": _NUM},
        "optional": {"vs_all_cores": _NUM, "cores": _NUM,
                     "protocol_plane": _PROTOCOL_PLANE},
    },
    # bench.py assemble_open_loop_row
    "open_loop_p99_ms": {
        "required": {"metric": _STR, "value": _NUM, "unit": _STR,
                     "offered_per_sec": _NUM, "goodput_per_sec": _NUM,
                     "latency": _LATENCY_BLOCK, "sweep": _list_of(_DICT)},
        "optional": {"shards": _NUM, "zipf_skew": _NUM,
                     "admission_high_water": _NUM, "viewchange": _DICT,
                     "trace": _DICT, "critical_path": _DICT,
                     "health": _DICT, "degraded_notes": _DICT},
    },
    # bench.py assemble_transport_row
    "transport_committed_tx_per_sec": {
        "required": {"metric": _STR, "value": _NUM, "unit": _STR,
                     "vs_baseline": _NUM, "flavor": _STR, "nodes": _NUM,
                     "requests": _NUM, "transport": _DICT},
        "optional": {"inproc_tx_per_sec": _NUM,
                     "protocol_plane": _PROTOCOL_PLANE,
                     "inproc_protocol_plane": _DICT,
                     "critical_path": _DICT, "cluster_trace": _DICT},
    },
    # bench.py assemble_sharded_row
    "sharded_committed_tx_per_sec": {
        "required": {"metric": _STR, "value": _NUM, "unit": _STR,
                     "vs_baseline": _NUM,
                     "shard": {"required": {"sweep": _list_of(_DICT)},
                               "optional": {"scaling": _DICT,
                                            "top": _DICT}}},
        "optional": {"reshard": _DICT},
    },
    # bench.py assemble_mesh_row
    "mesh_committed_tx_per_sec": {
        "required": {"metric": _STR, "value": _NUM, "unit": _STR,
                     "vs_baseline": _NUM, "devices": _NUM,
                     "mesh": {"required": {"sweep": _list_of(_DICT)},
                              "optional": {"gating": _DICT,
                                           "verdict_parity": _DICT,
                                           "verdict_parity_2d": _DICT,
                                           "capacity_scaling": _NUM,
                                           "topology": _STR,
                                           "downgrades": _NUM,
                                           "top": _DICT}}},
        "optional": {},
    },
    # bench.py viewchange_guard_rows — the forced-VC phase's
    # request p99 in the degraded harness, the longitudinal
    # failover-regression pin
    "viewchange_phase_p99_ms": {
        "required": {"metric": _STR, "value": _NUM, "unit": _STR},
        "optional": {"offered_per_sec": _NUM, "shards": _NUM,
                     "healthy_p99_ms": _NUM, "vs_healthy": _NUM},
    },
    # bench.py viewchange_guard_rows — complain-timer
    # arm-to-fire p99 under the degraded run's muted leader
    "viewchange_detection_p99_ms": {
        "required": {"metric": _STR, "value": _NUM, "unit": _STR},
        "optional": {"count": _NUM, "offered_per_sec": _NUM,
                     "shards": _NUM, "timer": _DICT},
    },
    # bench.py commitpath_guard_rows — the open-loop
    # saturation knee (highest swept offered load meeting the goodput +
    # shed SLO), the longitudinal raw-speed pin
    "open_loop_knee_tx_per_sec": {
        "required": {"metric": _STR, "value": _NUM, "unit": _STR},
        "optional": {"goodput_per_sec": _NUM, "p99_ms": _NUM,
                     "beyond_sweep": (bool,)},
    },
    # bench.py commitpath_guard_rows — HEALTHY-phase critical
    # path segment shares (unit "share", lower is better): the two
    # segments the commit-path work cut
    "critpath_*": {
        "required": {"metric": _STR, "value": _NUM, "unit": _STR},
        "optional": {"phase": _STR, "requests": _NUM,
                     "dominant_segment": _STR, "sums_consistent": (bool,),
                     "offered_per_sec": _NUM},
    },
    # bench.py commitpath_guard_rows — per-S knee of the
    # process-per-shard affinity sweep
    "open_loop_affinity_s*": {
        "required": {"metric": _STR, "value": _NUM, "unit": _STR,
                     "shards": _NUM},
        "optional": {"loop_affinity": _STR, "goodput_per_sec": _NUM,
                     "p99_ms": _NUM, "beyond_sweep": (bool,)},
    },
    # assemble_rejoin_row — rejoin wall-clock + bytes at a
    # given history depth, snapshot-install vs chain-replay control.
    # The flat-vs-depth guard pins the deep-history snapshot row within
    # 2x the shallow one (vs O(depth) for the replay control).
    "rejoin_*": {
        "required": {"metric": _STR, "value": _NUM, "unit": _STR,
                     "history_decisions": _NUM, "mode": _STR,
                     "bytes_transferred": _NUM},
        "optional": {"decisions_replayed": _NUM, "snapshot_bytes": _NUM,
                     "snap_chunks": _NUM, "requests": _NUM,
                     "vs_small_history": _NUM, "interval": _NUM},
    },
    # bench.py rejoin_guard_rows — deep-over-shallow snapshot
    # rejoin wall ratio (unit "x", lower is better); the committed
    # baseline pins the ideal 1.0 with a 100% allowance, encoding the
    # acceptance bound "deep rejoin within 2x shallow" directly.  Listed
    # as an EXACT family so it wins over the rejoin_* wildcard.
    "rejoin_flatness_vs_depth": {
        "required": {"metric": _STR, "value": _NUM, "unit": _STR,
                     "history_small": _NUM, "history_deep": _NUM},
        "optional": {"snapshot_small_s": _NUM, "snapshot_deep_s": _NUM,
                     "replay_ratio": _NUM, "interval": _NUM},
    },
    # bench.py assemble_byzantine_row — honest-path request
    # p99 WITH an f=1 actor flooding forged votes at the shared verify
    # plane (per-sender accounting shuns + sheds it), next to the same
    # cluster's no-actor control; the baseline bounds the forger's
    # latency tax on honest clients
    "byzantine_forge_p99_ms": {
        "required": {"metric": _STR, "value": _NUM, "unit": _STR,
                     "healthy_p99_ms": _NUM},
        "optional": {"vs_healthy": _NUM, "forged": _NUM,
                     "shun_events": _NUM, "shed_votes": _NUM,
                     "spike_acked": _NUM, "healthy_spike_acked": _NUM,
                     "latency": _LATENCY_BLOCK, "healthy_latency": _DICT},
    },
    # assemble_read_row — mixed 95/5 read/write sweep against
    # the socket cluster: wall-clock quorum-read p99 next to the SAME
    # run's write (submit->committed) p99.  The read plane never touches
    # consensus, so the pinned contrast is reads staying far under the
    # write path; the storm block records that an over-gate read flood
    # shed READS while the concurrent writes kept committing.
    "read_p99_ms": {
        "required": {"metric": _STR, "value": _NUM, "unit": _STR,
                     "write_p99_ms": _NUM, "nodes": _NUM, "reads": _NUM},
        "optional": {"writes": _NUM, "vs_write": _NUM, "mode": _STR,
                     "local_p99_ms": _NUM, "follower_p99_ms": _NUM,
                     "read_sheds": _NUM, "storm": _DICT, "read": _DICT},
    },
    # assemble_read_scaling_row — aggregate read capacity at
    # n=8 over n=4 at fixed S.  Local reads touch ONLY their serving
    # replica (no fan-out, no consensus work), so cluster read capacity
    # is n x the measured per-replica service rate; the row carries both
    # per-replica rates so a flat-with-n service rate (the isolation
    # invariant) is what the guard actually pins.  On a multi-core host
    # the aggregate is realized parallelism; on a 1-core rig it is
    # capacity aggregation under that measured invariant.
    "read_scaling_vs_n": {
        "required": {"metric": _STR, "value": _NUM, "unit": _STR,
                     "nodes_small": _NUM, "nodes_large": _NUM},
        "optional": {"reads_per_sec_small": _NUM,
                     "reads_per_sec_large": _NUM,
                     "per_replica_rate_small": _NUM,
                     "per_replica_rate_large": _NUM,
                     "rate_flatness": _NUM, "ideal": _NUM},
    },
    # assemble_selfdrive_rows — the controller's behavior
    # under the remediation_storm chaos round: actions taken per injected
    # fault (unit "actions/fault", lower is better — a thrashing
    # controller fails this long before it breaks safety) and A→B→A
    # oscillation reversals inside one hysteresis window (unit "count",
    # pinned at 0 so ANY flip-flop regresses the baseline).  The
    # oscillation row is listed as an EXACT family so it wins over the
    # wildcard and can carry its own (tighter) baseline threshold.
    "selfdrive_*": _SELFDRIVE_ROW,
    "selfdrive_oscillation_reversals": _SELFDRIVE_ROW,
    # obs.baseline.tiny_logical_row — the tier-1 regression-gate row
    # (value = mean logical commit latency; percentiles ride in "latency")
    "tiny_logical_commit_ms": {
        "required": {"metric": _STR, "value": _NUM, "unit": _STR,
                     "requests": _NUM, "decisions": _NUM,
                     "latency": _PCTS},
        "optional": {"nodes": _NUM, "seed": _NUM, "p50_ms": _NUM},
    },
}


def assemble_rejoin_row(*, history: int, mode: str, rejoin_s: float,
                        bytes_transferred: int,
                        decisions_replayed: Optional[int] = None,
                        snapshot_bytes: Optional[int] = None,
                        snap_chunks: Optional[int] = None,
                        interval: Optional[int] = None,
                        vs_small_history: Optional[float] = None) -> dict:
    """The ``rejoin_*`` bench row, as a PURE function so the
    tier-1 schema gate can validate synthetic rows without running the
    bench.  ``mode`` is ``"snapshot"`` (offer + install + tail) or
    ``"replay"`` (the full chain-replay control); ``vs_small_history``
    is this row's wall-clock over the smallest swept history's — the
    flat-vs-depth guard the baseline pins (snapshot mode must stay ~1.0
    while the replay control grows with depth)."""
    if mode not in ("snapshot", "replay"):
        raise ValueError(f"mode must be 'snapshot' or 'replay', got {mode!r}")
    row = {
        "metric": f"rejoin_wall_s_h{int(history)}_{mode}",
        "value": round(float(rejoin_s), 4),
        "unit": "s",
        "history_decisions": int(history),
        "mode": mode,
        "bytes_transferred": int(bytes_transferred),
    }
    if decisions_replayed is not None:
        row["decisions_replayed"] = int(decisions_replayed)
    if snapshot_bytes is not None:
        row["snapshot_bytes"] = int(snapshot_bytes)
    if snap_chunks is not None:
        row["snap_chunks"] = int(snap_chunks)
    if interval is not None:
        row["interval"] = int(interval)
    if vs_small_history is not None:
        row["vs_small_history"] = round(float(vs_small_history), 4)
    return row


def assemble_read_row(*, read_p99_ms: float, write_p99_ms: float,
                      nodes: int, reads: int, writes: Optional[int] = None,
                      mode: str = "quorum",
                      local_p99_ms: Optional[float] = None,
                      follower_p99_ms: Optional[float] = None,
                      read_sheds: Optional[int] = None,
                      storm: Optional[dict] = None,
                      read_stats: Optional[dict] = None) -> dict:
    """The ``read_p99_ms`` bench row, as a PURE function so
    the tier-1 schema gate can validate synthetic rows without running
    the bench.  ``read_p99_ms`` is the wall-clock p99 of ``mode`` reads
    during the mixed 95/5 phase; ``write_p99_ms`` the SAME phase's
    submit->committed p99 — the pinned contrast is the read plane never
    paying consensus latency."""
    if mode not in ("local", "follower", "quorum"):
        raise ValueError(f"mode must be local/follower/quorum, got {mode!r}")
    row = {
        "metric": "read_p99_ms",
        "value": round(float(read_p99_ms), 3),
        "unit": "ms",
        "write_p99_ms": round(float(write_p99_ms), 3),
        "nodes": int(nodes),
        "reads": int(reads),
        "mode": mode,
    }
    if write_p99_ms:
        row["vs_write"] = round(float(read_p99_ms) / float(write_p99_ms), 4)
    if writes is not None:
        row["writes"] = int(writes)
    if local_p99_ms is not None:
        row["local_p99_ms"] = round(float(local_p99_ms), 3)
    if follower_p99_ms is not None:
        row["follower_p99_ms"] = round(float(follower_p99_ms), 3)
    if read_sheds is not None:
        row["read_sheds"] = int(read_sheds)
    if storm is not None:
        row["storm"] = dict(storm)
    if read_stats is not None:
        row["read"] = dict(read_stats)
    return row


def assemble_read_scaling_row(*, per_replica_rate_small: float,
                              per_replica_rate_large: float,
                              nodes_small: int, nodes_large: int) -> dict:
    """The ``read_scaling_vs_n`` bench row: aggregate read
    capacity (n x measured per-replica local-read service rate) at
    ``nodes_large`` over ``nodes_small``.  ``rate_flatness`` is the
    per-replica rate ratio large/small — the isolation invariant (a
    local read costs the same no matter the cluster size) that makes
    the aggregate claim honest on any core count."""
    if nodes_small <= 0 or nodes_large <= nodes_small:
        raise ValueError(
            f"need 0 < nodes_small < nodes_large, got "
            f"{nodes_small}/{nodes_large}"
        )
    if per_replica_rate_small <= 0 or per_replica_rate_large <= 0:
        raise ValueError("per-replica rates must be positive")
    agg_small = per_replica_rate_small * nodes_small
    agg_large = per_replica_rate_large * nodes_large
    return {
        "metric": "read_scaling_vs_n",
        "value": round(agg_large / agg_small, 4),
        "unit": "ratio",
        "nodes_small": int(nodes_small),
        "nodes_large": int(nodes_large),
        "reads_per_sec_small": round(agg_small, 1),
        "reads_per_sec_large": round(agg_large, 1),
        "per_replica_rate_small": round(float(per_replica_rate_small), 1),
        "per_replica_rate_large": round(float(per_replica_rate_large), 1),
        "rate_flatness": round(
            per_replica_rate_large / per_replica_rate_small, 4),
        "ideal": round(nodes_large / nodes_small, 4),
    }


def assemble_selfdrive_rows(stats: dict) -> list:
    """The ``selfdrive_*`` bench rows, as a PURE function over
    the stats dict :func:`remediation_storm_round` returns, so the tier-1
    schema gate can validate synthetic rows without running the ~20s
    chaos round.  Two rows: ``selfdrive_actions_per_fault`` (how many
    remediations the controller spent per injected fault — the
    anti-thrash pin) and ``selfdrive_oscillation_reversals`` (A→B→A
    flips inside one hysteresis window — pinned at zero)."""
    faults = int(stats.get("faults", 0))
    actions = int(stats.get("actions", 0))
    if faults <= 0:
        raise ValueError(f"faults must be positive, got {faults}")
    if actions < 0:
        raise ValueError(f"actions must be >= 0, got {actions}")
    reversals = int(stats.get("reversals", 0))
    common = {
        "faults": faults,
        "actions": actions,
        "actions_ok": int(stats.get("actions_ok", actions)),
        "scale_out": int(stats.get("scale_out", 0)),
        "scale_in": int(stats.get("scale_in", 0)),
        "retune": int(stats.get("retune", 0)),
    }
    apf_row = {
        "metric": "selfdrive_actions_per_fault",
        "value": round(actions / faults, 4),
        "unit": "actions/fault",
        **common,
    }
    rev_row = {
        "metric": "selfdrive_oscillation_reversals",
        "value": float(reversals),
        "unit": "count",
        **common,
    }
    for key in ("vetoes", "final_status", "fill_at_scale_out", "peak_fill",
                "ctl_spans", "clear_spans", "seed", "verdict_samples"):
        val = stats.get(key)
        if val is None:
            continue
        if key == "vetoes":
            apf_row[key] = dict(val)
        elif key == "final_status":
            apf_row[key] = str(val)
        elif key in ("fill_at_scale_out", "peak_fill"):
            apf_row[key] = round(float(val), 4)
        else:
            apf_row[key] = int(val)
    return [apf_row, rev_row]


def identify_row(row: dict) -> Optional[str]:
    """The schema family a row belongs to, or None for unpinned rows."""
    metric = row.get("metric")
    if not isinstance(metric, str):
        return None
    if metric in ROW_SCHEMAS:
        return metric
    for family in ROW_SCHEMAS:
        if family.endswith("*") and metric.startswith(family[:-1]):
            return family
    return None


def validate_row(row: dict) -> list[str]:
    """Schema errors for one row ([] when clean or the family is
    unpinned — an unknown family is not drift, it is a new row)."""
    family = identify_row(row)
    if family is None:
        return []
    errors: list[str] = []
    _check(row, ROW_SCHEMAS[family], "", errors)
    return [f"{family}: {e}" for e in errors]


def validate_rows(rows: list) -> list[str]:
    errors: list[str] = []
    for i, row in enumerate(rows):
        for e in validate_row(row):
            errors.append(f"row[{i}] {e}")
    return errors
