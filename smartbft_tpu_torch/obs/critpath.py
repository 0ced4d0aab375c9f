"""Per-request critical-path decomposition: where did THIS request's
latency go, across the whole cluster?

The flight recorders answer "what happened on node i"; this module joins
their events into one answer per REQUEST: submit → leader pool →
propose broadcast → prepare quorum (the voter who completed it named) →
commit-record WAL persist → commit quorum → deliver.  The decomposition
follows the vcphases sums-consistent idiom — each segment is the delta
between consecutive PRESENT marks on one timeline, a missing mark's
interval is absorbed by the next present mark — so segment sums equal
the measured end-to-end commit latency by construction, with the worst
residual (clamped negative deltas from cross-process clock skew)
reported instead of hidden.

One deliberate divergence from the idealized segment order: this
implementation persists the commit record BEFORE broadcasting its
commit vote (the WAL-first rule every view obeys), so the
``wal_persist`` segment sits between the prepare quorum and the commit
quorum — the true pipeline, not the idealized one.

Mark vocabulary (flight-recorder event kinds):

==================  =====================================================
``req.submit``      front-door entry (pool.submit, pre-admission)
``req.pool``        pooled (admission/park wait ended)
``batch.propose``   the leader assembled the batch containing it
``quorum.prepare``  prepare quorum completed (extra.slowest_voter = the
                    node whose vote completed it)
``wal.persist``     the commit record's durability wave resolved
``quorum.commit``   commit quorum completed (slowest voter named)
``req.deliver``     delivered (per request, carries (view, seq))
==================  =====================================================

Everything here is a PURE function over event dicts (the
``assemble_*`` idiom): benches feed it merged recorder snapshots, tests
feed it synthetic events, and the block schema is pinned through the
same function both use.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .recorder import pct as _pct

__all__ = ["SEGMENTS", "assemble_critical_path_block"]

#: canonical mark order along the request pipeline
_MARKS = ("submit", "pool", "propose", "prepare_quorum", "wal_persist",
          "commit_quorum", "deliver")

#: mark -> the segment ENDING at it (the interval since the previous
#: present mark), in pipeline order
_SEGMENT_OF = (
    ("pool", "pool_wait"),
    ("propose", "propose_wait"),
    ("prepare_quorum", "prepare_wave"),
    ("wal_persist", "wal_persist"),
    ("commit_quorum", "commit_wave"),
    ("deliver", "deliver"),
)

SEGMENTS = tuple(seg for _, seg in _SEGMENT_OF)

#: event kind -> (view,seq)-scoped mark name
_VS_MARK_OF_KIND = {
    "batch.propose": "propose",
    "quorum.prepare": "prepare_quorum",
    "wal.persist": "wal_persist",
    "quorum.commit": "commit_quorum",
}


def _shard_of(node: str) -> str:
    """The shard scope of a recorder label: ``"s0n1"`` -> ``"s0"``,
    ``"s2g1n3"`` -> ``"s2g1"`` (a reborn shard id's NEW generation is a
    distinct scope — two generations never share a (view, seq) space),
    ``"n4"`` -> ``""`` (single-group socket replicas)."""
    cut = node.rfind("n")
    return node[:cut] if cut > 0 else ""


def _vs_key(node: str, view: int, seq: int) -> tuple:
    return (_shard_of(node), view, seq)


def _decompose(marks: dict) -> Optional[dict]:
    """One request's segments from its mark timestamps (absolute
    seconds).  Consecutive deltas over PRESENT marks, clamped at zero;
    the clamp total is the residual vs the end-to-end span."""
    t_submit = marks.get("submit")
    t_deliver = marks.get("deliver")
    if t_submit is None or t_deliver is None:
        return None
    total_ms = max(t_deliver - t_submit, 0.0) * 1e3
    segments: dict[str, float] = {}
    prev = t_submit
    for mark, seg in _SEGMENT_OF:
        t = marks.get(mark)
        if t is None:
            continue
        segments[seg] = max(t - prev, 0.0) * 1e3
        prev = t
    residual = abs(sum(segments.values()) - total_ms)
    return {"total_ms": total_ms, "segments": segments,
            "residual_ms": residual}


def _stats(vals: list, total_pool: float) -> dict:
    vals = sorted(vals)
    s = sum(vals)
    return {
        "count": len(vals),
        "p50_ms": round(_pct(vals, 0.50), 3),
        "p95_ms": round(_pct(vals, 0.95), 3),
        "p99_ms": round(_pct(vals, 0.99), 3),
        "max_ms": round(vals[-1], 3) if vals else 0.0,
        "mean_ms": round(s / len(vals), 3) if vals else 0.0,
        # fraction of ALL measured request time spent in this segment —
        # the decomposition column; shares sum to ~1 across segments
        "share": round(s / total_pool, 3) if total_pool else 0.0,
    }


def _fold(rows: list[dict], *, residual_tolerance_ms: float,
          sample: int) -> dict:
    per_seg: dict[str, list] = {seg: [] for seg in SEGMENTS}
    totals: list[float] = []
    worst_residual = 0.0
    for r in rows:
        totals.append(r["total_ms"])
        worst_residual = max(worst_residual, r["residual_ms"])
        for seg, ms in r["segments"].items():
            per_seg.setdefault(seg, []).append(ms)
    totals.sort()
    total_pool = sum(totals)
    segments = {seg: _stats(vals, total_pool)
                for seg, vals in per_seg.items() if vals}
    dominant = max(segments, key=lambda s: segments[s]["share"],
                   default=None) if segments else None
    return {
        "requests": len(rows),
        "end_to_end": {
            "count": len(totals),
            "p50_ms": round(_pct(totals, 0.50), 3),
            "p95_ms": round(_pct(totals, 0.95), 3),
            "p99_ms": round(_pct(totals, 0.99), 3),
            "max_ms": round(totals[-1], 3) if totals else 0.0,
            "mean_ms": round(total_pool / len(totals), 3) if totals else 0.0,
        },
        "segments": segments,
        "dominant_segment": dominant,
        # the instrument's core promise, stated per block: every request's
        # segment sums equal its end-to-end latency within the tolerance
        "sums_consistent": worst_residual <= residual_tolerance_ms,
        "worst_residual_ms": round(worst_residual, 4),
        "residual_tolerance_ms": residual_tolerance_ms,
        "sample": [
            {"key": r["key"],
             "total_ms": round(r["total_ms"], 3),
             "residual_ms": round(r["residual_ms"], 4),
             "segments": {s: round(ms, 3)
                          for s, ms in r["segments"].items()}}
            for r in rows[:max(0, sample)]
        ],
    }


def assemble_critical_path_block(
    events: Sequence[dict],
    *,
    phases: Optional[Sequence[str]] = None,
    sample: int = 8,
    residual_tolerance_ms: float = 1.0,
) -> dict:
    """Fold merged flight-recorder events into the ONE ``critical_path``
    block a bench row carries (pure function, ``assemble_*`` idiom; schema pinned
    by tests/test_critpath.py).

    ``events`` are event dicts (``SpanEvent.as_dict`` shape, ``node``
    filled), already on ONE timeline — the in-process harness's shared
    scheduler clock, or a socket cluster's skew-adjusted merge (then
    ``residual_tolerance_ms`` should be at least the offset error
    bound).  Per request: the submit/pool marks come from its first
    ``req.submit``/``req.pool`` events; the (view, seq) pipeline marks
    come from the node that recorded ``batch.propose`` for that slot
    (the leader — its pipeline IS the critical path), falling back to
    the earliest recording node; ``deliver`` prefers the leader's
    ``req.deliver``.  ``phases`` groups requests by request-id prefix
    (the open-loop harness's per-phase ``request_prefix``), yielding a
    per-phase sub-block each with its own dominant segment.

    ``slowest_prepare_voters`` counts, per completing voter, how often
    that node's vote was the one that completed a prepare quorum — the
    "slowest f+1-th voter named" column.  Granularity caveat: the views
    observe arrivals per INGEST WAVE, so votes landing in one coalesced
    wave are simultaneous to the instrument and ties within the
    completing wave resolve in signer-index order — a follower is only
    distinguishably slow when its vote misses its peers' wave."""
    # -- pass 1: (shard, view, seq)-scoped pipeline marks ------------------
    leader_of: dict[tuple, str] = {}
    vs_marks: dict[tuple, dict[str, dict[str, float]]] = {}
    # per-slot completing voter BY OBSERVING NODE (insertion order =
    # merge order, earliest first): resolved leader-first at join time,
    # like the timestamp marks — each replica's quorum can complete on a
    # different arrival order, and mixing perspectives would blame a
    # voter that was not last on the LEADER's (critical) path
    slowest_prepare: dict[tuple, dict[str, int]] = {}
    for ev in events:
        kind = ev.get("kind", "")
        mark = _VS_MARK_OF_KIND.get(kind)
        if mark is None:
            continue
        view, seq = ev.get("view"), ev.get("seq")
        if view is None or seq is None:
            continue
        node = ev.get("node", "")
        vs = _vs_key(node, view, seq)
        if kind == "batch.propose" and vs not in leader_of:
            leader_of[vs] = node
        per_node = vs_marks.setdefault(vs, {}).setdefault(mark, {})
        if node not in per_node:
            per_node[node] = ev.get("t", 0.0)
        if kind == "quorum.prepare":
            voter = (ev.get("extra") or {}).get("slowest_voter")
            if voter is not None and voter >= 0:
                slowest_prepare.setdefault(vs, {}).setdefault(node, voter)
    # -- pass 2: per-request submit/pool/deliver marks ---------------------
    submits: dict[str, float] = {}
    pools: dict[str, float] = {}
    delivers: dict[str, list] = {}  # key -> [(node, t, view, seq)]
    for ev in events:
        kind = ev.get("kind", "")
        key = ev.get("key", "")
        if not key:
            continue
        if kind == "req.submit":
            submits.setdefault(key, ev.get("t", 0.0))
        elif kind == "req.pool":
            pools.setdefault(key, ev.get("t", 0.0))
        elif kind == "req.deliver":
            delivers.setdefault(key, []).append(
                (ev.get("node", ""), ev.get("t", 0.0),
                 ev.get("view"), ev.get("seq"))
            )
    # -- join --------------------------------------------------------------
    rows: list[dict] = []
    voter_counts: dict[int, int] = {}
    counted_vs: set = set()  # one count per QUORUM, not per request —
    # a 100-request batch's quorum must not outvote a 1-request batch's
    for key, dels in delivers.items():
        t_submit = submits.get(key)
        if t_submit is None:
            continue  # ring overwrote the submit: skip, count below
        # the request's slot: from its deliver events (prefer the leader's)
        view, seq = dels[0][2], dels[0][3]
        if view is None or seq is None:
            continue
        vs = _vs_key(dels[0][0], view, seq)
        leader = leader_of.get(vs, "")
        deliver = next((d for d in dels if d[0] == leader),
                       min(dels, key=lambda d: d[1]))
        marks: dict[str, float] = {"submit": t_submit,
                                   "deliver": deliver[1]}
        t_pool = pools.get(key)
        if t_pool is not None:
            marks["pool"] = t_pool
        for mark, per_node in vs_marks.get(vs, {}).items():
            t = per_node.get(leader)
            if t is None and per_node:
                t = min(per_node.values())
            if t is not None:
                marks[mark] = t
        row = _decompose(marks)
        if row is None:
            continue
        row["key"] = key
        rows.append(row)
        by_node = slowest_prepare.get(vs)
        if by_node and vs not in counted_vs:
            counted_vs.add(vs)
            voter = by_node.get(leader, next(iter(by_node.values())))
            voter_counts[voter] = voter_counts.get(voter, 0) + 1
    rows.sort(key=lambda r: r["key"])
    block = _fold(rows, residual_tolerance_ms=residual_tolerance_ms,
                  sample=sample)
    block["requests_seen"] = len(delivers)
    block["requests_decomposed"] = len(rows)
    block["slowest_prepare_voters"] = {
        str(v): n for v, n in sorted(voter_counts.items())
    }
    block["slowest_prepare_voter"] = (
        max(voter_counts, key=voter_counts.get) if voter_counts else None
    )
    if phases:
        by_phase: dict[str, list] = {}
        for r in rows:
            rid = r["key"].split(":", 1)[-1]
            for p in phases:
                if rid.startswith(p):
                    by_phase.setdefault(p, []).append(r)
                    break
        block["phases"] = {
            p: _fold(prows, residual_tolerance_ms=residual_tolerance_ms,
                     sample=0)
            for p, prows in by_phase.items()
        }
    return block
