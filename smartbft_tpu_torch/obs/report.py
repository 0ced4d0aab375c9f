"""Render flight-recorder dumps: ``python -m smartbft_tpu_torch.obs.report``.

Input: one or more JSON dump files (``TraceRecorder.dump_to``, the chaos
runner's per-replica ``flight-*.json`` artifacts, or a ``cmd=trace``
control-channel response saved to disk).  Output: a merged text timeline
(events from every replica interleaved by timestamp, offsets relative to
the earliest event) followed by a per-span-type percentile summary over
the events that carry durations, plus derived submit→deliver spans
joined by request key when both ends are present.

**Cluster timelines.**  Multi-PROCESS dumps live on different
monotonic clocks; a dump carrying ``clock_offset_s`` (written by
``SocketCluster.cluster_timeline`` from the control-channel ping
midpoint estimate) has every event timestamp shifted by ``-offset``
during the merge, so N replicas' rings interleave on ONE causally-
ordered timeline with a stated error bound (RTT/2 per replica).  When
offsets are known, ``net.recv`` sidecar events additionally yield a
per-directed-link network-time summary: receiver ingest (skew-adjusted)
minus the sender's flush stamp (``extra.sent_us``, mapped through the
SENDER's offset).

Usage::

    python -m smartbft_tpu_torch.obs.report run/flight-*.json [--last N]
    python -m smartbft_tpu_torch.obs.report dump.json --summary-only
    python -m smartbft_tpu_torch.obs.report run/flight-*.json \
        --offsets run/offsets.json   # {"n1": {"offset_s": ...}, ...}
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

from .recorder import pct as _pct

__all__ = ["load_dump", "merged_events", "link_summary", "render", "main"]


def load_dump(path: str) -> dict:
    """Load one dump file; accepts both the recorder's native dump shape
    and a saved ``cmd=trace`` control response (events under "events")."""
    with open(path) as fh:
        data = json.load(fh)
    if "events" not in data:
        raise ValueError(f"{path}: not a flight-recorder dump (no 'events')")
    return data


def merged_events(dumps: list[dict]) -> list[dict]:
    """Fold N dumps into one chronologically-sorted event list.

    Each event gets its dump's ``node`` label (when the event lacks one)
    and — the clock-alignment step — its timestamp shifted by the dump's
    ``clock_offset_s`` so every replica's monotonic clock maps onto the
    estimator's (parent's) timeline: ``t_cluster = t_replica - offset``.
    Dumps without an offset merge unshifted (the single-process case,
    where all recorders already share one clock).  Pure function."""
    events: list[dict] = []
    for d in dumps:
        node = d.get("node", "")
        off = float(d.get("clock_offset_s", 0.0) or 0.0)
        for ev in d.get("events", []):
            if (node and "node" not in ev) or off:
                ev = dict(ev)
                if node and "node" not in ev:
                    ev["node"] = node
                if off:
                    ev["t"] = ev.get("t", 0.0) - off
            events.append(ev)
    events.sort(key=lambda e: e.get("t", 0.0))
    return events


def link_summary(events: list[dict], offsets: dict) -> list[dict]:
    """Per-directed-link network time from ``net.recv`` sidecar events.

    ``events`` must already be clock-aligned (:func:`merged_events`);
    ``offsets`` maps node label -> offset seconds (the SENDER's stamp
    ``extra.sent_us`` is in the sender's clock and needs its own
    offset).  Per hop: ``net_ms = (t_recv_aligned - (sent_us/1e6 -
    offset_sender)) * 1e3``.  In a multi-clock merge (``offsets``
    non-empty) a hop needs BOTH endpoints' offsets known — rows whose
    sender or receiver clock is unestimated are skipped rather than
    published with unbounded skew.  Returns one row per directed link
    with exact percentiles — the WAN-profile work (ROADMAP item 5)
    reads per-link time straight off this table.

    Offset-estimation error can exceed a loopback hop's real flight
    time: an apparently NEGATIVE network time is an artifact of that
    error bound, so it is CLAMPED to 0 and counted per link
    (``clamped``) instead of published as a physically impossible
    measurement."""
    links: dict[tuple, list] = {}
    clamped: dict[tuple, int] = {}
    for ev in events:
        if ev.get("kind") != "net.recv":
            continue
        extra = ev.get("extra") or {}
        sent_us = extra.get("sent_us")
        frm = extra.get("from")
        if sent_us is None or frm is None:
            continue
        sender = f"n{frm}"
        off = offsets.get(sender)
        if offsets and (off is None or ev.get("node", "?") not in offsets):
            continue  # an endpoint's clock was never aligned: skip
        if off is None:
            off = 0.0  # single-clock run: no shift needed anywhere
        net_ms = (ev.get("t", 0.0) - (sent_us / 1e6 - off)) * 1e3
        key = (sender, ev.get("node", "?"))
        if net_ms < 0.0:
            clamped[key] = clamped.get(key, 0) + 1
            net_ms = 0.0
        links.setdefault(key, []).append(net_ms)
    rows = []
    for (a, b), vals in sorted(links.items()):
        vals.sort()
        rows.append({
            "link": f"{a}->{b}",
            "count": len(vals),
            "p50_ms": round(_pct(vals, 0.50), 3),
            "p95_ms": round(_pct(vals, 0.95), 3),
            "p99_ms": round(_pct(vals, 0.99), 3),
            "max_ms": round(vals[-1], 3),
            # samples the skew error bound pushed below zero (published
            # as 0): err_bound exceeding the hop time is EXPECTED on
            # loopback, and hiding the clamp would overstate precision
            "clamped": clamped.get((a, b), 0),
        })
    return rows


def _fmt_event(ev: dict, t0: float) -> str:
    parts = [f"+{ev.get('t', 0.0) - t0:10.4f}s",
             f"[{ev.get('node', '?'):>6}]",
             f"{ev.get('kind', '?'):<22}"]
    for field, tag in (("key", ""), ("view", "v"), ("seq", "s"),
                       ("epoch", "e"), ("launch", "L")):
        if field in ev:
            parts.append(f"{tag}{ev[field]}")
    if "dur_ms" in ev:
        parts.append(f"{ev['dur_ms']:.3f}ms")
    if ev.get("extra"):
        parts.append(json.dumps(ev["extra"], sort_keys=True))
    return " ".join(parts)


def _summary_rows(events: list[dict]) -> list[tuple]:
    """(kind, count, p50, p95, p99, max) over events carrying dur_ms,
    plus derived ``req.submit->deliver`` spans joined by request key."""
    by_kind: dict[str, list] = {}
    for ev in events:
        if "dur_ms" in ev:
            by_kind.setdefault(ev["kind"], []).append(ev["dur_ms"])
    # derived submit→deliver per (node, key): first submit-ish stamp to
    # first deliver stamp — the request's protocol-pipeline span
    first_seen: dict[tuple, float] = {}
    derived: list = []
    for ev in events:
        key = ev.get("key")
        if not key:
            continue
        ident = (ev.get("node", ""), key)
        if ev["kind"] in ("req.submit", "req.pool") \
                and ident not in first_seen:
            first_seen[ident] = ev["t"]
        elif ev["kind"] == "req.deliver" and ident in first_seen:
            derived.append((ev["t"] - first_seen.pop(ident)) * 1e3)
    if derived:
        by_kind["req.submit->deliver"] = derived
    rows = []
    for kind in sorted(by_kind):
        vals = sorted(by_kind[kind])
        rows.append((kind, len(vals), _pct(vals, 0.50), _pct(vals, 0.95),
                     _pct(vals, 0.99), vals[-1]))
    return rows


def render(dumps: list[dict], *, last: Optional[int] = None,
           summary_only: bool = False) -> str:
    """Merged (clock-aligned when offsets present) text timeline +
    per-span-type percentile summary + per-link network times."""
    events = merged_events(dumps)
    aligned = any(d.get("clock_offset_s") for d in dumps)
    if last is not None and last >= 0:
        events = events[-last:] if last else []
    out: list[str] = []
    header = (f"flight recorder: {len(dumps)} dump(s), "
              f"{len(events)} event(s)"
              + (", clock-aligned" if aligned else "")
              + (f", dropped {sum(d.get('dropped', 0) for d in dumps)}"
                 if any(d.get("dropped") for d in dumps) else ""))
    out.append(header)
    unaligned = sorted(d.get("node", "?") for d in dumps
                       if not d.get("offset_known", True))
    if aligned and unaligned:
        # loud degradation: these nodes merge with an UNKNOWN clock —
        # their timestamps are unshifted and their per-link rows are
        # excluded, not silently published with assumed-zero skew
        out.append(
            f"WARNING: no clock offset for {', '.join(unaligned)} — "
            "their events merge UNALIGNED and their links are excluded"
        )
    if events and not summary_only:
        t0 = events[0].get("t", 0.0)
        out.append("")
        out.append("timeline:")
        out.extend("  " + _fmt_event(ev, t0) for ev in events)
    rows = _summary_rows(events)
    if rows:
        out.append("")
        out.append("span summary (ms):")
        out.append(f"  {'kind':<24} {'count':>6} {'p50':>10} {'p95':>10} "
                   f"{'p99':>10} {'max':>10}")
        for kind, n, p50, p95, p99, mx in rows:
            out.append(f"  {kind:<24} {n:>6} {p50:>10.3f} {p95:>10.3f} "
                       f"{p99:>10.3f} {mx:>10.3f}")
    offsets = {d.get("node", ""): d.get("clock_offset_s", 0.0)
               for d in dumps
               if d.get("node") and d.get("offset_known", True)}
    hops = link_summary(events, offsets if aligned else {})
    if hops:
        out.append("")
        out.append("per-link network time (ms"
                   + (", skew-adjusted" if aligned else "") + "):")
        out.append(f"  {'link':<12} {'count':>6} {'p50':>10} {'p95':>10} "
                   f"{'p99':>10} {'max':>10}")
        for h in hops:
            out.append(f"  {h['link']:<12} {h['count']:>6} "
                       f"{h['p50_ms']:>10.3f} {h['p95_ms']:>10.3f} "
                       f"{h['p99_ms']:>10.3f} {h['max_ms']:>10.3f}")
    return "\n".join(out) + "\n"


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Render SmartBFT flight-recorder dumps as a text "
                    "timeline + per-span-type percentile summary"
    )
    ap.add_argument("dumps", nargs="+", help="flight-recorder JSON dump(s)")
    ap.add_argument("--last", type=int, default=None,
                    help="only the newest N merged events")
    ap.add_argument("--summary-only", action="store_true",
                    help="skip the timeline, print only the span summary")
    ap.add_argument("--offsets", default=None,
                    help="JSON file of per-node clock offsets "
                         "({\"n1\": {\"offset_s\": ...}, ...} — "
                         "SocketCluster.cluster_timeline writes one); "
                         "applied to dumps lacking an embedded offset")
    args = ap.parse_args(argv)
    dumps = [load_dump(p) for p in args.dumps]
    if args.offsets:
        with open(args.offsets) as fh:
            offs = json.load(fh)
        for d in dumps:
            if "clock_offset_s" not in d:
                known = d.get("node", "") in offs
                entry = offs.get(d.get("node", ""), {})
                d["clock_offset_s"] = (
                    entry.get("offset_s", 0.0)
                    if isinstance(entry, dict) else float(entry)
                )
                # a node ABSENT from the offsets file merges with an
                # UNKNOWN clock — flag it so its per-link rows are
                # skipped, not published with assumed-zero skew
                d["offset_known"] = known
    print(render(dumps, last=args.last, summary_only=args.summary_only),
          end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
