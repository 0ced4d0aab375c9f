"""Delivery multiplexer: one combined committed stream over S shards.

Each shard commits an independent, totally-ordered chain; the embedder of
a sharded deployment wants ONE stream of committed entries (to apply to
state, index, or serve reads from) without losing the per-shard ordering
guarantees.  :class:`DeliveryMux` is that seam: shards feed their newly
committed decisions in, the mux enforces the per-shard invariants —
**gapless** (each shard's sequence numbers arrive as 1,2,3,... with no
hole) and **exactly-once** (no request id delivered twice within a shard)
— and appends to a combined, arrival-ordered stream of
:class:`CommittedEntry`.

The shard SET is no longer fixed for the stream's lifetime: a live
reshard calls :meth:`begin_epoch` at the flip, which opens cursors for
new shards, freezes retired ones (any later ingest for them is a
violation — a retired shard that still commits after its drain forked
the transition), and stamps an **epoch watermark** into the stream: the
combined index at which the epoch changed, the shard ids on each side,
and the per-shard barrier sequences.  Entries carry the epoch they were
delivered under, and per-shard gaplessness spans the transition —
surviving shards keep counting, new shards start at 1.

Cross-epoch duplication prevention is EXPLICIT (the Mir-BFT rule for
re-bucketing client spaces): at the flip the mux rebuilds the hand-off
set from every still-unpruned delivered CLIENT request id (control-plane
barrier ids commit once per shard and are excluded), and an ingest in the
new epoch that repeats one — the moved client whose request committed in
its old shard and then again in its new one — is as loud a violation as
an intra-shard duplicate.  Rebuilding (never accumulating) keeps the set
bounded by the retention window across unbounded transitions.

There is deliberately NO cross-shard ordering claim: entries from
different shards interleave in arrival order only.  Cross-shard
transactions are out of scope (README "Sharded mode"); anything needing
an order across shards must impose it above this layer.

A violation raises :class:`ShardStreamViolation` — a sharded deployment
that forked or double-delivered must fail loudly at the front door, not
smear bad entries into the embedder's state machine.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional, Sequence

from .epoch import RESHARD_CLIENT

__all__ = ["CommittedEntry", "DeliveryMux", "ShardStreamViolation"]

#: request-id prefix of per-shard control commands (reshard barriers):
#: legitimately committed once per SHARD, so they are excluded from the
#: cross-epoch hand-off set — a stale barrier from an ABORTED transition
#: that finally orders on its shard after a later successful flip must
#: not read as a moved-client duplicate (per-shard exactly-once for them
#: is still enforced by each cursor's own seen set)
_CONTROL_PREFIX = RESHARD_CLIENT + ":"


class ShardStreamViolation(RuntimeError):
    """A shard's committed feed broke gaplessness or exactly-once."""


@dataclass(frozen=True)
class CommittedEntry:
    """One committed decision in the combined stream."""

    shard_id: int
    seq: int          # the shard-local consensus sequence (1-based, gapless)
    index: int        # position in the combined stream (0-based, arrival order)
    decision: object  # the shard's Decision (proposal + signatures)
    request_ids: tuple = ()
    epoch: int = 0    # the epoch this entry was delivered under


@dataclass
class _ShardCursor:
    next_seq: int = 1
    delivered: int = 0
    requests: int = 0  # total request ids delivered (survives pruning)
    seen_requests: set = field(default_factory=set)
    retired: bool = False  # frozen by a scale-in flip; ingest raises


class DeliveryMux:
    """Combined committed stream with per-shard invariant enforcement.

    ``ingest(shard_id, decision, seq=..., request_ids=...)`` appends one
    decision; feeds usually come from :class:`~smartbft_tpu_torch.shard.set.
    ShardSet.poll_committed`, which extracts ``seq`` from the decision's
    ViewMetadata and the request ids from the shard's inspector.  Readers
    either poll ``combined[since:]`` or register an ``on_deliver``
    callback (called synchronously per entry, in stream order).  A
    long-lived embedder calls ``prune(upto)`` once entries are applied,
    so the committed path does not grow memory with history (ShardSet
    wires this automatically to its delivery watermark).
    """

    def __init__(self, shard_ids: Sequence[int],
                 on_deliver: Optional[Callable[[CommittedEntry], None]] = None,
                 on_deliver_batch: Optional[
                     Callable[[list[CommittedEntry]], None]] = None):
        self._cursors: dict[int, _ShardCursor] = {
            int(s): _ShardCursor() for s in shard_ids
        }
        self.combined: list[CommittedEntry] = []
        self._pruned = 0  # entries dropped by prune(); indexes stay absolute
        self._on_deliver = on_deliver
        # egress twin of the view's ingest_batch: when set, a whole wave of
        # entries reaches the application in ONE call (stream order inside
        # the list) instead of one callback dispatch per decision;
        # on_deliver is then never called
        self._on_deliver_batch = on_deliver_batch
        self._epoch = 0
        #: request ids delivered before the current epoch's flip that must
        #: never re-deliver after it (explicit cross-epoch dedup).  REBUILT
        #: at each flip from the cursors' still-unpruned history — bounded
        #: by the retention window like intra-shard dedup, with older
        #: duplicates falling to the pools' history exactly as prune()
        #: documents
        self._handoff_seen: set = set()
        #: requests delivered by retired-incarnation cursors replaced by a
        #: re-entering shard id (keeps requests_total()/committed counts
        #: monotone across shrink-then-grow paths)
        self._replaced_requests = 0
        #: their still-unpruned ids — a dead generation has no cursor to
        #: feed the hand-off rebuild, so these carry its dedup horizon
        #: (trimmed by prune() on the same watermark as cursor history)
        self._replaced_seen: set = set()
        #: one record per begin_epoch: where in the stream the flip landed
        self._watermarks: list[dict] = []

    # -- feeding -----------------------------------------------------------

    def ingest(self, shard_id: int, decision, *, seq: int,
               request_ids: Iterable = ()) -> CommittedEntry:
        return self.ingest_batch(
            shard_id, [(seq, request_ids, decision)]
        )[0]

    def ingest_batch(
        self, shard_id: int, decisions: Sequence[tuple]
    ) -> list[CommittedEntry]:
        """Wave-batched feed: ``decisions`` is a consecutive run of
        ``(seq, request_ids, decision)`` for ONE shard — the shape a
        committed wave leaves the pipelined window in.  The cursor is
        resolved once, every invariant (gapless, exactly-once, hand-off
        dedup) is enforced across the whole run in one pass, and the
        application sees ONE ``on_deliver_batch`` call per wave (falling
        back to per-entry ``on_deliver``, in stream order).  A violation
        raises AFTER the validated prefix is dispatched — callbacks track
        the stream, so everything that entered ``combined`` reaches the
        application exactly once.  ``ingest`` is the single-decision
        special case."""
        cur = self._cursors.get(shard_id)
        if cur is None:
            raise ShardStreamViolation(
                f"decision from unknown shard {shard_id}"
            )
        entries: list[CommittedEntry] = []
        try:
            self._ingest_run(shard_id, cur, decisions, entries)
        finally:
            # callbacks track the STREAM, not the call: every entry that
            # entered `combined` is dispatched exactly once even when a
            # later decision in the run violates (the violation still
            # raises after the validated prefix is delivered)
            if entries:
                if self._on_deliver_batch is not None:
                    self._on_deliver_batch(entries)
                elif self._on_deliver is not None:
                    for entry in entries:
                        self._on_deliver(entry)
        return entries

    def _ingest_run(self, shard_id: int, cur: _ShardCursor,
                    decisions: Sequence[tuple],
                    entries: list) -> None:
        for seq, request_ids, decision in decisions:
            if cur.retired:
                raise ShardStreamViolation(
                    f"shard {shard_id} is retired (epoch {self._epoch}) but "
                    f"delivered seq {seq} — it committed past its drain barrier"
                )
            if seq != cur.next_seq:
                raise ShardStreamViolation(
                    f"shard {shard_id} stream gap: got seq {seq}, "
                    f"expected {cur.next_seq}"
                )
            ids = tuple(str(r) for r in request_ids)
            # duplicates against everything delivered before AND within this
            # very decision — both violate per-shard exactly-once — and, across
            # an epoch flip, against the hand-off snapshot of every shard's
            # unpruned history (a moved client's request must not commit twice)
            seen_here: set = set()
            dupes = []
            handoff_dupes = []
            for r in ids:
                if r in cur.seen_requests or r in seen_here:
                    dupes.append(r)
                elif r in self._handoff_seen:
                    handoff_dupes.append(r)
                seen_here.add(r)
            if dupes:
                raise ShardStreamViolation(
                    f"shard {shard_id} delivered duplicates at seq {seq}: "
                    f"{sorted(set(dupes))}"
                )
            if handoff_dupes:
                raise ShardStreamViolation(
                    f"shard {shard_id} re-delivered handed-off requests at seq "
                    f"{seq} (already committed before the epoch {self._epoch} "
                    f"flip): {sorted(set(handoff_dupes))}"
                )
            cur.seen_requests.update(ids)
            cur.next_seq += 1
            cur.delivered += 1
            cur.requests += len(ids)
            entry = CommittedEntry(
                shard_id=shard_id, seq=seq,
                index=self._pruned + len(self.combined),
                decision=decision, request_ids=ids,
                epoch=self._epoch,
            )
            self.combined.append(entry)
            entries.append(entry)

    # -- epochs ------------------------------------------------------------

    @property
    def epoch(self) -> int:
        return self._epoch

    def begin_epoch(self, epoch: int, shard_ids: Sequence[int], *,
                    retire: Sequence[int] = (),
                    barriers: Optional[dict] = None) -> dict:
        """Flip the stream to a new epoch (called by the reshard
        orchestrator at the atomic router flip).

        ``shard_ids`` is the NEW epoch's full shard set; ``retire`` names
        shards leaving it (their cursors freeze — later ingest raises);
        ``barriers`` records each old shard's barrier sequence for the
        watermark.  A shard id re-entering after an earlier retirement
        gets a FRESH cursor (a new consensus-group generation restarts at
        seq 1); its old ids stay caught by the hand-off set.  Returns the
        watermark record appended to ``snapshot()['watermarks']``."""
        if epoch <= self._epoch:
            raise ValueError(
                f"epoch must exceed the current {self._epoch}, got {epoch}"
            )
        new_ids = {int(s) for s in shard_ids}
        retire_ids = {int(s) for s in retire}
        if retire_ids & new_ids:
            raise ValueError(
                f"shards cannot be both retired and live: "
                f"{sorted(retire_ids & new_ids)}"
            )
        # the hand-off snapshot: every unpruned id any cursor (live or
        # already-retired) has delivered — the explicit duplication
        # prevention for moved key-ranges.  Rebuilt (not accumulated) so
        # the set stays bounded by the retention window across unbounded
        # autoscaler transitions; pruned history falls to pool dedup.
        handoff: set = {
            r for r in self._replaced_seen
            if not r.startswith(_CONTROL_PREFIX)
        }
        for cur in self._cursors.values():
            handoff.update(r for r in cur.seen_requests
                           if not r.startswith(_CONTROL_PREFIX))
        for sid in retire_ids:
            cur = self._cursors.get(sid)
            if cur is None:
                raise ValueError(f"cannot retire unknown shard {sid}")
            cur.retired = True
        for sid in new_ids:
            cur = self._cursors.get(sid)
            if cur is None or cur.retired:
                # brand-new shard, or a retired id re-entering as a new
                # consensus-group generation; the dead incarnation's
                # delivered-request count stays in the monotone total and
                # its unpruned ids stay in the dedup horizon
                if cur is not None:
                    self._replaced_requests += cur.requests
                    self._replaced_seen.update(cur.seen_requests)
                self._cursors[sid] = _ShardCursor()
        self._handoff_seen = handoff
        mark = {
            "epoch": int(epoch),
            "index": self.total(),
            "shards": sorted(new_ids),
            "retired": sorted(retire_ids),
            "barriers": {int(k): int(v) for k, v in (barriers or {}).items()},
        }
        self._watermarks.append(mark)
        self._epoch = int(epoch)
        return mark

    # -- reading -----------------------------------------------------------

    def since(self, index: int) -> list[CommittedEntry]:
        """Combined entries from stream position ``index`` on (entries
        below the prune watermark are gone)."""
        return self.combined[max(index - self._pruned, 0):]

    def prune(self, upto: int) -> int:
        """Drop combined entries with stream index < ``upto`` — the
        embedder's acknowledgment that they are applied/persisted.  Keeps
        the committed-path memory bounded in long-lived deployments
        (everything else history-driven in this codebase is bounded too).
        Per-shard cursors and counters are untouched; duplicate-request
        detection narrows to the ids delivered at/after the watermark (the
        per-shard request pool's client dedup covers the full history).
        Returns the number of entries dropped."""
        drop = min(max(upto - self._pruned, 0), len(self.combined))
        if not drop:
            return 0
        for e in self.combined[:drop]:
            self._cursors[e.shard_id].seen_requests.difference_update(
                e.request_ids
            )
            # a replaced incarnation's entries map to its successor's
            # cursor above (a no-op); their ids are trimmed here
            self._replaced_seen.difference_update(e.request_ids)
        del self.combined[:drop]
        self._pruned += drop
        return drop

    def shard_ids(self) -> list[int]:
        """Every shard the stream has ever carried (retired included)."""
        return sorted(self._cursors)

    def live_shard_ids(self) -> list[int]:
        return sorted(s for s, c in self._cursors.items() if not c.retired)

    def height(self, shard_id: int) -> int:
        """Decisions delivered through the mux for one shard (0 for a
        shard the stream has not opened a cursor for yet — e.g. a new
        group mid-transition, before its epoch flips)."""
        cur = self._cursors.get(shard_id)
        return cur.delivered if cur is not None else 0

    def heights(self) -> dict[int, int]:
        return {s: c.delivered for s, c in self._cursors.items()}

    def total(self) -> int:
        return self._pruned + len(self.combined)

    def requests_delivered(self, shard_id: int) -> int:
        cur = self._cursors.get(shard_id)
        return cur.requests if cur is not None else 0

    def requests_total(self) -> int:
        """Total request ids ever delivered through the stream — MONOTONE
        across epoch flips (retired incarnations replaced by re-entering
        shard ids keep their counts here)."""
        return self._replaced_requests + sum(
            c.requests for c in self._cursors.values()
        )

    def snapshot(self) -> dict:
        """JSON-able per-shard + combined block for bench rows."""
        return {
            "total": self.total(),
            "pruned": self._pruned,
            "epoch": self._epoch,
            "watermarks": [dict(m) for m in self._watermarks],
            "per_shard": {
                s: {"decisions": c.delivered,
                    "requests": c.requests,
                    "next_seq": c.next_seq,
                    "retired": c.retired}
                for s, c in sorted(self._cursors.items())
            },
        }
