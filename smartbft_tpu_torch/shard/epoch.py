"""Epoch protocol primitives for live resharding.

A reshard (S -> S') is not a configuration flag — it is an ordered,
crash-recoverable state transition, and this module holds its three
building blocks:

* **The barrier command** (:func:`reshard_command_payload` /
  :func:`detect_reshard`): the resize decision rides each shard's own
  ordered stream as an ordinary request (client ``RESHARD_CLIENT``,
  request id ``reshard-e<epoch>``).  The sequence at which a shard
  commits its marker is that shard's *barrier*: every decision at or
  below it belongs to the old epoch, everything after it can assume the
  drain of moved key-ranges has begun.  Committing the decision through
  the shards themselves is the Vertical-Paxos / SMR-reconfiguration rule
  (PAPERS.md [4]): a resize decided on a side channel can always race
  the stream it is trying to fence.  Because the marker is a normal
  request, the per-shard pool's client dedup makes re-submission after a
  coordinator recovery exactly-once for free.

* **The epoch journal** (:class:`EpochJournal`): a WAL-style JSON-lines
  file recording every transition edge (``prepare`` -> ``barrier``\\*N ->
  ``flip`` -> ``done``, or ``abort``), fsync'd per append, replayed with
  torn-tail tolerance.  :func:`recover_epochs` folds a replay into the
  durable facts a restarting front door needs: the last completed epoch,
  the epoch numbers already consumed (aborted transitions burn their
  number — their markers may have committed, so the number can never be
  reused), and the one incomplete transition, if any, with how far it
  got.  A coordinator that crashed mid-drain resumes (or completes a
  journaled flip) instead of guessing.

* **The error contract** (:class:`ShardEpochError`): the single loud
  failure of the live path — raised to submitters of a *moved*
  key-range when the bounded drain deadline expires (or the transition
  aborts), and to a caller trying to start a second concurrent reshard.
  Unmoved key-ranges never see it; their shards never stop serving.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from ..codec import decode, encode, wiremsg

__all__ = [
    "RESHARD_CLIENT",
    "ReshardCommand",
    "ShardEpochError",
    "EpochJournal",
    "barrier_request_id",
    "barrier_marker",
    "reshard_command_payload",
    "detect_reshard",
    "recover_epochs",
]

#: the reserved client id every barrier command is submitted under; the
#: front door's routing, drain accounting, and the delivery mux treat it
#: as control-plane traffic (it is excluded from moved-key checks)
RESHARD_CLIENT = "__reshard__"

#: payload prefix marking a request as a reshard barrier command (same
#: convention as testing.reconfig.RECONFIG_MAGIC)
RESHARD_MAGIC = b"smartbft-reshard\x00"


class ShardEpochError(RuntimeError):
    """The live-reshard error contract (see module docstring)."""


@wiremsg
class ReshardCommand:
    """The ordered resize decision: what the barrier request carries."""

    epoch: int = 0
    old_shards: int = 0
    new_shards: int = 0


def barrier_request_id(epoch: int) -> str:
    """The request id of epoch ``epoch``'s barrier command."""
    return f"reshard-e{epoch}"


def barrier_marker(epoch: int) -> str:
    """The ``client:request_id`` string a committed barrier shows as in a
    delivery-mux entry's ``request_ids`` (RequestInfo.__str__ format) —
    what the front door scans committed streams for."""
    return f"{RESHARD_CLIENT}:{barrier_request_id(epoch)}"


def reshard_command_payload(epoch: int, old_shards: int, new_shards: int) -> bytes:
    """Payload bytes of the barrier request (embedders wrap these in their
    own request envelope, e.g. testing.app.TestRequest)."""
    return RESHARD_MAGIC + encode(ReshardCommand(
        epoch=epoch, old_shards=old_shards, new_shards=new_shards
    ))


def detect_reshard(payload: bytes) -> Optional[ReshardCommand]:
    """Parse a request payload; None when it is not a barrier command."""
    if not payload.startswith(RESHARD_MAGIC):
        return None
    return decode(ReshardCommand, payload[len(RESHARD_MAGIC):])


class EpochJournal:
    """Append-only JSON-lines journal of epoch-transition edges.

    Record shapes (one JSON object per line)::

        {"t": "prepare", "epoch": E, "old": S,   "new": S'}
        {"t": "barrier", "epoch": E, "shard": s, "seq": n}
        {"t": "flip",    "epoch": E, "shards": [ids...]}
        {"t": "done",    "epoch": E}
        {"t": "abort",   "epoch": E, "reason": "..."}

    ``append`` flushes and fsyncs before returning — a journaled edge
    survives a SIGKILL in the very next instruction.  ``replay`` tolerates
    a torn tail (a partial or corrupt final line ends the replay; the
    transition simply recovers one edge earlier, which every edge is
    designed to make safe: re-preparing is a no-op, re-submitting a
    barrier dedups in the pool, re-flipping is idempotent)."""

    def __init__(self, path: str):
        self.path = str(path)
        self._fh = None

    def replay(self) -> list[dict]:
        records: list[dict] = []
        if not os.path.exists(self.path):
            return records
        with open(self.path, "rb") as fh:
            data = fh.read()
        for line in data.split(b"\n"):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                break  # torn tail: everything after is unreadable
            if not isinstance(rec, dict) or "t" not in rec:
                break
            records.append(rec)
        return records

    def append(self, record: dict) -> None:
        if self._fh is None:
            # seal a crash-torn tail BEFORE the first append: replay stops
            # at the first unreadable line, so writing after torn bytes
            # would glue onto them and permanently hide this record (and
            # every later one) from recovery — the torn-tail-truncation
            # rule the WAL package applies, here at JSON-line granularity
            self._seal_torn_tail()
            self._fh = open(self.path, "ab")
        self._fh.write((json.dumps(record, sort_keys=True) + "\n").encode())
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def _seal_torn_tail(self) -> None:
        """Truncate the file to its longest replayable prefix (exactly
        what replay() accepts): an unterminated or unparseable tail is a
        torn final write and is dropped, never written after."""
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as fh:
            data = fh.read()
        good = 0
        pos = 0
        while True:
            nl = data.find(b"\n", pos)
            if nl < 0:
                break  # unterminated tail: torn
            line = data[pos:nl].strip()
            pos = nl + 1
            if line:
                try:
                    rec = json.loads(line)
                except ValueError:
                    break
                if not isinstance(rec, dict) or "t" not in rec:
                    break
            good = pos
        if good < len(data):
            with open(self.path, "r+b") as fh:
                fh.truncate(good)
                fh.flush()
                os.fsync(fh.fileno())

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def recover_epochs(records: list[dict]) -> dict:
    """Fold a journal replay into the recovery facts.

    Returns ``{"epoch": last completed epoch (0 if none),
    "shards": that epoch's shard count (None if no completed transition),
    "next_epoch": first epoch number safe to allocate,
    "incomplete": None | {"epoch", "old", "new", "barriers", "flipped"}}``.

    An ``abort`` or ``done`` closes its transition; a ``prepare`` without
    either is the (single) incomplete one.  Epoch numbers are consumed by
    every prepare — aborted or not — because the transition's barrier
    markers may already sit in committed history."""
    epoch = 0
    shards: Optional[int] = None
    next_epoch = 1
    open_tr: Optional[dict] = None
    for rec in records:
        t = rec.get("t")
        if t == "prepare":
            open_tr = {
                "epoch": int(rec["epoch"]),
                "old": int(rec.get("old", 0)),
                "new": int(rec.get("new", 0)),
                "barriers": {},
                "flipped": False,
            }
            next_epoch = max(next_epoch, open_tr["epoch"] + 1)
        elif t == "barrier" and open_tr is not None \
                and int(rec.get("epoch", -1)) == open_tr["epoch"]:
            open_tr["barriers"][int(rec["shard"])] = int(rec["seq"])
        elif t == "flip" and open_tr is not None \
                and int(rec.get("epoch", -1)) == open_tr["epoch"]:
            open_tr["flipped"] = True
        elif t == "done":
            done_epoch = int(rec.get("epoch", 0))
            if done_epoch >= epoch:
                epoch = done_epoch
                if open_tr is not None and open_tr["epoch"] == done_epoch:
                    shards = open_tr["new"]
            next_epoch = max(next_epoch, epoch + 1)
            open_tr = None
        elif t == "abort":
            open_tr = None
    return {"epoch": epoch, "shards": shards, "next_epoch": next_epoch,
            "incomplete": open_tr}
