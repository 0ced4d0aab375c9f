"""Deterministic client-id -> shard routing.

The sharded front door must send every request of one client to ONE
consensus group: per-shard exactly-once dedup (the request pool's
client/request-id memory) only works if a client's retries land on the
same shard, and cross-shard transactions are out of scope by design (see
README "Sharded mode").  Two properties matter:

* **Determinism** — any front-door process (and any test/bench) computes
  the same mapping from the same (seed, num_shards), with no shared state;
* **Re-routable on reconfig** — growing or shrinking the shard count must
  not reshuffle the world.  Routing uses Lamping & Veach's *jump
  consistent hash*: changing S -> S' moves only ~|S'-S|/max(S,S') of the
  key space, so scale-out drains a bounded slice of clients per added
  shard instead of invalidating every shard's dedup memory.

Mir-BFT (Stathakopoulou et al., 2021) partitions the request space by
client-id hash for the same reason: independent instances over disjoint
request spaces multiply throughput without weakening per-group safety.
"""

from __future__ import annotations

import hashlib
from typing import Optional

__all__ = ["ShardRouter", "jump_hash"]

_JUMP_MULT = 2862933555777941757  # the 64-bit LCG constant of the paper
_MASK64 = (1 << 64) - 1


def jump_hash(key: int, buckets: int) -> int:
    """Jump consistent hash (Lamping & Veach 2014): uniform, stateless,
    and monotone — growing ``buckets`` only ever moves keys INTO the new
    buckets, never between old ones."""
    if buckets <= 0:
        raise ValueError(f"buckets must be positive, got {buckets}")
    key &= _MASK64
    b, j = -1, 0
    while j < buckets:
        b = j
        key = (key * _JUMP_MULT + 1) & _MASK64
        j = int((b + 1) * (1 << 31) / ((key >> 33) + 1))
    return b


class ShardRouter:
    """Deterministic, epoch-tagged client-id -> shard mapping.

    ``route`` hashes the client id (blake2b-64, keyed by ``seed`` so
    disjoint deployments get independent mappings) and jump-hashes into
    ``num_shards`` buckets.  ``reshard`` installs a new shard count AS A
    NEW EPOCH — the router keeps the full ``(epoch, num_shards)`` history
    so routing can be pinned to any installed epoch (``route(cid,
    epoch=e)``): the live-reshard drain needs to reason about where a
    client lived *before* and where it lives *after* without the answer
    shifting under it.  Epoch numbers increase strictly but may skip —
    an aborted transition burns its number (its barrier markers may have
    committed) without ever being installed.  The jump hash guarantees
    minimal movement between any two epochs (see module docstring).
    """

    def __init__(self, num_shards: int, seed: int = 0):
        if num_shards <= 0:
            raise ValueError(f"num_shards must be positive, got {num_shards}")
        self._seed = seed
        # canonical 64-bit reduction: distinct seeds in [-2^63, 2^64) get
        # distinct salts (seed=-s and seed=+s must NOT collide)
        self._salt = (seed % (1 << 64)).to_bytes(8, "big")
        #: installed epochs, ascending: (epoch number, shard count)
        self._epochs: list[tuple[int, int]] = [(0, num_shards)]

    @property
    def num_shards(self) -> int:
        return self._epochs[-1][1]

    @property
    def epoch(self) -> int:
        """The latest INSTALLED epoch (a transition in flight that has
        not flipped yet is not an epoch)."""
        return self._epochs[-1][0]

    @property
    def seed(self) -> int:
        return self._seed

    def epochs(self) -> list[tuple[int, int]]:
        """The installed ``(epoch, num_shards)`` history, ascending."""
        return list(self._epochs)

    def shards_at(self, epoch: int) -> int:
        """Shard count governing ``epoch`` — the newest installed epoch
        at or below it (skipped numbers never changed the mapping).
        Scanned from the newest end: the hot path (every routed submit
        asks about the ACTIVE epoch) resolves in O(1); only recovery-time
        queries about ancient epochs walk deeper."""
        for e, s in reversed(self._epochs):
            if e <= epoch:
                return s
        raise ValueError(
            f"epoch {epoch} predates the router's first epoch "
            f"{self._epochs[0][0]}"
        )

    def key_of(self, client_id) -> int:
        """The stable 64-bit hash a client id routes by (exposed so tests
        and drain tooling can reason about placement)."""
        raw = client_id if isinstance(client_id, (bytes, bytearray)) \
            else str(client_id).encode()
        return int.from_bytes(
            hashlib.blake2b(raw, digest_size=8, key=self._salt).digest(),
            "big",
        )

    def route(self, client_id, epoch: Optional[int] = None) -> int:
        """The shard index owning ``client_id`` — in the current epoch by
        default, or pinned to any installed ``epoch``.  A client key never
        mixes epochs: for a fixed epoch the answer is a pure function of
        (seed, client_id, shards_at(epoch))."""
        shards = self.num_shards if epoch is None else self.shards_at(epoch)
        return jump_hash(self.key_of(client_id), shards)

    def route_with(self, client_id, num_shards: int) -> int:
        """Where ``client_id`` WOULD live under ``num_shards`` — the pure
        prospective mapping the drain uses before the new epoch is
        installed (moved iff route_with(c, S) != route_with(c, S'))."""
        return jump_hash(self.key_of(client_id), num_shards)

    def moved(self, client_id, old_shards: int, new_shards: int) -> bool:
        """Does ``client_id``'s owning shard change between the two shard
        counts?  The per-client drain predicate of a live reshard."""
        return (self.route_with(client_id, old_shards)
                != self.route_with(client_id, new_shards))

    def moved_fraction(self, old_shards: int, new_shards: int,
                       sample: int = 2048) -> float:
        """Measured fraction of a deterministic key sample that moves
        between the two shard counts — the jump hash bounds it by
        ~|S'-S|/max(S,S'); benches report the measured value."""
        if sample <= 0:
            raise ValueError("sample must be positive")
        moved = sum(
            1 for k in range(sample)
            if self.moved(f"moved-probe-{k}", old_shards, new_shards)
        )
        return moved / sample

    def reshard(self, num_shards: int, epoch: Optional[int] = None) -> dict:
        """Install a new shard count as a new epoch.

        ``epoch`` defaults to ``self.epoch + 1``; an orchestrator that
        burned numbers on aborted transitions passes its own (strictly
        greater) allocation.  Returns ``{"old": S, "new": S',
        "epoch": e}`` for the caller's log/journal.  The caller owns
        draining: requests already routed keep their old shard's dedup
        history, so a deployment shrinking S must quiesce the moved
        key-ranges first (exactly the Mir-BFT epoch-change dance); this
        object only guarantees the MAPPING moves minimally and stays
        queryable per epoch."""
        if num_shards <= 0:
            raise ValueError(f"num_shards must be positive, got {num_shards}")
        e = self.epoch + 1 if epoch is None else int(epoch)
        if e <= self.epoch:
            raise ValueError(
                f"epoch must exceed the installed {self.epoch}, got {e}"
            )
        old = self.num_shards
        self._epochs.append((e, num_shards))
        return {"old": old, "new": num_shards, "epoch": e}
