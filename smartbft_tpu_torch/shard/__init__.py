"""Sharded consensus groups over one shared device verify plane.

S independent consensus groups ("shards") run in one process behind a
single client-facing front door; their prepare/commit verify waves
coalesce into COMMON device launches through one shared
``AsyncBatchCoalescer``/``TorchVerifyEngine``, so launch fill — and with it
aggregate committed tx/s — multiplies with the shard count while launch
counts grow sublinearly (the Mir-BFT/SBFT multi-instance multiplier,
landed on this codebase's strongest axis).  See README "Sharded mode".

The shard count is ELASTIC: ``ShardSet.reshard`` splits or merges groups
under live traffic through an epoch protocol (barrier commands committed
through each shard's own ordered stream, moved key-ranges drained behind
the barrier, atomic router flip, journaled for crash recovery), and an
occupancy-driven autoscaler can drive it from the pools' backpressure
signal.  See README "Elastic shards".

Components:
  ShardRouter         — deterministic, epoch-tagged client-id -> shard map
  DeliveryMux         — combined committed stream, per-shard exactly-once/
                        gapless across epoch transitions
  ShardSet            — composition root / front door / epoch machine /
                        metrics roll-up
  EpochJournal        — WAL-style journal of epoch-transition edges
  OccupancyAutoscaler — scale-out/in decisions over Pool.occupancy()
"""

from .autoscale import OccupancyAutoscaler, run_autoscaler
from .epoch import EpochJournal, ShardEpochError
from .mux import CommittedEntry, DeliveryMux, ShardStreamViolation
from .router import ShardRouter, jump_hash
from .set import ShardHandle, ShardSet

__all__ = [
    "CommittedEntry",
    "DeliveryMux",
    "EpochJournal",
    "OccupancyAutoscaler",
    "ShardEpochError",
    "ShardHandle",
    "ShardRouter",
    "ShardSet",
    "ShardStreamViolation",
    "jump_hash",
    "run_autoscaler",
]
