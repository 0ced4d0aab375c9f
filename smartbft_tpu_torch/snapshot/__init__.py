"""Snapshot state transfer + log compaction.

The catch-up story before this package was full chain replay: a
SIGKILL'd replica re-pulled every committed decision it missed, a
scale-out shard started fresh, and ledgers/WALs grew forever.  This
package is the PBFT stable-checkpoint half the reference survey names
(StateCollector + state transfer): application state is periodically
captured ANCHORED at a committed decision's certificate, written
crash-safely, verified against that certificate on install, and used to
answer "you are too far behind" with snapshot + tail instead of the
whole chain — which is what makes rejoin O(1) in history depth and lets
the pre-horizon ledger/WAL prefix be deleted.
"""

from .store import (
    CHAIN_SEED,
    RECENT_IDS_CAP,
    AppState,
    Snapshot,
    SnapshotError,
    SnapshotManifest,
    SnapshotStore,
    chain_update,
    encode_snapshot_blob,
    fold_ids,
    make_manifest,
    parse_snapshot_blob,
    plan_catchup,
    state_digest,
    verify_anchor,
    verify_manifest_state,
    verify_snapshot,
    verify_tail,
)

__all__ = [
    "CHAIN_SEED",
    "RECENT_IDS_CAP",
    "AppState",
    "Snapshot",
    "SnapshotError",
    "SnapshotManifest",
    "SnapshotStore",
    "chain_update",
    "encode_snapshot_blob",
    "fold_ids",
    "make_manifest",
    "parse_snapshot_blob",
    "plan_catchup",
    "state_digest",
    "verify_anchor",
    "verify_manifest_state",
    "verify_snapshot",
    "verify_tail",
]
