"""Crash-safe snapshot store + the pure verification/planning functions.

On-disk contract (the ``EpochJournal`` idiom, hardened for binary blobs):

* one snapshot is ONE file ``snapshot-%016x.snap`` (hex height), written
  as temp file + flush + fsync + atomic rename + directory fsync — a
  crash at ANY instant leaves either the complete previous snapshot or
  the complete new one, never a half-visible file;
* the file is ``MAGIC | u32 manifest_len | manifest | state_blob``; the
  manifest carries the state blob's size and blake2b digest, so a torn
  or tampered file is DETECTED on open (short header, undecodable
  manifest, size/digest mismatch) and skipped instead of installed;
* the manifest also carries the ANCHOR: the committed decision
  (proposal + signatures) at exactly ``height`` — PBFT's stable
  checkpoint certificate.  ``verify_snapshot`` re-checks the anchor
  against cluster membership and quorum size on every install, so a
  snapshot is never trusted because of where it came from, only because
  of what it proves.

Chain digests: the pre-snapshot ledger prefix is deleted by compaction,
so fork detection can no longer re-hash the whole prefix.  The chained
digest ``d_{i+1} = sha256(d_i || payload_i || metadata_i)`` folds each
decision into a running 32-byte value whose final state is independent
of whether the prefix is still on disk — the manifest pins the chain
value at ``height`` and recovery extends it from there, arriving at a
bit-identical digest to a replica that replayed everything.

Everything in this module is synchronous, lock-free, and pure except
:class:`SnapshotStore`'s file I/O — callers own their locking.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence

from ..codec import decode, encode, wiremsg
from ..messages import Proposal, Signature, ViewMetadata

#: snapshot file magic — versioned separately from the manifest's
#: format_version so a reader can reject a foreign file before decoding
SNAP_MAGIC = b"sbftsnp1"

SNAP_SUFFIX = ".snap"
_HDR_LEN = len(SNAP_MAGIC) + 4

#: the chain-digest seed (height 0: nothing folded in yet)
CHAIN_SEED = b"\x00" * 32

#: bounded dedup window carried in AppState: enough ids for the pool to
#: purge in-flight duplicates after an install, without making snapshot
#: size O(history) — which would defeat the whole flat-rejoin point
RECENT_IDS_CAP = 1024


class SnapshotError(Exception):
    """A snapshot failed verification — never install it."""


def chain_update(digest: bytes, payload: bytes, metadata: bytes) -> bytes:
    """Fold one committed decision into the chained ledger digest."""
    h = hashlib.sha256(digest)
    h.update(payload)
    h.update(metadata)
    return h.digest()


def fold_ids(digest: bytes, ids: Iterable[str]) -> bytes:
    """Fold committed request ids ("client:rid") into a chained digest —
    the exactly-once oracle that survives compaction (equality across
    replicas proves identical delivered-request sequences without either
    side holding the full id list)."""
    for rid in ids:
        h = hashlib.sha256(digest)
        h.update(rid.encode())
        digest = h.digest()
    return digest


@wiremsg
class AppState:
    """The bounded application state a snapshot carries for the test
    embedders (socket ``ReplicaApp`` and in-process ``testing.app.App``):
    delivered-request count, the chained ids digest, and a bounded recent
    window for pool dedup/purge after install.  Real embedders supply
    their own state blob; the manifest/digest machinery is agnostic."""

    request_count: int = 0
    ids_digest: bytes = b""
    recent_ids: list[str] = None  # type: ignore[assignment]
    #: the committed KV view the read plane serves: key ->
    #: latest committed payload, as parallel lists (the codec's untagged
    #: encoding has no dict shape).  Must ride the snapshot or a
    #: compaction would silently forget every key behind the horizon —
    #: O(distinct keys), which the test embedders bound by client count.
    kv_keys: list[str] = None  # type: ignore[assignment]
    kv_values: list[bytes] = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.recent_ids is None:
            object.__setattr__(self, "recent_ids", [])
        if self.kv_keys is None:
            object.__setattr__(self, "kv_keys", [])
        if self.kv_values is None:
            object.__setattr__(self, "kv_values", [])


@wiremsg
class SnapshotManifest:
    """Everything needed to verify + install one snapshot (untagged
    canonical encoding, like every control-plane message)."""

    format_version: int = 1
    #: decisions folded in: ledger[0:height] — the snapshot horizon
    height: int = 0
    #: chained ledger digest at ``height`` (chain_update from CHAIN_SEED)
    chain_digest: bytes = b""
    #: blake2b-32 of the state blob (torn/tamper detection)
    state_digest: bytes = b""
    state_bytes: int = 0
    #: the anchoring certificate: the committed decision at seq ``height``
    anchor_proposal: Proposal = None  # type: ignore[assignment]
    anchor_signatures: list[Signature] = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.anchor_proposal is None:
            object.__setattr__(self, "anchor_proposal", Proposal())
        if self.anchor_signatures is None:
            object.__setattr__(self, "anchor_signatures", [])


@dataclass(frozen=True)
class Snapshot:
    """One verified-on-open snapshot: manifest + state blob + file path."""

    manifest: SnapshotManifest
    state: bytes
    path: str = ""


def state_digest(state: bytes) -> bytes:
    return hashlib.blake2b(state, digest_size=32).digest()


def make_manifest(height: int, chain: bytes, state: bytes,
                  anchor_proposal: Proposal,
                  anchor_signatures: Sequence[Signature]) -> SnapshotManifest:
    return SnapshotManifest(
        height=height,
        chain_digest=chain,
        state_digest=state_digest(state),
        state_bytes=len(state),
        anchor_proposal=anchor_proposal,
        anchor_signatures=list(anchor_signatures),
    )


# ---------------------------------------------------------------------------
# pure verification — the sync-poisoning guard's teeth
# ---------------------------------------------------------------------------


def verify_manifest_state(manifest: SnapshotManifest,
                          state: bytes) -> Optional[str]:
    """Blob-integrity half of installation: size + digest must match the
    manifest.  Returns the failure reason, None when clean."""
    if manifest.height <= 0:
        return f"non-positive snapshot height {manifest.height}"
    if len(state) != manifest.state_bytes:
        return (f"state size mismatch: manifest says {manifest.state_bytes}, "
                f"got {len(state)}")
    if state_digest(state) != manifest.state_digest:
        return "state digest mismatch (torn or tampered blob)"
    return None


def verify_anchor(manifest: SnapshotManifest, quorum: int,
                  members: Optional[frozenset] = None) -> Optional[str]:
    """Certificate half of installation: the anchoring decision must sit
    at exactly ``height`` and carry >= quorum distinct signers from the
    known membership.  (Crypto is the embedder's Verifier SPI — the test
    embedders use trivial signatures, so the checks here are structural;
    a production Verifier additionally checks the signature bytes.)"""
    proposal = manifest.anchor_proposal
    if not proposal.metadata:
        return "anchor proposal carries no metadata"
    try:
        md = decode(ViewMetadata, proposal.metadata)
    except Exception as e:  # noqa: BLE001 — hostile input path
        return f"anchor metadata undecodable: {e!r}"
    if md.latest_sequence != manifest.height:
        return (f"anchor sequence {md.latest_sequence} != snapshot height "
                f"{manifest.height}")
    signers = {s.signer for s in manifest.anchor_signatures}
    if members is not None:
        unknown = signers - set(members)
        if unknown:
            return f"anchor signed by unknown nodes {sorted(unknown)}"
    if len(signers) < quorum:
        return (f"anchor certificate has {len(signers)} distinct signers, "
                f"quorum is {quorum}")
    return None


def verify_snapshot(manifest: SnapshotManifest, state: bytes, quorum: int,
                    members: Optional[frozenset] = None) -> Optional[str]:
    """Full install-time verification: blob integrity AND anchor
    certificate.  None means safe to install."""
    return (verify_manifest_state(manifest, state)
            or verify_anchor(manifest, quorum, members))


def verify_tail(decisions: Sequence, from_height: int,
                quorum: int = 0,
                members: Optional[frozenset] = None) -> Optional[str]:
    """Verify a sync tail BEFORE applying it: each decision must sit at
    the exactly-next sequence and (when quorum > 0) carry a plausible
    commit certificate.  ``decisions`` are WireDecision-shaped (a
    ``proposal`` and ``signatures``).  Returns the first failure reason,
    None when the whole tail is consistent."""
    expect = from_height + 1
    for i, wd in enumerate(decisions):
        md_raw = wd.proposal.metadata
        if not md_raw:
            return f"tail[{i}] carries no metadata"
        try:
            md = decode(ViewMetadata, md_raw)
        except Exception as e:  # noqa: BLE001 — hostile input path
            return f"tail[{i}] metadata undecodable: {e!r}"
        if md.latest_sequence != expect:
            return (f"tail[{i}] sequence {md.latest_sequence}, "
                    f"expected {expect}")
        if quorum > 0:
            signers = {s.signer for s in wd.signatures}
            if members is not None:
                unknown = signers - set(members)
                if unknown:
                    return (f"tail[{i}] signed by unknown nodes "
                            f"{sorted(unknown)}")
            if len(signers) < quorum:
                return (f"tail[{i}] has {len(signers)} distinct signers, "
                        f"quorum is {quorum}")
        expect += 1
    return None


def plan_catchup(my_height: int, peer_total: int,
                 peer_snapshot_height: int) -> str:
    """Catch-up planning for a lagging replica: ``"snapshot"`` when the
    peer's snapshot horizon is past our height (the peer compacted the
    prefix away — or fetching it would be O(history) anyway),
    ``"tail"`` when plain decision paging reaches it, ``"none"`` when we
    are already caught up."""
    if peer_total <= my_height:
        return "none"
    if peer_snapshot_height > my_height:
        return "snapshot"
    return "tail"


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------


def _snap_name(height: int) -> str:
    return f"snapshot-{height:016x}{SNAP_SUFFIX}"


def _parse_snap_name(name: str) -> Optional[int]:
    if not (name.startswith("snapshot-") and name.endswith(SNAP_SUFFIX)):
        return None
    stem = name[len("snapshot-"):-len(SNAP_SUFFIX)]
    if len(stem) != 16:
        return None
    try:
        return int(stem, 16)
    except ValueError:
        return None


def encode_snapshot_blob(manifest: SnapshotManifest, state: bytes) -> bytes:
    """The on-disk/on-wire snapshot file image (what SnapshotStore.save
    writes and the chunked FT_SNAP transfer ships)."""
    blob = encode(manifest)
    return SNAP_MAGIC + len(blob).to_bytes(4, "big") + blob + state


def parse_snapshot_blob(data: bytes) -> Optional[tuple[SnapshotManifest, bytes]]:
    """Parse a transferred snapshot file image; None on any structural
    damage (short header, foreign magic, undecodable manifest, blob
    size/digest mismatch) — the receiver treats that as a failed
    transfer, never installs it."""
    if len(data) < _HDR_LEN or data[:len(SNAP_MAGIC)] != SNAP_MAGIC:
        return None
    mlen = int.from_bytes(data[len(SNAP_MAGIC):_HDR_LEN], "big")
    if len(data) < _HDR_LEN + mlen:
        return None
    try:
        manifest = decode(SnapshotManifest, data[_HDR_LEN:_HDR_LEN + mlen])
    except Exception:  # noqa: BLE001 — hostile input path
        return None
    state = data[_HDR_LEN + mlen:]
    if verify_manifest_state(manifest, state) is not None:
        return None
    return manifest, state


def _fsync_dir(dir_path: str) -> None:
    fd = os.open(dir_path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class SnapshotStore:
    """Directory of at most ``keep`` verified snapshots, newest wins.

    ``save`` is atomic (temp + fsync + rename + dir fsync) and prunes
    older snapshots AFTER the new one is durable — a crash between the
    two leaves both, and ``latest`` picks the newer.  ``latest`` verifies
    blob integrity on open and SKIPS torn/tampered files (counted in
    ``rejected_files``) instead of raising: a corrupt snapshot is
    equivalent to no snapshot, the replica falls back to chain sync."""

    def __init__(self, dir_path: str, keep: int = 1):
        self.dir = os.path.normpath(dir_path)
        self.keep = max(1, keep)
        self.rejected_files = 0
        os.makedirs(self.dir, mode=0o700, exist_ok=True)

    def _heights(self) -> list[int]:
        try:
            names = os.listdir(self.dir)
        except FileNotFoundError:
            return []
        hs = [h for h in (_parse_snap_name(n) for n in names) if h is not None]
        hs.sort()
        return hs

    def save(self, manifest: SnapshotManifest, state: bytes) -> str:
        """Write one snapshot crash-safely; returns the final path."""
        err = verify_manifest_state(manifest, state)
        if err:
            raise SnapshotError(f"refusing to save inconsistent snapshot: {err}")
        final = os.path.join(self.dir, _snap_name(manifest.height))
        tmp = final + ".tmp"
        blob = encode(manifest)
        with open(tmp, "wb") as fh:
            fh.write(SNAP_MAGIC)
            fh.write(len(blob).to_bytes(4, "big"))
            fh.write(blob)
            fh.write(state)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, final)
        _fsync_dir(self.dir)
        self._gc()
        return final

    def _gc(self) -> None:
        heights = self._heights()
        for h in heights[:-self.keep]:
            try:
                os.remove(os.path.join(self.dir, _snap_name(h)))
            except OSError:
                pass
        # stray temp files from a crash mid-save are garbage by contract
        try:
            for name in os.listdir(self.dir):
                if name.endswith(".tmp"):
                    os.remove(os.path.join(self.dir, name))
        except OSError:
            pass

    def load(self, height: int) -> Optional[Snapshot]:
        return self._read(os.path.join(self.dir, _snap_name(height)))

    def read_range(self, height: int, offset: int,
                   max_bytes: int) -> tuple[int, bytes, bool]:
        """One bounded byte slice of the snapshot FILE at ``height`` —
        ``(total_bytes, data, last)`` with ``total_bytes == 0`` when the
        file is gone (superseded/pruned: the chunked-transfer requester
        restarts against the current offer).  This is the single
        file-open surface both the FT_SNAP chunk server and the
        read-plane's read-at-base path go through; integrity of the
        WHOLE file is the caller's side of the contract (`load` for the
        verified-object path, the transfer receiver's parse for the
        chunked path)."""
        path = os.path.join(self.dir, _snap_name(height))
        try:
            total = os.path.getsize(path)
            with open(path, "rb") as fh:
                fh.seek(offset)
                data = fh.read(max(0, max_bytes))
        except OSError:
            return 0, b"", False
        return total, data, offset + len(data) >= total

    def latest(self) -> Optional[Snapshot]:
        """The newest snapshot that passes blob verification, or None."""
        for h in reversed(self._heights()):
            snap = self._read(os.path.join(self.dir, _snap_name(h)))
            if snap is not None:
                return snap
        return None

    def _read(self, path: str) -> Optional[Snapshot]:
        try:
            with open(path, "rb") as fh:
                data = fh.read()
        except OSError:
            return None
        if len(data) < _HDR_LEN or data[:len(SNAP_MAGIC)] != SNAP_MAGIC:
            self.rejected_files += 1
            return None
        mlen = int.from_bytes(data[len(SNAP_MAGIC):_HDR_LEN], "big")
        if len(data) < _HDR_LEN + mlen:
            self.rejected_files += 1
            return None
        try:
            manifest = decode(SnapshotManifest, data[_HDR_LEN:_HDR_LEN + mlen])
        except Exception:  # noqa: BLE001 — torn/foreign manifest
            self.rejected_files += 1
            return None
        state = data[_HDR_LEN + mlen:]
        if verify_manifest_state(manifest, state) is not None:
            self.rejected_files += 1
            return None
        return Snapshot(manifest=manifest, state=state, path=path)

    def disk_bytes(self) -> int:
        total = 0
        for h in self._heights():
            try:
                total += os.path.getsize(os.path.join(self.dir, _snap_name(h)))
            except OSError:
                pass
        return total
