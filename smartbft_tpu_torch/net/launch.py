"""One-replica process entry point: ``python -m smartbft_tpu_torch.net.launch``.

A replica process is a :class:`ReplicaApp` (every SPI interface,
implemented for a process that shares NOTHING in memory with its peers)
wired to a :class:`~smartbft_tpu_torch.net.transport.SocketComm` and a
Consensus facade running on its own wall-clock driver.  Processes share
only key material and the peer address map — exactly the deployment
contract of the paper's embedder.

What replaces the in-process harness's shared state:

* **Ledger** — each committed decision is appended (length-prefixed
  frame, ``framing.WireDecision``) to a per-replica ledger file.  On
  restart the file is replayed with torn-tail tolerance (a SIGKILL
  mid-append loses at most the partial tail record; the replica then
  catches up over the wire like any lagging peer).
* **Synchronizer** — ``sync()`` asks every peer for its ledger tail over
  the transport's SYNC_REQ/SYNC_RESP frames (nonce-correlated, batched
  at ``MAX_SYNC_DECISIONS`` per round trip) and applies the longest
  consistent extension.  This is what makes SIGKILL-and-rejoin a real
  scenario instead of a shared-memory illusion.
* **Control channel** — a tiny line-JSON server (its own UDS/TCP
  listener, NOT the consensus transport) the parent cluster manager
  uses to submit requests, read heights/digests/transport stats, inject
  socket-level faults, and request graceful shutdown.

Crypto is trivial (signature = node id), matching the in-process
harness's default: this subsystem proves the TRANSPORT, the crypto
planes are proven elsewhere and plug in through the same SPI.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import threading
from typing import Optional

from .. import wal as walmod
from ..api import (
    Application,
    Assembler,
    Comm,
    MembershipNotifier,
    RequestInspector,
    Signer,
    Synchronizer,
    Verifier,
)
from ..codec import decode, encode, wiremsg
from ..config import Configuration
from ..consensus import Consensus
from ..core.readplane import (
    ReadStats,
    TokenBucket,
    follower_read_accept,
    quorum_read_decide,
    session_retry_after_ms,
)
from ..core.util import compute_quorum
from ..messages import Proposal, Signature, ViewMetadata
from ..snapshot import (
    CHAIN_SEED,
    RECENT_IDS_CAP,
    AppState,
    SnapshotStore,
    chain_update,
    fold_ids,
    make_manifest,
    parse_snapshot_blob,
    verify_snapshot,
    verify_tail,
)
from ..types import Decision, Reconfig, RequestInfo, SyncResponse
from ..utils.logging import StdLogger
from ..utils.memo import BoundedMemo
from .framing import (
    FrameDecoder,
    FrameError,
    ReadRequest,
    ReadResponse,
    WireDecision,
    encode_frame,
    parse_addr,
)
from .transport import MAX_SYNC_DECISIONS, SocketComm

#: ledger-file frame types (framing reserves 1..9 for the socket
#: protocol; the ledger file is a private on-disk format, any tag works
#: as long as the reader and writer agree — but reusing FrameDecoder
#: keeps torn-tail handling in one place, so the tags must be known
#: ones).  _FT_LEDGER frames one committed decision; _FT_LEDGER_BASE is
#: the optional LEADING frame of a compacted file: the snapshot
#: reference that replaces the deleted pre-horizon prefix.
from .framing import FT_SYNC_RESP as _FT_LEDGER  # noqa: E402
from .framing import FT_SNAP_REQ as _FT_LEDGER_BASE  # noqa: E402

#: donor-shun threshold: once a peer has served this many
#: poisoned sync tails / snapshot blobs, the synchronizer stops asking it
#: at all — a liar that keeps lying costs one request timeout per sync
#: round forever otherwise.  Certificate checks already make the lies
#: harmless; this just stops paying for them.  Deliberately small and
#: not config-plumbed: honest donors score 0 (stale races skip QUIETLY in
#: phase 1 and never count), so any nonzero streak is a tamperer.
SYNC_DONOR_SHUN_THRESHOLD = 3


@wiremsg
class LedgerBaseRef:
    """The compacted ledger's leading frame: decisions ``1..height`` were
    replaced by the snapshot at ``height`` whose chained ledger digest is
    ``chain_digest`` — recovery seeds the chain there and replays only
    the suffix, arriving at a digest bit-identical to a full replay.

    ``app_state`` (an encoded :class:`~smartbft_tpu_torch.snapshot.AppState`)
    and ``anchor`` (an encoded :class:`WireDecision` — the certificate at
    ``height``) duplicate the snapshot file's seeding material INSIDE the
    ledger: a replica whose snapshot directory is lost or corrupted after
    compaction can still recover its app counters and its consensus
    metadata instead of restarting at sequence zero."""

    height: int = 0
    chain_digest: bytes = b""
    app_state: bytes = b""
    anchor: bytes = b""


def proc_config(self_id: int) -> Configuration:
    """Wall-clock configuration for a localhost multi-process cluster:
    the socket twin of ``testing.app.fast_config`` — timeouts sized for
    real time on one machine (RTT ~50 us), snappy enough that the smoke
    gate's kill/rejoin cycles finish in seconds."""
    return Configuration(
        self_id=self_id,
        request_batch_max_count=10,
        request_batch_max_bytes=10 * 1024 * 1024,
        request_batch_max_interval=0.02,
        incoming_message_buffer_size=400,
        request_pool_size=800,
        request_forward_timeout=1.0,
        # round-16 fix: derive the EFFECTIVE forward timeout from the
        # transport's measured RTT (localhost: µs → clamped to the 10 ms
        # floor) instead of waiting out the full constant above — which
        # the cluster timeline measured as 97.6% of follower-submitted
        # request latency.  The constant stays the ceiling/fallback.
        request_forward_rtt_multiplier=20.0,
        request_complain_timeout=4.0,
        request_auto_remove_timeout=60.0,
        view_change_resend_interval=1.0,
        view_change_timeout=6.0,
        leader_heartbeat_timeout=3.0,
        leader_heartbeat_count=10,
        num_of_ticks_behind_before_syncing=10,
        collect_timeout=0.5,
        # off, like the in-process fast_config: a fresh replica starts at
        # its recovered height and catches up through the behind-by-
        # heartbeat sync path; sync_on_start=True measurably destabilizes
        # the first seconds of a wall-clock cluster (start-time syncs
        # contend with the first commit waves for the sync lock)
        sync_on_start=False,
        speed_up_view_change=False,
        leader_rotation=False,
        decisions_per_leader=0,
        transport_outbox_cap=4096,
        transport_reconnect_backoff_base=0.02,
        transport_reconnect_backoff_max=0.5,
    )


class LedgerFile:
    """Append-only committed-decision log with torn-tail-tolerant replay
    and snapshot-horizon compaction.

    Frames are ``framing`` frames; a truncated/corrupt tail record (the
    SIGKILL case) ends the replay instead of raising — the replica simply
    restarts a few decisions behind and syncs the rest from its peers.

    A COMPACTED file begins with a :class:`LedgerBaseRef` frame: the
    decisions behind the snapshot horizon were deleted and replaced by
    the reference (height + chained digest).  ``read_all`` then returns
    only the suffix, with ``base_height``/``base_digest`` exposing where
    it starts.  ``compact`` rewrites the file (temp + fsync + atomic
    rename — the same crash contract as the snapshot store) so a crash
    mid-compaction leaves either the old full file or the new compacted
    one, never a truncated hybrid."""

    def __init__(self, path: str):
        self.path = path
        self._fh = None
        #: decisions compacted away: the file's suffix starts at
        #: base_height (0 = never compacted, full chain on disk)
        self.base_height = 0
        #: chained ledger digest at base_height (CHAIN_SEED when 0)
        self.base_digest = CHAIN_SEED
        #: encoded AppState / WireDecision at the base (b"" when 0)
        self.base_state = b""
        self.base_anchor = b""

    def read_all(self) -> list[Decision]:
        decisions: list[Decision] = []
        self.base_height = 0
        self.base_digest = CHAIN_SEED
        self.base_state = b""
        self.base_anchor = b""
        if not os.path.exists(self.path):
            return decisions
        decoder = FrameDecoder()
        with open(self.path, "rb") as fh:
            data = fh.read()
        try:
            frames = decoder.feed(data)
        except FrameError:
            frames = []  # poisoned mid-file: at worst we resync everything
        for i, (ftype, payload) in enumerate(frames):
            if ftype == _FT_LEDGER_BASE:
                if i != 0:
                    break  # a base ref anywhere but first is corruption
                try:
                    ref = decode(LedgerBaseRef, payload)
                except Exception:
                    break  # torn base frame: treat as empty suffix
                self.base_height = ref.height
                self.base_digest = ref.chain_digest
                self.base_state = ref.app_state
                self.base_anchor = ref.anchor
                continue
            try:
                wd = decode(WireDecision, payload)
            except Exception:
                break  # torn tail
            decisions.append(
                Decision(proposal=wd.proposal, signatures=tuple(wd.signatures))
            )
        return decisions

    def open_append(self) -> None:
        self._fh = open(self.path, "ab")

    def append(self, decision: Decision) -> None:
        wd = WireDecision(
            proposal=decision.proposal, signatures=list(decision.signatures)
        )
        self._fh.write(encode_frame(_FT_LEDGER, encode(wd)))
        self._fh.flush()

    def compact(self, base_height: int, base_digest: bytes,
                suffix: list[Decision], *, app_state: bytes = b"",
                anchor: bytes = b"") -> None:
        """Replace the pre-horizon prefix with a snapshot reference:
        rewrite the file as ``[LedgerBaseRef, suffix...]`` atomically and
        reopen the append handle on the new file."""
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as fh:
            ref = LedgerBaseRef(height=base_height, chain_digest=base_digest,
                                app_state=app_state, anchor=anchor)
            fh.write(encode_frame(_FT_LEDGER_BASE, encode(ref)))
            for d in suffix:
                wd = WireDecision(proposal=d.proposal,
                                  signatures=list(d.signatures))
                fh.write(encode_frame(_FT_LEDGER, encode(wd)))
            fh.flush()
            os.fsync(fh.fileno())
        reopen = self._fh is not None
        if reopen:
            self._fh.close()
            self._fh = None
        os.replace(tmp, self.path)
        dir_fd = os.open(os.path.dirname(os.path.abspath(self.path)),
                         os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
        self.base_height = base_height
        self.base_digest = base_digest
        self.base_state = app_state
        self.base_anchor = anchor
        if reopen:
            self.open_append()

    def disk_bytes(self) -> int:
        try:
            if self._fh is not None:
                self._fh.flush()
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class _SnapshotServer:
    """The transport's duck-typed snapshot hook: serves the replica's
    current snapshot offer as bounded chunks read straight off the file
    (never materializing the blob in memory per request)."""

    def __init__(self, replica: "ReplicaApp"):
        self.replica = replica

    def describe(self):
        return self.replica._snap_offer

    def read_chunk(self, height: int, offset: int,
                   max_bytes: int) -> tuple[int, bytes, bool]:
        offer = self.replica._snap_offer
        if offer is None or offer[0] != height:
            return 0, b"", False  # gone/superseded: requester restarts
        # byte access goes through the store's
        # single file-open surface, shared with the read-at-base path
        total, data, last = self.replica.snapshot_store.read_range(
            height, offset, max_bytes
        )
        if total == 0:
            return 0, b"", False
        return total, data, last


class ReplicaApp(Application, Assembler, Comm, Signer, Verifier,
                 RequestInspector, Synchronizer, MembershipNotifier):
    """The multi-process embedder: one OS process, no shared memory."""

    #: ledger appends are a buffered write + flush — cheap enough to run
    #: inline on the event loop instead of paying an executor round-trip
    blocking_deliver = False

    def __init__(self, spec: dict):
        self.spec = spec
        self.id = int(spec["node_id"])
        self.logger = StdLogger(f"replica-{self.id}")
        self.config = _config_from_spec(spec)
        self.peers = {int(k): v for k, v in spec["peers"].items()}
        self.transport = SocketComm.from_config(
            self.config,
            self.peers,
            listen=spec["listen"],
            cluster_key=bytes.fromhex(spec.get("cluster_key", "")),
            logger=self.logger,
        )
        self.transport.sync_server = self._serve_sync
        # per-replica pull-based observability: a Prometheus
        # text-exposition provider ALWAYS (counters are cheap and the
        # control channel's cmd=metrics needs something to read), the
        # flight recorder only when the spec asks (cmd=trace then serves
        # the per-replica timeline to SocketCluster / operators)
        from ..metrics import MetricsBundle, PrometheusProvider
        from ..obs import NOP_RECORDER, TraceRecorder

        self.metrics_provider = PrometheusProvider()
        self.metrics = MetricsBundle(self.metrics_provider)
        if spec.get("trace"):
            self.recorder = TraceRecorder(
                node=f"n{self.id}",
                capacity=int(spec.get("trace_capacity", 2048)),
            )
        else:
            self.recorder = NOP_RECORDER
        self.transport.recorder = self.recorder
        # cluster health plane: every replica judges itself
        # against the declarative SLO spec on a periodic tick; cmd=health
        # serves the verdict, SocketCluster.cluster_health aggregates n
        # of them.  Breach/clear transitions land in the flight recorder
        # (when armed) so SLO violations show on the merged timeline.
        from ..obs.health import HealthMonitor

        self.health = HealthMonitor(recorder=self.recorder,
                                    node=f"n{self.id}")
        self.health_interval = float(spec.get("health_interval", 0.25))
        self._health_task = None
        # FT_TRACE sidecars carry the SAME "client:rid" correlator the
        # recorder stamps on req.submit/req.deliver (request_id memoizes,
        # so the per-forward cost is a dict hit once warm)
        self.transport.request_key_fn = \
            lambda raw: str(self.request_id(raw))
        self.ledger_file = LedgerFile(spec["ledger_path"])
        self.lock = threading.Lock()
        #: committed-decision SUFFIX: ledger[i] is the decision at
        #: absolute sequence _base_height + i + 1.  Before the first
        #: compaction _base_height is 0 and this is the whole chain.
        self.ledger: list[Decision] = []
        self._base_height = 0
        self._base_chain = CHAIN_SEED
        #: chained ledger digest over ALL committed decisions (compacted
        #: prefix included) — the fork detector that survives compaction
        self._chain = CHAIN_SEED
        #: bounded app state (what a snapshot carries): delivered-request
        #: count, chained request-id digest, recent-id dedup window
        self._request_count = 0
        self._ids_digest = CHAIN_SEED
        from collections import deque

        self._recent_ids: deque = deque(maxlen=RECENT_IDS_CAP)
        #: the certificate at _base_height — serves as SyncResponse.latest
        #: when the suffix is empty (a freshly installed snapshot)
        self._anchor_decision: Optional[Decision] = None
        self.snapshot_store = SnapshotStore(
            spec.get("snap_dir") or spec["ledger_path"] + "-snapshots"
        )
        #: (height, total_bytes, digest) of the snapshot on offer + its
        #: file path — what the transport's FT_SNAP plane serves
        self._snap_offer: Optional[tuple[int, int, bytes]] = None
        self._snap_path = ""
        self._snap_inflight = False
        self._last_snapshot_height = 0
        #: per-peer count of LOUDLY rejected sync material (tampered
        #: tails / snapshots that failed certificate verification)
        self.sync_poisoned: dict[int, int] = {}
        self.transport.snapshot_server = _SnapshotServer(self)
        # read plane: the committed KV view (key = client id,
        # value = that client's latest committed payload — deterministic
        # over the committed order, so honest replicas' read stamps match
        # bit-exactly), its token-bucket gate (reads bypass the write
        # pool's admission entirely; a read storm drains THIS bucket and
        # sheds reads, never writes), serving counters, and the bounded
        # watch registry for committed-stream subscriptions
        self._kv: dict[str, bytes] = {}
        self._read_gate = TokenBucket(self.config.read_gate_rate,
                                      self.config.read_gate_burst)
        self.read_stats = ReadStats()
        self.transport.read_server = self._serve_read
        self._watches: dict[int, dict] = {}
        self._watch_seq = 0
        # disk gauges (promlint-clean: consensus_<sub>_<name>)
        from ..metrics import MetricOpts

        _g = self.metrics_provider.new_gauge
        self.snapshot_age_gauge = _g(MetricOpts(
            namespace="consensus", subsystem="snapshot",
            name="age_decisions",
            help="decisions committed since the last snapshot"))
        self.snapshot_disk_gauge = _g(MetricOpts(
            namespace="consensus", subsystem="snapshot", name="disk_bytes",
            help="bytes of snapshot files on disk"))
        self.ledger_disk_gauge = _g(MetricOpts(
            namespace="consensus", subsystem="ledger", name="disk_bytes",
            help="bytes of the (compacted) ledger file on disk"))
        self.wal_disk_gauge = _g(MetricOpts(
            namespace="consensus", subsystem="wal", name="disk_bytes",
            help="bytes of live WAL segments on disk"))
        self.verification_seq = 0
        self.membership_changed = False
        self.consensus: Optional[Consensus] = None
        self._wal = None
        self._request_id_cache: BoundedMemo[bytes, RequestInfo] = BoundedMemo()
        #: epoch -> committed barrier ledger seq (immutable once found) and
        #: epoch -> ledger index already scanned without finding it — the
        #: reshard manager polls barrier_seq every ~100 ms, so each poll
        #: must cost O(new entries), not O(ledger)
        self._barrier_seqs: dict[int, int] = {}
        self._barrier_scan: dict[int, int] = {}
        #: committed_ids / ledger_digest polling
        #: memos, same discipline as the barrier memo above — each poll
        #: costs O(new entries), and a base move (compaction or snapshot
        #: install re-bases the suffix) invalidates the whole memo
        self._ids_cache: list[str] = []
        self._ids_scan = 0
        self._ids_cache_base = -1
        self._chain_prefix: list[bytes] = []
        self._chain_prefix_base = -1

    # ------------------------------------------------------------ app SPI

    def deliver(self, proposal: Proposal, signatures) -> Reconfig:
        decision = Decision(proposal=proposal, signatures=tuple(signatures))
        try:
            ids = [str(i) for i in self.requests_from_proposal(proposal)]
        except Exception:  # noqa: BLE001 — foreign payload: no request ids
            ids = []
        kv_updates = self._kv_updates(proposal)
        with self.lock:
            self.ledger.append(decision)
            self.ledger_file.append(decision)
            self._chain = chain_update(self._chain, proposal.payload,
                                       proposal.metadata)
            self._ids_digest = fold_ids(self._ids_digest, ids)
            self._recent_ids.extend(ids)
            self._request_count += len(ids)
            for client, _rid, payload in kv_updates:
                self._kv[client] = payload
            height = self._base_height + len(self.ledger)
        if self._watches and kv_updates:
            self._publish_watches(height, kv_updates)
        self._maybe_capture()
        return self._reconfig_in(proposal)

    def _kv_updates(self, proposal: Proposal) -> list[tuple[str, str, bytes]]:
        """The committed KV view's delta for one decision: one
        ``(client_id, request_id, payload)`` per well-formed TestRequest
        in the batch, in batch order.  Foreign payloads contribute
        nothing (mirrors ``_reconfig_in``'s tolerance)."""
        from ..testing.app import BatchPayload, TestRequest

        if not proposal.payload:
            return []
        try:
            batch = decode(BatchPayload, proposal.payload)
        except Exception:  # noqa: BLE001 — foreign payload
            return []
        out: list[tuple[str, str, bytes]] = []
        for raw in batch.requests:
            try:
                req = decode(TestRequest, raw)
            except Exception:  # noqa: BLE001 — foreign request
                continue
            out.append((req.client_id, req.request_id, bytes(req.payload)))
        return out

    # ------------------------------------------------------- snapshots --------

    def _maybe_capture(self) -> None:
        """Kick an async snapshot capture when the configured interval of
        decisions has accumulated since the last horizon.  Runs after
        every deliver; cheap when disabled (one int compare)."""
        interval = self.config.snapshot_interval_decisions
        if interval <= 0 or self._snap_inflight:
            return
        with self.lock:
            height = self._base_height + len(self.ledger)
        if height - self._last_snapshot_height < interval:
            return
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            return  # not on the loop; the next on-loop deliver triggers
        from ..utils.tasks import create_logged_task

        self._snap_inflight = True
        create_logged_task(self._capture_snapshot(),
                           name=f"snapshot-{self.id}", logger=self.logger)

    async def _capture_snapshot(self) -> None:
        """Capture + truncate, each step crash-safe:

        1. freeze (height H, chain digest at H, anchor certificate at H,
           bounded app state) under the lock;
        2. write the snapshot file (temp + fsync + atomic rename — a kill
           here leaves the old snapshot + the full ledger: recovery sees
           nothing unusual);
        3. compact the ledger file (atomic rewrite: base ref + suffix)
           and prune WAL segments behind the horizon — a kill between 2
           and 3 leaves snapshot AND full ledger, which recovery
           reconciles by seeding from the snapshot and folding the
           suffix past it."""
        import time as _time

        try:
            with self.lock:
                height = self._base_height + len(self.ledger)
                if height <= self._last_snapshot_height or not self.ledger:
                    return
                anchor = self.ledger[-1]
                chain_at = self._chain
                state = AppState(
                    request_count=self._request_count,
                    ids_digest=self._ids_digest,
                    recent_ids=list(self._recent_ids),
                    kv_keys=list(self._kv.keys()),
                    kv_values=list(self._kv.values()),
                )
            blob = encode(state)
            manifest = make_manifest(height, chain_at, blob,
                                     anchor.proposal,
                                     list(anchor.signatures))
            t0 = _time.monotonic()
            path = self.snapshot_store.save(manifest, blob)
            if self.recorder.enabled:
                self.recorder.record("snapshot.capture", seq=height,
                                     dur=_time.monotonic() - t0,
                                     extra={"bytes": os.path.getsize(path)})
            anchor_wire = encode(WireDecision(
                proposal=anchor.proposal, signatures=list(anchor.signatures)
            ))
            t0 = _time.monotonic()
            with self.lock:
                cut = height - self._base_height
                suffix = self.ledger[cut:]
                self.ledger_file.compact(height, chain_at, suffix,
                                         app_state=blob, anchor=anchor_wire)
                self.ledger = suffix
                self._base_height = height
                self._base_chain = chain_at
                self._anchor_decision = anchor
            dropped = 0
            if self._wal is not None and hasattr(self._wal,
                                                 "drop_stale_segments"):
                dropped = self._wal.drop_stale_segments()
            if self.recorder.enabled:
                self.recorder.record("snapshot.truncate", seq=height,
                                     dur=_time.monotonic() - t0,
                                     extra={"wal_segments_dropped": dropped})
            self._snap_offer = (height, os.path.getsize(path),
                                manifest.state_digest)
            self._snap_path = path
            self._last_snapshot_height = height
        except Exception as e:  # noqa: BLE001 — capture must never kill consensus
            self.logger.warnf("snapshot capture failed: %r", e)
        finally:
            self._snap_inflight = False

    def _reconfig_in(self, proposal: Proposal) -> Reconfig:
        from ..testing.app import BatchPayload, TestRequest
        from ..testing.reconfig import RECONFIG_MAGIC, detect_reconfig

        found = Reconfig(in_latest_decision=False)
        if not proposal.payload or RECONFIG_MAGIC not in proposal.payload:
            return found
        try:
            batch = decode(BatchPayload, proposal.payload)
        except Exception:
            return found
        for raw in batch.requests:
            try:
                req = decode(TestRequest, raw)
            except Exception:
                continue
            reconfig = detect_reconfig(req.payload)
            if reconfig is not None:
                found = reconfig
        return found

    def assemble_proposal(self, metadata: bytes, requests) -> Proposal:
        from ..testing.app import BatchPayload

        return Proposal(
            header=b"",
            payload=encode(BatchPayload(requests=list(requests))),
            metadata=metadata,
            verification_sequence=self.verification_seq,
        )

    # ------------------------------------------------------------ Comm

    def send_consensus(self, target_id: int, msg) -> None:
        self.transport.send_consensus(target_id, msg)

    def broadcast_consensus(self, msg, targets=None) -> None:
        self.transport.broadcast_consensus(msg, targets)

    def send_transaction(self, target_id: int, request: bytes) -> None:
        self.transport.send_transaction(target_id, request)

    def nodes(self) -> list[int]:
        return self.transport.nodes()

    def rtt_seconds(self):
        """Expose the transport's measured RTT through the Comm seam —
        the forward-timeout derivation reads it off whatever object
        Consensus holds as ``comm`` (this embedder)."""
        return self.transport.rtt_seconds()

    # ------------------------------------------------------------ crypto (trivial)

    def sign(self, data: bytes) -> bytes:
        return b"sig-%d" % self.id

    def sign_proposal(self, proposal: Proposal, auxiliary_input: bytes) -> Signature:
        return Signature(signer=self.id, value=b"sig-%d" % self.id,
                         msg=auxiliary_input)

    def verify_proposal(self, proposal: Proposal) -> list[RequestInfo]:
        return self.requests_from_proposal(proposal)

    def verify_request(self, raw_request: bytes) -> RequestInfo:
        return self.request_id(raw_request)

    def verify_consenter_sig(self, signature: Signature, proposal: Proposal) -> bytes:
        return signature.msg

    def verify_signature(self, signature: Signature) -> None:
        return None

    def verification_sequence(self) -> int:
        return self.verification_seq

    def requests_from_proposal(self, proposal: Proposal) -> list[RequestInfo]:
        from ..testing.app import BatchPayload

        if not proposal.payload:
            return []
        batch = decode(BatchPayload, proposal.payload)
        return [self.request_id(r) for r in batch.requests]

    def auxiliary_data(self, msg: bytes) -> bytes:
        return msg

    def request_id(self, raw_request: bytes) -> RequestInfo:
        from ..testing.app import TestRequest

        def compute() -> RequestInfo:
            req = decode(TestRequest, raw_request)
            return RequestInfo(client_id=req.client_id, request_id=req.request_id)

        return self._request_id_cache.get_or(raw_request, compute)

    def membership_change(self) -> bool:
        return self.membership_changed

    # ------------------------------------------------------------ sync (over the wire)

    def _serve_sync(self, from_height: int) -> tuple[list, int]:
        """Transport sync-server hook (runs on the event loop).  Heights
        are ABSOLUTE; a request from behind our compaction horizon gets
        an empty tail — the transport attaches the snapshot offer, which
        is the only way past the deleted prefix."""
        with self.lock:
            base = self._base_height
            total = base + len(self.ledger)
            if from_height >= base:
                lo = from_height - base
                tail = self.ledger[lo:lo + MAX_SYNC_DECISIONS]
            else:
                tail = []
        return (
            [WireDecision(proposal=d.proposal, signatures=list(d.signatures))
             for d in tail],
            total,
        )

    def sync(self) -> SyncResponse:
        """Synchronizer SPI — called on an executor thread; the socket
        round trips run on the event loop via run_coroutine_threadsafe."""
        try:
            fut = asyncio.run_coroutine_threadsafe(self._sync_over_wire(),
                                                   self._loop)
            fut.result(timeout=30.0)
        except Exception as e:  # noqa: BLE001 — sync must not kill the caller
            self.logger.warnf("wire sync failed: %r", e)
        with self.lock:
            mine = list(self.ledger)
            anchor = self._anchor_decision
        # a freshly installed snapshot leaves an empty suffix: the anchor
        # certificate IS the latest decision (Consensus re-anchors its
        # view/sequence off its metadata, exactly as after a replay)
        if mine:
            latest = mine[-1]
        elif anchor is not None:
            latest = anchor
        else:
            latest = Decision(proposal=Proposal())
        reconfig = (
            self._reconfig_in(latest.proposal) if latest.proposal.payload
            else Reconfig(in_latest_decision=False)
        )
        return SyncResponse(latest=latest, reconfig=reconfig)

    def _poisoned(self, peer: int, reason: str) -> None:
        """A peer served sync material that failed verification: reject
        LOUDLY, count per-peer, never install.  (The guard
        that keeps one compromised peer from rewriting a rejoiner.)"""
        self.sync_poisoned[peer] = self.sync_poisoned.get(peer, 0) + 1
        self.transport.metrics.sync_poisoned += 1
        if self.recorder.enabled:
            self.recorder.record("sync.poisoned", key=f"peer-{peer}",
                                 extra={"reason": reason[:160]})
        self.logger.warnf(
            "SYNC POISONING: rejecting material from peer %d (%d so far): %s",
            peer, self.sync_poisoned[peer], reason,
        )

    async def _sync_over_wire(self) -> None:
        """Pull our peers' ledger tails until no peer is ahead of us.

        Every tail is verified BEFORE any decision is applied: sequence
        continuity always, and the commit certificate (>= quorum distinct
        known signers per decision) — a tampered tail increments the
        poisoning counters and is dropped whole.  When every usable peer
        answers from past its compaction horizon (empty tail + snapshot
        offer), the snapshot branch fetches, verifies against the anchor
        certificate, and installs — then loops to pull the tail beyond
        the snapshot."""
        members = frozenset([self.id, *self.peers])
        quorum, _f = compute_quorum(len(members))
        for _round in range(64):  # bound: 64 * MAX_SYNC_DECISIONS decisions
            with self.lock:
                my_height = self._base_height + len(self.ledger)
            # donor shun: peers with a poisoning streak are not
            # even asked — unless EVERY peer is shunned, in which case ask
            # all of them (a fully partitioned rejoiner must still be able
            # to make progress off whichever donor has stopped lying; the
            # certificate checks below stay the actual safety boundary)
            peers = [p for p in self.peers
                     if self.sync_poisoned.get(p, 0)
                     < SYNC_DONOR_SHUN_THRESHOLD]
            if not peers:
                peers = list(self.peers)
            results = await asyncio.gather(*[
                self.transport.request_sync(p, my_height, timeout=1.0)
                for p in peers
            ])
            batches = [(p, r) for p, r in zip(peers, results)
                       if r is not None]
            usable = []
            for peer, batch in batches:
                if not batch.decisions:
                    continue
                # phase 1 — continuity from OUR height: failure is the
                # normal stale-batch race (we moved on), skip quietly
                if verify_tail(batch.decisions, my_height) is not None:
                    continue
                # phase 2 — certificates: failure here is tampering
                err = verify_tail(batch.decisions, my_height,
                                  quorum=quorum, members=members)
                if err is not None:
                    self._poisoned(peer, f"sync tail: {err}")
                    continue
                usable.append(batch)
            if usable:
                best = max(usable, key=lambda b: len(b.decisions))
                applied = 0
                for wd in best.decisions:
                    md = (decode(ViewMetadata, wd.proposal.metadata)
                          if wd.proposal.metadata else ViewMetadata())
                    with self.lock:
                        expect = self._base_height + len(self.ledger) + 1
                    if md.latest_sequence != expect:
                        break  # raced a live commit: re-request from new height
                    self.deliver(wd.proposal, list(wd.signatures))
                    self._drop_synced_from_pool(wd.proposal)
                    applied += 1
                if applied == 0:
                    return
                continue
            # no usable tail: are we behind somebody's compaction horizon?
            installed = await self._try_snapshot_catchup(
                batches, my_height, quorum, members
            )
            if not installed:
                return

    async def _try_snapshot_catchup(self, batches, my_height: int,
                                    quorum: int, members) -> bool:
        """Fetch + verify + install the best snapshot on offer; True when
        one was installed (the caller loops to pull the tail past it)."""
        offers = [(p, b) for p, b in batches
                  if b.snapshot_height > my_height and b.snapshot_bytes > 0
                  # donor shun: a peer can cross the threshold
                  # MID-ROUND (poisoned tail above, then its offer lands
                  # here), so re-check before paying for a chunked
                  # multi-frame snapshot transfer from a known tamperer
                  and self.sync_poisoned.get(p, 0)
                  < SYNC_DONOR_SHUN_THRESHOLD]
        offers.sort(key=lambda pb: pb[1].snapshot_height, reverse=True)
        for peer, batch in offers:
            data = await self.transport.fetch_snapshot(
                peer, batch.snapshot_height,
                chunk_bytes=self.config.snapshot_chunk_bytes,
            )
            if data is None:
                continue  # transfer abandoned/superseded: try next offer
            parsed = parse_snapshot_blob(data)
            if parsed is None:
                self._poisoned(peer, "snapshot blob failed integrity checks")
                continue
            manifest, state = parsed
            err = verify_snapshot(manifest, state, quorum, members)
            if err is not None:
                self._poisoned(peer, f"snapshot: {err}")
                continue
            self._install_snapshot(manifest, state)
            return True
        return False

    def _install_snapshot(self, manifest, state: bytes) -> None:
        """Adopt a VERIFIED foreign snapshot as our new base: persist it
        first (crash between persist and ledger reset = recovery seeds
        from the saved snapshot), then swap the in-memory state and
        compact the ledger file down to just the base reference."""
        import time as _time

        t0 = _time.monotonic()
        app = decode(AppState, state)
        anchor = Decision(proposal=manifest.anchor_proposal,
                          signatures=tuple(manifest.anchor_signatures))
        path = self.snapshot_store.save(manifest, state)
        anchor_wire = encode(WireDecision(
            proposal=manifest.anchor_proposal,
            signatures=list(manifest.anchor_signatures),
        ))
        from collections import deque

        with self.lock:
            self.ledger = []
            self._base_height = manifest.height
            self._base_chain = manifest.chain_digest
            self._chain = manifest.chain_digest
            self._request_count = app.request_count
            self._ids_digest = app.ids_digest
            self._recent_ids = deque(app.recent_ids, maxlen=RECENT_IDS_CAP)
            self._kv = dict(zip(app.kv_keys, app.kv_values))
            self._anchor_decision = anchor
            self.ledger_file.compact(manifest.height, manifest.chain_digest,
                                     [], app_state=state, anchor=anchor_wire)
        if self._wal is not None and hasattr(self._wal,
                                             "drop_stale_segments"):
            self._wal.drop_stale_segments()
        self._snap_offer = (manifest.height, os.path.getsize(path),
                            manifest.state_digest)
        self._snap_path = path
        self._last_snapshot_height = manifest.height
        # purge the pool of anything the snapshot already covers — the
        # recent-id window is bounded, so at worst a long-pooled request
        # older than the window waits out its auto-remove timeout
        if self.consensus is not None and self.consensus.pool is not None:
            from ..core.pool import remove_delivered_requests

            infos = []
            for rid in app.recent_ids:
                client, _, req_id = rid.partition(":")
                infos.append(RequestInfo(client_id=client, request_id=req_id))
            remove_delivered_requests(self.consensus.pool, infos, self.logger)
        if self.recorder.enabled:
            self.recorder.record("snapshot.install", seq=manifest.height,
                                 dur=_time.monotonic() - t0,
                                 extra={"bytes": len(state)})
        self.logger.infof(
            "installed snapshot at height %d (%d state bytes): "
            "rejoin skipped the compacted prefix",
            manifest.height, len(state),
        )

    def _drop_synced_from_pool(self, proposal: Proposal) -> None:
        """Remove a wire-synced decision's requests from the local pool.

        Wire sync delivers around consensus (the decisions never pass
        through Controller._decide), so without this a request that sat in
        OUR pool while the cluster committed it stays pooled forever: the
        pool keeps forwarding it, the leader keeps rejecting it as already
        processed, the forward-timeout keeps complaining — observed as the
        restarted kill-rejoin replica complaining about a healthy leader
        until request_auto_remove_timeout (60 s) finally fired."""
        if self.consensus is None or self.consensus.pool is None:
            return
        from ..core.pool import remove_delivered_requests

        try:
            infos = self.requests_from_proposal(proposal)
        except Exception:  # noqa: BLE001 — foreign payload: nothing pooled
            return
        remove_delivered_requests(self.consensus.pool, infos, self.logger)

    # ------------------------------------------------------ read plane --------

    def _serve_read(self, req: ReadRequest) -> ReadResponse:
        """Serve one keyed read from COMMITTED state — no pool, no
        proposer, no verify launch (the Castro–Liskov read-only path).
        The read gate sheds BEFORE any state is touched, with the
        FT_REJECT contract inline (kind + drain-rate retry-after +
        occupancy): a read storm degrades reads, never writes."""
        if not self._read_gate.allow():
            self.read_stats.sheds += 1
            spent, burst = self._read_gate.occupancy()
            return ReadResponse(
                nonce=req.nonce, key=req.key, shed=True,
                shed_kind="read_gate",
                retry_after_ms=int(self._read_gate.retry_after() * 1000),
                occupancy=spent, high_water=burst,
            )
        if req.at_base:
            return self._read_at_base(req)
        with self.lock:
            height = self._base_height + len(self.ledger)
            digest = self._chain
            value = self._kv.get(req.key)
            anchor = self._last_snapshot_height
        found = value is not None
        self.read_stats.note_served(at_base=False, found=found)
        return ReadResponse(
            nonce=req.nonce, key=req.key, found=found,
            value=value if found else b"", height=height,
            state_digest=digest, anchor_height=anchor, at_base=False,
        )

    def _read_at_base(self, req: ReadRequest) -> ReadResponse:
        """Snapshot-anchored read: serve from the latest PERSISTED base,
        stamped with the snapshot's height, its chained ledger digest,
        and its own height as the anchor certificate.  ``load`` re-runs
        the store's full integrity verification on every read — a torn
        or tampered base is refused LOUDLY (counted, per the
        sync-poisoning precedent), never silently served."""
        height = self._last_snapshot_height
        snap = self.snapshot_store.load(height) if height > 0 else None
        app = None
        if snap is not None:
            try:
                app = decode(AppState, snap.state)
            except Exception:  # noqa: BLE001 — foreign state blob
                app = None
        if app is None:
            self.read_stats.base_refused += 1
            self.transport.metrics.read_base_refused += 1
            self.logger.warnf(
                "READ-AT-BASE REFUSED: no verifiable snapshot at height %d "
                "(%d refusals so far)", height, self.read_stats.base_refused)
            return ReadResponse(nonce=req.nonce, key=req.key, shed=True,
                                shed_kind="base_refused")
        kv = dict(zip(app.kv_keys, app.kv_values))
        value = kv.get(req.key)
        found = value is not None
        with self.lock:
            live = self._base_height + len(self.ledger)
        self.read_stats.note_served(
            at_base=True, found=found,
            lag=max(0, live - snap.manifest.height),
        )
        return ReadResponse(
            nonce=req.nonce, key=req.key, found=found,
            value=value if found else b"",
            height=snap.manifest.height,
            state_digest=snap.manifest.chain_digest,
            anchor_height=snap.manifest.height, at_base=True,
        )

    def _read_committed_hook(self, key: str):
        """The Consensus facade's ``read_hook``: the committed-state
        answer as ``(value, height, state_digest, anchor_height)``, or
        None when the key was never written."""
        with self.lock:
            value = self._kv.get(key)
            if value is None:
                return None
            height = self._base_height + len(self.ledger)
            return value, height, self._chain, self._last_snapshot_height

    def add_watch(self, prefix: str) -> Optional[int]:
        """Register a committed-stream subscription on a key prefix;
        None once the per-replica watch cap is reached (the registry is
        bounded like every other per-peer resource)."""
        from collections import deque

        if len(self._watches) >= self.config.read_max_watches:
            return None
        self._watch_seq += 1
        wid = self._watch_seq
        self._watches[wid] = {"prefix": prefix, "events": deque(),
                              "dropped": 0}
        return wid

    def _publish_watches(self, height: int, updates) -> None:
        """Fan one decision's KV delta to matching watches, bounded per
        subscriber: a slow poller drops its OLDEST events and is told
        how many (the transport outbox's drop-oldest-with-counts
        discipline) — backpressure never reaches the commit path."""
        cap = self.config.read_watch_buffer
        for w in self._watches.values():
            prefix = w["prefix"]
            events = w["events"]
            for client, rid, _payload in updates:
                if not client.startswith(prefix):
                    continue
                if len(events) >= cap:
                    events.popleft()
                    w["dropped"] += 1
                    self.read_stats.watch_dropped += 1
                events.append({"key": client, "rid": rid, "height": height})
                self.read_stats.watch_notifications += 1

    def poll_watch(self, wid: int):
        """Drain a watch's buffered events: ``(events, dropped)`` since
        the previous poll, or None for an unknown watch id."""
        w = self._watches.get(wid)
        if w is None:
            return None
        events = list(w["events"])
        w["events"].clear()
        dropped = w["dropped"]
        w["dropped"] = 0
        return events, dropped

    def remove_watch(self, wid: int) -> bool:
        return self._watches.pop(wid, None) is not None

    # ------------------------------------------------------------ lifecycle

    def _recover_local_state(self) -> None:
        """Rebuild chain/app state from disk: ledger suffix + the best
        seeding source (newest verified snapshot if its height lands
        inside [base, base+len(suffix)], else the base ref's embedded
        app state).  Every crash point of the capture/install flows
        resolves here:

        * killed before the snapshot rename — old snapshot + old ledger,
          nothing unusual;
        * killed between snapshot rename and ledger compaction — the
          snapshot exists at H with the FULL ledger still on disk: seed
          app state from the snapshot, fold only ``suffix[H-base:]``
          into it, fold the chain over the whole suffix — bit-identical
          to a replica that replayed everything;
        * killed mid-compaction — ``os.replace`` leaves old or new file;
        * snapshot directory lost/corrupted after compaction — the base
          ref's embedded app_state/anchor seed recovery instead."""
        self.ledger = self.ledger_file.read_all()
        self.ledger_file.open_append()
        base = self.ledger_file.base_height
        self._base_height = base
        self._base_chain = self.ledger_file.base_digest
        suffix = self.ledger
        snap = self.snapshot_store.latest()
        seed_height: Optional[int] = None
        app = AppState()
        if snap is not None and \
                base <= snap.manifest.height <= base + len(suffix):
            try:
                app = decode(AppState, snap.state)
                seed_height = snap.manifest.height
            except Exception:  # noqa: BLE001 — foreign state blob
                self.logger.warnf("snapshot state undecodable; ignoring")
        if seed_height is not None:
            m = snap.manifest
            self._anchor_decision = Decision(
                proposal=m.anchor_proposal,
                signatures=tuple(m.anchor_signatures),
            )
            self._last_snapshot_height = m.height
            self._snap_offer = (m.height, os.path.getsize(snap.path),
                                m.state_digest)
            self._snap_path = snap.path
        elif base > 0:
            # no usable snapshot but the ledger IS compacted: fall back
            # to the base ref's embedded seeding material
            try:
                if self.ledger_file.base_state:
                    app = decode(AppState, self.ledger_file.base_state)
                seed_height = base
                if self.ledger_file.base_anchor:
                    wd = decode(WireDecision, self.ledger_file.base_anchor)
                    self._anchor_decision = Decision(
                        proposal=wd.proposal,
                        signatures=tuple(wd.signatures),
                    )
                self._last_snapshot_height = base
            except Exception:  # noqa: BLE001 — torn base material
                self.logger.warnf(
                    "compacted ledger with no seeding material: app "
                    "counters restart at zero (consensus state is safe)"
                )
                seed_height = base
        from collections import deque

        self._request_count = app.request_count
        self._ids_digest = app.ids_digest or CHAIN_SEED
        self._recent_ids = deque(app.recent_ids or [],
                                 maxlen=RECENT_IDS_CAP)
        self._kv = dict(zip(app.kv_keys or [], app.kv_values or []))
        fold_from = (seed_height - base) if seed_height is not None else 0
        for d in suffix[fold_from:]:
            try:
                ids = [str(i)
                       for i in self.requests_from_proposal(d.proposal)]
            except Exception:  # noqa: BLE001 — foreign payload
                ids = []
            self._ids_digest = fold_ids(self._ids_digest, ids)
            self._recent_ids.extend(ids)
            self._request_count += len(ids)
            for client, _rid, payload in self._kv_updates(d.proposal):
                self._kv[client] = payload
        chain = self._base_chain
        for d in suffix:
            chain = chain_update(chain, d.proposal.payload,
                                 d.proposal.metadata)
        self._chain = chain

    def disk_snapshot(self) -> dict:
        """The disk-bound observables (control cmd=snapshot + the SLO
        signal source): on-disk byte totals and snapshot staleness."""
        with self.lock:
            height = self._base_height + len(self.ledger)
            base = self._base_height
        wal_bytes = 0
        if self._wal is not None and hasattr(self._wal, "disk_bytes"):
            wal_bytes = self._wal.disk_bytes()
        return {
            "height": height,
            "base_height": base,
            "snapshot_height": self._last_snapshot_height,
            "snapshot_age_decisions": height - self._last_snapshot_height,
            "snapshot_interval": self.config.snapshot_interval_decisions,
            "snapshot_disk_bytes": self.snapshot_store.disk_bytes(),
            "snapshot_rejected_files": self.snapshot_store.rejected_files,
            "ledger_disk_bytes": self.ledger_file.disk_bytes(),
            "wal_disk_bytes": wal_bytes,
            "sync_poisoned": dict(self.sync_poisoned),
        }

    def _refresh_disk_gauges(self) -> None:
        disk = self.disk_snapshot()
        self.snapshot_age_gauge.set(disk["snapshot_age_decisions"])
        self.snapshot_disk_gauge.set(disk["snapshot_disk_bytes"])
        self.ledger_disk_gauge.set(disk["ledger_disk_bytes"])
        self.wal_disk_gauge.set(disk["wal_disk_bytes"])

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        kw = {}
        if self.spec.get("wal_file_size_bytes"):
            kw["file_size_bytes"] = int(self.spec["wal_file_size_bytes"])
        self._wal, entries = walmod.initialize_and_read_all(
            self.spec["wal_dir"], self.logger, **kw
        )
        self._recover_local_state()
        with self.lock:
            suffix = list(self.ledger)
            anchor = self._anchor_decision
        if suffix:
            last = suffix[-1]
            md = decode(ViewMetadata, last.proposal.metadata)
            last_proposal, last_sigs = last.proposal, list(last.signatures)
        elif anchor is not None:
            # compacted-to-empty ledger: consensus re-anchors at the
            # snapshot's certificate, exactly as if it had replayed to it
            md = decode(ViewMetadata, anchor.proposal.metadata)
            last_proposal = anchor.proposal
            last_sigs = list(anchor.signatures)
        else:
            md, last_proposal, last_sigs = ViewMetadata(), Proposal(), []
        self.consensus = Consensus(
            config=self.config,
            application=self,
            assembler=self,
            wal=self._wal,
            wal_initial_content=entries,
            comm=self,
            signer=self,
            verifier=self,
            membership_notifier=self,
            request_inspector=self,
            synchronizer=self,
            logger=self.logger,
            metadata=md,
            last_proposal=last_proposal,
            last_signatures=last_sigs,
            scheduler=None,  # own wall-clock driver: this is production mode
            metrics=self.metrics,
            viewchanger_tick_interval=0.1,
            heartbeat_tick_interval=0.1,
            recorder=self.recorder,
        )
        # the read plane's committed-state hook: embedder-owned state,
        # exposed through the facade so in-process callers read the same
        # (value, height, digest, anchor) stamps the wire plane serves
        self.consensus.read_hook = self._read_committed_hook
        self.transport.attach(self.consensus)
        await self.transport.start()
        await self.consensus.start()
        # health sources wire AFTER start: the pool and WAL exist now
        self.health.watch_consensus(self.consensus)
        from ..obs.health import (
            read_signal_source,
            snapshot_signal_source,
            wal_signal_source,
        )

        self.health.add_source(wal_signal_source(self._wal))
        self.health.add_source(snapshot_signal_source(self.disk_snapshot))
        self.health.add_source(read_signal_source(self.read_stats.snapshot))
        from ..utils.tasks import create_logged_task

        self._health_task = create_logged_task(
            self._health_loop(), name=f"health-{self.id}",
            logger=self.logger,
        )

    async def _health_loop(self) -> None:
        """Periodic SLO tick — the burn windows need a steady sample
        cadence, not just whenever an operator polls cmd=health."""
        while True:
            try:
                self._refresh_disk_gauges()
                self.health.tick()
            except Exception as e:  # noqa: BLE001 — judged, never judging
                self.logger.warnf("health tick failed: %r", e)
            await asyncio.sleep(self.health_interval)

    async def stop(self) -> None:
        if self._health_task is not None:
            self._health_task.cancel()
            import contextlib

            with contextlib.suppress(asyncio.CancelledError):
                await self._health_task
            self._health_task = None
        if self.consensus is not None:
            await self.consensus.stop()
        await self.transport.close()
        if self._wal is not None and hasattr(self._wal, "close"):
            self._wal.close()
        self.ledger_file.close()

    # ------------------------------------------------------------ control queries

    def height(self) -> int:
        with self.lock:
            return self._base_height + len(self.ledger)

    def committed_requests(self) -> int:
        """Delivered-request count over the WHOLE history — O(1) now:
        maintained incrementally (and carried across compaction inside
        the snapshot's AppState) instead of re-decoding the ledger."""
        with self.lock:
            return self._request_count

    def committed_ids(self) -> list[str]:
        """Every committed request as "client:rid", in ledger order — the
        chaos runner's exactly-once oracle and the client-resubmission
        check (a request in NO live ledger after quiescence died with a
        killed replica's pool and must be resubmitted, like any BFT
        client would).  Covers the SUFFIX after the compaction horizon:
        with snapshots enabled the full-history oracle is ids_digest
        (chained, O(1) per replica) — the harness picks per scenario.

        Memoized with the ``barrier_seq`` discipline: the harness polls this every settle tick, so each poll
        decodes only the NEW suffix entries; a base move (compaction /
        snapshot install) rebuilds from the new suffix."""
        with self.lock:
            base = self._base_height
            ledger = list(self.ledger)
        if base != self._ids_cache_base:
            self._ids_cache = []
            self._ids_scan = 0
            self._ids_cache_base = base
        for idx in range(self._ids_scan, len(ledger)):
            infos = self.requests_from_proposal(ledger[idx].proposal)
            self._ids_cache.extend(str(i) for i in infos)
            self._ids_scan = idx + 1
        return list(self._ids_cache)

    def ids_digest(self) -> str:
        """Chained digest over every delivered request id — the
        exactly-once oracle that survives compaction (equal digests =
        identical delivered sequences, without any replica holding the
        full id list)."""
        with self.lock:
            return self._ids_digest.hex()

    def ledger_digest(self, upto: int) -> str:
        """Fork detector, chained semantics: the running chain digest at
        absolute height ``upto`` (0 = current height).  For heights at or
        behind the compaction horizon the BASE digest answers — the
        caller (check_fork_free) reads ``base`` off the same control
        response and compares only heights both replicas can still
        compute.

        Mid-height answers memoize the running prefix digests:
        ``_chain_prefix[k]`` is the digest after ``k``
        suffix decisions, extended lazily to the requested height, so
        the fork checker's repeated common-height probes cost O(new
        entries) instead of re-hashing the prefix every call."""
        with self.lock:
            base = self._base_height
            if upto == 0 or upto >= base + len(self.ledger):
                return self._chain.hex()
            if upto <= base:
                return self._base_chain.hex()
            base_chain = self._base_chain
            ledger = list(self.ledger)
        if base != self._chain_prefix_base:
            self._chain_prefix = [base_chain]
            self._chain_prefix_base = base
        k = upto - base
        while len(self._chain_prefix) <= k:
            d = ledger[len(self._chain_prefix) - 1]
            self._chain_prefix.append(chain_update(
                self._chain_prefix[-1], d.proposal.payload,
                d.proposal.metadata))
        return self._chain_prefix[k].hex()

    def barrier_seq(self, epoch: int) -> int:
        """Ledger position (1-based) of epoch ``epoch``'s committed
        reshard barrier command, 0 while it has not committed here.  The
        cluster manager polls this on every replica after a control-plane
        ``reshard`` trigger: once non-zero everywhere, the resize decision
        is ordered — it rode the stream, not a side channel.  Memoized
        (the position never changes once committed) and incrementally
        scanned, so the manager's poll loop costs O(new entries) per call
        instead of re-decoding the whole ledger on every tick."""
        from ..shard.epoch import barrier_marker

        found = self._barrier_seqs.get(epoch)
        if found:
            return found
        marker = barrier_marker(epoch)
        with self.lock:
            base = self._base_height
            ledger = list(self.ledger)
        start = max(0, self._barrier_scan.get(epoch, 0) - base)
        for idx in range(start, len(ledger)):
            infos = self.requests_from_proposal(ledger[idx].proposal)
            if any(str(i) == marker for i in infos):
                self._barrier_seqs[epoch] = base + idx + 1
                return base + idx + 1
        self._barrier_scan[epoch] = base + len(ledger)
        return 0


def _config_from_spec(spec: dict) -> Configuration:
    import dataclasses

    cfg = proc_config(int(spec["node_id"]))
    overrides = spec.get("config") or {}
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


# --------------------------------------------------------------------------
# control channel (line JSON; parent-facing, never part of consensus)
# --------------------------------------------------------------------------


def _reply_dict(reply: ReadResponse) -> dict:
    """A read reply's JSON shape on the control channel — the full stamp
    always, the shed contract only when the gate fired."""
    d = {
        "found": reply.found,
        "value": reply.value.hex(),
        "height": reply.height,
        "state_digest": reply.state_digest.hex(),
        "anchor_height": reply.anchor_height,
        "at_base": reply.at_base,
    }
    if reply.shed:
        d.update(shed=True, shed_kind=reply.shed_kind,
                 retry_after_ms=reply.retry_after_ms,
                 occupancy=reply.occupancy, high_water=reply.high_water)
    return d


class ControlServer:
    def __init__(self, replica: ReplicaApp, addr: str, stop_evt: asyncio.Event):
        self.replica = replica
        self.addr = addr
        self.stop_evt = stop_evt
        self._server: Optional[asyncio.AbstractServer] = None
        #: the connections ``_serve`` holds open; close() shuts them before
        #: it awaits the server, whose wait_closed() waits for them
        self._writers: set[asyncio.StreamWriter] = set()

    async def start(self) -> None:
        scheme, hostpath, port = parse_addr(self.addr)
        if scheme == "tcp":
            self._server = await asyncio.start_server(
                self._serve, host=hostpath, port=port
            )
        else:
            self._server = await asyncio.start_unix_server(
                self._serve, path=hostpath
            )

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            for writer in list(self._writers):
                writer.close()
            await self._server.wait_closed()
            self._server = None
            scheme, hostpath, _ = parse_addr(self.addr)
            if scheme == "uds":
                import contextlib

                with contextlib.suppress(OSError):
                    os.unlink(hostpath)

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)
        try:
            while True:
                line = await reader.readline()
                if not line:
                    return
                try:
                    req = json.loads(line)
                    resp = await self._handle(req)
                except Exception as e:  # noqa: BLE001 — control must answer
                    resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                writer.write((json.dumps(resp) + "\n").encode())
                await writer.drain()
        except (ConnectionError, OSError):
            pass
        finally:
            self._writers.discard(writer)
            writer.close()

    async def _handle(self, req: dict) -> dict:
        r = self.replica
        cmd = req.get("cmd")
        if cmd == "ping":
            import time

            running = r.consensus is not None and r.consensus._running
            # "now" is this process's monotonic clock — the parent's
            # request/response midpoint against it estimates the clock
            # offset that aligns per-replica trace timestamps onto ONE
            # cluster timeline (SocketCluster.estimate_clock_offsets)
            return {"ok": True, "running": running, "node_id": r.id,
                    "now": time.monotonic()}
        if cmd == "leader":
            lead = r.consensus.get_leader_id() if r.consensus else 0
            return {"ok": True, "leader": lead}
        if cmd == "submit":
            from ..core.pool import AdmissionRejected, SubmitTimeoutError
            from ..testing.app import TestRequest

            raw = encode(TestRequest(
                client_id=req["client"],
                request_id=req["rid"],
                payload=bytes.fromhex(req.get("payload", "")),
            ))
            try:
                await r.consensus.submit_request(raw)
            except AdmissionRejected as e:
                # the admission contract, now visible to SOCKET
                # clients: structured reject + drain-rate retry-after
                # hint instead of an opaque error string
                return {
                    "ok": False,
                    "rejected": "admission",
                    "retry_after_ms": int((e.retry_after or 0.0) * 1000),
                    "occupancy": e.occupancy,
                    "error": f"AdmissionRejected: {e}",
                }
            except SubmitTimeoutError as e:
                return {
                    "ok": False,
                    "rejected": "timeout",
                    "retry_after_ms": 0,
                    "occupancy": r.consensus.pool_occupancy(),
                    "error": f"SubmitTimeoutError: {e}",
                }
            # Read-your-write session token: the ack
            # carries a height the client can hand to cmd=read
            # mode=follower as min_height.  The pooled height is only a
            # lower bound (the request is admitted, not yet ordered);
            # wait_committed_s > 0 parks until THIS request is committed
            # locally and returns the height that provably covers it.
            wait_s = float(req.get("wait_committed_s", 0.0))
            committed = False
            if wait_s > 0:
                rid = f"{req['client']}:{req['rid']}"
                deadline = asyncio.get_event_loop().time() + wait_s
                while asyncio.get_event_loop().time() < deadline:
                    if rid in r.committed_ids():
                        committed = True
                        break
                    await asyncio.sleep(0.01)
            return {"ok": True, "height": r.height(), "committed": committed}
        if cmd == "height":
            pool = r.consensus.pool_occupancy() if r.consensus else {}
            return {"ok": True, "height": r.height(),
                    "pool": pool.get("size", 0)}
        if cmd == "occupancy":
            # the autoscaler's saturation signal, per replica — a manager
            # of S socket groups sums these into the ShardSet.occupancy
            # shape and feeds shard.autoscale.OccupancyAutoscaler
            occ = r.consensus.pool_occupancy() if r.consensus else {}
            return {"ok": True, "occupancy": occ}
        if cmd == "reshard":
            # control-plane reshard trigger: order epoch `epoch`'s barrier
            # command through THIS replica's consensus stream (Vertical
            # Paxos rule — the resize decision must ride the ordered
            # stream).  Idempotent: the pool's client dedup absorbs
            # re-triggers after a manager crash.  Construction shared with
            # the in-process harness (testing.app.submit_barrier_request)
            # so the barrier marker can never drift between the two.
            from ..testing.app import submit_barrier_request

            epoch = int(req["epoch"])
            await submit_barrier_request(
                r.consensus, epoch, int(req.get("old", 1)), int(req["new"])
            )
            return {"ok": True, "epoch": epoch,
                    "barrier_seq": r.barrier_seq(epoch)}
        if cmd == "barrier":
            epoch = int(req["epoch"])
            return {"ok": True, "epoch": epoch,
                    "barrier_seq": r.barrier_seq(epoch)}
        if cmd == "committed":
            return {"ok": True, "committed": r.committed_requests(),
                    "height": r.height()}
        if cmd == "committed_ids":
            return {"ok": True, "ids": r.committed_ids()}
        if cmd == "ledger_digest":
            upto = int(req.get("upto", 0))
            with r.lock:
                base = r._base_height
            return {"ok": True, "digest": r.ledger_digest(upto),
                    "height": r.height(), "base": base,
                    "ids_digest": r.ids_digest()}
        if cmd == "snapshot":
            # disk-bound observables + snapshot staleness —
            # what the kill-rejoin scenarios and the truncating soak's
            # bounded-disk oracle read off every replica
            return {"ok": True, "node": f"n{r.id}", **r.disk_snapshot()}
        if cmd == "stats":
            frontier = (r.consensus.delivery_frontier()
                        if r.consensus is not None else {})
            return {"ok": True, "transport": r.transport.transport_snapshot(),
                    "height": r.height(),
                    "committed": r.committed_requests(),
                    "disk": r.disk_snapshot(),
                    "read": r.read_stats.snapshot(),
                    "frontier": frontier}
        if cmd == "read":
            return await self._read(req)
        if cmd == "watch":
            # committed-stream subscription on a key prefix: bounded
            # buffer per watch, drained by cmd=watch_poll
            wid = r.add_watch(str(req.get("prefix", "")))
            if wid is None:
                return {"ok": False, "error": "watch cap reached",
                        "max_watches": r.config.read_max_watches}
            return {"ok": True, "watch_id": wid}
        if cmd == "watch_poll":
            polled = r.poll_watch(int(req["watch_id"]))
            if polled is None:
                return {"ok": False, "error": "unknown watch"}
            events, dropped = polled
            return {"ok": True, "events": events, "dropped": dropped}
        if cmd == "unwatch":
            return {"ok": r.remove_watch(int(req["watch_id"]))}
        if cmd == "health":
            # live SLO verdict: tick once on demand so the
            # answer reflects NOW even between periodic samples, then
            # serve the verdict + recent transitions
            r.health.tick()
            return {
                "ok": True,
                "node": f"n{r.id}",
                "health": r.health.verdict(),
                "transitions": r.health.transition_log()[-16:],
            }
        if cmd == "metrics":
            # Prometheus text exposition over the control channel: the
            # per-replica counters finally have a reader in multi-process
            # deployments (mount behind an HTTP handler in production)
            return {"ok": True, "text": r.metrics_provider.expose()}
        if cmd == "trace":
            # per-replica flight-recorder pull: summary block + events.
            # "since" (an event-sequence cursor from a previous pull's
            # "next_since") ships only NEW events — repeated pulls are
            # O(new), never a re-send of the whole ring; "last" keeps the
            # newest-N semantics.  since wins when both are present.
            last = req.get("last")
            since = req.get("since")
            if since is not None:
                events, cursor = r.recorder.snapshot_since(int(since))
            else:
                # the full/newest-N pull rides the same exact-seqno path
                # (events_since) so next_since can never cover an event
                # the snapshot raced past (recorders are fed from
                # executor threads too — the torn-pair hazard)
                evs, cursor = r.recorder.events_since(0)
                if last is not None:
                    evs = evs[-int(last):] if int(last) else []
                events = [e.as_dict() for e in evs]
            return {
                "ok": True,
                "node": f"n{r.id}",
                "trace": r.recorder.trace_block(),
                "dropped": r.recorder.dropped,
                "events": events,
                "next_since": cursor,
            }
        if cmd == "fault":
            return self._fault(req)
        if cmd == "stop":
            self.stop_evt.set()
            return {"ok": True}
        return {"ok": False, "error": f"unknown cmd {cmd!r}"}

    async def _read(self, req: dict) -> dict:
        """cmd=read — the serving plane's client edge, three modes:

        * ``local``: this replica's committed state as-is (optionally
          ``at_base``: anchored to the latest persisted snapshot);
        * ``follower``: local serve plus the client-side staleness
          judgement — ``accepted`` is the :func:`follower_read_accept`
          verdict against ``frontier`` (default: this replica's own
          height) and ``max_lag`` decisions;
        * ``quorum``: fan the read to every peer and apply the ``f+1``
          match rule — the reply is committed-proof without touching
          consensus."""
        r = self.replica
        key = str(req.get("key", ""))
        mode = req.get("mode", "local")
        max_lag = int(req.get("max_lag", 0))
        if mode == "quorum":
            return await self._quorum_read(key, max_lag)
        at_base = bool(req.get("at_base", False))
        min_height = int(req.get("min_height", 0))
        if mode == "follower" and min_height > 0:
            # Read-your-write session frontier: the
            # client hands back the height token its write ack carried.
            # A replica still behind it PARKS briefly (park_s, bounded)
            # for the commit to arrive; if it is still behind on wake it
            # answers a structured "stale" with a commit-gap-derived
            # retry-after hint — never a silently stale value.
            park_s = min(float(req.get("park_s", 0.25)), 5.0)
            deadline = asyncio.get_event_loop().time() + park_s
            while (r.height() + max_lag < min_height
                   and asyncio.get_event_loop().time() < deadline):
                await asyncio.sleep(0.01)
            height = r.height()
            if height + max_lag < min_height:
                frontier = (r.consensus.delivery_frontier()
                            if r.consensus is not None else {})
                return {
                    "ok": True, "accepted": False, "stale": True,
                    "height": height, "min_height": min_height,
                    "max_lag": max_lag,
                    "retry_after_ms": session_retry_after_ms(
                        height, min_height, frontier.get("commit_gap_s")
                    ),
                }
        reply = r._serve_read(ReadRequest(nonce=0, key=key, at_base=at_base))
        out = _reply_dict(reply)
        out["ok"] = True
        if mode == "follower":
            frontier = int(req.get("frontier", min_height or r.height()))
            out["accepted"] = follower_read_accept(reply, frontier, max_lag)
            out["frontier"] = frontier
            out["max_lag"] = max_lag
        return out

    async def _quorum_read(self, key: str, max_lag: int) -> dict:
        """Fan a keyed read to every peer (plus our own answer) and
        accept on ``f+1`` bit-identical stamps.  Contradicting donors
        are attributed to the MisbehaviorTable as OBSERVED-only
        ``stale_read`` evidence — read replies are unsigned, so they
        count for the operator but never feed the shun score."""
        r = self.replica
        members = [r.id, *r.peers]
        _quorum, f = compute_quorum(len(members))
        need = f + 1
        local = r._serve_read(ReadRequest(nonce=0, key=key, at_base=False))
        peer_ids = list(r.peers)
        results = await asyncio.gather(*[
            r.transport.request_read(p, key, timeout=1.0)
            for p in peer_ids
        ])
        replies = [(r.id, local), *zip(peer_ids, results)]
        decision = quorum_read_decide(replies, need,
                                      max_lag_decisions=max_lag)
        if r.consensus is not None:
            for sender, _reason in decision.outliers:
                r.consensus.misbehavior.note(sender, "stale_read")
        out = {"ok": True, "need": need, "matches": decision.matches,
               "outliers": [[s, why] for s, why in decision.outliers],
               "quorum": decision.winner is not None}
        if decision.winner is not None:
            out.update(_reply_dict(decision.winner))
        return out

    def _fault(self, req: dict) -> dict:
        """Socket-level chaos: the same fault vocabulary the in-process
        network exposes, applied at the transport."""
        t = self.replica.transport
        action = req.get("action")
        peer = int(req.get("peer", 0))
        peers = [peer] if peer else list(t._peers)
        if action == "mute":
            t.mute()
        elif action == "unmute":
            t.unmute()
        elif action == "drop_link":
            for p in peers:
                t.drop_link(p)
        elif action == "restore_link":
            for p in peers:
                t.restore_link(p)
        elif action == "heal_links":
            for p in list(t._dropped_links):
                t.restore_link(p)
            for p in list(t._slow_links):
                t.slow_link(p, 0.0)
            t.unmute()
        elif action == "slow_link":
            delay = float(req.get("delay", 0.0))
            for p in peers:
                t.slow_link(p, delay)
        else:
            return {"ok": False, "error": f"unknown fault {action!r}"}
        return {"ok": True}


async def run_replica(spec: dict) -> None:
    replica = ReplicaApp(spec)
    stop_evt = asyncio.Event()
    control = ControlServer(replica, spec["control"], stop_evt)
    await control.start()  # control first: the parent polls it for readiness
    await replica.start()
    try:
        await stop_evt.wait()
    finally:
        await replica.stop()
        await control.close()


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="SmartBFT socket replica process")
    ap.add_argument("--spec-file", required=True,
                    help="path to the JSON ReplicaSpec")
    args = ap.parse_args(argv)
    with open(args.spec_file) as fh:
        spec = json.load(fh)
    asyncio.run(run_replica(spec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
