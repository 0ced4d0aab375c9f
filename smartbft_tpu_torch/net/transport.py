"""SocketComm: the asyncio TCP/UDS implementation of the Comm SPI.

The in-process ``testing.network.Network`` and this transport sit behind
the SAME seam (``api.Comm`` + the optional ``broadcast_consensus``
vectorization hook), so every protocol component is transport-blind.
The message plane carries canonical wire BYTES with encode-once
broadcast — the serialization work a real network needs was already
paid; this module adds the sockets:

* **Encode-once broadcast** — ``broadcast_consensus`` computes the
  canonical encoding once (``messages.wire_of``, memoized on the frozen
  instance), frames it once, and enqueues the SAME bytes object on every
  peer's outbox;
* **Per-wave write coalescing** — each peer has one sender task that
  drains the WHOLE outbox per wakeup and writes it as one
  ``writev``-style batch (one ``write`` + one ``drain`` per wave),
  mirroring the wave-batched ingest on the send side.  A depth-k
  window's k pre-prepares leave in one flush instead of k;
* **Wave-batched ingest** — one ``reader.read()`` returns whatever the
  peer's last flush carried; every complete frame in it is decoded
  (``messages.unmarshal_interned``) and handed to
  ``Consensus.handle_message_batch`` in ONE call, so a quorum wave
  registers in one scheduler tick — identical to the in-process plane;
* **Reconnect with exponential backoff + jitter** — the same retry
  idiom as the verify plane: base doubles to a cap, each sleep is
  multiplied by ``1 ± jitter`` so n replicas redialing a restarted peer
  do not thundering-herd it;
* **Loud-but-bounded peer death** — outboxes are capped deques: when a
  peer is down past its cap the OLDEST frame is dropped and counted
  (protocol recovery — re-sends, view changes, sync — is built for loss;
  unbounded queues are how one dead peer OOMs a live replica);
* **Malformed frames drop the connection, loudly** — a bad length
  prefix, unknown frame type, or undecodable consensus payload counts
  in metrics and closes THAT connection; the replica and the intern LRU
  (which only caches successful decodes) are untouched;
* **Wire tracing sidecar** — while this node's flight
  recorder is armed, each coalesced flush appends at most ONE untagged
  ``FT_TRACE`` frame batching the flush's correlation contexts (request
  key / (view, seq), origin, hop counter) plus the sender's monotonic
  flush stamp; the receive side records one ``net.recv`` event per
  context and remembers request hop chains so re-forwards continue
  them.  Data-frame counts and the canonical consensus encoding are
  untouched; sidecar loss costs timeline coverage, never correctness.

Connections are DIRECTED: each node dials every peer and uses that
connection only for its own sends; inbound connections only receive.
Two simplex links per pair cost one extra fd but remove all tie-break
complexity (simultaneous dial, connection reuse races), and a link
fault maps 1:1 onto a socket: dropping my outbound link to you is
exactly "my sends stop reaching you".
"""

from __future__ import annotations

import asyncio
import contextlib
import random
import time
from collections import OrderedDict, deque
from time import perf_counter
from typing import Callable, Optional

from ..api import Comm
from ..codec import CodecError, decode, encode
from ..messages import Message, unmarshal_interned, wire_of
from ..metrics import PROTOCOL_PLANE, install_plane, reset_plane
from ..utils.logging import StdLogger
from ..utils.tasks import create_logged_task
from .framing import (
    DEFAULT_MAX_FRAME_BYTES,
    FT_CONSENSUS,
    FT_HELLO,
    FT_READ_REQ,
    FT_READ_RESP,
    FT_REJECT,
    FT_REQUEST,
    FT_SNAP_REQ,
    FT_SNAP_RESP,
    FT_SYNC_REQ,
    FT_SYNC_RESP,
    FT_TRACE,
    FrameDecoder,
    FrameError,
    Hello,
    ReadRequest,
    ReadResponse,
    RejectFrame,
    SnapshotChunk,
    SnapshotFetchRequest,
    SyncBatch,
    SyncRequest,
    TraceCtx,
    TraceFrame,
    encode_frame,
    parse_addr,
    reject_digest,
)

#: read-buffer size per reader.read() call; one sender flush usually fits
READ_CHUNK = 256 * 1024

#: per-connection-attempt timeout (a dead TCP peer can otherwise park the
#: dial in SYN-retry for minutes; UDS fails instantly either way)
CONNECT_TIMEOUT = 3.0

#: a connection whose first frame is not a valid HELLO within this window
#: is rejected (handshake_rejected) — garbage dialers cannot hold fds open
HANDSHAKE_TIMEOUT = 5.0

#: SyncBatch responses are capped at this many decisions per round trip;
#: the requester loops until caught up.  A BYTE budget additionally caps
#: each batch under the frame cap (see ``_serve_sync``) — a deep tail of
#: fat decisions pages across continuation requests instead of emitting
#: one over-cap frame that would poison the connection it rides on.
MAX_SYNC_DECISIONS = 256

#: frame-envelope headroom reserved out of max_frame_bytes when budgeting
#: a SyncBatch / SnapshotChunk (codec framing + the non-payload fields)
FRAME_ENVELOPE_BYTES = 65536

#: resume attempts for one snapshot transfer before giving up (each
#: retry re-requests from the current offset — the reconnect-resume path)
SNAP_FETCH_RETRIES = 8

#: bounded memory of inbound request trace contexts (key -> (origin, hop))
#: used to continue the hop chain when this node re-forwards a request;
#: beyond the cap the OLDEST entry is evicted (telemetry, never state)
REQ_HOP_CAP = 1024


class TransportMetrics:
    """Per-transport counters, exported as the ``transport`` block in
    bench rows and readable over the replica control channel.  Separate
    from ProtocolPlaneTimers: the plane accounts protocol-core cost
    (codec/ingest/route/vote-reg), this accounts the SOCKET layer —
    bytes, frames, flushes, reconnects, drops."""

    __slots__ = (
        "bytes_sent", "bytes_received", "frames_sent", "frames_received",
        "flush_batches", "ingest_batches", "connects", "reconnects",
        "connect_failures", "outbox_dropped", "link_dropped",
        "malformed_frames", "connections_dropped", "handshake_rejected",
        "sync_requests", "sync_responses", "rejects_sent", "rejects_received",
        "trace_frames_sent", "trace_frames_received", "trace_ctxs_sent",
        # sync paging + snapshot state transfer.  sync_batches /
        # sync_bytes count SERVED SyncBatch replies and their decision
        # payload bytes (the paging accounting); the snap_*
        # counters meter the chunked snapshot RPC on both sides; and
        # sync_poisoned counts inbound batches/snapshots REJECTED by the
        # embedder's certificate verification (bumped by the app layer —
        # the transport is payload-agnostic, the counter lives here so it
        # rides the same transport_snapshot()/bench surface).
        "sync_batches", "sync_bytes", "snap_requests", "snap_chunks_sent",
        "snap_chunks_received", "snap_bytes_sent", "snap_bytes_received",
        "sync_poisoned",
        # the read/serving plane.  read_requests counts inbound
        # FT_READ_REQ served by this node, read_responses the replies that
        # resolved a local waiter; read_sheds_sent counts reads the LOCAL
        # token-bucket gate refused (the serving side of "a read storm
        # degrades reads, never writes"), read_sheds_received the shed
        # replies this node's clients got back; read_base_refused counts
        # read-at-base requests refused because the snapshot base was
        # torn/tampered/absent (a loud refusal).
        "read_requests", "read_responses", "read_sheds_sent",
        "read_sheds_received", "read_base_refused",
    )

    def __init__(self) -> None:
        for name in self.__slots__:
            setattr(self, name, 0)

    def snapshot(self) -> dict:
        snap = {name: getattr(self, name) for name in self.__slots__}
        snap["frames_per_flush"] = (
            round(self.frames_sent / self.flush_batches, 2)
            if self.flush_batches else 0.0
        )
        return snap


class _Peer:
    """Sender-side state for one outbound (directed) link."""

    __slots__ = ("id", "addr", "outbox", "wake", "task", "connected",
                 "trace_pending")

    def __init__(self, peer_id: int, addr: str):
        self.id = peer_id
        self.addr = addr
        self.outbox: deque = deque()
        self.wake: Optional[asyncio.Event] = None  # created on start()
        self.task: Optional[asyncio.Task] = None
        self.connected = False
        #: correlation contexts for data frames awaiting the next flush's
        #: FT_TRACE sidecar (only populated while wire tracing is armed)
        self.trace_pending: deque = deque()


class SocketComm(Comm):
    """Asyncio TCP/UDS node-to-node transport (see module docstring).

    ``peers`` maps node id -> address string for every OTHER replica;
    ``listen`` is this node's own address (``tcp://host:port`` with port
    0 for ephemeral, or ``uds:///path``).  ``consensus`` must be
    attached (:meth:`attach`) before traffic flows; frames arriving
    before that are dropped and counted.
    """

    def __init__(
        self,
        self_id: int,
        listen: str,
        peers: dict[int, str],
        *,
        cluster_key: bytes = b"",
        group: int = 0,
        outbox_cap: int = 4096,
        backoff_base: float = 0.05,
        backoff_max: float = 2.0,
        backoff_jitter: float = 0.25,
        max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
        logger=None,
        plane=None,
        rng: Optional[random.Random] = None,
    ):
        if self_id in peers:
            raise ValueError(f"peers must not contain self_id {self_id}")
        self.self_id = self_id
        self.listen = listen
        self.group = group
        self.cluster_key = bytes(cluster_key)
        self.outbox_cap = outbox_cap
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.backoff_jitter = backoff_jitter
        self.max_frame_bytes = max_frame_bytes
        self.logger = logger or StdLogger(f"smartbft.net.{self_id}")
        self.plane = PROTOCOL_PLANE if plane is None else plane
        self.metrics = TransportMetrics()
        # flight recorder for control-plane transitions (reconnects);
        # the embedder swaps in a real obs.TraceRecorder when tracing
        from ..obs.recorder import NOP_RECORDER

        self.recorder = NOP_RECORDER
        #: optional embedder hook mapping raw request bytes -> the request
        #: key ("client:rid") so FT_TRACE sidecars carry the SAME
        #: correlator the flight recorder stamps on req.submit/req.deliver
        #: (the transport itself is payload-agnostic); failures fall back
        #: to an empty key — the context still carries origin + hop
        self.request_key_fn: Optional[Callable[[bytes], object]] = None
        #: inbound request contexts (key -> (origin, hop)) so a re-forward
        #: of the same request continues its hop chain; bounded LRU
        self._req_hops: "OrderedDict[str, tuple[int, int]]" = OrderedDict()
        self.consensus = None
        #: multi-process sync server hook: (from_height) -> (decisions,
        #: total_height) with decisions a list[framing.WireDecision]; the
        #: embedder should materialize at most MAX_SYNC_DECISIONS — the
        #: transport additionally byte-budgets the reply under the frame
        #: cap and pages the rest via continuation requests
        self.sync_server: Optional[Callable[[int], tuple[list, int]]] = None
        #: snapshot state-transfer hook, duck-typed:
        #:   describe() -> Optional[(height, total_bytes, digest)] — the
        #:     snapshot currently on offer (None = no snapshot);
        #:   read_chunk(height, offset, max_bytes) ->
        #:     (total_bytes, data, last) — one bounded slice of the
        #:     snapshot file at `height`; total_bytes == 0 means that
        #:     snapshot is gone (superseded mid-transfer) and the
        #:     requester must restart against the current offer.
        self.snapshot_server = None
        #: read-plane server hook, duck-typed like sync_server:
        #: (framing.ReadRequest) -> framing.ReadResponse, answered from
        #: COMMITTED state only.  The embedder owns the token-bucket gate
        #: and returns a shed-shaped response when it refuses; the
        #: transport just counts and carries.  None = reads unserved
        #: (requester times out, same as a down peer).
        self.read_server: Optional[Callable[[ReadRequest], ReadResponse]] = None
        #: optional embedder hook: (sender_id, framing.RejectFrame) called
        #: on every received FT_REJECT (the peer shed a request this node
        #: forwarded); the last few frames are kept in `rejects` either way
        self.on_reject: Optional[Callable[[int, RejectFrame], None]] = None
        #: bounded record of received reject frames (newest last) — the
        #: client-visible admission contract over the wire, readable via
        #: the control channel / tests without installing a hook
        self.rejects: deque = deque(maxlen=64)
        self._rng = rng or random.Random(self_id * 7919 + 17)
        self._peers: dict[int, _Peer] = {
            pid: _Peer(pid, addr) for pid, addr in peers.items()
        }
        self._server: Optional[asyncio.AbstractServer] = None
        self._bound_addr: Optional[str] = None
        self._reader_tasks: set[asyncio.Task] = set()
        self._inbound_writers: set[asyncio.StreamWriter] = set()
        self._sync_waiters: dict[int, asyncio.Future] = {}
        self._snap_waiters: dict[int, asyncio.Future] = {}
        self._read_waiters: dict[int, asyncio.Future] = {}
        self._sync_nonce = 0
        self._started = False
        self._closing = False
        self._closed_evt: Optional[asyncio.Event] = None
        # fault injection (socket-level chaos)
        self.muted = False
        self._dropped_links: set[int] = set()
        self._slow_links: dict[int, float] = {}
        #: per-peer RTT estimate (seconds), EWMA over measured round
        #: trips: the TCP dial (connect = one SYN/SYN-ACK round trip;
        #: UDS connects in ~µs, which is the true loopback answer) and
        #: every sync RPC.  Consumed by Pool via Consensus's
        #: forward-timeout derivation (request_forward_rtt_multiplier):
        #: follower-submitted requests otherwise spend most of their
        #: latency waiting out the FIXED forward constant.
        self._rtt: dict[int, float] = {}

    @classmethod
    def from_config(cls, config, peers: dict[int, str], *,
                    listen: Optional[str] = None, **kw) -> "SocketComm":
        """Build from the Configuration transport knobs (the same fields
        ConfigMirror round-trips through a reconfiguration)."""
        return cls(
            config.self_id,
            listen if listen is not None else config.transport_listen,
            peers,
            outbox_cap=config.transport_outbox_cap,
            backoff_base=config.transport_reconnect_backoff_base,
            backoff_max=config.transport_reconnect_backoff_max,
            max_frame_bytes=config.transport_max_frame_bytes,
            **kw,
        )

    # ------------------------------------------------------------ lifecycle

    def attach(self, consensus) -> None:
        """Point ingest at the consensus intake (any object exposing the
        handle_message_batch / handle_request surface)."""
        self.consensus = consensus

    @property
    def bound_addr(self) -> str:
        """The address actually bound (resolves tcp port 0); valid after
        :meth:`start`."""
        return self._bound_addr or self.listen

    async def start(self) -> None:
        if self._started:
            return
        self._started = True
        self._closing = False
        self._closed_evt = asyncio.Event()
        scheme, hostpath, port = parse_addr(self.listen)
        if scheme == "tcp":
            self._server = await asyncio.start_server(
                self._on_connection, host=hostpath, port=port
            )
            bound = self._server.sockets[0].getsockname()
            self._bound_addr = f"tcp://{bound[0]}:{bound[1]}"
        else:
            self._server = await asyncio.start_unix_server(
                self._on_connection, path=hostpath
            )
            self._bound_addr = self.listen
        for peer in self._peers.values():
            peer.wake = asyncio.Event()
            if peer.outbox:
                peer.wake.set()
            peer.task = create_logged_task(
                self._peer_sender(peer),
                name=f"net-send-{self.self_id}->{peer.id}",
                logger=self.logger,
            )

    async def close(self) -> None:
        """Graceful shutdown contract: stop accepting, drain + close every
        sender, cancel every reader, close every inbound connection — the
        transport leaves ZERO background tasks and zero open sockets."""
        if not self._started or self._closing:
            return
        self._closing = True
        self._closed_evt.set()
        # stop accepting; the server's wait_closed() comes last, since it
        # waits until every connection it accepted is closed
        server, self._server = self._server, None
        if server is not None:
            server.close()
        # senders: wake them so each drains its outbox once and exits
        for peer in self._peers.values():
            if peer.wake is not None:
                peer.wake.set()
        sender_tasks = [p.task for p in self._peers.values() if p.task]
        if sender_tasks:
            await asyncio.gather(*sender_tasks, return_exceptions=True)
        for peer in self._peers.values():
            peer.task = None
        # readers: nothing to drain on the receive side — cancel
        for task in list(self._reader_tasks):
            task.cancel()
        if self._reader_tasks:
            await asyncio.gather(*self._reader_tasks, return_exceptions=True)
        self._reader_tasks.clear()
        for writer in list(self._inbound_writers):
            writer.close()
            with contextlib.suppress(Exception):
                await writer.wait_closed()
        self._inbound_writers.clear()
        if server is not None:
            await server.wait_closed()
        for fut in self._sync_waiters.values():
            if not fut.done():
                fut.cancel()
        self._sync_waiters.clear()
        for fut in self._snap_waiters.values():
            if not fut.done():
                fut.cancel()
        self._snap_waiters.clear()
        for fut in self._read_waiters.values():
            if not fut.done():
                fut.cancel()
        self._read_waiters.clear()
        scheme, hostpath, _ = parse_addr(self.listen)
        if scheme == "uds":
            import os

            with contextlib.suppress(OSError):
                os.unlink(hostpath)
        self._started = False

    # ------------------------------------------------------------ Comm SPI

    def nodes(self) -> list[int]:
        return sorted([self.self_id, *self._peers.keys()])

    def send_consensus(self, target_id: int, msg: Message) -> None:
        if self.muted:
            return
        self.plane.sends += 1
        wire = wire_of(msg, self.plane)
        self._enqueue(target_id, encode_frame(FT_CONSENSUS, wire))
        if self.recorder.enabled:
            self._trace_ctx(target_id, self._consensus_ctx(msg))

    def broadcast_consensus(self, msg: Message,
                            targets: Optional[list[int]] = None) -> None:
        """Encode-once fan-out: ONE canonical encoding, ONE frame object,
        shared by reference across every peer outbox."""
        self.plane.broadcasts += 1
        if self.muted:
            return  # outbound silence: nothing leaves, nothing encodes
        t0 = perf_counter()
        codec0 = self.plane.codec_us
        frame = encode_frame(FT_CONSENSUS, wire_of(msg, self.plane))
        ctx = self._consensus_ctx(msg) if self.recorder.enabled else None
        for target in (targets if targets is not None else self._peers):
            if target == self.self_id:
                continue
            self._enqueue(target, frame)
            if ctx is not None:
                # ONE frozen context object shared across every sidecar,
                # mirroring the encode-once data frame
                self._trace_ctx(target, ctx)
        # disjoint accounting: encode time is already in codec_us
        self.plane.route_us += (
            (perf_counter() - t0) * 1e6 - (self.plane.codec_us - codec0)
        )

    def send_transaction(self, target_id: int, request: bytes) -> None:
        if self.muted:
            return
        self._enqueue(target_id, encode_frame(FT_REQUEST, request))
        if self.recorder.enabled:
            key = self._request_key(request)
            # continue the hop chain of a remembered inbound context (a
            # forward of a forward); otherwise this node originates it
            origin, hop = self._req_hops.get(key, (self.self_id, 0)) \
                if key else (self.self_id, 0)
            self._trace_ctx(target_id, TraceCtx(
                kind="request", key=key, origin=origin, hop=hop + 1,
            ))

    # ------------------------------------------------------------ tracing

    def _consensus_ctx(self, msg: Message) -> TraceCtx:
        """Correlation context for one consensus message: class name +
        (view, seq) when the message carries them (pre-prepare / prepare /
        commit / heartbeat do; view-change messages carry other fields and
        correlate by kind + origin alone)."""
        view = getattr(msg, "view", 0)
        seq = getattr(msg, "seq", 0)
        return TraceCtx(
            kind=type(msg).__name__,
            view=view if isinstance(view, int) and view >= 0 else 0,
            seq=seq if isinstance(seq, int) and seq >= 0 else 0,
            origin=self.self_id,
            hop=1,
        )

    def _request_key(self, request: bytes) -> str:
        if self.request_key_fn is None:
            return ""
        try:
            return str(self.request_key_fn(request))
        except Exception:  # noqa: BLE001 — telemetry must never shed traffic
            return ""

    def _trace_ctx(self, target: int, ctx: TraceCtx) -> None:
        """Stage one sidecar context for ``target``'s next flush.  Mirrors
        the outbox's fault surface (dropped links stage nothing) and its
        bound (oldest context dropped past the cap) — contexts are
        advisory, so a mismatch after drops costs coverage, not
        correctness."""
        peer = self._peers.get(target)
        if peer is None or target in self._dropped_links:
            return
        if len(peer.trace_pending) >= self.outbox_cap:
            peer.trace_pending.popleft()
        peer.trace_pending.append(ctx)

    def _on_trace_frame(self, sender: int, payload: bytes,
                        recv_t: Optional[float] = None) -> None:
        """Ingest one FT_TRACE sidecar: remember request hop chains and —
        when this node's recorder is armed — stamp one ``net.recv`` event
        per context (receiver-ingest side of the per-hop network time;
        the sender's ``sent_us`` rides in ``extra`` for the clock-aligned
        merge to subtract).  ``recv_t`` is the socket READ time of the
        batch the sidecar arrived in (time.monotonic, the recorder's
        clock domain): the dispatch loop awaits consensus handling of
        the wave BEFORE reaching this frame, and stamping at record time
        would book that compute as wire time."""
        frame = decode(TraceFrame, payload)  # CodecError -> drop conn
        self.metrics.trace_frames_received += 1
        rec = self.recorder
        for e in frame.entries:
            if e.kind == "request" and e.key:
                self._req_hops[e.key] = (e.origin, e.hop)
                self._req_hops.move_to_end(e.key)
                if len(self._req_hops) > REQ_HOP_CAP:
                    self._req_hops.popitem(last=False)
            if rec.enabled:
                consensus_kind = e.kind != "request"
                rec.record(
                    "net.recv",
                    key=e.key,
                    view=e.view if consensus_kind else -1,
                    seq=e.seq if consensus_kind else -1,
                    extra={"from": sender, "origin": e.origin, "hop": e.hop,
                           "sent_us": frame.sent_us, "wire": e.kind},
                    t=recv_t,
                )

    # ------------------------------------------------------------ send path

    def _enqueue(self, target: int, frame: bytes) -> None:
        peer = self._peers.get(target)
        if peer is None:
            return
        if target in self._dropped_links:
            self.metrics.link_dropped += 1
            return
        if len(peer.outbox) >= self.outbox_cap:
            # loud-but-bounded: drop the OLDEST frame (the protocol's
            # recovery paths — re-sends, view change, sync — are built for
            # loss; what it cannot survive is unbounded memory growth).
            # Its staged trace context drops with it (oldest-for-oldest —
            # approximate, since untraced frame kinds hold no context,
            # but it keeps the sidecar from advertising frames that never
            # went out; phantom net.recv events would fabricate coverage
            # exactly under the overload the recorder exists to diagnose)
            peer.outbox.popleft()
            if peer.trace_pending:
                peer.trace_pending.popleft()
            self.metrics.outbox_dropped += 1
            if self.metrics.outbox_dropped % 1000 == 1:
                self.logger.warnf(
                    "outbox to peer %d full (cap %d): dropping oldest "
                    "(%d dropped so far)",
                    target, self.outbox_cap, self.metrics.outbox_dropped,
                )
        peer.outbox.append(frame)
        if peer.wake is not None:
            peer.wake.set()

    async def _peer_sender(self, peer: _Peer) -> None:
        """Connect loop + per-wave flush loop for one directed link."""
        backoff = self.backoff_base
        first = True
        while not self._closing:
            try:
                t_dial = perf_counter()
                reader, writer = await asyncio.wait_for(
                    self._dial(peer.addr), timeout=CONNECT_TIMEOUT
                )
                self._note_rtt(peer.id, perf_counter() - t_dial)
            except (OSError, asyncio.TimeoutError):
                self.metrics.connect_failures += 1
                if self._closing:
                    return
                await self._backoff_sleep(backoff)
                backoff = min(backoff * 2, self.backoff_max)
                continue
            self.metrics.connects += 1
            if not first:
                self.metrics.reconnects += 1
                if self.recorder.enabled:
                    self.recorder.record("ctl.reconnect",
                                         extra={"peer": peer.id})
            first = False
            backoff = self.backoff_base
            peer.connected = True
            try:
                hello = Hello(node_id=self.self_id, group=self.group,
                              key=self.cluster_key)
                writer.write(encode_frame(FT_HELLO, encode(hello)))
                await writer.drain()
                await self._flush_loop(peer, writer)
                return  # clean close() exit
            except (OSError, ConnectionError, asyncio.TimeoutError) as e:
                self.logger.warnf(
                    "link %d->%d broke (%r); reconnecting",
                    self.self_id, peer.id, e,
                )
            finally:
                peer.connected = False
                writer.close()
                with contextlib.suppress(Exception):
                    await writer.wait_closed()

    async def _dial(self, addr: str):
        scheme, hostpath, port = parse_addr(addr)
        if scheme == "tcp":
            return await asyncio.open_connection(host=hostpath, port=port)
        return await asyncio.open_unix_connection(path=hostpath)

    async def _flush_loop(self, peer: _Peer, writer: asyncio.StreamWriter) -> None:
        """Drain the whole outbox per wakeup and write it as ONE batch —
        the send-side mirror of wave-batched ingest.  On close(), performs
        one final drain so frames already accepted are not stranded."""
        while True:
            while not peer.outbox and not self._closing:
                peer.wake.clear()
                await peer.wake.wait()
            delay = self._slow_links.get(peer.id)
            if delay:
                await asyncio.sleep(delay)
            batch_len = len(peer.outbox)
            if batch_len:
                pending = [peer.outbox.popleft() for _ in range(batch_len)]
                ctxs = None
                if peer.trace_pending and self.recorder.enabled:
                    # ONE sidecar frame per flush describing the whole
                    # batch (the write-coalescing contract).  The sidecar
                    # stays OUT of `pending`: a mid-flush failure hands
                    # the contexts back to trace_pending so the retry
                    # flush re-encodes them with a FRESH sent_us stamp
                    # (a re-queued stale stamp would book the whole
                    # reconnect outage as per-link network time) and the
                    # data-frame accounting below never counts it
                    ctxs = list(peer.trace_pending)
                    peer.trace_pending.clear()
                elif peer.trace_pending:
                    # tracing disarmed between enqueue and flush: drop the
                    # stale contexts instead of letting them accumulate
                    peer.trace_pending.clear()
                try:
                    blob = b"".join(pending)
                    if ctxs:
                        blob += encode_frame(FT_TRACE, encode(TraceFrame(
                            origin=self.self_id,
                            sent_us=int(time.monotonic() * 1e6),
                            entries=ctxs,
                        )))
                    writer.write(blob)
                    await writer.drain()
                except BaseException:
                    # the link died mid-flush: re-queue the batch at the
                    # front (new frames may have arrived behind it) so the
                    # reconnect delivers it instead of silently losing it
                    peer.outbox.extendleft(reversed(pending))
                    if ctxs:
                        peer.trace_pending.extendleft(reversed(ctxs))
                    raise
                self.metrics.flush_batches += 1
                self.metrics.frames_sent += batch_len
                self.metrics.bytes_sent += len(blob)
                if ctxs:
                    self.metrics.trace_frames_sent += 1
                    self.metrics.trace_ctxs_sent += len(ctxs)
            if self._closing and not peer.outbox:
                return

    async def _backoff_sleep(self, delay: float) -> None:
        jitter = 1.0 + self.backoff_jitter * (2 * self._rng.random() - 1.0)
        with contextlib.suppress(asyncio.TimeoutError):
            # close() sets the event, so a parked reconnect wakes instantly
            await asyncio.wait_for(self._closed_evt.wait(), delay * jitter)

    # ------------------------------------------------------------ recv path

    async def _on_connection(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        # runs AS the server's connection task; register for cancellation
        task = asyncio.current_task()
        self._reader_tasks.add(task)
        self._inbound_writers.add(writer)
        try:
            await self._serve_connection(reader, writer)
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — one bad conn never kills the node
            self.logger.errorf("inbound connection handler died: %r", e)
        finally:
            self._reader_tasks.discard(task)
            self._inbound_writers.discard(writer)
            writer.close()
            with contextlib.suppress(Exception):
                await writer.wait_closed()

    async def _serve_connection(self, reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter) -> None:
        decoder = FrameDecoder(self.max_frame_bytes)
        # -- handshake: first frame must be a valid HELLO with our key
        sender: Optional[int] = None
        try:
            # ONE deadline for the whole handshake (not per read: a
            # trickling dialer must not hold the fd open by sending one
            # byte per read-timeout window)
            deadline = asyncio.get_running_loop().time() + HANDSHAKE_TIMEOUT
            frames: list = []
            while not frames:
                remaining = deadline - asyncio.get_running_loop().time()
                if remaining <= 0:
                    raise asyncio.TimeoutError("handshake deadline expired")
                data = await asyncio.wait_for(reader.read(READ_CHUNK), remaining)
                if not data:
                    return  # dialer went away before the hello
                frames = decoder.feed(data)
            ftype, payload = frames[0]
            if ftype != FT_HELLO:
                raise FrameError(f"first frame is type {ftype}, not HELLO")
            hello = decode(Hello, payload)
            if hello.key != self.cluster_key:
                raise FrameError("cluster key mismatch")
            if hello.node_id == self.self_id or (
                hello.node_id not in self._peers
            ):
                raise FrameError(f"unknown peer id {hello.node_id}")
            sender = hello.node_id
            frames = frames[1:]
        except (FrameError, CodecError, asyncio.TimeoutError) as e:
            self.metrics.handshake_rejected += 1
            self.logger.warnf("rejecting inbound connection: %r", e)
            return
        # -- steady state: read -> decode frames -> batch-dispatch
        try:
            recv_t = time.monotonic()  # covers handshake-leftover frames
            while True:
                if frames:
                    await self._dispatch(sender, frames, recv_t)
                data = await reader.read(READ_CHUNK)
                if not data:
                    return  # peer closed cleanly (its reconnect, our EOF)
                # the batch's arrival instant, captured BEFORE dispatch
                # awaits consensus handling (net.recv timestamps use it)
                recv_t = time.monotonic()
                frames = decoder.feed(data)
        except (FrameError, CodecError) as e:
            # poisoned stream: drop THIS connection loudly; the peer's
            # sender will redial and resume from a clean framing state
            self.metrics.malformed_frames += 1
            self.metrics.connections_dropped += 1
            self.plane.malformed_dropped += 1
            self.logger.warnf(
                "dropping connection from peer %s: malformed frame (%r)",
                sender, e,
            )

    async def _dispatch(self, sender: int, frames: list,
                        recv_t: Optional[float] = None) -> None:
        """Decode (interned) and route one read's frames, preserving
        arrival order across kinds — the socket twin of testing.network.
        Node._dispatch, with the same disjoint plane accounting.
        ``recv_t`` is the batch's socket read time (see
        :meth:`_on_trace_frame`)."""
        if sender in self._dropped_links:
            self.metrics.link_dropped += len(frames)
            return
        plane = self.plane
        t0 = perf_counter()
        codec0 = plane.codec_us
        vote0 = plane.vote_reg_us
        token = install_plane(plane)
        poisoned: Optional[CodecError] = None
        try:
            run: list = []  # consecutive (sender, msg) consensus pairs
            for ftype, payload in frames:
                if ftype == FT_CONSENSUS:
                    try:
                        msg = unmarshal_interned(payload, plane)
                    except CodecError as e:
                        # flush what already decoded, then poison the conn
                        poisoned = e
                        break
                    run.append((sender, msg))
                elif ftype == FT_REQUEST:
                    await self._flush_consensus(run)
                    if self.consensus is not None:
                        shed = await self.consensus.handle_request(
                            sender, payload
                        )
                        if shed is not None:
                            self._send_reject(sender, payload, shed)
                elif ftype == FT_REJECT:
                    await self._flush_consensus(run)
                    self._on_reject_frame(sender, payload)
                elif ftype == FT_TRACE:
                    await self._flush_consensus(run)
                    self._on_trace_frame(sender, payload, recv_t)
                elif ftype == FT_SYNC_REQ:
                    await self._flush_consensus(run)
                    self._serve_sync(sender, payload)
                elif ftype == FT_SYNC_RESP:
                    await self._flush_consensus(run)
                    self._resolve_sync(payload)
                elif ftype == FT_SNAP_REQ:
                    await self._flush_consensus(run)
                    self._serve_snapshot(sender, payload)
                elif ftype == FT_SNAP_RESP:
                    await self._flush_consensus(run)
                    self._resolve_snapshot(payload)
                elif ftype == FT_READ_REQ:
                    await self._flush_consensus(run)
                    self._serve_read(sender, payload)
                elif ftype == FT_READ_RESP:
                    await self._flush_consensus(run)
                    self._resolve_read(payload)
                else:  # FT_HELLO after handshake: tolerated no-op
                    continue
            await self._flush_consensus(run)
        finally:
            reset_plane(token)
        plane.ingest_us += (
            (perf_counter() - t0) * 1e6
            - (plane.codec_us - codec0)
            - (plane.vote_reg_us - vote0)
        )
        plane.batch_ingests += 1
        plane.msgs_ingested += len(frames)
        self.metrics.ingest_batches += 1
        self.metrics.frames_received += len(frames)
        self.metrics.bytes_received += sum(len(p) + 5 for _, p in frames)
        if poisoned is not None:
            raise poisoned

    async def _flush_consensus(self, run: list) -> None:
        if not run:
            return
        c = self.consensus
        if c is None:
            run.clear()
            return
        batch_async = getattr(c, "handle_message_batch_async", None)
        if batch_async is not None:
            await batch_async(list(run))
        else:
            batch_sync = getattr(c, "handle_message_batch", None)
            if batch_sync is not None:
                batch_sync(list(run))
            else:
                for sender, msg in run:
                    c.handle_message(sender, msg)
        run.clear()

    # ------------------------------------------------------------ rejects

    def _send_reject(self, sender: int, payload: bytes, shed) -> None:
        """Turn a pool shed of a forwarded request into a structured
        REJECT frame back to the forwarder (the admission contract,
        now visible across the wire instead of dying inside this
        process).  Advisory: the forwarder's pool timers keep running."""
        from ..core.pool import AdmissionRejected

        retry_after = float(getattr(shed, "retry_after", 0.0) or 0.0)
        occ = getattr(shed, "occupancy", None) or {}
        kind = "admission" if isinstance(shed, AdmissionRejected) \
            else "timeout"
        frame = RejectFrame(
            kind=kind,
            reason=str(shed)[:512],
            retry_after_ms=int(retry_after * 1000),
            occupancy=int(occ.get("size", 0) or 0),
            high_water=int(occ.get("high_water", 0) or 0),
            request_digest=reject_digest(payload),
        )
        self._enqueue(sender, encode_frame(FT_REJECT, encode(frame)))
        self.metrics.rejects_sent += 1

    def _on_reject_frame(self, sender: int, payload: bytes) -> None:
        frame = decode(RejectFrame, payload)  # CodecError -> drop conn
        self.metrics.rejects_received += 1
        self.rejects.append((sender, frame))
        self.logger.warnf(
            "peer %d shed a forwarded request (%s, retry-after %d ms)",
            sender, frame.kind, frame.retry_after_ms,
        )
        if self.on_reject is not None:
            try:
                self.on_reject(sender, frame)
            except Exception as e:  # noqa: BLE001 — embedder hook
                self.logger.warnf("on_reject hook failed: %r", e)

    # ------------------------------------------------------------ sync RPC

    def _serve_sync(self, sender: int, payload: bytes) -> None:
        req = decode(SyncRequest, payload)  # CodecError -> drop conn (caller)
        self.metrics.sync_requests += 1
        if self.sync_server is None:
            return
        decisions, total = self.sync_server(req.from_height)
        # double cap: decision count AND encoded bytes under the frame
        # cap.  At least one decision always ships (the loop's progress
        # guarantee); an over-budget single decision still fits the frame
        # because transport_max_frame_bytes exceeds any legal proposal by
        # the validated envelope headroom.
        budget = self.max_frame_bytes - FRAME_ENVELOPE_BYTES
        picked: list = []
        used = 0
        for wd in decisions[:MAX_SYNC_DECISIONS]:
            size = len(encode(wd))
            if picked and used + size > budget:
                break
            picked.append(wd)
            used += size
        offer_height = offer_bytes = 0
        offer_digest = b""
        snap = self.snapshot_server
        if snap is not None:
            desc = snap.describe()
            if desc is not None and desc[0] > req.from_height:
                offer_height, offer_bytes, offer_digest = desc
        resp = SyncBatch(
            nonce=req.nonce,
            from_height=req.from_height,
            total_height=total,
            decisions=picked,
            snapshot_height=offer_height,
            snapshot_bytes=offer_bytes,
            snapshot_digest=offer_digest,
        )
        self._enqueue(sender, encode_frame(FT_SYNC_RESP, encode(resp)))
        self.metrics.sync_batches += 1
        self.metrics.sync_bytes += used

    def _resolve_sync(self, payload: bytes) -> None:
        resp = decode(SyncBatch, payload)  # CodecError -> drop conn (caller)
        self.metrics.sync_responses += 1
        fut = self._sync_waiters.pop(resp.nonce, None)
        if fut is not None and not fut.done():
            fut.set_result(resp)

    async def request_sync(self, target: int, from_height: int,
                           timeout: float = 2.0) -> Optional[SyncBatch]:
        """One sync round trip to ``target``; None on timeout / peer down."""
        self._sync_nonce += 1
        nonce = self._sync_nonce
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._sync_waiters[nonce] = fut
        req = SyncRequest(nonce=nonce, from_height=from_height)
        t0 = perf_counter()
        self._enqueue(target, encode_frame(FT_SYNC_REQ, encode(req)))
        try:
            resp = await asyncio.wait_for(fut, timeout)
            # a completed sync RPC is a measured round trip (enqueue ->
            # response dispatch): opportunistically refresh the RTT
            self._note_rtt(target, perf_counter() - t0)
            return resp
        except (asyncio.TimeoutError, asyncio.CancelledError):
            return None
        finally:
            self._sync_waiters.pop(nonce, None)

    # ------------------------------------------------------------ snapshot RPC

    def _serve_snapshot(self, sender: int, payload: bytes) -> None:
        req = decode(SnapshotFetchRequest, payload)  # CodecError -> drop conn
        self.metrics.snap_requests += 1
        snap = self.snapshot_server
        if snap is None:
            return
        max_bytes = min(
            req.max_bytes or self.max_frame_bytes,
            self.max_frame_bytes - FRAME_ENVELOPE_BYTES,
        )
        total, data, last = snap.read_chunk(req.height, req.offset, max_bytes)
        chunk = SnapshotChunk(
            nonce=req.nonce,
            height=req.height,
            total_bytes=total,
            offset=req.offset,
            data=data,
            last=last,
        )
        self._enqueue(sender, encode_frame(FT_SNAP_RESP, encode(chunk)))
        self.metrics.snap_chunks_sent += 1
        self.metrics.snap_bytes_sent += len(data)

    def _resolve_snapshot(self, payload: bytes) -> None:
        chunk = decode(SnapshotChunk, payload)  # CodecError -> drop conn
        self.metrics.snap_chunks_received += 1
        self.metrics.snap_bytes_received += len(chunk.data)
        fut = self._snap_waiters.pop(chunk.nonce, None)
        if fut is not None and not fut.done():
            fut.set_result(chunk)

    async def request_snapshot_chunk(
        self, target: int, height: int, offset: int, max_bytes: int,
        timeout: float = 2.0,
    ) -> Optional[SnapshotChunk]:
        """One chunk round trip; None on timeout / peer down."""
        self._sync_nonce += 1
        nonce = self._sync_nonce
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._snap_waiters[nonce] = fut
        req = SnapshotFetchRequest(nonce=nonce, height=height,
                                   offset=offset, max_bytes=max_bytes)
        t0 = perf_counter()
        self._enqueue(target, encode_frame(FT_SNAP_REQ, encode(req)))
        try:
            chunk = await asyncio.wait_for(fut, timeout)
            self._note_rtt(target, perf_counter() - t0)
            return chunk
        except (asyncio.TimeoutError, asyncio.CancelledError):
            return None
        finally:
            self._snap_waiters.pop(nonce, None)

    async def fetch_snapshot(
        self, target: int, height: int, *, chunk_bytes: int = 1024 * 1024,
        timeout: float = 2.0,
    ) -> Optional[bytes]:
        """Fetch the peer's whole snapshot file at ``height``, chunk by
        chunk under the frame cap.  A lost chunk (reconnect, timeout)
        re-requests from the CURRENT offset — partial progress is kept in
        memory only, so resume is just re-asking; ``SNAP_FETCH_RETRIES``
        consecutive losses abandon the transfer.  None when the peer no
        longer serves ``height`` (superseded mid-transfer: the caller
        restarts against the peer's current offer) or on abandonment."""
        buf = bytearray()
        retries = 0
        while True:
            chunk = await self.request_snapshot_chunk(
                target, height, len(buf), chunk_bytes, timeout
            )
            if chunk is None:
                retries += 1
                if retries > SNAP_FETCH_RETRIES:
                    return None
                continue  # resume: re-request the same offset
            if chunk.total_bytes == 0:
                return None  # snapshot gone on the responder
            if chunk.offset != len(buf) or (not chunk.data and not chunk.last):
                retries += 1  # stale chunk / empty non-final slice
                if retries > SNAP_FETCH_RETRIES:
                    return None
                continue  # re-request the current offset
            retries = 0
            buf += chunk.data
            if chunk.last or len(buf) >= chunk.total_bytes:
                return bytes(buf)

    # ------------------------------------------------------------ read RPC

    def _serve_read(self, sender: int, payload: bytes) -> None:
        req = decode(ReadRequest, payload)  # CodecError -> drop conn
        self.metrics.read_requests += 1
        server = self.read_server
        if server is None:
            return  # unserved: the requester times out, same as a down peer
        resp = server(req)
        if resp is None:
            return
        if resp.shed:
            self.metrics.read_sheds_sent += 1
        self._enqueue(sender, encode_frame(FT_READ_RESP, encode(resp)))

    def _resolve_read(self, payload: bytes) -> None:
        resp = decode(ReadResponse, payload)  # CodecError -> drop conn
        self.metrics.read_responses += 1
        if resp.shed:
            self.metrics.read_sheds_received += 1
        fut = self._read_waiters.pop(resp.nonce, None)
        if fut is not None and not fut.done():
            fut.set_result(resp)

    async def request_read(self, target: int, key: str, *,
                           at_base: bool = False,
                           timeout: float = 2.0) -> Optional[ReadResponse]:
        """One keyed read round trip to ``target``; None on timeout / peer
        down.  A shed reply IS returned (``resp.shed``) — the caller owns
        retry-after handling, exactly like the FT_REJECT contract."""
        self._sync_nonce += 1
        nonce = self._sync_nonce
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._read_waiters[nonce] = fut
        req = ReadRequest(nonce=nonce, key=key, at_base=at_base)
        t0 = perf_counter()
        self._enqueue(target, encode_frame(FT_READ_REQ, encode(req)))
        try:
            resp = await asyncio.wait_for(fut, timeout)
            self._note_rtt(target, perf_counter() - t0)
            return resp
        except (asyncio.TimeoutError, asyncio.CancelledError):
            return None
        finally:
            self._read_waiters.pop(nonce, None)

    # ------------------------------------------------------------ RTT

    def _note_rtt(self, peer_id: int, sample: float) -> None:
        """Fold one measured round trip into the per-peer EWMA."""
        if sample <= 0:
            return
        prev = self._rtt.get(peer_id)
        self._rtt[peer_id] = sample if prev is None \
            else 0.7 * prev + 0.3 * sample

    def rtt_seconds(self) -> Optional[float]:
        """The transport's measured RTT envelope: the WORST (largest)
        per-peer estimate, because a forwarded request must reach
        whichever peer currently leads — deriving the forward timer from
        the slowest link is the conservative choice.  None before any
        round trip was measured (the consumer falls back to the
        configured constant)."""
        if not self._rtt:
            return None
        return max(self._rtt.values())

    # ------------------------------------------------------------ faults

    def mute(self) -> None:
        """Outbound-only silence (the chaos mute-leader fault)."""
        self.muted = True

    def unmute(self) -> None:
        self.muted = False

    def drop_link(self, peer_id: int) -> None:
        """Blackhole the link with ``peer_id`` in BOTH directions at this
        node: outbound frames stop enqueuing, inbound frames from it stop
        dispatching.  Applied on both endpoints by the chaos runner, it is
        a full partition cut; applied on one, an asymmetric drop."""
        self._dropped_links.add(peer_id)

    def restore_link(self, peer_id: int) -> None:
        self._dropped_links.discard(peer_id)

    def slow_link(self, peer_id: int, delay: float) -> None:
        """Add ``delay`` seconds before every flush to ``peer_id`` (the
        throttled-WAN-link fault); 0 clears."""
        if delay > 0:
            self._slow_links[peer_id] = delay
        else:
            self._slow_links.pop(peer_id, None)

    # ------------------------------------------------------------ queries

    def transport_snapshot(self) -> dict:
        snap = self.metrics.snapshot()
        snap["peers_connected"] = sum(
            1 for p in self._peers.values() if p.connected
        )
        snap["outbox_backlog"] = sum(len(p.outbox) for p in self._peers.values())
        snap["rtt_ms"] = {
            str(p): round(r * 1e3, 3) for p, r in sorted(self._rtt.items())
        }
        return snap
