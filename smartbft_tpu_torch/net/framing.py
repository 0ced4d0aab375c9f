"""Length-prefixed framing over the canonical wire encoding.

One frame on the socket is::

    u32 big-endian length L  |  1-byte frame type  |  payload (L-1 bytes)

``L`` counts the type byte plus the payload, so ``L >= 1`` always; a
length of zero, a length above the negotiated cap, or an unknown frame
type is a :class:`FrameError` — the transport treats any of them as a
poisoned stream and drops THAT connection loudly (counted in its
metrics) without crashing the replica.  TCP gives no other framing
recovery point: once a length prefix is wrong, every later byte is
garbage, so closing and letting the peer reconnect is the only sound
move.

Frame types:

* ``FT_HELLO``      — first frame on every connection: identifies the
  dialing node and carries the shared cluster key (replicas share ONLY
  key material and the peer address map);
* ``FT_CONSENSUS``  — one consensus message in the canonical tagged
  encoding (exactly the bytes ``messages.wire_of`` produces; the
  receive side decodes through ``messages.unmarshal_interned``);
* ``FT_REQUEST``    — a raw client request (the ``send_transaction``
  SPI surface, also how the pool forwards requests to the leader);
* ``FT_SYNC_REQ`` / ``FT_SYNC_RESP`` — ledger catch-up for the
  multi-process cluster (a restarted replica has no in-process shared
  ledger to sync from), correlated by nonce; a SYNC_RESP may carry a
  snapshot OFFER instead of (or alongside) a tail when the requester is
  behind the responder's snapshot horizon;
* ``FT_SNAP_REQ`` / ``FT_SNAP_RESP`` — chunked snapshot state transfer:
  byte-offset paging of one snapshot file under the frame
  cap, nonce-correlated, resumable after reconnect by re-requesting
  from the current offset;
* ``FT_REJECT``     — structured shed notice travelling the REVERSE
  direction of an ``FT_REQUEST``: the receiving replica's pool refused
  the request (admission gate / bounded-wait timeout), and the sender —
  which fronts the client — gets the admission contract (shed kind,
  retry-after hint, occupancy snapshot) instead of silence.  Advisory:
  the protocol's forward/complain timers keep running either way.
* ``FT_READ_REQ`` / ``FT_READ_RESP`` — the read/serving plane:
  a keyed read executed at a replica against COMMITTED
  state only — no pool, no proposer, no verify launch.  The reply is
  stamped ``(value, height, state_digest, anchor_height)`` so a client
  can either fan the read to several replicas and accept on ``f+1``
  bit-identical stamps (quorum read) or accept a single reply under an
  explicit staleness bound (follower read).  Reads have their own
  token-bucket gate at the serving replica: a shed reply carries the
  FT_REJECT contract fields (kind / retry-after / occupancy) inline,
  correlated by nonce instead of request digest, and NEVER touches the
  write-path admission gate — a read storm degrades reads, not writes;
* ``FT_TRACE``      — cluster-tracing SIDECAR: a batch of
  compact correlation contexts (request key / (view, seq), origin node,
  monotonic hop counter) describing the data frames of the SAME
  write-coalesced flush, stamped with the sender's monotonic clock at
  flush time.  Strictly advisory telemetry: it rides only when the
  sender's flight recorder is armed, the canonical signed consensus
  encoding is untouched (same rule as FT_REJECT — the sidecar is a
  separate untagged frame, never a trailer on a consensus frame), and a
  receiver without tracing just updates its hop memory and moves on.
  Loss is tolerated by construction — a dropped sidecar frame costs
  timeline coverage, never correctness.

The handshake / sync payloads are encoded with the UNTAGGED canonical
codec (``codec.encode`` / ``codec.decode``): the frame type already
names the class, and keeping them out of the tagged-union registry
means their registration order can never perturb the consensus tag
space that every replica must agree on byte-exactly.
"""

from __future__ import annotations

import struct

from ..codec import wiremsg
from ..messages import Proposal, Signature

_U32 = struct.Struct(">I")

#: hard cap on one frame (length prefix included payload), matching the
#: Configuration default ``transport_max_frame_bytes``.  A proposal is
#: bounded by request_batch_max_bytes (default 10 MiB) plus headers, so
#: 16 MiB passes every legitimate frame while a hostile/corrupt length
#: prefix (e.g. 4 GiB) is rejected before any allocation.
DEFAULT_MAX_FRAME_BYTES = 16 * 1024 * 1024

FT_HELLO = 1
FT_CONSENSUS = 2
FT_REQUEST = 3
FT_SYNC_REQ = 4
FT_SYNC_RESP = 5
FT_REJECT = 6
FT_TRACE = 7
FT_SNAP_REQ = 8
FT_SNAP_RESP = 9
FT_READ_REQ = 10
FT_READ_RESP = 11

_KNOWN_TYPES = frozenset(
    (FT_HELLO, FT_CONSENSUS, FT_REQUEST, FT_SYNC_REQ, FT_SYNC_RESP,
     FT_REJECT, FT_TRACE, FT_SNAP_REQ, FT_SNAP_RESP, FT_READ_REQ,
     FT_READ_RESP)
)


class FrameError(Exception):
    """Unrecoverable stream corruption: the connection must be dropped."""


def encode_frame(ftype: int, payload: bytes) -> bytes:
    """``u32 length | type | payload`` — the only writer of the format."""
    return _U32.pack(1 + len(payload)) + bytes([ftype]) + payload


class FrameDecoder:
    """Incremental frame extraction over arbitrary read() chunk boundaries.

    ``feed`` accepts ANY split of the byte stream — one byte at a time,
    half a length prefix, three frames in one chunk — and returns every
    complete ``(type, payload)`` it can; partial frames wait in the
    buffer for more bytes.  Raises :class:`FrameError` on a zero /
    oversized length prefix or an unknown frame type, leaving the caller
    exactly one sound option: drop the connection.
    """

    __slots__ = ("_buf", "_max_frame")

    def __init__(self, max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES):
        self._buf = bytearray()
        self._max_frame = max_frame_bytes

    def __len__(self) -> int:
        return len(self._buf)

    def feed(self, data: bytes) -> list[tuple[int, bytes]]:
        buf = self._buf
        buf += data
        frames: list[tuple[int, bytes]] = []
        off = 0
        try:
            while len(buf) - off >= 4:
                length = _U32.unpack_from(buf, off)[0]
                if length == 0:
                    raise FrameError("zero-length frame")
                if length > self._max_frame:
                    raise FrameError(
                        f"frame length {length} exceeds cap {self._max_frame}"
                    )
                if len(buf) - off - 4 < length:
                    break  # partial frame: wait for more bytes
                ftype = buf[off + 4]
                if ftype not in _KNOWN_TYPES:
                    raise FrameError(f"unknown frame type {ftype}")
                payload = bytes(buf[off + 5 : off + 4 + length])
                frames.append((ftype, payload))
                off += 4 + length
        finally:
            # consume what we parsed even when raising: diagnostics read
            # cleaner when the poisoned prefix is at offset 0
            del buf[:off]
        return frames


# --------------------------------------------------------------------------
# handshake / sync wire messages (untagged encoding; see module docstring)
# --------------------------------------------------------------------------


@wiremsg
class Hello:
    """First frame on every connection (both directions are dialed
    separately: each node's outbound connection carries only its sends)."""

    node_id: int = 0
    group: int = 0
    key: bytes = b""


def reject_digest(request: bytes) -> bytes:
    """Constant-size correlation id for a rejected request: echoing the
    FULL request back would roughly double per-request bandwidth exactly
    when the link is already saturated (rejects fire under overload)."""
    import hashlib

    return hashlib.blake2b(bytes(request), digest_size=16).digest()


@wiremsg
class RejectFrame:
    """Structured shed notice for one FT_REQUEST (untagged encoding, like
    every control-plane frame).  ``kind`` is the shed cause
    ("admission" | "timeout"); ``retry_after_ms`` the drain-rate-derived
    hint (0 = no hint, as for bounded-wait timeouts); ``request_digest``
    is :func:`reject_digest` of the rejected raw request — a fixed-size
    correlation id the forwarder can match against its in-flight set
    without any shared nonce state (and without the overload-amplifying
    full echo); ``occupancy``/``high_water`` snapshot the gate's inputs
    at rejection time (0/0 when unavailable)."""

    kind: str = ""
    reason: str = ""
    retry_after_ms: int = 0
    occupancy: int = 0
    high_water: int = 0
    request_digest: bytes = b""


@wiremsg
class TraceCtx:
    """One correlation context riding an FT_TRACE sidecar (untagged
    encoding).  ``kind`` is the traced frame's flavor — the consensus
    message class name (``"PrePrepare"``/``"Prepare"``/``"Commit"``/…)
    or ``"request"`` for an FT_REQUEST — ``key`` the request key
    (``"client:rid"``) when the embedder supplied a
    ``request_key_fn``, ``(view, seq)`` the consensus correlator,
    ``origin`` the node that CREATED the context (not necessarily the
    sender of this hop), and ``hop`` the monotonic wire-hop counter:
    1 for a first send, incremented each time a replica re-forwards a
    request whose inbound context it remembered."""

    kind: str = ""
    key: str = ""
    view: int = 0
    seq: int = 0
    origin: int = 0
    hop: int = 0


@wiremsg
class TraceFrame:
    """The FT_TRACE sidecar payload: every data frame of ONE
    write-coalesced flush described in one batch, stamped with the
    sender's ``time.monotonic`` at flush time (microseconds).  The
    receiver's ingest timestamp minus ``sent_us`` — after the control-
    channel clock-offset alignment maps both onto one timeline — is the
    per-hop network time."""

    origin: int = 0
    sent_us: int = 0
    entries: list[TraceCtx] = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.entries is None:
            object.__setattr__(self, "entries", [])


@wiremsg
class SyncRequest:
    """Fetch committed decisions from ``from_height`` (0-based) onward."""

    nonce: int = 0
    from_height: int = 0


@wiremsg
class WireDecision:
    """One committed decision (types.Decision) in wire form."""

    proposal: Proposal = None  # type: ignore[assignment]
    signatures: list[Signature] = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.proposal is None:
            object.__setattr__(self, "proposal", Proposal())
        if self.signatures is None:
            object.__setattr__(self, "signatures", [])


@wiremsg
class SyncBatch:
    """Response to :class:`SyncRequest` — the responder's ledger tail,
    capped per round trip in BOTH decisions (``MAX_SYNC_DECISIONS``) and
    encoded bytes (a margin under ``transport_max_frame_bytes`` — a deep
    tail must page across nonce-correlated continuation requests, never
    exceed the frame cap in one reply).

    Snapshot offer: when the responder has compacted its
    ledger behind a snapshot horizon above the requested height — or the
    requester is simply too far behind — ``snapshot_height`` /
    ``snapshot_bytes`` / ``snapshot_digest`` describe the snapshot the
    requester should fetch over FT_SNAP_REQ/FT_SNAP_RESP instead of
    paging the whole chain.  ``snapshot_height == 0`` means no offer;
    ``decisions`` then starts at ``from_height`` as before.  An offer
    can ride WITH a (possibly empty) tail: the requester installs the
    snapshot first, then pages the suffix."""

    nonce: int = 0
    from_height: int = 0
    total_height: int = 0
    decisions: list[WireDecision] = None  # type: ignore[assignment]
    snapshot_height: int = 0
    snapshot_bytes: int = 0
    snapshot_digest: bytes = b""

    def __post_init__(self):
        if self.decisions is None:
            object.__setattr__(self, "decisions", [])


@wiremsg
class SnapshotFetchRequest:
    """Fetch one chunk of the peer's snapshot at ``height`` starting at
    byte ``offset`` (nonce-correlated like :class:`SyncRequest`).
    Resume-after-reconnect = re-issuing from the current offset — the
    requester buffers received chunks in memory only, so a crashed
    transfer restarts clean."""

    nonce: int = 0
    height: int = 0
    offset: int = 0
    max_bytes: int = 0


@wiremsg
class SnapshotChunk:
    """One bounded slice of snapshot file bytes (manifest + state blob,
    exactly the on-disk format).  ``total_bytes`` lets the requester
    pre-size and detect completion; ``last`` marks the final chunk.  A
    responder whose snapshot at ``height`` is gone (superseded mid-
    transfer) answers ``total_bytes == 0`` — the requester restarts
    against the peer's CURRENT offer."""

    nonce: int = 0
    height: int = 0
    total_bytes: int = 0
    offset: int = 0
    data: bytes = b""
    last: bool = False


@wiremsg
class ReadRequest:
    """One keyed read against a replica's COMMITTED state
    (nonce-correlated like :class:`SyncRequest`).  ``key`` names the
    committed-state entry to read (the test embedders key by client id);
    ``at_base`` asks the replica to answer from its latest verified
    snapshot BASE instead of live state — the snapshot-anchored path a
    client uses when it wants a reply whose digest is pinned by an
    anchor certificate rather than by the live chain."""

    nonce: int = 0
    key: str = ""
    at_base: bool = False


@wiremsg
class ReadResponse:
    """The read-plane reply.  ``value`` is the committed value for
    ``key`` (empty when the key has never been written — ``found``
    disambiguates an empty value from a missing key); ``height`` is the
    delivered-decision count the value reflects; ``state_digest`` the
    chained ledger digest at that height (bit-identical across honest
    replicas, so ``f+1`` matching ``(value, height, state_digest)``
    stamps prove the value is committed); ``anchor_height`` the height
    of the newest snapshot anchor certificate at answer time (0 = none
    yet).  A gated read comes back with ``shed=True`` and the FT_REJECT
    contract fields (``shed_kind``/``retry_after_ms``/``occupancy``/
    ``high_water``) instead of a value — the nonce correlates it, so no
    request digest is needed."""

    nonce: int = 0
    key: str = ""
    found: bool = False
    value: bytes = b""
    height: int = 0
    state_digest: bytes = b""
    anchor_height: int = 0
    at_base: bool = False
    shed: bool = False
    shed_kind: str = ""
    retry_after_ms: int = 0
    occupancy: int = 0
    high_water: int = 0


# --------------------------------------------------------------------------
# addresses
# --------------------------------------------------------------------------


def parse_addr(addr: str) -> tuple[str, str, int]:
    """``tcp://host:port`` or ``uds:///path`` -> (scheme, host_or_path, port).

    Raises ValueError on anything else — addresses come from operator
    config and must fail loudly, not fall back.
    """
    if addr.startswith("tcp://"):
        rest = addr[len("tcp://") :]
        host, sep, port = rest.rpartition(":")
        if not sep or not host or not port.isdigit():
            raise ValueError(f"malformed tcp address: {addr!r}")
        return "tcp", host, int(port)
    if addr.startswith("uds://"):
        path = addr[len("uds://") :]
        if not path:
            raise ValueError(f"malformed uds address: {addr!r}")
        return "uds", path, 0
    raise ValueError(f"unsupported transport address scheme: {addr!r}")
