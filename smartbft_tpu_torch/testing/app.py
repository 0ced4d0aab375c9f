"""Test application: implements every SPI interface in-process.

Re-design of upstream SmartBFT test/test_app.go:28-494.  Crypto is trivial by
default (signature = node id, verification always succeeds, auxiliary data
passes through) but a real provider (smartbft_tpu_torch.crypto.provider.
P256CryptoProvider or Ed25519CryptoProvider) can be injected via
``crypto=`` — then every commit vote carries a real signature and
verification can genuinely fail.  Plus: a
shared in-memory ledger that doubles as the Synchronizer source,
fault-injection hooks, restart with real per-node WAL dirs, and the fast
test configuration.
"""

from __future__ import annotations

import asyncio
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
from ..messages import Proposal, Signature, ViewMetadata
from ..metrics import InMemoryProvider, MetricsBundle
from ..snapshot import CHAIN_SEED, chain_update  # noqa: F401 — re-exported
from ..types import Decision, Reconfig, RequestInfo, SyncResponse
from ..utils.clock import Scheduler
from ..utils.memo import BoundedMemo
from ..utils.logging import RecordingLogger
from .network import Network


@wiremsg
class TestRequest:
    """Mirrors the reference test Request{ClientID, ID} (test/test_app.go)."""

    client_id: str = ""
    request_id: str = ""
    payload: bytes = b""


@wiremsg
class BatchPayload:
    requests: list[bytes] = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.requests is None:
            object.__setattr__(self, "requests", [])


def barrier_request_bytes(epoch: int, old_shards: int,
                          new_shards: int) -> bytes:
    """Epoch ``epoch``'s reshard barrier command in the TestRequest
    envelope — the ONE construction both the in-process shard harness
    (AppShard.submit_barrier) and the socket control plane (ControlServer
    cmd=reshard) order through their streams, so the marker the mux scan
    and ReplicaApp.barrier_seq look for can never drift between them."""
    from ..shard.epoch import (
        RESHARD_CLIENT,
        barrier_request_id,
        reshard_command_payload,
    )

    return encode(TestRequest(
        client_id=RESHARD_CLIENT,
        request_id=barrier_request_id(epoch),
        payload=reshard_command_payload(epoch, old_shards, new_shards),
    ))


async def submit_barrier_request(consensus, epoch: int, old_shards: int,
                                 new_shards: int) -> None:
    """Order the barrier command through ``consensus``, treating the
    pool's already-exists/already-processed dedup as success (a recovered
    coordinator re-submits; client dedup makes that exactly-once).
    ``internal=True``: the barrier must not be shed by the client-facing
    admission gate — a reshard is how an over-the-knee deployment scales
    OUT, so the gate refusing its own remediation would lock the cluster
    into shedding forever."""
    from ..core.pool import ReqAlreadyExistsError, ReqAlreadyProcessedError

    try:
        await consensus.submit_request(
            barrier_request_bytes(epoch, old_shards, new_shards),
            internal=True,
        )
    except (ReqAlreadyExistsError, ReqAlreadyProcessedError):
        pass


def fast_config(self_id: int) -> Configuration:
    """test_app.go:28-46 — tight timeouts for tests."""
    return Configuration(
        self_id=self_id,
        request_batch_max_count=10,
        request_batch_max_bytes=10 * 1024 * 1024,
        request_batch_max_interval=0.05,
        incoming_message_buffer_size=200,
        request_pool_size=400,
        request_forward_timeout=1.0,
        request_complain_timeout=2.0,
        request_auto_remove_timeout=30.0,
        view_change_resend_interval=1.0,
        view_change_timeout=10.0,
        leader_heartbeat_timeout=15.0,
        leader_heartbeat_count=10,
        num_of_ticks_behind_before_syncing=10,
        # blocking saves keep the logical clock honest: an awaited fsync
        # wave spans real executor round-trips during which wait_for-driven
        # tests advance timers the protocol never earned (Configuration
        # docstring has the full rationale); production keeps the default ON
        wal_group_commit=False,
        collect_timeout=0.5,
        sync_on_start=False,
        speed_up_view_change=False,
        leader_rotation=False,
        decisions_per_leader=0,
    )


class SharedLedgers:
    """Shared view over every node's committed decisions — the Synchronizer
    source (test_app.go:327-371)."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.ledgers: dict[int, list[Decision]] = {}
        # decode memos shared by every in-process replica: the SAME frozen
        # bytes reach all n nodes, so a per-App cache decodes each request
        # (and each proposal payload) once PER REPLICA — at open-loop rates
        # that redundant decode is a top-5 profile line.  Values are
        # immutable (RequestInfo / tuple), so cross-node sharing is safe.
        self.request_infos: BoundedMemo[bytes, "RequestInfo"] = BoundedMemo()
        self.proposal_infos: BoundedMemo[bytes, tuple] = BoundedMemo(512)

    def register(self, node_id: int) -> None:
        with self.lock:
            self.ledgers.setdefault(node_id, [])

    def append(self, node_id: int, decision: Decision) -> None:
        with self.lock:
            self.ledgers.setdefault(node_id, []).append(decision)

    def height(self, node_id: int) -> int:
        with self.lock:
            return len(self.ledgers.get(node_id, []))

    def longest(self, exclude: int) -> list[Decision]:
        with self.lock:
            best: list[Decision] = []
            for nid, ledger in self.ledgers.items():
                if nid == exclude:
                    continue
                if len(ledger) > len(best):
                    best = list(ledger)
            return best

    def get(self, node_id: int) -> list[Decision]:
        with self.lock:
            return list(self.ledgers.get(node_id, []))


class App(Application, Assembler, Comm, Signer, Verifier, RequestInspector,
          Synchronizer, MembershipNotifier):
    """One test node: SPI implementation + fault injection + lifecycle."""

    def __init__(
        self,
        node_id: int,
        network: Optional[Network],
        shared: SharedLedgers,
        scheduler: Scheduler,
        wal_dir: Optional[str] = None,
        config: Optional[Configuration] = None,
        use_metrics: bool = False,
        crypto=None,
        wal_file_size_bytes: Optional[int] = None,
        comm=None,
        recorder=None,
    ):
        self.id = node_id
        self.network = network
        self.shared = shared
        self.scheduler = scheduler
        self.wal_dir = wal_dir
        # tiny segments force frequent rotation — the WAL-growth soak tests
        # use this to observe truncation-driven segment deletion quickly
        self.wal_file_size_bytes = wal_file_size_bytes
        self.config = config or fast_config(node_id)
        self.logger = RecordingLogger(f"app-{node_id}")
        self.lock = threading.Lock()
        # shared across the in-process replica set (see SharedLedgers) —
        # one decode per unique bytes for the WHOLE cluster, not per node
        self._request_id_cache = shared.request_infos
        self._proposal_infos_cache = shared.proposal_infos
        self.verification_seq = 0
        self.delay_sync_by: float = 0.0
        self.membership_changed = False
        # snapshot handoff provenance: a node seeded from a
        # donor shard's snapshot starts with the donor's chained digests
        # and committed-request count instead of replaying its history
        self.base_height = 0
        self.base_digest = ""
        self.base_ids_digest = ""
        self.base_request_count = 0
        self.base_recent_ids: list[str] = []
        self.base_kv: dict[str, bytes] = {}
        # read plane: the committed KV view (key = client id,
        # value = latest committed payload), folded LAZILY from the
        # shared ledger on each read — O(new decisions) per read via the
        # scan cursor, so the view needs no hook in deliver.  The chain
        # digest is folded alongside so read stamps carry it without an
        # O(ledger) capture per read.  Reads get their own token-bucket
        # gate (off by default) and stats block, same as the socket
        # embedder.
        from ..core.readplane import ReadStats, TokenBucket

        self._kv: dict[str, bytes] = {}
        self._read_scan = 0
        self._read_chain: Optional[bytes] = None
        self._read_gate = TokenBucket(self.config.read_gate_rate,
                                      self.config.read_gate_burst,
                                      clock=scheduler.now if scheduler
                                      is not None else None)
        self.read_stats = ReadStats()
        self.consensus: Optional[Consensus] = None
        self._wal = None
        # transport seam: either the in-process Network (default) or a real
        # socket transport (smartbft_tpu_torch.net.SocketComm) — the SAME App runs
        # over both, which is how the socket tests/bench pair against the
        # in-process rows without touching the protocol stack
        self.comm = comm
        if comm is not None:
            self.node = None
            comm.attach(self)
        else:
            if network is None:
                raise ValueError("App needs a Network or an explicit comm=")
            self.node = network.add_node(node_id)
            self.node.consensus = self
        shared.register(node_id)
        self.metrics = MetricsBundle(InMemoryProvider()) if use_metrics else None
        #: flight recorder handed to this node's Consensus (None = nop):
        #: the chaos/sharded harnesses wire one per replica when tracing
        self.recorder = recorder
        self.clock = scheduler
        # optional real-crypto provider (smartbft_tpu_torch.crypto.provider.
        # P256CryptoProvider / Ed25519CryptoProvider); when set,
        # Signer/Verifier crypto methods delegate to it and the View's
        # async batch path is enabled
        self.crypto = crypto
        if crypto is not None and hasattr(crypto, "verify_consenter_sigs_batch_async"):
            self.verify_consenter_sigs_batch_async = (
                crypto.verify_consenter_sigs_batch_async
            )
        if crypto is not None and hasattr(crypto, "configure_fault_policy"):
            # expose the verify-plane wiring seam so Consensus.start can
            # arm launch deadlines / retry / breaker from the Configuration
            self.configure_fault_policy = crypto.configure_fault_policy
        if crypto is not None and hasattr(crypto, "configure_verify_mesh"):
            # mesh-graduation seam: Configuration.verify_mesh_devices
            # reaches the shared coalescer through the same facade wiring
            self.configure_verify_mesh = crypto.configure_verify_mesh
        if crypto is not None and hasattr(crypto, "configure_flush_hold"):
            # occupancy-gating seam: Configuration.verify_flush_hold
            # reaches the shared coalescer the same way
            self.configure_flush_hold = crypto.configure_flush_hold
        if crypto is not None and hasattr(crypto, "configure_misbehavior"):
            # per-sender attribution seam: Consensus hands its
            # MisbehaviorTable to the provider so failed verify verdicts
            # are charged to the signer instead of the aggregate counter
            self.configure_misbehavior = crypto.configure_misbehavior
        if crypto is not None and hasattr(crypto, "note_view_flip"):
            # view-flip warm seams: the Controller (a new view installed)
            # and the windowed view (its depose) find them on the App,
            # their verifier, and reach the shared coalescer through the
            # provider (the JAX package's App forwards neither, so there
            # they find nothing)
            self.note_view_flip = crypto.note_view_flip
            self.note_view_depose = crypto.note_view_depose

    # ------------------------------------------------------------------ app

    #: in-memory ledger append — never blocks, so the controller may run
    #: deliver inline instead of paying an executor round-trip per decision
    blocking_deliver = False

    def deliver(self, proposal: Proposal, signatures) -> Reconfig:
        decision = Decision(proposal=proposal, signatures=tuple(signatures))
        self.shared.append(self.id, decision)
        return self._reconfig_in(proposal)

    def _reconfig_in(self, proposal: Proposal) -> Reconfig:
        """Scan a committed batch for a reconfiguration transaction
        (test/reconfig.go; the last one in the batch wins)."""
        from .reconfig import RECONFIG_MAGIC, detect_reconfig

        found = Reconfig(in_latest_decision=False)
        if not proposal.payload:
            return found
        # fast path: no request in this batch can be a reconfig unless the
        # magic marker appears somewhere in the raw payload — one memchr
        # scan instead of 500 per-request decodes on every deliver
        if RECONFIG_MAGIC not in proposal.payload:
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

    # -- Assembler ---------------------------------------------------------

    def assemble_proposal(self, metadata: bytes, requests) -> Proposal:
        return Proposal(
            header=b"",
            payload=encode(BatchPayload(requests=list(requests))),
            metadata=metadata,
            verification_sequence=self.verification_seq,
        )

    # -- Comm --------------------------------------------------------------

    def send_consensus(self, target_id: int, msg) -> None:
        if self.comm is not None:
            self.comm.send_consensus(target_id, msg)
            return
        self.network.send_consensus(self.id, target_id, msg)

    def broadcast_consensus(self, msg, targets=None) -> None:
        # encode-once fan-out: the transport marshals once and shares the
        # wire bytes (and, in-process, the interned decoded object) across
        # recipients
        if self.comm is not None:
            self.comm.broadcast_consensus(msg, targets)
            return
        self.network.broadcast_consensus(self.id, msg, targets)

    def send_transaction(self, target_id: int, request: bytes) -> None:
        if self.comm is not None:
            self.comm.send_transaction(target_id, request)
            return
        self.network.send_transaction(self.id, target_id, request)

    def nodes(self) -> list[int]:
        if self.comm is not None:
            return self.comm.nodes()
        return self.network.node_ids()

    # -- Signer ------------------------------------------------------------

    def sign(self, data: bytes) -> bytes:
        if self.crypto is not None:
            return self.crypto.sign(data)
        return b"sig-%d" % self.id

    def sign_proposal(self, proposal: Proposal, auxiliary_input: bytes) -> Signature:
        if self.crypto is not None:
            return self.crypto.sign_proposal(proposal, auxiliary_input)
        return Signature(signer=self.id, value=b"sig-%d" % self.id, msg=auxiliary_input)

    # -- Verifier (trivial crypto, test_app.go:237-267) --------------------

    def verify_proposal(self, proposal: Proposal) -> list[RequestInfo]:
        return self.requests_from_proposal(proposal)

    def verify_request(self, raw_request: bytes) -> RequestInfo:
        return self.request_id(raw_request)

    def verify_consenter_sig(self, signature: Signature, proposal: Proposal) -> bytes:
        if self.crypto is not None:
            return self.crypto.verify_consenter_sig(signature, proposal)
        return signature.msg

    def verify_consenter_sigs_batch(self, signatures, proposal: Proposal):
        if self.crypto is not None and hasattr(self.crypto, "verify_consenter_sigs_batch"):
            return self.crypto.verify_consenter_sigs_batch(signatures, proposal)
        # SPI default: sequential loop over verify_consenter_sig
        return super().verify_consenter_sigs_batch(signatures, proposal)

    def verify_signature(self, signature: Signature) -> None:
        if self.crypto is not None:
            return self.crypto.verify_signature(signature)
        return None

    def verification_sequence(self) -> int:
        return self.verification_seq

    def requests_from_proposal(self, proposal: Proposal) -> list[RequestInfo]:
        if not proposal.payload:
            return []
        # memoized per payload: verification, delivery, and sync all
        # re-extract infos from the same (frozen) proposal bytes.  Cached
        # as a tuple (immutable, shared across replicas); callers get a
        # fresh list since some mutate the result.
        infos = self._proposal_infos_cache.get(proposal.payload)
        if infos is None:
            batch = decode(BatchPayload, proposal.payload)
            infos = tuple(self.request_id(r) for r in batch.requests)
            self._proposal_infos_cache.put(proposal.payload, infos)
        return list(infos)

    def auxiliary_data(self, msg: bytes) -> bytes:
        if self.crypto is not None:
            return self.crypto.auxiliary_data(msg)
        return msg

    # -- RequestInspector --------------------------------------------------

    def request_id(self, raw_request: bytes) -> RequestInfo:
        # bounded memo: the same raw bytes are inspected at submit, forward,
        # proposal verification, and removal — and by EVERY replica, since
        # the memo lives on SharedLedgers.  Open-coded get/put keeps the
        # hit path free of per-call closure allocation.
        info = self._request_id_cache.get(raw_request)
        if info is None:
            req = decode(TestRequest, raw_request)
            info = RequestInfo(client_id=req.client_id,
                               request_id=req.request_id)
            self._request_id_cache.put(raw_request, info)
        return info

    # -- MembershipNotifier ------------------------------------------------

    def membership_change(self) -> bool:
        return self.membership_changed

    # -- Synchronizer (test_app.go:327-371) --------------------------------

    def sync(self) -> SyncResponse:
        import time as _time

        if self.delay_sync_by:
            _time.sleep(self.delay_sync_by)
        best = self.shared.longest(exclude=self.id)
        mine = self.shared.get(self.id)
        for decision in best[len(mine):]:
            self.deliver(decision.proposal, list(decision.signatures))
            self._drop_synced_from_pool(decision.proposal)
        mine = self.shared.get(self.id)
        latest = mine[-1] if mine else Decision(proposal=Proposal())
        # a reconfig in the latest synced decision must surface so the facade
        # rebuilds with the new membership (consensus.go:86-100)
        reconfig = (
            self._reconfig_in(latest.proposal) if mine else Reconfig(in_latest_decision=False)
        )
        return SyncResponse(latest=latest, reconfig=reconfig)

    def _drop_synced_from_pool(self, proposal: Proposal) -> None:
        """The socket replicas' wire-sync rule, applied to the
        in-process path: a decision this node learned by SYNC (not by its
        own consensus deliver) must still leave the request pool.  A
        pooled copy that survives the sync is re-proposed the moment this
        node becomes leader — measured as duplicate delivery (mux
        ShardStreamViolation) under adaptive-timer view-change churn at
        deep overload, where a deposed-and-synced node retakes leadership
        within milliseconds."""
        consensus = getattr(self, "consensus", None)
        pool = getattr(consensus, "pool", None)
        if pool is None:
            return
        from ..core.pool import remove_delivered_requests

        try:
            infos = self.requests_from_proposal(proposal)
        except Exception:  # noqa: BLE001 — foreign payload: nothing pooled
            return
        remove_delivered_requests(pool, infos, self.logger)

    # ------------------------------------------------------------------ lifecycle

    def _read_wal(self) -> list[bytes]:
        if self.wal_dir is None:
            # in-memory WAL stub: no durability, restart loses protocol state
            class _NopWAL:
                def append(self, entry: bytes, truncate_to: bool) -> None:
                    pass

            self._wal = _NopWAL()
            return []
        kw = {}
        if self.wal_file_size_bytes is not None:
            kw["file_size_bytes"] = self.wal_file_size_bytes
        self._wal, entries = walmod.initialize_and_read_all(
            self.wal_dir, self.logger, **kw
        )
        return entries

    def _latest_metadata(self) -> tuple[ViewMetadata, Proposal, list[Signature]]:
        mine = self.shared.get(self.id)
        if not mine:
            return ViewMetadata(), Proposal(), []
        last = mine[-1]
        md = decode(ViewMetadata, last.proposal.metadata)
        return md, last.proposal, list(last.signatures)

    async def start(self) -> None:
        entries = self._read_wal()
        md, last_proposal, last_sigs = self._latest_metadata()
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
            scheduler=self.scheduler,
            metrics=self.metrics,
            viewchanger_tick_interval=0.2,
            heartbeat_tick_interval=0.2,
            recorder=self.recorder,
        )
        # read plane: committed-state reads through the facade
        self.consensus.read_hook = self.read_committed
        if self.comm is not None:
            # real transport: point ingest at the fresh Consensus and open
            # the sockets; frames enqueued by consensus.start() (heartbeats,
            # sync) sit in the bounded outboxes until the listener is up
            self.comm.attach(self.consensus)
            await self.comm.start()
            await self.consensus.start()
            self._seed_pool_dedup()
            return
        self.node.consensus = self.consensus
        self.node.start()
        await self.consensus.start()
        self._seed_pool_dedup()

    async def stop(self) -> None:
        if self.consensus is not None:
            await self.consensus.stop()
        if self.comm is not None:
            await self.comm.close()
        else:
            await self.node.stop()
        if self._wal is not None and hasattr(self._wal, "close"):
            self._wal.close()

    async def restart(self) -> None:
        """Crash-restart with WAL recovery (test_app.go:129-143)."""
        await self.stop()
        await self.start()

    async def submit(self, client_id: str, request_id: str, payload: bytes = b"",
                     *, internal: bool = False) -> None:
        req = encode(TestRequest(client_id=client_id, request_id=request_id, payload=payload))
        await self.consensus.submit_request(req, internal=internal)

    async def submit_reconfig(
        self, request_id: str, nodes: list[int], config=None
    ) -> None:
        """Order a reconfiguration transaction (test/reconfig.go pattern).
        internal=True: a reconfig is control plane — the one that raises
        pool capacity or disarms the admission gate must not be shed by
        the very gate it remediates (Consensus.submit_request rationale)."""
        from .reconfig import reconfig_request_payload

        await self.submit("reconfig", request_id,
                          reconfig_request_payload(nodes, config),
                          internal=True)

    def pool_occupancy(self) -> dict:
        """Backpressure snapshot of this node's request pool — the shard
        front door's per-shard surface ({} while stopped)."""
        if self.consensus is None:
            return {}
        return self.consensus.pool_occupancy()

    # -- fault injection convenience --------------------------------------

    def disconnect(self) -> None:
        self.node.disconnect()

    def connect(self) -> None:
        self.node.connect()

    # -- queries -----------------------------------------------------------

    def ledger(self) -> list[Decision]:
        return self.shared.get(self.id)

    def height(self) -> int:
        return self.shared.height(self.id)

    # -- read plane ---------------------------------------------

    def _read_view(self, key: str) -> tuple[int, bytes, Optional[bytes]]:
        """Fold the shared ledger's NEW decisions into the committed KV
        view and running chain digest, then answer ``key`` — all under
        one lock hold so the ``(value, height, digest)`` stamp is a
        consistent cut (never a value newer than its stamped height)."""
        ledger = self.shared.get(self.id)
        with self.lock:
            if self._read_scan > len(ledger) or self._read_chain is None:
                # first read, or a fresh shared view: (re)build from the
                # installed base
                self._read_scan = 0
                self._kv = dict(self.base_kv)
                self._read_chain = (bytes.fromhex(self.base_digest)
                                    if self.base_digest else CHAIN_SEED)
            for d in ledger[self._read_scan:]:
                self._read_chain = chain_update(self._read_chain,
                                                d.proposal.payload,
                                                d.proposal.metadata)
                if not d.proposal.payload:
                    continue
                try:
                    batch = decode(BatchPayload, d.proposal.payload)
                except Exception:  # noqa: BLE001 — foreign payload
                    continue
                for raw in batch.requests:
                    try:
                        req = decode(TestRequest, raw)
                    except Exception:  # noqa: BLE001 — foreign request
                        continue
                    self._kv[req.client_id] = bytes(req.payload)
            self._read_scan = len(ledger)
            return (self.base_height + len(ledger), self._read_chain,
                    self._kv.get(key))

    def serve_read(self, key: str):
        """One keyed read from committed state, stamped — the in-process
        twin of ``ReplicaApp._serve_read`` (same gate, same reply shape),
        which is what lets the shard front door, the chaos oracle, and
        the bench apply the client-side rules of ``core.readplane``
        unchanged across both embedders."""
        from ..net.framing import ReadResponse

        if not self._read_gate.allow():
            self.read_stats.sheds += 1
            spent, burst = self._read_gate.occupancy()
            return ReadResponse(
                key=key, shed=True, shed_kind="read_gate",
                retry_after_ms=int(self._read_gate.retry_after() * 1000),
                occupancy=spent, high_water=burst,
            )
        height, chain, value = self._read_view(key)
        found = value is not None
        self.read_stats.note_served(at_base=False, found=found)
        return ReadResponse(
            key=key, found=found, value=value if found else b"",
            height=height, state_digest=chain,
            anchor_height=self.base_height, at_base=False,
        )

    def read_committed(self, key: str):
        """The facade ``read_hook`` shape: ``(value, height,
        state_digest, anchor_height)`` or None when never written."""
        height, chain, value = self._read_view(key)
        if value is None:
            return None
        return value, height, chain, self.base_height

    # -- snapshot handoff ---------------------------------------

    def capture_snapshot(self) -> dict:
        """Chained application snapshot of this node's committed state —
        the in-process twin of ``smartbft_tpu_torch.snapshot``'s capture: the
        chain digest and request-id digest fold over any installed base
        first, so snapshots CHAIN across repeated handoffs and two nodes
        with the same committed history produce identical digests no
        matter how many snapshot installs either went through."""
        from ..snapshot import (
            CHAIN_SEED,
            RECENT_IDS_CAP,
            chain_update,
            fold_ids,
        )

        chain = (bytes.fromhex(self.base_digest)
                 if self.base_digest else CHAIN_SEED)
        ids_digest = (bytes.fromhex(self.base_ids_digest)
                      if self.base_ids_digest else CHAIN_SEED)
        count = self.base_request_count
        recent = list(self.base_recent_ids)
        kv = dict(self.base_kv)
        ledger = self.ledger()
        for d in ledger:
            chain = chain_update(chain, d.proposal.payload,
                                 d.proposal.metadata)
            try:
                ids = [str(i) for i in
                       self.requests_from_proposal(d.proposal)]
            except Exception:  # noqa: BLE001 — foreign payload shape
                ids = []
            ids_digest = fold_ids(ids_digest, ids)
            count += len(ids)
            recent.extend(ids)
            if not d.proposal.payload:
                continue
            try:
                batch = decode(BatchPayload, d.proposal.payload)
            except Exception:  # noqa: BLE001 — foreign payload
                continue
            for raw in batch.requests:
                try:
                    req = decode(TestRequest, raw)
                except Exception:  # noqa: BLE001 — foreign request
                    continue
                kv[req.client_id] = bytes(req.payload)
        return {
            "height": self.base_height + len(ledger),
            "chain_digest": chain.hex(),
            "ids_digest": ids_digest.hex(),
            "request_count": count,
            "recent_ids": recent[-RECENT_IDS_CAP:],
            # the committed KV view rides the handoff so a seeded node's
            # read stamps match a full-history node's bit-for-bit (keys
            # whose last write predates the base must not vanish from
            # quorum reads after a scale-out)
            "kv": {k: v.hex() for k, v in kv.items()},
        }

    def install_base_state(self, snapshot: dict) -> None:
        """Seed this NOT-YET-STARTED node from a donor's
        :meth:`capture_snapshot` — the receiver half of the scale-out
        handoff.  The donor's recent request ids arm the pool's dedup
        memory at :meth:`start`, so a client resubmitting a request the
        donor already committed is refused instead of double-delivered."""
        if self.consensus is not None:
            raise RuntimeError(
                f"node {self.id}: install_base_state on a started node"
            )
        self.base_height = int(snapshot.get("height", 0))
        self.base_digest = str(snapshot.get("chain_digest", ""))
        self.base_ids_digest = str(snapshot.get("ids_digest", ""))
        self.base_request_count = int(snapshot.get("request_count", 0))
        self.base_recent_ids = [str(r) for r in
                                snapshot.get("recent_ids", [])]
        self.base_kv = {str(k): bytes.fromhex(v) for k, v in
                        (snapshot.get("kv") or {}).items()}

    def _seed_pool_dedup(self) -> None:
        pool = getattr(self.consensus, "pool", None)
        if pool is None or not self.base_recent_ids \
                or not hasattr(pool, "seed_processed"):
            return
        infos = []
        for rid in self.base_recent_ids:
            client, sep, req = rid.partition(":")
            if sep:
                infos.append(RequestInfo(client_id=client, request_id=req))
        pool.seed_processed(infos)


async def wait_for(predicate, scheduler: Scheduler, timeout: float = 30.0, step: float = 0.05):
    """Advance logical+real time until predicate() or timeout.

    Drives the shared scheduler in lockstep with the asyncio loop so
    tick-driven timers fire while tasks make progress.
    """
    elapsed = 0.0
    while elapsed < timeout:
        if predicate():
            return
        await asyncio.sleep(0)  # let tasks run
        scheduler.advance_by(step)
        await asyncio.sleep(0.001)
        elapsed += step
    raise TimeoutError(f"condition not met within {timeout}s of logical time")
