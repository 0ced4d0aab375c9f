"""The Controller: orchestrates views, decisions, sync, and leadership.

Re-design of upstream SmartBFT internal/bft/controller.go:88-965.  The
reference's ``run()`` goroutine selects over decision / view-change /
abort-view / leader-token / sync channels; here those become one typed event
queue drained by a single asyncio task, which preserves the reference's
ordering guarantees (a queued decision is always delivered before a
subsequently queued abort) without channel machinery.

The Decide handoff keeps the reference's rendezvous semantics
(controller.go:873-890): the View awaits a future that the controller loop
resolves only after the application delivered the decision.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Optional

from ..api import (
    Application,
    Assembler,
    Comm,
    Logger,
    RequestInspector,
    Signer,
    Synchronizer,
    Verifier,
)
from ..codec import decode
from ..messages import (
    Commit,
    HeartBeat,
    HeartBeatResponse,
    Message,
    NewView,
    NewViewRecord,
    PrePrepare,
    Prepare,
    SignedViewData,
    StateTransferRequest,
    StateTransferResponse,
    ViewChange,
    ViewMetadata,
)
from ..metrics import ConsensusMetrics, ViewMetrics
from ..types import (
    Checkpoint,
    Proposal,
    Reconfig,
    RequestInfo,
    ViewAndSeq,
    blacklist_of,
    cached_view_metadata,
)
from .pool import Pool, RequestTimeoutHandler, remove_delivered_requests
from .state import ABORT, COMMITTED
from .util import InFlightData, compute_quorum, get_leader_id
from ..utils.tasks import create_logged_task
from .view import (
    ViewSequence,
    ViewSequencesHolder,
    proposal_sequence_of_msg,
    view_number_of_msg,
)


@dataclass
class _Decision:
    proposal: Proposal
    signatures: list
    requests: list
    done: asyncio.Future


@dataclass
class _ViewChangeEvt:
    view_number: int
    proposal_seq: int


@dataclass
class _AbortViewEvt:
    view: int


class _ProposeEvt:
    pass


class _SyncEvt:
    pass


class _StopEvt:
    pass


class Controller(RequestTimeoutHandler):
    """Composed by the Consensus facade; fields mirror controller.go:88-144."""

    def __init__(
        self,
        *,
        self_id: int,
        n: int,
        nodes_list: list[int],
        leader_rotation: bool,
        decisions_per_leader: int,
        request_pool: Pool,
        batcher,
        leader_monitor,
        verifier: Verifier,
        logger: Logger,
        assembler: Assembler,
        application: Application,
        synchronizer: Synchronizer,
        signer: Signer,
        request_inspector: RequestInspector,
        proposer_builder,
        checkpoint: Checkpoint,
        failure_detector,
        view_changer,
        collector,
        state,
        in_flight: InFlightData,
        comm: Comm,
        view_sequences: ViewSequencesHolder,
        metrics_view: Optional[ViewMetrics] = None,
        metrics_consensus: Optional[ConsensusMetrics] = None,
        recorder=None,
        vc_phases=None,
        clock=None,
        misbehavior=None,
    ):
        self.id = self_id
        self.n = n
        self.nodes_list = nodes_list
        self._peers = [nid for nid in nodes_list if nid != self_id]
        self.leader_rotation = leader_rotation
        self.decisions_per_leader = decisions_per_leader
        self.request_pool = request_pool
        self.batcher = batcher
        self.leader_monitor = leader_monitor
        self.verifier = verifier
        self.logger = logger
        self.assembler = assembler
        self.application = application
        self.deliver = MutuallyExclusiveDeliver(self)
        self.synchronizer = synchronizer
        self.signer = signer
        self.request_inspector = request_inspector
        self.proposer_builder = proposer_builder
        self.checkpoint = checkpoint
        self.failure_detector = failure_detector
        self.view_changer = view_changer
        self.collector = collector
        self.state = state
        self.in_flight = in_flight
        self.comm = comm
        self.view_sequences = view_sequences
        self.metrics_view = metrics_view
        self.metrics_consensus = metrics_consensus
        #: flight recorder (obs.TraceRecorder; the nop singleton when
        #: tracing is off — every hot-path site guards on .enabled)
        from ..obs.recorder import NOP_RECORDER

        self.recorder = recorder if recorder is not None else NOP_RECORDER
        #: obs.ViewChangePhaseTracker — the first delivery in a new view
        #: closes an open view-change round's `first_commit` phase
        self.vc_phases = vc_phases
        #: core.misbehavior.MisbehaviorTable or None: shunned
        #: senders' votes are dropped at intake (a vote-forgery flood
        #: stops costing verify-plane launches) and their forwarded
        #: requests lose the admission-gate bypass
        self.misbehavior = misbehavior
        self._shunned_drops = 0  # throttled warn counter (intake shed)

        self.quorum = 0
        self.curr_view = None
        self.curr_view_number = 0
        self.curr_decisions_in_view = 0
        self.verification_sequence = 0

        # Internal control events only (1-slot tokens + decision rendezvous,
        # all bounded by construction).  Inbound network messages never queue
        # here: process_messages dispatches synchronously into the View /
        # ViewChanger / HeartbeatMonitor / StateCollector inboxes, each of
        # which enforces its own bound (the reference instead bounds the
        # controller's inMsgs channel, consensus.go:337).
        self._events: asyncio.Queue = asyncio.Queue()
        self._stopped = False
        self._task: Optional[asyncio.Task] = None
        self._propose_pending = False  # 1-slot leader token (controller.go:748-761)
        # propose-side launch shadow: batch formation + proposal assembly
        # run in this task, OFF the controller event loop, so decisions and
        # view events keep flowing while the leader waits on the batcher
        # (1-slot, like the token: at most one assembly in flight)
        self._assembly_task: Optional[asyncio.Task] = None
        self._fwd_submit_failures = 0  # throttled warn counter (handle_request)
        self._shed_submits = 0  # throttled info counter (submit_request)
        self._leader_memo_key = None  # (view, decisions, ckpt version) memo
        self._leader_memo = 0
        self._sync_pending = False  # 1-slot sync token (controller.go:718-730)
        self._sync_lock = asyncio.Lock()  # deliver-vs-sync (controller.go:143,940)
        self._reconfig: Optional[Reconfig] = None
        # commit inter-arrival EWMA:
        # one subtraction + two multiplies per delivery, read by the
        # heartbeat monitor's adaptive complain-timer derivation.  The
        # clock is the consensus scheduler's (logical in tests, wall under
        # WallClockDriver) so the signal lives in the same time domain as
        # the timers it feeds.
        self._clock = clock if clock is not None else time.monotonic
        self._last_commit_t: Optional[float] = None
        self._commit_gap_ewma = 0.0
        # last PROOF the leader is alive (heartbeat receipt time, fed by the
        # HeartbeatMonitor) — lets commit_interval_seconds tell "no load"
        # (leader alive, nothing to commit) from "no leader" (silence)
        self._leader_alive_at: Optional[float] = None

    # ------------------------------------------------------------------ info

    def blacklist(self) -> list[int]:
        prop, _ = self.checkpoint.get()
        return blacklist_of(prop)

    def latest_seq(self) -> int:
        prop, _ = self.checkpoint.get()
        if not prop.metadata:
            return 0
        return cached_view_metadata(prop.metadata).latest_sequence

    def leader_id(self) -> int:
        # memoized per (view, decisions, checkpoint version): recomputing
        # the blacklist from checkpoint metadata on EVERY inbound message
        # (process_messages routes by leader) measured ~1s per n=64 bench
        # run; all three inputs change only at decision/view boundaries
        key = (
            self.curr_view_number,
            self.curr_decisions_in_view,
            self.checkpoint.version,
        )
        if key == self._leader_memo_key:
            return self._leader_memo
        leader = get_leader_id(
            self.curr_view_number, self.n, self.nodes_list, self.leader_rotation,
            self.curr_decisions_in_view, self.decisions_per_leader, self.blacklist(),
        )
        self._leader_memo_key = key
        self._leader_memo = leader
        return leader

    def get_leader_id(self) -> int:
        return self.leader_id()

    def i_am_the_leader(self) -> tuple[bool, int]:
        leader = self.leader_id()
        return leader == self.id, leader

    def commit_interval_seconds(self) -> Optional[float]:
        """The measured commit inter-arrival EWMA (seconds), or None
        before two deliveries have landed — the cluster-visible liveness
        cadence the adaptive complain timer derives from.

        Idle decay: a busy-era EWMA of tens of ms
        would otherwise cadence-lock the complain timer at hair-trigger
        forever once traffic stops.  When the leader has PROVEN itself
        alive after the last commit (a heartbeat arrived — see
        on_leader_sign_of_life) and the commit silence has outgrown the
        EWMA, the silence span itself is reported: the derived timer then
        relaxes toward its configured ceiling as the lull extends.  Silence
        WITHOUT a fresh sign of life keeps the tight busy-era value — a
        possibly-dead leader must still be detected fast."""
        ewma = self._commit_gap_ewma
        if ewma <= 0:
            return None
        if (
            self._last_commit_t is not None
            and self._leader_alive_at is not None
            and self._leader_alive_at > self._last_commit_t
        ):
            # commit silence WITNESSED by a live leader: grows while
            # heartbeats keep arriving, freezes the moment they stop — a
            # leader that dies mid-lull must not keep relaxing the timer
            idle = self._leader_alive_at - self._last_commit_t
            if idle > 2.0 * ewma:
                return idle
        return ewma

    def on_leader_sign_of_life(self, t: float) -> None:
        """HeartbeatMonitor receipt hook: the current leader demonstrated
        liveness at ``t`` (same clock domain as ``clock``)."""
        self._leader_alive_at = t

    def delivery_frontier(self) -> dict:
        """The committed delivery frontier: the latest
        delivered sequence, the current view, and the commit inter-
        arrival EWMA.  The read plane's freshness reference — a client
        holding a frontier can bound how stale a follower-read reply is
        in DECISIONS (frontier seq minus reply height) instead of
        guessing in wall time."""
        return {
            "seq": self.latest_seq(),
            "view": self.curr_view_number,
            "commit_gap_s": self._commit_gap_ewma,
        }

    # ------------------------------------------------------------------ requests

    async def submit_request(self, request: bytes, *,
                             forwarded: bool = False) -> None:
        """consensus entry (controller.go:249-264).  ``forwarded`` marks a
        follower's forward landing here: it bypasses the admission gate
        (the request already holds a pool slot cluster-side; shedding it
        would only re-arm the follower's complain timer)."""
        info = self.request_inspector.request_id(request)
        try:
            await self.request_pool.submit(request, forwarded=forwarded)
        except Exception as e:
            # a shed submit is ROUTINE past the admission knee — throttle
            # like the forwarded-path warnings (per-request records on
            # this hot path cost whole seconds per open-loop bench run)
            self._shed_submits += 1
            if self._shed_submits == 1 or self._shed_submits % 1000 == 0:
                self.logger.infof(
                    "Request %s was not submitted (%d sheds so far), error: %s",
                    info, self._shed_submits, e,
                )
            raise
        self.logger.debugf("Request %s was submitted", info)

    async def handle_request(self, sender: int, req: bytes):
        """A forwarded client request lands at the leader
        (controller.go:231-247).

        Returns the shed exception when the pool's OVERLOAD machinery
        refused the submit (admission gate / bounded-wait timeout) so a
        transport can propagate a structured reject to the forwarding
        replica (net.framing.FT_REJECT); every other outcome — submitted,
        not-the-leader drop, bad request, dedup — returns None.  In-
        process callers ignore the return value, so the contract is
        purely additive."""
        i_am, leader = self.i_am_the_leader()
        if not i_am:
            self.logger.warnf(
                "Got request from %d but the leader is %d, dropping request", sender, leader
            )
            return None
        try:
            self.verifier.verify_request(req)
        except Exception as e:
            self.logger.warnf("Got bad request from %d: %s", sender, e)
            return None
        # shunned forwarders lose the admission-gate bypass:
        # forwarded=True exists because an honest follower's forward
        # already holds a pool slot cluster-side — a sender this node has
        # caught forging votes gets no such credit, so its submissions
        # compete through the front-door gate and are shed FIRST under
        # overload while honest shards keep their SLO
        forwarded = not (self.misbehavior is not None
                         and self.misbehavior.is_shunned(sender))
        try:
            await self.submit_request(req, forwarded=forwarded)
        except Exception as e:
            # the reference warns on forwarded-submit failure too
            # (controller.go:258-263); a full pool here is routine under
            # load, so throttle like the inbox-overflow warnings — per-
            # request logging on this hot path costs seconds per bench run
            self._fwd_submit_failures += 1
            if self._fwd_submit_failures == 1 or self._fwd_submit_failures % 1000 == 0:
                self.logger.warnf(
                    "Got request from %d but couldn't submit it (%d failures so far): %s",
                    sender, self._fwd_submit_failures, e,
                )
            from .pool import AdmissionRejected, SubmitTimeoutError

            if isinstance(e, (AdmissionRejected, SubmitTimeoutError)):
                return e
        return None

    # -- pool timeout chain (controller.go:266-297) ------------------------

    def on_request_timeout(self, request: bytes, info: RequestInfo) -> None:
        i_am, leader = self.i_am_the_leader()
        if i_am:
            self.logger.infof(
                "Request %s timeout expired, this node is the leader, nothing to do", info
            )
            return
        self.logger.infof(
            "Request %s timeout expired, forwarding request to leader: %d", info, leader
        )
        self.comm.send_transaction(leader, request)

    def on_leader_fwd_request_timeout(self, request: bytes, info: RequestInfo) -> None:
        i_am, leader = self.i_am_the_leader()
        if i_am:
            self.leader_monitor.stop_leader_send_msg()
            return
        self.logger.warnf(
            "Request %s leader-forwarding timeout expired, complaining about leader: %d",
            info, leader,
        )
        self.failure_detector.complain(self.curr_view_number, True)

    def on_auto_remove_timeout(self, info: RequestInfo) -> None:
        self.logger.debugf("Request %s auto-remove timeout expired", info)

    # -- heartbeat events (controller.go:301-318) --------------------------

    def on_heartbeat_timeout(self, view: int, leader_id: int) -> None:
        i_am, current_leader = self.i_am_the_leader()
        if i_am:
            return
        if leader_id != current_leader:
            self.logger.warnf(
                "Heartbeat timeout expired, but current leader: %d differs from reported leader: %d; ignoring",
                current_leader, leader_id,
            )
            return
        self.logger.warnf("Heartbeat timeout expired, complaining about leader: %d", leader_id)
        self.failure_detector.complain(self.curr_view_number, True)

    # ------------------------------------------------------------------ routing

    def _intake_filter(self, sender: int, m: Message) -> bool:
        """Misbehavior gate for the PrePrepare/Prepare/Commit intake
        — True means DROP.  Only Prepare/Commit votes from
        locally shunned senders are shed: PrePrepares, view-change
        traffic, and heartbeats always pass, so the liveness machinery
        that produces SHARED evidence against a bad leader keeps running
        even when this node has privately written the sender off.  A
        stale-view message is counted observationally (never shuns —
        honest replicas racing a view change emit them) and still flows
        to the view, whose own view gating drops it pre-verification."""
        mb = self.misbehavior
        if mb is None:
            return False
        if isinstance(m, (Prepare, Commit)) and mb.is_shunned(sender):
            mb.note_shed(sender)
            self._shunned_drops += 1
            if self._shunned_drops == 1 or self._shunned_drops % 1000 == 0:
                self.logger.warnf(
                    "Dropping vote from shunned sender %d at intake "
                    "(%d sheds so far)", sender, self._shunned_drops,
                )
            return True
        if view_number_of_msg(m) < self.curr_view_number:
            mb.note(sender, "stale_view")
        return False

    def _route_view_message_tail(self, sender: int, m: Message) -> None:
        """Shared tail of pre-prepare/prepare/commit routing: view-change
        evidence fan-out + artificial leader heartbeat (both intakes).  A
        lower-view message of the leader is no sign of life in this view,
        so it injects no heartbeat (the monitor would answer it with a
        HeartBeatResponse)."""
        if self.view_changer is not None:
            self.view_changer.handle_view_message(sender, m)
        if sender == self.leader_id() \
                and view_number_of_msg(m) >= self.curr_view_number:
            self.leader_monitor.inject_artificial_heartbeat(
                sender,
                HeartBeat(view=view_number_of_msg(m), seq=proposal_sequence_of_msg(m)),
            )

    def process_messages(self, sender: int, m: Message) -> None:
        """Dispatch inbound consensus messages (controller.go:321-344)."""
        if isinstance(m, (PrePrepare, Prepare, Commit)):
            if self._intake_filter(sender, m):
                return
            if self.curr_view is not None:
                self.curr_view.handle_message(sender, m)
            self._route_view_message_tail(sender, m)
        elif isinstance(m, (ViewChange, SignedViewData, NewView)):
            if self.view_changer is not None:
                self.view_changer.handle_message(sender, m)
        elif isinstance(m, (HeartBeat, HeartBeatResponse)):
            self.leader_monitor.process_msg(sender, m)
        elif isinstance(m, StateTransferRequest):
            self._respond_to_state_transfer_request(sender)
        elif isinstance(m, StateTransferResponse):
            self.collector.handle_message(sender, m)
        else:
            self.logger.warnf("Unexpected message type, ignoring")

    async def process_messages_async(self, sender: int, m: Message) -> None:
        """Async intake mirror of :meth:`process_messages` for transports
        that can block on backpressure (Configuration.inbox_backpressure):
        View/ViewChanger intake may suspend the sending task on a full
        inbox; every other route is synchronous."""
        if isinstance(m, (PrePrepare, Prepare, Commit)):
            if self._intake_filter(sender, m):
                return
            if self.curr_view is not None:
                intake = getattr(self.curr_view, "handle_message_async", None)
                if intake is not None:
                    await intake(sender, m)
                else:
                    self.curr_view.handle_message(sender, m)
            self._route_view_message_tail(sender, m)
        elif isinstance(m, (ViewChange, SignedViewData, NewView)):
            if self.view_changer is not None:
                await self.view_changer.handle_message_async(sender, m)
        else:
            self.process_messages(sender, m)

    # -- wave-batched intake ------------------------------------------------

    def _ingest_view_run(self, run: list) -> None:
        """Synchronous view intake for one run of view-bound messages."""
        view = self.curr_view
        if view is None:
            return
        rec = self.recorder
        if rec.enabled:
            rec.record("wave.ingest", view=self.curr_view_number,
                       extra={"count": len(run)})
        ingest = getattr(view, "ingest_batch", None)
        if ingest is not None:
            ingest(run)
        else:
            for sender, m in run:
                view.handle_message(sender, m)

    def _finish_view_run(self, run: list) -> None:
        """Shared tail of both flush paths: view-change evidence fan-out +
        artificial heartbeats, then reset the run."""
        for sender, m in run:
            self._route_view_message_tail(sender, m)
        run.clear()

    def _flush_view_run(self, run: list) -> None:
        """Hand a run of consecutive view-bound messages to the view in ONE
        ingest_batch call (one work-event wakeup per wave instead of ~n),
        then fan the view-change evidence / artificial heartbeats out."""
        if not run:
            return
        self._ingest_view_run(run)
        self._finish_view_run(run)

    async def _flush_view_run_async(self, run: list) -> None:
        """Backpressure-capable flush: identical to :meth:`_flush_view_run`
        except a view exposing ``ingest_batch_async`` is awaited (may block
        the delivering task on a full inbox)."""
        if not run:
            return
        view = self.curr_view
        ingest_async = getattr(view, "ingest_batch_async", None) \
            if view is not None else None
        if ingest_async is not None:
            await ingest_async(run)
        else:
            self._ingest_view_run(run)
        self._finish_view_run(run)

    def process_messages_batch(self, items) -> None:
        """Dispatch a whole ingest tick of (sender, msg) pairs, registering
        each consecutive run of pre-prepare/prepare/commit messages into
        the view as one wave.  Relative message order is preserved: a
        non-view message flushes the pending run before it dispatches."""
        run: list = []
        for sender, m in items:
            if isinstance(m, (PrePrepare, Prepare, Commit)):
                if not self._intake_filter(sender, m):
                    run.append((sender, m))
                continue
            self._flush_view_run(run)
            self.process_messages(sender, m)
        self._flush_view_run(run)

    async def process_messages_batch_async(self, items) -> None:
        """Backpressure-capable mirror of :meth:`process_messages_batch`."""
        run: list = []
        for sender, m in items:
            if isinstance(m, (PrePrepare, Prepare, Commit)):
                if not self._intake_filter(sender, m):
                    run.append((sender, m))
                continue
            await self._flush_view_run_async(run)
            await self.process_messages_async(sender, m)
        await self._flush_view_run_async(run)

    def _respond_to_state_transfer_request(self, sender: int) -> None:
        vs = self.view_sequences.load()
        if vs is None:
            self.logger.panicf("ViewSequences is nil")
        self.comm.send_consensus(
            sender,
            StateTransferResponse(view_num=self.curr_view_number, sequence=vs.proposal_seq),
        )

    # ------------------------------------------------------------------ views

    def _start_view(self, proposal_sequence: int) -> None:
        """controller.go:375-396."""
        view, init_phase = self.proposer_builder.new_proposer(
            self.leader_id(), proposal_sequence, self.curr_view_number,
            self.curr_decisions_in_view, self.quorum,
        )
        self.curr_view = view
        view.start()
        leader, _ = self.i_am_the_leader()
        role = "follower"
        if leader:
            window_has_room = getattr(view, "can_accept_more_proposals", None)
            if init_phase in (COMMITTED, ABORT) or (
                window_has_room is not None and window_has_room()
            ):
                self._acquire_leader_token()
            role = "leader"
        self.leader_monitor.change_role(role, self.curr_view_number, self.leader_id())
        self.logger.infof(
            "Starting view with number %d, sequence %d, and decisions %d",
            self.curr_view_number, proposal_sequence, self.curr_decisions_in_view,
        )

    async def _change_view(
        self, new_view_number: int, new_proposal_sequence: int, new_decisions_in_view: int
    ) -> None:
        """controller.go:428-454."""
        if self._stopped:
            return
        latest_view = self.curr_view_number
        if latest_view > new_view_number:
            return
        leader = self.curr_view.get_leader_id() if self.curr_view else 0
        stopped = self.curr_view.stopped() if self.curr_view else True
        if (
            not stopped
            and latest_view == new_view_number
            and self.leader_id() == leader
            and self.curr_decisions_in_view == new_decisions_in_view
        ):
            self.logger.debugf("Got view change to %d but view is already running", new_view_number)
            return
        if not await self._abort_view(latest_view):
            return
        self.curr_view_number = new_view_number
        self.curr_decisions_in_view = new_decisions_in_view
        self._start_view(new_proposal_sequence)
        if new_view_number > latest_view:
            # a real view FLIP (not a rotation restart): ask the verify
            # plane to launch its next waves immediately — the mesh idled
            # through the depose, and the new view's first deep windows
            # must not also pay the coalescing window/hold before their
            # quorum waves go out (; verifiers without the seam
            # no-op)
            warm = getattr(self.verifier, "note_view_flip", None)
            if warm is not None:
                try:
                    warm()
                except Exception as e:  # noqa: BLE001 — warmth is advisory
                    self.logger.warnf("view-flip verify warm failed: %r", e)
        if self.i_am_the_leader()[0]:
            self.batcher.reset()

    async def _abort_view(self, view: int) -> bool:
        """controller.go:456-473."""
        if view < self.curr_view_number:
            return False
        self._propose_pending = False  # drain leader token
        if self.curr_view is not None:
            await self.curr_view.abort()
        # Uncommitted in-flight batches must become proposable again in the
        # next view.  Batches the view-change ladder DOES redeliver cannot
        # be double-proposed despite the release: delivery removal runs on
        # every delivery path and also populates the recently-deleted dedup
        # map on pool misses, so a released request is either removed before
        # the new view can batch it (it was pooled here) or rejected at
        # re-submission/forwarding (ReqAlreadyProcessedError) — pinned by
        # the exactly-once assertion in the ladder view-change test.
        self.request_pool.release_in_flight()
        return True

    # -- externally invoked transitions ------------------------------------

    def sync(self) -> None:
        """Trigger a sync (controller.go:449-454): 1-slot token."""
        if self.i_am_the_leader()[0]:
            self.batcher.close()
        if not self._sync_pending:
            self._sync_pending = True
            self._events.put_nowait(_SyncEvt())

    def abort_view(self, view: int) -> None:
        """ViewChanger asks to abort (controller.go:457-463)."""
        self.batcher.close()
        self._events.put_nowait(_AbortViewEvt(view=view))

    def view_changed(self, new_view_number: int, new_proposal_sequence: int) -> None:
        """ViewChanger announces the new view (controller.go:466-473)."""
        if self.i_am_the_leader()[0]:
            self.batcher.close()
        self._events.put_nowait(
            _ViewChangeEvt(view_number=new_view_number, proposal_seq=new_proposal_sequence)
        )

    def _acquire_leader_token(self) -> None:
        if not self._propose_pending:
            self._propose_pending = True
            self._events.put_nowait(_ProposeEvt())

    def on_window_capacity(self) -> None:
        """A pipelined view re-opened propose capacity WITHOUT a delivery
        (its launch-shadow gate unlocked, or a WAL-bounding drain finished).
        Deliveries re-arm the token in _decide; this seam covers the two
        windowed transitions that happen between deliveries — otherwise the
        leader would idle under the in-flight launch with room to propose."""
        if self._stopped:
            return
        if self.i_am_the_leader()[0]:
            self._acquire_leader_token()

    # ------------------------------------------------------------------ propose

    async def _propose(self) -> None:
        """controller.go:475-487.  In pipelined mode (pipeline_depth > 1)
        the view accepts proposals while previous decisions are still in
        flight; the token re-arms after each propose until the window fills,
        and again on every delivery (_decide).

        Propose-side launch shadow: batch formation + assembly run in a
        concurrent task (_assemble_and_propose), NOT inline on the event
        loop — the old inline ``await next_batch()`` serialized every
        queued decision behind up to a full batch interval of waiting, so
        delivery fan-out stalled exactly when the leader was idling for
        requests.  The 1-slot assembly task mirrors the leader token."""
        self._propose_pending = False
        if self._stopped or self.batcher.closed():
            return
        if self._assembly_task is not None and not self._assembly_task.done():
            return  # assembly in flight; it re-arms the token when done
        view = self.curr_view
        window_has_room = getattr(view, "can_accept_more_proposals", None)
        if window_has_room is not None and not window_has_room():
            # window full: the next delivery (_decide) or the view's
            # capacity seam (on_window_capacity) re-arms the token
            return
        self._assembly_task = create_logged_task(
            self._assemble_and_propose(view, window_has_room),
            name=f"controller-assemble-{self.id}", logger=self.logger,
        )

    async def _assemble_and_propose(self, view, window_has_room) -> None:
        """One batch-form + assemble + propose cycle, running in the shadow
        of the in-flight wave's verify launch.  Every controller-state
        mutation here is loop-synchronous (no awaits between the post-batch
        guard and the propose), so the event loop never observes a half
        -proposed state."""
        next_batch = await self.batcher.next_batch()
        if not next_batch:
            if not (self._stopped or self.batcher.closed()):
                self._acquire_leader_token()  # try again later
            return
        if view is not self.curr_view or self._stopped or self.batcher.closed():
            # view changed/aborted while batching: the requests were never
            # marked in flight, so the next view re-batches them
            return
        metadata = view.get_metadata()
        proposal = self.assembler.assemble_proposal(metadata, next_batch)
        rec = self.recorder
        if rec.enabled:
            md = decode(ViewMetadata, metadata)
            rec.record("batch.propose", view=md.view_id,
                       seq=md.latest_sequence,
                       extra={"count": len(next_batch)})
        view.propose(proposal)
        if window_has_room is not None:
            # pipelined mode: reserve the batch until delivery removes it —
            # the next window slot's batch must be FRESH requests, not the
            # same FIFO front re-proposed (duplicate delivery otherwise)
            self.request_pool.mark_in_flight(
                self.request_inspector.request_id(r) for r in next_batch
            )
            if window_has_room():
                self._acquire_leader_token()

    # ------------------------------------------------------------------ loop

    async def _run(self) -> None:
        try:
            while True:
                evt = await self._events.get()
                if isinstance(evt, _StopEvt):
                    return
                if isinstance(evt, _Decision):
                    await self._decide(evt)
                elif isinstance(evt, _ViewChangeEvt):
                    await self._change_view(evt.view_number, evt.proposal_seq, 0)
                elif isinstance(evt, _AbortViewEvt):
                    await self._abort_view(evt.view)
                elif isinstance(evt, _ProposeEvt):
                    await self._propose()
                elif isinstance(evt, _SyncEvt):
                    await self._handle_sync_event()
        finally:
            self.logger.infof("Exiting")
            if self.curr_view is not None:
                await self.curr_view.abort()
            self._drain_pending_decisions()

    def _drain_pending_decisions(self) -> None:
        while True:
            try:
                evt = self._events.get_nowait()
            except asyncio.QueueEmpty:
                return
            if isinstance(evt, _Decision) and not evt.done.done():
                evt.done.set_result(None)

    async def _handle_sync_event(self) -> None:
        """controller.go:509-523."""
        self._sync_pending = False
        view, seq, dec = await self._sync()
        self.maybe_prune_revoked_requests()
        if view > 0 or seq > 0:
            await self._change_view(view, seq, dec)
        else:
            vs = self.view_sequences.load()
            if vs is None:
                self.logger.panicf("ViewSequences is nil")
            await self._change_view(
                self.curr_view_number, vs.proposal_seq, self.curr_decisions_in_view
            )

    # ------------------------------------------------------------------ decide

    async def decide(self, proposal: Proposal, signatures: list, requests: list) -> None:
        """Called by the View; resolves after delivery (controller.go:873-890)."""
        if self._stopped:
            return
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._events.put_nowait(
            _Decision(proposal=proposal, signatures=signatures, requests=requests, done=fut)
        )
        await fut

    async def _decide(self, d: _Decision) -> None:
        """controller.go:528-558."""
        reconfig = await self.deliver.deliver(d.proposal, d.signatures)
        if reconfig.in_latest_decision:
            self._reconfig = reconfig
            self.close()
        self.logger.debugf("Node %d delivered proposal", self.id)
        # Bulk removal: not-pooled requests (routine on followers, which see
        # most requests only inside batches) are counted, not raised/logged
        # per item — at RequestBatch=500 x 64 replicas the per-request
        # exception+logging path alone cost seconds per bench run.
        remove_delivered_requests(self.request_pool, d.requests, self.logger)
        if not d.done.done():
            d.done.set_result(None)
        if self._stopped:
            return
        self.curr_decisions_in_view += 1
        now = self._clock()
        if self._last_commit_t is not None:
            gap = now - self._last_commit_t
            if gap > 0:
                self._commit_gap_ewma = gap if self._commit_gap_ewma <= 0 \
                    else 0.7 * self._commit_gap_ewma + 0.3 * gap
        self._last_commit_t = now
        md = decode(ViewMetadata, d.proposal.metadata)
        vp = self.vc_phases
        if vp is not None and vp.open:
            # first commit closes an open VC round; the pool depth at this
            # flip is the stalled backlog the new view now drains
            vp.decision(md.view_id, backlog=self.request_pool.size())
        rec = self.recorder
        if rec.enabled:
            rec.record("decision.deliver", view=md.view_id,
                       seq=md.latest_sequence,
                       extra={"count": len(d.requests)})
            for info in d.requests:
                rec.record("req.deliver", key=str(info), view=md.view_id,
                           seq=md.latest_sequence)
        if self._check_if_rotate(list(md.black_list)):
            self.logger.debugf("Restarting view to rotate the leader")
            await self._change_view(
                self.curr_view_number, md.latest_sequence + 1, self.curr_decisions_in_view
            )
            self.request_pool.restart_timers()
        self.maybe_prune_revoked_requests()
        if self.i_am_the_leader()[0]:
            self._acquire_leader_token()

    def _check_if_rotate(self, blacklist: list[int]) -> bool:
        """controller.go:560-574 (called after increment).

        ``decisions_per_leader`` is the EFFECTIVE per-decision value
        (window granularity pre-multiplies by pipeline_depth), so in
        pipelined rotation mode this fires exactly at window boundaries —
        the just-delivered decision is then the window anchor, the windowed
        view has drained (its propose gate confines the window to the
        delivery frontier's window), and no in-flight sequence above the
        anchor can hold a commit quorum when the view is torn down."""
        if blacklist and self.misbehavior is not None:
            # corroboration accounting: the SHARED deterministic
            # blacklist named these nodes — record which of them this
            # node's local misbehavior table had independently suspected
            self.misbehavior.note_blacklisted(blacklist)
        view = self.curr_view_number
        dec = self.curr_decisions_in_view
        curr_leader = get_leader_id(
            view, self.n, self.nodes_list, self.leader_rotation,
            dec - 1, self.decisions_per_leader, blacklist,
        )
        next_leader = get_leader_id(
            view, self.n, self.nodes_list, self.leader_rotation,
            dec, self.decisions_per_leader, blacklist,
        )
        rotate = curr_leader != next_leader
        if rotate:
            self.logger.infof("Rotating leader from %d to %d", curr_leader, next_leader)
        return rotate

    # ------------------------------------------------------------------ sync

    async def _sync(self) -> tuple[int, int, int]:
        """controller.go:576-680.  Returns (view, seq, decisions); zeros mean
        'nothing learned'."""
        begin = time.monotonic()
        async with self._sync_lock:
            sync_response = await asyncio.get_running_loop().run_in_executor(
                None, self.synchronizer.sync
            )
        if self.metrics_consensus:
            self.metrics_consensus.latency_sync.observe(time.monotonic() - begin)
        if sync_response.reconfig.in_latest_decision:
            self.close()
            self.view_changer.close()

        latest_decision = sync_response.latest
        latest_seq = latest_view = latest_dec = 0
        latest_md = None
        if latest_decision is not None and latest_decision.proposal.metadata:
            latest_md = decode(ViewMetadata, latest_decision.proposal.metadata)
            latest_seq = latest_md.latest_sequence
            latest_view = latest_md.view_id
            latest_dec = latest_md.decisions_in_view
        else:
            self.logger.infof("Synchronizer returned with an empty proposal metadata")

        controller_sequence = self.latest_seq()
        new_proposal_sequence = controller_sequence + 1
        controller_view_num = self.curr_view_number
        new_view_num = controller_view_num
        new_decisions_in_view = 0

        if latest_seq > controller_sequence:
            self.logger.infof(
                "Synchronizer returned with sequence %d while the controller is at sequence %d",
                latest_seq, controller_sequence,
            )
            self.checkpoint.set(latest_decision.proposal, latest_decision.signatures)
            self.verification_sequence = latest_decision.proposal.verification_sequence
            new_proposal_sequence = latest_seq + 1
            new_decisions_in_view = latest_dec + 1
        elif (
            latest_md is not None
            and latest_seq == controller_sequence
            and latest_view >= controller_view_num
        ):
            # Caught-up sync: the synchronizer's latest decision is one we
            # already have, and it belongs to the view being (re)entered —
            # so the NEXT decision in that view is latest_dec + 1, exactly
            # as in the learned-something branch above.  Leaving 0 here
            # restarts the live view with decisions_in_view=0, after which
            # this node rejects the leader's correct dec=latest_dec+1
            # proposals forever ("invalid decisions in view") — a wedge the
            # socket kill-rejoin soak hit when a wall-clock straggler sync
            # fired on the restarted ex-leader right after it caught up.
            new_decisions_in_view = latest_dec + 1

        if latest_view > controller_view_num:
            new_view_num = latest_view

        response = await self._fetch_state()
        if response is None:
            self.logger.infof("Fetching state failed")
            if latest_md is None or latest_view < controller_view_num:
                return 0, 0, 0
        else:
            if response.view <= controller_view_num and latest_view < controller_view_num:
                return 0, 0, 0
            if response.view > new_view_num and response.seq == latest_seq + 1:
                self.logger.infof(
                    "Node %d collected state with view %d and sequence %d",
                    self.id, response.view, response.seq,
                )
                self.state.save(
                    NewViewRecord(
                        metadata=ViewMetadata(
                            view_id=response.view,
                            latest_sequence=latest_seq,
                            decisions_in_view=0,
                        )
                    )
                )
                new_view_num = response.view
                new_decisions_in_view = 0

        if latest_md is not None:
            self._maybe_prune_in_flight(latest_md)

        if new_view_num > controller_view_num:
            self.view_changer.inform_new_view(new_view_num)

        return new_view_num, new_proposal_sequence, new_decisions_in_view

    def _maybe_prune_in_flight(self, sync_md: ViewMetadata) -> None:
        """controller.go:682-705."""
        in_flight = self.in_flight.in_flight_proposal()
        if in_flight is None:
            return
        in_flight_md = decode(ViewMetadata, in_flight.metadata)
        if sync_md.latest_sequence < in_flight_md.latest_sequence:
            return
        self.logger.infof(
            "Synced to sequence %d, deleting in-flight as it is stale", sync_md.latest_sequence
        )
        self.in_flight.prune_synced(sync_md.latest_sequence)

    async def _fetch_state(self) -> Optional[ViewAndSeq]:
        """controller.go:707-716."""
        self.collector.clear_collected()
        self.broadcast_consensus(StateTransferRequest())
        return await self.collector.collect_state_responses()

    def maybe_prune_revoked_requests(self) -> None:
        """controller.go:733-746."""
        new_seq = self.verifier.verification_sequence()
        if new_seq == self.verification_sequence:
            return
        old = self.verification_sequence
        self.verification_sequence = new_seq
        self.logger.infof("Verification sequence changed: %d --> %d", old, new_seq)

        def predicate(req: bytes):
            try:
                self.verifier.verify_request(req)
                return None
            except Exception as e:
                return e

        self.request_pool.prune(predicate)

    # ------------------------------------------------------------------ start/stop

    async def _sync_on_start(
        self, start_view: int, start_seq: int, start_dec: int
    ) -> tuple[int, int, int]:
        """controller.go:763-778."""
        sync_view, sync_seq, sync_dec = await self._sync()
        self.maybe_prune_revoked_requests()
        view, seq, dec = start_view, start_seq, start_dec
        if sync_view > start_view:
            view = sync_view
            dec = sync_dec
        if sync_seq > start_seq:
            seq = sync_seq
            dec = sync_dec
        return view, seq, dec

    async def start(
        self,
        start_view_number: int,
        start_proposal_sequence: int,
        start_decisions_in_view: int,
        sync_on_start: bool,
    ) -> None:
        """controller.go:781-814."""
        self._stopped = False
        q, f = compute_quorum(self.n)
        self.quorum = q
        self.verification_sequence = self.verifier.verification_sequence()
        if sync_on_start:
            (
                start_view_number,
                start_proposal_sequence,
                start_decisions_in_view,
            ) = await self._sync_on_start(
                start_view_number, start_proposal_sequence, start_decisions_in_view
            )
        self.curr_view_number = start_view_number
        self.curr_decisions_in_view = start_decisions_in_view
        self._start_view(start_proposal_sequence)
        self._task = create_logged_task(
            self._run(), name=f"controller-{self.id}", logger=self.logger
        )

    def close(self) -> None:
        if not self._stopped:
            self._stopped = True
            self._events.put_nowait(_StopEvt())

    async def stop(self, pool_pause: bool = False) -> None:
        """controller.go:829-861."""
        self.close()
        self.batcher.close()
        # release a run-loop blocked in collect_state_responses: its timeout
        # lives on the logical scheduler, which may no longer be advancing by
        # the time stop() is called (the reference's collector timeout is
        # wall-clock and always fires, statecollector.go:100-106)
        self.collector.stop()
        if pool_pause:
            self.request_pool.stop_timers()
        else:
            self.request_pool.close()
        self.leader_monitor.close()
        self._propose_pending = False
        if self._task is not None:
            await self._task
            self._task = None
        if self._assembly_task is not None:
            # the closed batcher resolves any parked next_batch wait, so
            # this never blocks; awaiting keeps shutdown orphan-free
            try:
                await self._assembly_task
            finally:
                self._assembly_task = None

    def stopped(self) -> bool:
        return self._stopped

    # ------------------------------------------------------------------ comm

    def broadcast_consensus(self, m: Message) -> None:
        """Broadcast (controller.go:912-926).  Prefers the Comm's native
        ``broadcast_consensus`` seam — the vectorized message plane encodes
        the message ONCE there and shares the frozen decoded object across
        all recipients — falling back to the per-peer send loop for Comm
        implementations without it."""
        bcast = getattr(self.comm, "broadcast_consensus", None)
        if bcast is not None:
            bcast(m, self._peers)  # membership-scoped encode-once fan-out
        else:
            for node in self.nodes_list:
                if node == self.id:
                    continue
                self.comm.send_consensus(node, m)
        if isinstance(m, (PrePrepare, Prepare, Commit)):
            if self.i_am_the_leader()[0]:
                self.leader_monitor.heartbeat_was_sent()

    def send_consensus(self, target: int, m: Message) -> None:
        self.comm.send_consensus(target, m)

    def send_transaction(self, target: int, request: bytes) -> None:
        self.comm.send_transaction(target, request)

    def nodes(self) -> list[int]:
        return list(self.nodes_list)


class MutuallyExclusiveDeliver:
    """Deliver guarded against concurrent sync (controller.go:928-965)."""

    def __init__(self, controller: Controller):
        self.c = controller

    async def deliver(self, proposal: Proposal, signatures: list) -> Reconfig:
        pending_md = decode(ViewMetadata, proposal.metadata)
        async with self.c._sync_lock:
            latest = self.c.latest_seq()
            if latest != 0 and latest >= pending_md.latest_sequence:
                self.c.logger.infof(
                    "Attempted to deliver block %d via view change but meanwhile view change "
                    "already synced to seq %d, returning result from sync",
                    pending_md.latest_sequence, latest,
                )
                sync_result = await asyncio.get_running_loop().run_in_executor(
                    None, self.c.synchronizer.sync
                )
                self.c.checkpoint.set(
                    sync_result.latest.proposal, sync_result.latest.signatures
                )
                r = sync_result.reconfig
                return Reconfig(
                    in_latest_decision=getattr(
                        r, "in_replicated_decisions", getattr(r, "in_latest_decision", False)
                    ),
                    current_nodes=tuple(r.current_nodes),
                    current_config=r.current_config,
                )
            begin = time.monotonic()
            # executor offload: the app's deliver may block (disk/IPC), and
            # other components must keep making progress meanwhile — the
            # reference's deliver blocks only the controller goroutine.
            # Applications whose deliver is non-blocking (in-memory ledger
            # append: the test harness, the bench) declare
            # ``blocking_deliver = False`` and run inline — the executor
            # round-trip (submit + two loop wakeups) costs more than such
            # delivers themselves, measured ~0.1 ms x n x decisions per
            # n=64 bench run.
            if getattr(self.c.application, "blocking_deliver", True):
                result = await asyncio.get_running_loop().run_in_executor(
                    None, self.c.application.deliver, proposal, signatures
                )
            else:
                result = self.c.application.deliver(proposal, signatures)
            if self.c.metrics_view:
                self.c.metrics_view.latency_batch_save.observe(time.monotonic() - begin)
            self.c.checkpoint.set(proposal, signatures)
            return result
