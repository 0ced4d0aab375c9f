"""The View: one (view-number, leader) instance of the three-phase protocol.

Re-design of upstream SmartBFT internal/bft/view.go:68-1088.  The reference
runs a goroutine that drains an inbox channel and then blocks inside
phase-specific selects; here the same control flow is an asyncio task that
pumps one inbox and awaits phase predicates.  Three deliberate divergences,
all device-motivated:

1. **Batched commit verification** — the reference spawns a goroutine per
   commit vote calling ``VerifyConsenterSig`` (view.go:537-541); here commit
   votes accumulate between event-loop turns and are flushed through
   ``Verifier.verify_consenter_sigs_batch`` in one call, which the device
   verifier maps to a single vmap'd kernel launch.  Under load the batch
   grows automatically: while one batch is in flight on the device, newly
   arriving votes queue up for the next flush.
2. **Batched prev-commit-signature verification** in proposal validation
   (view.go:606-647) — a quorum-sized batch per pre-prepare.
3. Vote sets / pre-prepare slots are plain data, not channels — the view
   task is the single owner (SURVEY §2.4).

Pipelining is preserved: messages for sequence s+1 land in ``next_*`` sets
and are swapped in at ``_start_next_seq`` (view.go:107-113,860-894).
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, replace
from typing import Optional, Sequence

from ..api import Logger, MembershipNotifier, Signer, Verifier
from ..codec import decode, encode
from ..messages import (
    Commit,
    CommitRecord,
    Message,
    PreparesFrom,
    PrePrepare,
    Prepare,
    Proposal,
    ProposedRecord,
    Signature,
    ViewMetadata,
)
from ..metrics import BlacklistMetrics, ViewMetrics
from ..types import VerifyPlaneDown, proposal_digest
from ..metrics import PROTOCOL_PLANE, current_plane
from .rotation import RotationState
from .state import ABORT, COMMITTED, PREPARED, PROPOSED
from .util import SignerIndex, VoteSet, compute_quorum, iter_bits
from ..utils.tasks import create_logged_task

_MAX_U64 = 2**64 - 1


def view_number_of_msg(msg: Message) -> int:
    """util.go:31-45 — view of a pre-prepare/prepare/commit, else MaxUint64."""
    if isinstance(msg, (PrePrepare, Prepare, Commit)):
        return msg.view
    return _MAX_U64


def proposal_sequence_of_msg(msg: Message) -> int:
    if isinstance(msg, (PrePrepare, Prepare, Commit)):
        return msg.seq
    return _MAX_U64


class ViewAborted(Exception):
    pass


@dataclass(frozen=True)
class ViewSequence:
    """view.go's ViewSequence (util.go:333-336)."""

    view_active: bool = False
    proposal_seq: int = 0


class ViewSequencesHolder:
    """Shared mutable slot replacing the reference's atomic.Value."""

    def __init__(self) -> None:
        self._v: Optional[ViewSequence] = None

    def store(self, vs: ViewSequence) -> None:
        self._v = vs

    def load(self) -> Optional[ViewSequence]:
        return self._v


@dataclass(frozen=True)
class _ProposalInfo:
    digest: str
    view: int
    seq: int


_ABORT = object()  # inbox sentinel

#: one loud warning per process when a sync-only verifier measurably
#: stalls the event loop (module-level: shared by View and ViewChanger)
_warned_slow_sync_verifier = False


async def verify_sigs_batch(verifier, sigs, proposal, logger=None) -> list:
    """Batched consenter-signature verification, async path preferred.

    Sync-only verifiers run inline, ON the event loop.  Deliberate: every
    CryptoProvider exposes the async coalescer path (engine on a worker
    thread), so the inline branch serves injected test verifiers with
    trivial crypto — and threading it (asyncio.to_thread) makes the
    deterministic logical-clock tests racy: timers advance while the
    thread runs, firing spurious heartbeat/view-change timeouts.  A
    production embedder with a slow sync-only verifier hears about it
    loudly (once per process) when the inline call measurably stalls the
    loop every component shares.
    """
    global _warned_slow_sync_verifier
    batch_async = getattr(verifier, "verify_consenter_sigs_batch_async", None)
    if batch_async is not None:
        return await batch_async(sigs, proposal)
    t0 = time.monotonic()
    out = verifier.verify_consenter_sigs_batch(sigs, proposal)
    elapsed = time.monotonic() - t0
    if elapsed > 0.05 and not _warned_slow_sync_verifier:
        _warned_slow_sync_verifier = True
        if logger is None:
            from ..utils.logging import StdLogger

            logger = StdLogger("smartbft.view")
        logger.warnf(
            "Sync-only verifier blocked the event loop for %.0f ms "
            "verifying %d signatures; EVERY consensus component stalls "
            "during such calls — implement verify_consenter_sigs_batch_async "
            "(see smartbft_tpu_torch.crypto.provider.CryptoProvider) to run "
            "verification off-loop", 1e3 * elapsed, len(sigs),
        )
    return out


class View:
    """One protocol instance.  Constructed by ProposalMaker, owned by the
    Controller; communicates upward through Decider/FailureDetector/Sync."""

    def __init__(
        self,
        *,
        self_id: int,
        n: int,
        nodes_list: list[int],
        leader_id: int,
        quorum: int,
        number: int,
        decider,
        failure_detector,
        synchronizer,
        logger: Logger,
        comm,
        verifier: Verifier,
        signer: Signer,
        membership_notifier: Optional[MembershipNotifier],
        proposal_sequence: int,
        decisions_in_view: int,
        state,
        retrieve_checkpoint,
        decisions_per_leader: int,
        view_sequences: ViewSequencesHolder,
        metrics_view: Optional[ViewMetrics] = None,
        metrics_blacklist: Optional[BlacklistMetrics] = None,
        in_msg_q_size: int = 200,
        backpressure: bool = False,
        recorder=None,
    ):
        self.self_id = self_id
        self.n = n
        self.nodes_list = nodes_list
        self.leader_id = leader_id
        self.quorum = quorum
        self.number = number
        self.decider = decider
        self.failure_detector = failure_detector
        self.synchronizer = synchronizer
        self.logger = logger
        self.comm = comm
        self.verifier = verifier
        self.signer = signer
        self.membership_notifier = membership_notifier
        self.proposal_sequence = proposal_sequence
        self.decisions_in_view = decisions_in_view
        self.state = state
        self.retrieve_checkpoint = retrieve_checkpoint
        self.decisions_per_leader = decisions_per_leader
        self.view_sequences = view_sequences
        self.metrics = metrics_view
        self.metrics_blacklist = metrics_blacklist
        self.in_msg_q_size = in_msg_q_size
        # flight recorder (obs.TraceRecorder; nop singleton when tracing
        # is off): quorum-completion + WAL-persist marks for the per-
        # request critical-path decomposition (obs.critpath)
        from ..obs.recorder import NOP_RECORDER

        self.recorder = recorder if recorder is not None else NOP_RECORDER

        self.phase = COMMITTED
        # runtime
        self.my_proposal_sig: Optional[Signature] = None
        self.in_flight_proposal: Optional[Proposal] = None
        self.in_flight_requests: list = []
        # batch-processing latency starts at pre-prepare receipt; views that
        # skip processProposal (WAL restore, the in-flight commit view spun
        # up at Phase=PREPARED) must still have a start point
        self._begin_pre_prepare = self._now()
        self.last_broadcast_sent: Optional[Message] = None
        self._curr_prepare_sent: Optional[Prepare] = None
        self._curr_commit_sent: Optional[Commit] = None
        self._prev_prepare_sent: Optional[Prepare] = None
        self._prev_commit_sent: Optional[Commit] = None
        self._last_voted_proposal_by_id: dict[int, Commit] = {}
        # shared rotation machinery (blacklist metadata + chain checks);
        # also used by the pipelined WindowedView at window boundaries
        self._rotation = RotationState(
            self_id=self_id,
            n=n,
            nodes_list=nodes_list,
            leader_id=leader_id,
            get_view_number=lambda: self.number,
            decisions_per_leader=decisions_per_leader,
            verifier=verifier,
            retrieve_checkpoint=retrieve_checkpoint,
            membership_notifier=membership_notifier,
            logger=logger,
            metrics_blacklist=metrics_blacklist,
        )

        self.backpressure = backpressure
        # backpressure mode uses the queue's own bound so senders can block
        # on put(); drop mode keeps the unbounded queue + explicit check
        self._inbox: asyncio.Queue = asyncio.Queue(
            maxsize=in_msg_q_size if backpressure else 0
        )
        self._dropped_msgs = 0  # overflow counter for the bounded inbox
        self._aborted = False
        #: set by _stop; _decide races the decide rendezvous against it
        self._abort_event = asyncio.Event()
        self._abort_wait_task: Optional[asyncio.Task] = None
        # the per-shard accounting plane captured at intake: _drain_inbox
        # runs in the view's OWN task (whose context predates any transport
        # dispatch), so the drain must use the plane the transport installed
        # when it fed the inbox, not current_plane() at drain time
        self._vote_plane = None
        self._task: Optional[asyncio.Task] = None
        # 1-slot pre-prepare stashes (view.go:105-111)
        self._pre_prepare: Optional[PrePrepare] = None
        self._next_pre_prepare: Optional[PrePrepare] = None
        #: shared id->bit mapping: one per view, reused by all 4 vote sets
        self._signer_index = SignerIndex(nodes_list)
        self._setup_votes()

    # ------------------------------------------------------------------ votes

    def _setup_votes(self) -> None:
        def accept_prepares(_sender: int, m: Message) -> bool:
            return isinstance(m, Prepare)

        def accept_commits(sender: int, m: Message) -> bool:
            if not isinstance(m, Commit) or m.signature is None:
                return False
            return m.signature.signer == sender  # view.go:160-171

        idx = self._signer_index
        self.prepares = VoteSet(accept_prepares, idx)
        self.next_prepares = VoteSet(accept_prepares, idx)
        self.commits = VoteSet(accept_commits, idx)
        self.next_commits = VoteSet(accept_commits, idx)

    # ------------------------------------------------------------------ life

    def start(self) -> None:
        self._task = create_logged_task(
            self._run(), name=f"view-{self.self_id}-{self.number}",
            logger=self.logger,
        )

    def stopped(self) -> bool:
        return self._aborted

    def _stop(self) -> None:
        if not self._aborted:
            self._aborted = True
            self._abort_event.set()
            try:
                self._inbox.put_nowait(_ABORT)
            except asyncio.QueueFull:
                pass  # a full (backpressure) inbox wakes the loop anyway;
                # every dequeue re-checks self._aborted

    async def abort(self) -> None:
        """Force the view to end and wait for its task (view.go:1000-1010)."""
        self._stop()
        if self._task is not None:
            try:
                await self._task
            except asyncio.CancelledError:
                # Swallow ONLY the view task's own cancellation.  If the
                # CALLER is the one being cancelled (shutdown reaping a
                # controller parked here during a view change), eating the
                # error leaves that task permanently in 'cancelling' —
                # asyncio delivers the cancel once — and the event loop
                # can never close (the bug showed as a 0%-CPU hang in
                # asyncio.run's _cancel_all_tasks).
                cur = asyncio.current_task()
                # Task.cancelling is 3.11+; on 3.10 a finished view task
                # means the cancellation was the view's own — swallow it
                cancelling = getattr(cur, "cancelling", None)
                if not self._task.done() or (
                    cancelling is not None and cancelling()
                ):
                    raise

    def get_leader_id(self) -> int:
        return self.leader_id

    def handle_message(self, sender: int, msg: Message) -> None:
        """Sync intake: drop on overflow (the default policy).

        Bounded inbox (consensus.go:337 IncomingMessageBufferSize; the
        reference's View drains a buffered channel, view.go:274): drop on
        overflow so a Byzantine flooder cannot grow memory without limit."""
        if self._aborted:
            return
        self._note_intake_plane()
        if self._inbox.qsize() >= self.in_msg_q_size:
            self._dropped_msgs += 1
            if self._dropped_msgs == 1 or self._dropped_msgs % 1000 == 0:
                self.logger.warnf(
                    "View %d inbox full (%d), dropped %d messages from %d",
                    self.number, self.in_msg_q_size, self._dropped_msgs, sender,
                )
            return
        self._inbox.put_nowait((sender, msg))

    async def handle_message_async(self, sender: int, msg: Message) -> None:
        """Async intake: with ``backpressure`` on, a full inbox BLOCKS the
        sending task until the view drains — the reference's full-channel
        semantics (view.go:190).  Without backpressure, same as the sync
        path."""
        if not self.backpressure:
            self.handle_message(sender, msg)
            return
        if self._aborted:
            return
        self._note_intake_plane()
        await self._inbox.put((sender, msg))

    def ingest_batch(self, items) -> None:
        """Wave-batched intake: enqueue a whole wave of (sender, msg) pairs
        in one call.  The run task's pending ``get()`` wakes once for the
        wave instead of once per message; ``_drain_inbox`` then registers
        the rest without further awaits."""
        for sender, msg in items:
            self.handle_message(sender, msg)

    def _note_intake_plane(self) -> None:
        """Latch the transport's per-shard plane the first time one feeds
        this inbox.  A view belongs to exactly one group, so the capture is
        stable; loopback/self-deliveries (default-plane contexts) never
        overwrite it."""
        if self._vote_plane is None:
            p = current_plane()
            if p is not PROTOCOL_PLANE:
                self._vote_plane = p

    async def ingest_batch_async(self, items) -> None:
        """Backpressure-aware wave intake (blocks per message on a full
        inbox, like handle_message_async)."""
        if not self.backpressure:
            self.ingest_batch(items)
            return
        for sender, msg in items:
            await self.handle_message_async(sender, msg)

    # ------------------------------------------------------------------ loop

    async def _run(self) -> None:
        try:
            while True:
                if self.phase == COMMITTED:
                    await self._process_proposal()
                elif self.phase == PROPOSED:
                    self.comm.broadcast_consensus(self.last_broadcast_sent)
                    await self._process_prepares()
                elif self.phase == PREPARED:
                    self.comm.broadcast_consensus(self.last_broadcast_sent)
                    await self._prepared()
                elif self.phase == ABORT:
                    return
                if self.metrics:
                    self.metrics.phase.set(self.phase)
        except ViewAborted:
            pass
        except Exception as e:  # pragma: no cover - defensive
            self.logger.errorf("View %d crashed: %r", self.number, e)
            raise
        finally:
            # release EVERY sender blocked in handle_message_async's put()
            # on the (bounded) inbox of a view that is going away: each
            # drain pass frees at most qsize putters, and a freed putter
            # immediately re-fills the slot — so drain repeatedly, yielding
            # between passes, until a pass finds nothing (more concurrent
            # senders than the bound is the norm at large n)
            while True:
                drained = False
                while True:
                    try:
                        self._inbox.get_nowait()
                        drained = True
                    except asyncio.QueueEmpty:
                        break
                if not drained:
                    break
                await asyncio.sleep(0)
            self.view_sequences.store(
                ViewSequence(view_active=False, proposal_seq=self.proposal_sequence)
            )

    async def _next_event(self) -> None:
        """Await and process exactly one inbound message (or abort)."""
        item = await self._inbox.get()
        if item is _ABORT or self._aborted:
            raise ViewAborted()
        sender, msg = item
        self._process_msg(sender, msg)

    def _drain_inbox(self) -> None:
        """Process everything already queued without awaiting — lets votes
        coalesce ahead of a batched verify."""
        t0 = time.perf_counter()
        drained = False
        try:
            while True:
                try:
                    item = self._inbox.get_nowait()
                except asyncio.QueueEmpty:
                    return
                if item is _ABORT or self._aborted:
                    raise ViewAborted()
                drained = True
                sender, msg = item
                self._process_msg(sender, msg)
        finally:
            if drained:
                plane = self._vote_plane
                if plane is None:
                    plane = current_plane()
                plane.vote_reg_us += (time.perf_counter() - t0) * 1e6

    # ------------------------------------------------------------------ routing

    def _process_msg(self, sender: int, m: Message) -> None:
        """view.go:194-261 — route one message into slots/vote-sets.  Unlike
        the reference, a lower-view message of the leader is dropped, not
        complained about."""
        if self._aborted:
            return
        msg_view = view_number_of_msg(m)
        msg_seq = proposal_sequence_of_msg(m)

        if msg_view != self.number:
            if sender != self.leader_id:
                self._discover_if_sync_needed(sender, m)
                return
            if msg_view < self.number:
                # the leader's own message of an earlier view: it was sent
                # before the leader's NewView and overtook it (view-change
                # traffic and view traffic ride separate queues).  Stale,
                # harmless to safety, and no sign of a faulty leader, so it
                # is dropped; the controller's intake counted it stale_view
                return
            self.failure_detector.complain(self.number, False)
            self.synchronizer.sync()
            self._stop()
            return

        if msg_seq == self.proposal_sequence - 1 and self.proposal_sequence > 0:
            self._handle_prev_seq_message(msg_seq, sender, m)
            return

        if msg_seq != self.proposal_sequence and msg_seq != self.proposal_sequence + 1:
            self.logger.warnf(
                "%d got message from %d with sequence %d but our sequence is %d",
                self.self_id, sender, msg_seq, self.proposal_sequence,
            )
            self._discover_if_sync_needed(sender, m)
            return

        for_next = msg_seq == self.proposal_sequence + 1

        if isinstance(m, PrePrepare):
            self._process_pre_prepare(m, for_next, sender)
            return

        if sender == self.self_id:
            return  # ignore own votes (view.go:238-241)

        if isinstance(m, Prepare):
            (self.next_prepares if for_next else self.prepares).register_vote(sender, m)
            return

        if isinstance(m, Commit):
            (self.next_commits if for_next else self.commits).register_vote(sender, m)
            return

    def _process_pre_prepare(self, pp: PrePrepare, for_next: bool, sender: int) -> None:
        """view.go:301-324 — stash into the 1-slot (current or next)."""
        if pp.proposal is None:
            self.logger.warnf("%d got pre-prepare from %d with empty proposal", self.self_id, sender)
            return
        if sender != self.leader_id:
            self.logger.warnf(
                "%d got pre-prepare from %d but the leader is %d",
                self.self_id, sender, self.leader_id,
            )
            return
        if for_next:
            if self._next_pre_prepare is None:
                self._next_pre_prepare = pp
            else:
                self.logger.warnf("Got a pre-prepare for next sequence without processing previous one, dropping message")
        else:
            if self._pre_prepare is None:
                self._pre_prepare = pp
            else:
                self.logger.warnf("Got a pre-prepare for current sequence without processing previous one, dropping message")

    # ------------------------------------------------------------------ phases

    async def _process_proposal(self) -> None:
        """COMMITTED -> PROPOSED (view.go:351-427)."""
        self._prev_prepare_sent = self._curr_prepare_sent
        self._prev_commit_sent = self._curr_commit_sent
        self._curr_prepare_sent = None
        self._curr_commit_sent = None
        self.in_flight_proposal = None
        self.in_flight_requests = []
        self.last_broadcast_sent = None

        while self._pre_prepare is None:
            await self._next_event()
        pp = self._pre_prepare
        self._pre_prepare = None
        proposal = pp.proposal
        prev_commits = list(pp.prev_commit_signatures)

        try:
            requests = await self._verify_proposal(proposal, prev_commits)
        except VerifyPlaneDown as e:
            # the verify PLANE is down (retries + fallback exhausted), not
            # the proposal: don't blame the leader — escalate to sync and
            # let restore/catch-up re-validate once the plane recovers
            self.logger.errorf(
                "Verify plane down validating proposal at seq %d: %s; "
                "aborting view and syncing", self.proposal_sequence, e,
            )
            self.synchronizer.sync()
            self._stop()
            raise ViewAborted() from e
        except Exception as e:
            self.logger.warnf(
                "%d received bad proposal from %d: %s", self.self_id, self.leader_id, e
            )
            self.failure_detector.complain(self.number, False)
            self.synchronizer.sync()
            self._stop()
            raise ViewAborted() from e

        if self.metrics:
            self.metrics.count_txs_in_batch.set(len(requests))
        self._begin_pre_prepare = self._now()

        seq = self.proposal_sequence
        prepare = Prepare(view=self.number, seq=seq, digest=proposal_digest(proposal))

        # Record the pre-prepare before sending our prepare (WAL-first).
        # Awaiting durability (group-commit fsync wave) instead of blocking
        # lets every other component make progress while the disk syncs.
        await self._save_state(ProposedRecord(pre_prepare=pp, prepare=prepare))
        self.last_broadcast_sent = prepare
        self._curr_prepare_sent = replace(prepare, assist=True)
        self.in_flight_proposal = proposal
        self.in_flight_requests = requests

        # The leader broadcasts the pre-prepare only after persisting it
        # (view.go:421-423): WAL-first ordering.
        if self.self_id == self.leader_id:
            self.comm.broadcast_consensus(pp)

        self.logger.infof("Processed proposal with seq %d", seq)
        self.phase = PROPOSED

    async def _process_prepares(self) -> None:
        """PROPOSED -> PREPARED (view.go:441-517)."""
        proposal = self.in_flight_proposal
        expected_digest = proposal_digest(proposal)
        voter_ids: list[int] = []
        taken_mask = 0

        def sweep() -> None:
            # incremental mask sweep: only bits not seen before — popcount
            # + bit iteration, no per-vote objects or hashing
            nonlocal taken_mask
            new = self.prepares.mask & ~taken_mask
            taken_mask |= new
            for idx in iter_bits(new):
                prepare: Prepare = self.prepares.payloads[idx]
                if prepare.digest != expected_digest:
                    self.logger.warnf(
                        "Got wrong digest at processPrepares for prepare with seq %d",
                        prepare.seq,
                    )
                    continue
                voter_ids.append(self.prepares.signer_id(idx))

        while len(voter_ids) < self.quorum - 1:
            sweep()
            if len(voter_ids) >= self.quorum - 1:
                break
            await self._next_event()

        rec = self.recorder
        if rec.enabled:
            # the voter whose prepare COMPLETED the quorum — "the slowest
            # f+1-th voter", the critical-path table's named straggler.
            # Granularity is the INGEST WAVE: votes landing in one
            # coalesced wave are observationally simultaneous here, and
            # ties within the completing wave resolve in signer-index
            # order (the mask sweep's iteration order)
            rec.record(
                "quorum.prepare", view=self.number,
                seq=self.proposal_sequence,
                # quorum == 1 (n == 1) needs no peer votes: there is no
                # completing voter to name (and [-1] on the empty list
                # would crash the view — tracing must never break it)
                extra={"slowest_voter": voter_ids[self.quorum - 2]
                       if self.quorum >= 2
                       and len(voter_ids) >= self.quorum - 1 else -1,
                       "voters": len(voter_ids)},
            )

        # sweep prepares that are already queued/registered into the witness
        # list before signing: PreparesFrom is the liveness evidence behind
        # blacklist redemption (util.go:502-541), and crediting only the
        # FIRST quorum-1 voters lets a slow-but-alive replica lose the
        # witness race on every decision and never get redeemed
        # (the vote set dedupes per sender, so one more pass of the same
        # collection loop suffices)
        self._drain_inbox()
        sweep()

        self.logger.infof(
            "%d collected %d prepares from %s", self.self_id, len(voter_ids), voter_ids
        )

        prp_from = encode(PreparesFrom(ids=voter_ids))
        self.my_proposal_sig = self.signer.sign_proposal(proposal, prp_from)

        seq = self.proposal_sequence
        commit = Commit(
            view=self.number,
            seq=seq,
            digest=expected_digest,
            signature=Signature(
                signer=self.my_proposal_sig.signer,
                value=self.my_proposal_sig.value,
                msg=self.my_proposal_sig.msg,
            ),
        )
        # Save our commit before broadcasting it (group-commit durability).
        await self._save_state(CommitRecord(commit=commit))
        if rec.enabled:
            rec.record("wal.persist", view=self.number, seq=seq)
        self._curr_commit_sent = replace(commit, assist=True)
        self.last_broadcast_sent = commit
        self.logger.infof("Processed prepares for proposal with seq %d", seq)
        self.phase = PREPARED

    async def _prepared(self) -> None:
        """PREPARED -> COMMITTED via quorum of verified commits
        (view.go:326-349,519-551)."""
        proposal = self.in_flight_proposal
        signatures = await self._process_commits(proposal)

        seq = self.proposal_sequence
        rec = self.recorder
        if rec.enabled:
            rec.record(
                "quorum.commit", view=self.number, seq=seq,
                extra={"slowest_voter": signatures[-1].signer
                       if signatures else -1},
            )
        self.logger.infof("%d processed commits for proposal with seq %d", self.self_id, seq)
        if self.metrics:
            self.metrics.count_batch_all.add(1)
            self.metrics.count_txs_all.add(len(self.in_flight_requests))
            size = len(proposal.metadata) + len(proposal.header) + len(proposal.payload)
            for s in signatures:
                size += len(s.value) + len(s.msg)
            self.metrics.size_of_batch.add(size)
            self.metrics.latency_batch_processing.observe(self._now() - self._begin_pre_prepare)

        await self._decide(proposal, signatures, self.in_flight_requests)
        self.phase = COMMITTED

    async def _process_commits(self, proposal: Proposal) -> list[Signature]:
        """Collect Q-1 valid commit signatures, verifying in batches.

        Flush policy: hold the batch until enough candidates are pending to
        possibly complete the quorum.  Eager flushing launched a partial
        wave (the first few arrivals) and then a second launch for the
        rest; on accelerators where a launch costs ~100 ms of fixed
        latency, one quorum-sized launch per decision halves the verify
        latency on the critical path.  Liveness is unchanged: with too few
        candidates we block on the next event exactly as before."""
        expected_digest = proposal_digest(proposal)
        valid: list[Signature] = []
        seen: set[int] = set()
        pending: list[Signature] = []
        taken_mask = 0

        while len(valid) < self.quorum - 1:
            # gather every pending, digest-matching vote not yet verified
            # (incremental mask sweep — integer ops, no vote objects)
            new = self.commits.mask & ~taken_mask
            taken_mask |= new
            for idx in iter_bits(new):
                commit: Commit = self.commits.payloads[idx]
                if commit.digest != expected_digest:
                    self.logger.warnf("Got wrong digest at processCommits for seq %d", commit.seq)
                    continue
                sig = commit.signature
                if sig.signer in seen:
                    continue
                pending.append(sig)
            if pending and len(valid) + len(pending) >= self.quorum - 1:
                try:
                    results = await self._verify_consenter_sigs_batch(
                        pending, proposal
                    )
                except VerifyPlaneDown as e:
                    # the device plane exhausted its deadline+retry budget
                    # AND the host fallback: escalate to sync instead of
                    # letting the exception kill the view task (which would
                    # stall this replica permanently).  No complaint — the
                    # engine being down is not the leader's fault.
                    self.logger.errorf(
                        "Verify plane down collecting commits for seq %d: "
                        "%s; aborting view and syncing",
                        self.proposal_sequence, e,
                    )
                    self.synchronizer.sync()
                    self._stop()
                    raise ViewAborted() from e
                for sig, aux in zip(pending, results):
                    if aux is None:
                        self.logger.warnf("Couldn't verify %d's signature", sig.signer)
                        continue
                    if sig.signer in seen:
                        continue
                    # stop at EXACTLY quorum-1, like the reference's vote
                    # collector (view.go:326-349): a batched flush can
                    # validate extras, but admitting them would make
                    # certificate sizes vary per replica — and the
                    # prev-commit count check (view.go:694, ours :698)
                    # rejects any later pre-prepare carrying fewer commits
                    # than the verifier's own stored certificate
                    if len(valid) >= self.quorum - 1:
                        break
                    seen.add(sig.signer)
                    valid.append(sig)
                pending = []
                # more votes may have queued while verifying — drain w/o await
                self._drain_inbox()
                continue
            if len(valid) >= self.quorum - 1:
                break
            await self._next_event()

        self.logger.infof(
            "%d collected %d commits from %s",
            self.self_id, len(valid), sorted(s.signer for s in valid),
        )
        return valid

    async def _save_state(self, msg) -> None:
        """Persist a SavedMessage, awaiting durability.

        Prefers the state's ``save_durable`` (group-commit: append now,
        fsync in a shared wave — the WAL-first guarantee is intact because
        the caller broadcasts only after this resumes).  Falls back to the
        blocking ``save`` for injected test doubles.  A view abort that
        lands during the await is re-raised here so no post-abort
        broadcast goes out."""
        save_durable = getattr(self.state, "save_durable", None)
        if save_durable is not None:
            await save_durable(msg)
        else:
            self.state.save(msg)
        if self._aborted:
            raise ViewAborted()

    async def _verify_consenter_sigs_batch(
        self, sigs: Sequence[Signature], proposal: Proposal
    ) -> list:
        return await verify_sigs_batch(self.verifier, sigs, proposal, self.logger)

    async def _decide(self, proposal, signatures, requests) -> None:
        """view.go:851-858: prepare next sequence, then hand the decision to
        the Controller and wait for delivery.

        Deliberate divergence from the reference: the ViewSequence is stored
        AFTER ``_start_next_seq`` (the reference stores the just-decided
        sequence, view.go:853).  Every consumer treats ProposalSeq as "the
        sequence this view is working on" — the proposer stores the next
        expected sequence at view start, and the sync path checks
        ``response.seq == latest_seq + 1`` (controller.go:651) — so storing
        the just-decided value made the two sources ambiguous: a replica
        stuck one sequence behind an idle cluster reads the leader's
        heartbeat seq as equal to its own and never syncs (the heartbeat
        one-behind rescue, heartbeatmonitor.go:231-247, can then never
        fire).  Storing the next expected sequence on both paths makes the
        comparison sound."""
        self.logger.infof("Deciding on seq %d", self.proposal_sequence)
        self._start_next_seq()
        self.view_sequences.store(
            ViewSequence(view_active=True, proposal_seq=self.proposal_sequence)
        )
        signatures = list(signatures) + [self.my_proposal_sig]
        # Race the decide rendezvous against abort, as WindowedView._decide
        # does: the controller resolves the decision from the same loop that
        # processes abort events, so a view parked here while an abort is
        # dequeued ahead of its decision deadlocked controller._abort_view
        # (await view.abort() -> await task -> parked here forever; the
        # deposed leader of the chaos censor round hung so).  On abort the
        # decision stays queued: it is committed, and the controller loop
        # delivers it once the abort has finished.
        decide = create_logged_task(
            self.decider.decide(proposal, signatures, requests),
            name=f"view-decide-{self.self_id}-{self.proposal_sequence - 1}",
            logger=self.logger,
        )
        if self._abort_wait_task is None or self._abort_wait_task.done():
            self._abort_wait_task = create_logged_task(
                self._abort_event.wait(),
                name=f"view-abortwait-{self.self_id}", logger=self.logger,
            )
        await asyncio.wait(
            {decide, self._abort_wait_task}, return_when=asyncio.FIRST_COMPLETED
        )
        if not decide.done():
            raise ViewAborted()
        decide.result()

    def _start_next_seq(self) -> None:
        """Pipeline swap: next-* become current (view.go:860-894)."""
        prev_seq = self.proposal_sequence
        self.proposal_sequence += 1
        self.decisions_in_view += 1
        if self.metrics:
            self.metrics.proposal_sequence.set(self.proposal_sequence)
            self.metrics.decisions_in_view.set(self.decisions_in_view)
        self.logger.infof("Sequence: %d-->%d", prev_seq, self.proposal_sequence)

        self._pre_prepare = self._next_pre_prepare
        self._next_pre_prepare = None

        self.prepares, self.next_prepares = self.next_prepares, self.prepares
        self.next_prepares.clear()

        self.commits, self.next_commits = self.next_commits, self.commits
        self.next_commits.clear()

    # ------------------------------------------------------------------ verify

    async def _verify_proposal(
        self, proposal: Proposal, prev_commits: list[Signature]
    ) -> list:
        """view.go:553-607 — structural, metadata, verification-sequence,
        prev-commit-signature, and blacklist checks."""
        requests = self.verifier.verify_proposal(proposal)

        md = decode(ViewMetadata, proposal.metadata)

        if md.view_id != self.number:
            raise ValueError(f"invalid view number: expected {self.number} got {md.view_id}")
        if md.latest_sequence != self.proposal_sequence:
            raise ValueError(
                f"invalid proposal sequence: expected {self.proposal_sequence} got {md.latest_sequence}"
            )
        if md.decisions_in_view != self.decisions_in_view:
            raise ValueError(
                f"invalid decisions in view: expected {self.decisions_in_view} got {md.decisions_in_view}"
            )
        expected_seq = self.verifier.verification_sequence()
        if proposal.verification_sequence != expected_seq:
            raise ValueError(
                f"verification sequence mismatch: expected {expected_seq} got {proposal.verification_sequence}"
            )

        prepare_acks = await self._rotation.verify_prev_commit_signatures(
            prev_commits, expected_seq
        )
        self._rotation.verify_blacklist(
            prev_commits, expected_seq, list(md.black_list), prepare_acks
        )
        self._rotation.verify_prev_commit_digest(prev_commits, md)

        return requests

    # ------------------------------------------------------------------ assists

    def _handle_prev_seq_message(self, msg_seq: int, sender: int, m: Message) -> None:
        """Resend our previous prepare/commit to a lagging replica
        (view.go:718-756)."""
        if isinstance(m, PrePrepare):
            self.logger.warnf(
                "Got pre-prepare for sequence %d but we're in sequence %d",
                msg_seq, self.proposal_sequence,
            )
            return
        if isinstance(m, Prepare):
            if m.assist:
                return
            if self._prev_prepare_sent is not None:
                self.comm.send_consensus(sender, self._prev_prepare_sent)
        elif isinstance(m, Commit):
            if m.assist:
                return
            if self._prev_commit_sent is not None:
                self.comm.send_consensus(sender, self._prev_commit_sent)

    def _discover_if_sync_needed(self, sender: int, m: Message) -> None:
        """f+1 matching future commit votes trigger a sync (view.go:758-818)."""
        if not isinstance(m, Commit):
            return
        _, f = compute_quorum(self.n)
        threshold = f + 1
        self._last_voted_proposal_by_id[sender] = m
        if len(self._last_voted_proposal_by_id) < threshold:
            return
        counts: dict[_ProposalInfo, int] = {}
        for vote in self._last_voted_proposal_by_id.values():
            info = _ProposalInfo(digest=vote.digest, view=vote.view, seq=vote.seq)
            counts[info] = counts.get(info, 0) + 1
        for info, count in counts.items():
            if count < threshold:
                continue
            if info.view < self.number:
                continue
            if info.seq <= self.proposal_sequence and info.view == self.number:
                continue
            self.logger.warnf(
                "Seen %d votes for digest %s in view %d, sequence %d but I am in view %d and seq %d",
                count, info.digest, info.view, info.seq, self.number, self.proposal_sequence,
            )
            self._stop()
            self.synchronizer.sync()
            return

    # ------------------------------------------------------------------ leader

    def get_metadata(self) -> bytes:
        """Build the next proposal's ViewMetadata incl. blacklist update and
        prev-commit-signature digest (view.go:896-948)."""
        metadata = ViewMetadata(
            view_id=self.number,
            latest_sequence=self.proposal_sequence,
            decisions_in_view=self.decisions_in_view,
        )
        return encode(self._rotation.build_leader_metadata(metadata))

    def propose(self, proposal: Proposal) -> None:
        """Leader: wrap as pre-prepare and self-deliver first so the WAL
        records it before the broadcast (view.go:951-977)."""
        prev_sigs: list[Signature] = []
        if self.decisions_per_leader > 0:
            _, prev_sigs = self.retrieve_checkpoint()
        pp = PrePrepare(
            view=self.number,
            seq=self.proposal_sequence,
            proposal=proposal,
            prev_commit_signatures=list(prev_sigs),
        )
        self.handle_message(self.leader_id, pp)
        self.logger.debugf(
            "Proposing proposal sequence %d in view %d", self.proposal_sequence, self.number
        )

    # ------------------------------------------------------------------ misc

    def _now(self) -> float:
        return time.monotonic()
