"""Pipelined in-flight window: k sequences outstanding at once.

No reference counterpart — this is the one deliberate protocol DEPARTURE
from the upstream SmartBFT code (SURVEY §7(c) anticipated it).  The reference keeps
exactly one sequence in flight: the leader re-acquires the propose token
only after the current decision delivers (controller.go:555-557) and the
View pipelines only vote *collection* one sequence ahead
(view.go:107-113,860-894).  On an accelerator whose fixed per-launch cost
dominates the quorum-verification kernel, that shape pays one launch per
decision, strictly serialized — the launch floor can never be amortized.

:class:`WindowedView` runs a window of up to ``2k`` per-sequence slots,
each a miniature three-phase machine (pre-prepare -> prepare -> commit),
with three global invariants that keep the safety argument inductive:

* **In-order prepare-send**: a slot persists its ProposedRecord and sends
  its prepare only after every lower slot did (WAL suffix stays ordered,
  so crash restore rebuilds the window unambiguously).
* **In-order commit-send**: a slot signs/broadcasts its commit only after
  every lower slot did.  Hence a commit quorum at seq s implies quorum
  commit-sends at every s' < s, and the multi-in-flight view change
  (viewchanger.check_in_flight_ladder) inherits the single-slot quorum-
  intersection argument rung by rung.
* **In-order delivery**: slot s hands its decision to the Controller only
  after s-1 delivered (the reference's decide rendezvous, unchanged).

Commit-signature verification is NOT ordered: each slot flushes its quorum
wave as an independent task through ``verify_consenter_sigs_batch_async``,
so the waves of k consecutive sequences sit in the coalescer concurrently
and merge into ONE device launch — the cross-decision batching axis that
divides the launch floor by the window depth.

**Launch-shadow overlap.**  The propose window is TWO windows deep: the
leader fills the base window [low, low+k) unconditionally, and once every
base-window slot has staged its commit — the point where the only work
left in the base window is the device verify wave plus in-order delivery
— it keeps proposing into the shadow region [low+k, low+2k).  The shadow
sequences run their whole protocol plane (pre-prepare, prepares, commit
staging) UNDER the in-flight launch, and their verify waves accumulate in
the coalescer, flushing the moment the device frees.  Without the shadow
the protocol plane idles for the full launch duration at every window
boundary, so the launch cost is serialized with the protocol cost instead
of hidden behind it.  When shadow capacity opens without a delivery the
view notifies the Controller through the ``capacity_cb`` seam so the
leader token re-arms (``Controller.on_window_capacity``).  Message intake
accepts sequences up to 3k ahead of the delivery frontier — one extra
window of skew tolerance for replicas whose frontier trails the
leader's — so slot memory is bounded by 3k slots.

**Window-granular rotation** (``rotation_granularity='window'``): the
reference rotation protocol chains each pre-prepare to the PREVIOUS
decision's commit certificate (view.go:606-647,1022-1062), which a
pipelined leader does not hold yet — so per-decision chaining and
pipelining are mutually exclusive.  Instead of abandoning rotation, the
windowed view anchors the chain on the LAST DECISION OF EACH WINDOW: only
the first pre-prepare of a window carries prev-commit signatures (the
previous window's anchor certificate, read from the checkpoint) plus the
recomputed blacklist; every other proposal in the window carries the SAME
blacklist and an empty certificate, which followers enforce.  Window
boundaries are defined by the cluster-agreed per-view decision count
(``decisions_in_view % k == 0``), so they are identical on every replica
— including one that crash-restarts mid-window or joins by sync.  The
cost: the pipeline drains at each window boundary (the anchor must
DELIVER before the next window's first proposal can be built or
verified), so the launch shadow does not cross boundaries in rotation
mode.  ``decisions_per_leader`` is interpreted in windows — config
pre-multiplies it into decisions (Configuration.
effective_decisions_per_leader) so every get_leader_id/blacklist
computation stays reference-shaped.  With rotation off
(``decisions_per_leader == 0``) the blacklist is empty by protocol and
pre-prepares carry no prev-commit signatures, which this class enforces.

WAL truncation cadence: a ProposedRecord carries the truncate mark only
when its sequence IS the delivery frontier (mid-window records must
survive a crash for restore to rebuild the ladder).  Under sustained
saturation the frontier-aligned append would otherwise never land, so the
view bounds segment growth itself: after ``max(8k, 64)`` consecutive
non-truncating saves it stops admitting new proposals (``_drain_pending``)
until the window drains; the next proposal then lands at the delivery
frontier with the truncate mark, old segments are deleted at the next
file rotation, and proposing resumes.  The cost is one window's latency
every few dozen decisions; any natural load dip truncates for free and
resets the counter.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field, replace
from typing import Optional

from ..api import Logger, Signer, Verifier
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
from ..types import (
    VerifyPlaneDown,
    blacklist_of,
    cached_view_metadata,
    proposal_digest,
)
from ..metrics import current_plane
from .rotation import RotationState
from .state import ABORT, COMMITTED, PREPARED, PROPOSED
from .util import SignerIndex, VoteSet, compute_quorum, iter_bits
from ..utils.tasks import create_logged_task
from .view import (
    ViewAborted,
    ViewSequence,
    ViewSequencesHolder,
    proposal_sequence_of_msg,
    verify_sigs_batch,
    view_number_of_msg,
)

#: slot-local pseudo-phase: quorum of valid commits collected, awaiting
#: in-order delivery (the single-slot View has no equivalent state — it
#: delivers immediately)
READY = 100


@dataclass
class _Slot:
    seq: int
    #: shared per-cluster SignerIndex: the slot's vote sets and masks all
    #: key on the same dense bit layout (integer ops, no hashing)
    index: Optional[SignerIndex] = None
    phase: int = COMMITTED
    pre_prepare: Optional[PrePrepare] = None
    proposal: Optional[Proposal] = None
    digest: str = ""
    requests: list = field(default_factory=list)
    prepares: VoteSet = None  # type: ignore[assignment]
    commits: VoteSet = None  # type: ignore[assignment]
    prepare_sent: Optional[Prepare] = None
    commit_sent: Optional[Commit] = None
    my_sig: Optional[Signature] = None
    prepare_voters: list[int] = field(default_factory=list)
    prepares_taken_mask: int = 0
    commits_taken_mask: int = 0
    pending_sigs: list = field(default_factory=list)
    seen_mask: int = 0  # signers with an accepted (verified-valid) commit
    valid_sigs: list = field(default_factory=list)
    verify_inflight: bool = False
    verify_failures: int = 0
    begin: float = 0.0

    def __post_init__(self):
        self.prepares = VoteSet(
            lambda _s, m: isinstance(m, Prepare), self.index
        )

        def accept_commit(sender: int, m: Message) -> bool:
            if not isinstance(m, Commit) or m.signature is None:
                return False
            return m.signature.signer == sender  # view.go:160-171

        self.commits = VoteSet(accept_commit, self.index)


@dataclass(frozen=True)
class _ProposalInfo:
    digest: str
    view: int
    seq: int


class WindowedView:
    """Drop-in View replacement for ``pipeline_depth >= 2`` (static leader
    or window-granular rotation).

    Same interface the Controller and ViewChanger consume: handle_message /
    start / abort / stopped / propose / get_metadata / get_leader_id plus
    the ``phase`` / ``proposal_sequence`` / ``number`` attributes.
    """

    #: WAL-drain trigger: consecutive non-truncating saves before proposing
    #: pauses for one window so a truncating append can land.  None derives
    #: max(8 * window, 64); tests/deployments override the class attribute
    #: to tighten the segment-growth bound.
    DRAIN_AFTER_SAVES: Optional[int] = None

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
        proposal_sequence: int,
        decisions_in_view: int,
        state,
        retrieve_checkpoint,
        view_sequences: ViewSequencesHolder,
        window: int,
        in_flight=None,
        metrics_view: Optional[ViewMetrics] = None,
        capacity_cb=None,
        decisions_per_leader: int = 0,
        membership_notifier=None,
        metrics_blacklist: Optional[BlacklistMetrics] = None,
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
        self.proposal_sequence = proposal_sequence  # lowest undelivered seq
        self.decisions_in_view = decisions_in_view
        self.state = state
        self.retrieve_checkpoint = retrieve_checkpoint
        self.view_sequences = view_sequences
        self.window = max(2, int(window))
        self.in_flight = in_flight
        self.metrics = metrics_view
        # flight recorder: per-slot quorum-completion + WAL-persist marks
        # for the critical-path decomposition (obs.critpath); the nop
        # singleton keeps every site at one attribute read when off
        from ..obs.recorder import NOP_RECORDER

        self.recorder = recorder if recorder is not None else NOP_RECORDER
        #: one dense signer-id index shared by every slot's vote sets
        self._signer_index = SignerIndex(nodes_list)
        #: called (no args) when propose capacity re-opens WITHOUT a
        #: delivery — the launch-shadow gate unlocking, or a WAL drain
        #: completing; the Controller re-arms the leader token on it
        self.capacity_cb = capacity_cb

        # reference-anchored bookkeeping for metadata checks: the expected
        # decisions_in_view of seq s is start_dec + (s - start_seq)
        self._start_seq = proposal_sequence
        self._start_dec = decisions_in_view

        # window-granular rotation (decisions_per_leader is the EFFECTIVE
        # per-decision value, i.e. config decisions_per_leader x window)
        self.decisions_per_leader = decisions_per_leader
        self.rotation = decisions_per_leader > 0
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
        # the blacklist established by the current window's FIRST proposal:
        # followers require every later proposal in the window to match it
        # (_staged_blacklist tracks the staging frontier) and the leader
        # stamps it into mid-window metadata (_proposing_blacklist).  Both
        # seed from the checkpoint — mid-window (re)starts land between two
        # boundary recomputations, and every delivered proposal of a window
        # carries that window's blacklist, so the checkpoint metadata IS the
        # current window blacklist.
        ckpt_bl: list[int] = []
        if self.rotation:
            ckpt_prop, _ = retrieve_checkpoint()
            if ckpt_prop is not None:
                ckpt_bl = blacklist_of(ckpt_prop)
        self._staged_blacklist: list[int] = list(ckpt_bl)
        self._proposing_blacklist: list[int] = list(ckpt_bl)

        #: exposed for the Controller's init-phase logic; tracks the lowest
        #: undelivered slot (COMMITTED when none)
        self.phase = COMMITTED
        self.my_proposal_sig: Optional[Signature] = None  # per-slot; kept for API parity

        self.slots: dict[int, _Slot] = {}
        self._next_propose_seq = proposal_sequence  # leader only
        self._prepare_frontier = proposal_sequence - 1  # highest seq whose prepare was sent
        self._commit_frontier = proposal_sequence - 1  # highest seq whose commit was sent
        # per-seq history of our own prepare/commit for lagging-replica
        # assists (the single-slot View keeps exactly seq-1,
        # view.go:718-756; a window keeps its whole trailing edge)
        self._sent_history: dict[int, tuple[Optional[Prepare], Optional[Commit]]] = {}
        self._last_voted_proposal_by_id: dict[int, Commit] = {}

        # Direct synchronous ingest — no per-message queue.  Every task in
        # this process shares one event loop, so _process_msg (which never
        # awaits) is atomic with respect to the advance loop; routing a
        # message straight into its slot's vote set replaces the reference's
        # channel hop (view.go:274) and saves a queue put/get plus a task
        # wakeup per message — at n=64 that is ~12k hops per decision.
        # Memory stays bounded WITHOUT an inbox cap: vote sets dedup per
        # sender, pre-prepare slots are 1-per-seq, and the window holds at
        # most 3*window slots (base + launch shadow + intake skew).
        self._work = asyncio.Event()
        self._verify_results: list[tuple] = []
        self._aborted = False
        self._abort_event = asyncio.Event()
        # persistent abort sentinel for the decide rendezvous: created
        # lazily on first delivery, reused for every decision, cancelled
        # once in _run's teardown — the per-decision create+cancel pair
        # was a measurable fixed cost of the deliver segment
        self._abort_wait_task: Optional[asyncio.Task] = None
        self._task: Optional[asyncio.Task] = None
        self._verify_tasks: set[asyncio.Task] = set()
        self._restored_broadcasts: list[Message] = []

        # WAL segment-growth bound under saturation (module docstring): a
        # drain pauses proposing until the window empties so the next
        # ProposedRecord lands frontier-aligned with the truncate mark
        self._drain_after = self.DRAIN_AFTER_SAVES or max(8 * self.window, 64)
        self._saves_since_truncate = 0
        self._drain_pending = False
        self._could_accept = True  # last can_accept_more_proposals() edge

    # ------------------------------------------------------------------ life

    def start(self) -> None:
        self._task = create_logged_task(
            self._run(), name=f"wview-{self.self_id}-{self.number}",
            logger=self.logger,
        )

    def stopped(self) -> bool:
        return self._aborted

    def _stop(self) -> None:
        if not self._aborted:
            self._aborted = True
            self._work.set()
            self._abort_event.set()

    async def handle_message_async(self, sender: int, msg: Message) -> None:
        """Async-intake shim: direct ingest never blocks (memory is bounded
        by vote-set dedup + the slot window), so backpressure is a no-op."""
        self.handle_message(sender, msg)

    async def abort(self) -> None:
        """view.go:1000-1010 semantics; see View.abort for the cancellation
        contract."""
        self._stop()
        # depose-time plane warmth: waves this window already
        # handed to the coalescer flush + launch NOW instead of idling in
        # the coalescing window/hold while the view change runs — the
        # mesh keeps verifying through the depose and the flip lands on a
        # warm plane.  Cancelling our awaiting tasks below does not
        # cancel the launches themselves; verifiers without the seam
        # no-op.
        depose = getattr(self.verifier, "note_view_depose", None)
        if depose is not None:
            try:
                depose()
            except Exception as e:  # noqa: BLE001 — warmth is advisory
                self.logger.warnf("depose verify warm failed: %r", e)
        for t in list(self._verify_tasks):
            t.cancel()
        if self._task is not None:
            try:
                await self._task
            except asyncio.CancelledError:
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

    # ------------------------------------------------------------------ intake

    def handle_message(self, sender: int, msg: Message) -> None:
        if self._aborted:
            return
        try:
            self._process_msg(sender, msg)
        except ViewAborted:
            pass  # _stop() already latched; the run loop exits on its own
        except Exception as e:
            # contain ingest failures the way the old queued path's run-loop
            # handler did: tear the view down loudly instead of letting the
            # exception escape into the transport's receive loop
            self.logger.errorf(
                "WindowedView %d failed processing a message from %d: %r",
                self.number, sender, e,
            )
            self._stop()
        self._work.set()

    def ingest_batch(self, items) -> None:
        """Wave-batched intake: register a whole wave of (sender, msg)
        pairs — e.g. all n-1 prepares of a phase — in ONE call with ONE
        run-loop wakeup, instead of ~n handle_message call chains each
        setting the work event.  Direct ingest never blocks (vote-set dedup
        + the slot window bound memory), so the batch is synchronous."""
        if self._aborted:
            return
        t0 = time.perf_counter()
        try:
            for sender, msg in items:
                self._process_msg(sender, msg)
        except ViewAborted:
            pass
        except Exception as e:
            self.logger.errorf(
                "WindowedView %d failed processing a message batch: %r",
                self.number, e,
            )
            self._stop()
        current_plane().vote_reg_us += (time.perf_counter() - t0) * 1e6
        self._work.set()

    # ------------------------------------------------------------------ windows

    def _dec_of(self, seq: int) -> int:
        """Cluster-agreed decisions_in_view of ``seq`` (verified in
        _verify_proposal, so every replica derives the same value)."""
        return self._start_dec + (seq - self._start_seq)

    def _is_window_first(self, seq: int) -> bool:
        """Rotation mode: is ``seq`` the first decision of a window?  The
        grid is anchored on the per-view decision count, NOT on this view
        object's construction point — a mid-window crash-restart or sync
        constructs the view mid-grid and must agree with the cluster."""
        return self._dec_of(seq) % self.window == 0

    def _checkpoint_at(self, seq: int) -> bool:
        """True iff the checkpoint holds exactly the decision below ``seq``
        — the anchor a window-first pre-prepare chains to.  On the propose
        hot path, so the metadata decode rides the bounded cache."""
        prop, _ = self.retrieve_checkpoint()
        latest = 0
        if prop is not None and prop.metadata:
            latest = cached_view_metadata(prop.metadata).latest_sequence
        return latest == seq - 1

    # ------------------------------------------------------------------ leader

    def can_accept_more_proposals(self) -> bool:
        """Leader: may another proposal enter the window right now?

        Rotation off — base window [low, low+k) is always proposable, and
        the shadow region [low+k, low+2k) opens only once every base-window
        slot has staged its commit (commit frontier at the base edge): from
        that point the base window is waiting purely on the device wave +
        in-order delivery, so the next window's protocol plane runs in the
        shadow of the in-flight launch instead of idling behind it.

        Rotation on (window granularity) — proposing is confined to the
        delivery frontier's window: the next window's first pre-prepare
        chains to THIS window's anchor certificate, which exists only once
        the anchor has delivered (and the checkpoint advanced to it).  The
        pipeline therefore drains at each boundary; no launch shadow
        crosses it."""
        if self._aborted or self._drain_pending:
            return False
        nxt = self._next_propose_seq
        low = self.proposal_sequence
        if self.rotation:
            if self._dec_of(nxt) // self.window != self._dec_of(low) // self.window:
                return False
            if self._is_window_first(nxt) and not self._checkpoint_at(nxt):
                # the delivery frontier can run ahead of the checkpoint by
                # one decide rendezvous (proposal_sequence advances before
                # the controller delivers); the chain needs the certificate
                return False
            return True
        if nxt < low + self.window:
            return True
        if nxt >= low + 2 * self.window:
            return False
        return self._commit_frontier >= low + self.window - 1

    def get_metadata(self) -> bytes:
        """Metadata for the NEXT unproposed sequence (view.go:896-948).

        Rotation off: empty blacklist, no prev-commit digest.  Rotation on:
        a window-first sequence recomputes the blacklist from the anchor
        checkpoint and binds the anchor certificate digest (exactly the
        single-slot per-decision flow, once per window); mid-window
        sequences restate the window blacklist with no certificate."""
        nxt = self._next_propose_seq
        metadata = ViewMetadata(
            view_id=self.number,
            latest_sequence=nxt,
            decisions_in_view=self._dec_of(nxt),
        )
        if not self.rotation:
            return encode(metadata)
        if self._is_window_first(nxt):
            metadata = self._rotation.build_leader_metadata(metadata)
            self._proposing_blacklist = list(metadata.black_list)
        else:
            metadata = replace(metadata, black_list=list(self._proposing_blacklist))
        return encode(metadata)

    def propose(self, proposal: Proposal) -> None:
        """Leader: wrap as pre-prepare for the next window sequence and
        self-deliver first (WAL-first, view.go:951-977).  The broadcast to
        peers happens after the slot persists the ProposedRecord.  In
        rotation mode a window-first pre-prepare carries the previous
        window's anchor certificate (the checkpoint signatures)."""
        prev_sigs: list[Signature] = []
        if self.rotation and self._is_window_first(self._next_propose_seq):
            _, prev_sigs = self.retrieve_checkpoint()
        pp = PrePrepare(
            view=self.number,
            seq=self._next_propose_seq,
            proposal=proposal,
            prev_commit_signatures=list(prev_sigs),
        )
        self._next_propose_seq += 1
        if not self._aborted:
            try:
                self._process_msg(self.leader_id, pp)
            except ViewAborted:
                pass
            self._work.set()
        self.logger.debugf(
            "Proposing sequence %d in view %d (window %d..%d)",
            pp.seq, self.number, self.proposal_sequence, self._next_propose_seq - 1,
        )

    # ------------------------------------------------------------------ loop

    async def _run(self) -> None:
        try:
            for m in self._restored_broadcasts:
                self.comm.broadcast_consensus(m)
            self._restored_broadcasts = []
            while True:
                self._absorb_pending_verify_results()
                progressed = await self._advance()
                if self._aborted:
                    raise ViewAborted()
                if progressed:
                    continue
                if self._verify_results:
                    continue  # arrived during _advance's awaits
                await self._work.wait()
                self._work.clear()
                if self._aborted:
                    raise ViewAborted()
        except ViewAborted:
            pass
        except Exception as e:  # pragma: no cover - defensive
            self.logger.errorf("WindowedView %d crashed: %r", self.number, e)
            raise
        finally:
            for t in list(self._verify_tasks):
                t.cancel()
            if self._abort_wait_task is not None:
                self._abort_wait_task.cancel()
                self._abort_wait_task = None
            self.view_sequences.store(
                ViewSequence(view_active=False, proposal_seq=self.proposal_sequence)
            )

    def _absorb_pending_verify_results(self) -> None:
        while self._verify_results:
            seq, sigs, results = self._verify_results.pop(0)
            self._absorb_verify_results(seq, sigs, results)

    # ------------------------------------------------------------------ routing

    def _process_msg(self, sender: int, m: Message) -> None:
        """view.go:194-261 adapted to a window of sequences; a lower-view
        message of the leader is dropped, as in :meth:`View._process_msg`."""
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

        low = self.proposal_sequence
        if msg_seq < low:
            self._handle_prev_seq_message(msg_seq, sender, m)
            return
        # intake span = propose span (2 windows: base + launch shadow) + one
        # window of frontier-skew tolerance, so a replica whose delivery
        # frontier trails the leader's still accepts shadow pre-prepares
        span = 3 * self.window
        if msg_seq >= low + span:
            self.logger.warnf(
                "%d got message from %d with sequence %d outside window [%d, %d)",
                self.self_id, sender, msg_seq, low, low + span,
            )
            self._discover_if_sync_needed(sender, m)
            return

        slot = self.slots.get(msg_seq)
        if slot is None:
            slot = self.slots[msg_seq] = _Slot(
                seq=msg_seq, index=self._signer_index
            )

        if isinstance(m, PrePrepare):
            if m.proposal is None:
                self.logger.warnf(
                    "%d got pre-prepare from %d with empty proposal", self.self_id, sender
                )
                return
            if sender != self.leader_id:
                self.logger.warnf(
                    "%d got pre-prepare from %d but the leader is %d",
                    self.self_id, sender, self.leader_id,
                )
                return
            if slot.pre_prepare is None and slot.phase == COMMITTED:
                slot.pre_prepare = m
            return

        if sender == self.self_id:
            return  # own votes are implicit (view.go:238-241)

        if isinstance(m, Prepare):
            slot.prepares.register_vote(sender, m)
            # in-window assist (the windowed analogue of view.go:718-756):
            # each broadcast is one-shot here, so a peer still collecting
            # prepares at a sequence we have already COMMITTED on likely
            # lost ours — resend it directly.  Gating on our phase being
            # ahead keeps steady-state traffic clean: in lockstep operation
            # prepares arrive while we are still in PROPOSED ourselves.
            if (
                not m.assist
                and slot.phase in (PREPARED, READY)
                and slot.prepare_sent is not None
            ):
                self.comm.send_consensus(sender, slot.prepare_sent)
        elif isinstance(m, Commit):
            slot.commits.register_vote(sender, m)
            if (
                not m.assist
                and slot.phase == READY
                and slot.commit_sent is not None
            ):
                self.comm.send_consensus(sender, slot.commit_sent)

    # ------------------------------------------------------------------ advance

    async def _advance(self) -> bool:
        """Run every enabled state transition once; True if any fired.

        Transitions are attempted lowest-sequence-first so the in-order
        invariants (prepare-send, commit-send, delivery) fall out of the
        iteration order plus the frontier guards."""
        progressed = False
        # Stage -> one durability wave -> finalize: each ready slot's WAL
        # record is WRITTEN during staging (record order = staged order =
        # sequence order, keeping the in-order save invariants), then ALL
        # staged records await one shared fsync wave, then finalization
        # broadcasts in sequence order.  Sequentially awaiting per-slot
        # saves instead cost k wave round-trips per window.
        staged: list = []  # (durability_future_or_None, finalize)
        for seq in sorted(self.slots):
            slot = self.slots.get(seq)
            if slot is None:
                continue
            if (
                slot.phase == COMMITTED
                and slot.pre_prepare is not None
                and seq == self._prepare_frontier + 1
                # rotation: a window-first pre-prepare chains to the previous
                # window's anchor certificate — hold it until every lower
                # sequence has DELIVERED locally (the checkpoint then sits
                # exactly at the anchor, making the chain verifiable)
                and (
                    not self.rotation
                    or not self._is_window_first(seq)
                    or seq == self.proposal_sequence
                )
            ):
                staged.append(await self._stage_proposal(slot))
                progressed = True
            if (
                slot.phase == PROPOSED
                and seq == self._commit_frontier + 1
                and self._count_prepares(slot) >= self.quorum - 1
            ):
                staged.append(self._stage_commit(slot))
                progressed = True
            if slot.phase == PREPARED:
                self._maybe_flush_verify(slot)
        if staged:
            futs = [f for f, _ in staged if f is not None]
            if futs:
                await asyncio.gather(*futs)
            if self._aborted:
                raise ViewAborted()
            for _, finalize in staged:
                finalize()
        # wave-batched delivery: a commit burst (one network flush carrying
        # the whole window's commits) turns several consecutive slots READY
        # at once — deliver the entire in-order run in THIS pass instead of
        # paying one full _advance rescan per decision
        low = self.slots.get(self.proposal_sequence)
        while low is not None and low.phase == READY:
            await self._deliver(low)
            progressed = True
            low = self.slots.get(self.proposal_sequence)
        self.phase = self._lowest_phase()
        if self.metrics:
            self.metrics.phase.set(self.phase)
        # launch-shadow/drain edge: capacity can re-open WITHOUT a delivery
        # (the base window's last commit staged, or a drain completed) — the
        # Controller only re-arms the leader token on deliveries, so tell it
        can_now = self.can_accept_more_proposals()
        if (
            can_now
            and not self._could_accept
            and self.self_id == self.leader_id
            and self.capacity_cb is not None
        ):
            self.capacity_cb()
        self._could_accept = can_now
        return progressed

    def _lowest_phase(self) -> int:
        if self._aborted:
            return ABORT
        low = self.slots.get(self.proposal_sequence)
        if low is None:
            return COMMITTED
        return low.phase if low.phase != READY else PREPARED

    # -- phase 1: proposal --------------------------------------------------

    async def _stage_proposal(self, slot: _Slot):
        """COMMITTED -> PROPOSED for one slot (view.go:351-427), split into
        stage (verify + WAL write now) and finalize (sends, after the shared
        durability wave).  Async because a rotation-mode window-first slot
        batch-verifies the anchor certificate it chains to."""
        pp = slot.pre_prepare
        proposal = pp.proposal
        try:
            requests = await self._verify_proposal(slot, pp)
        except VerifyPlaneDown as e:
            # the verify PLANE is down, not the proposal: don't blame the
            # leader — escalate to sync and re-validate after recovery
            self.logger.errorf(
                "Verify plane down validating seq %d: %s; aborting view "
                "and syncing", slot.seq, e,
            )
            self.synchronizer.sync()
            self._stop()
            raise ViewAborted() from e
        except Exception as e:
            self.logger.warnf(
                "%d received bad proposal from %d at seq %d: %s",
                self.self_id, self.leader_id, slot.seq, e,
            )
            self.failure_detector.complain(self.number, False)
            self.synchronizer.sync()
            self._stop()
            raise ViewAborted() from e

        slot.proposal = proposal
        slot.digest = proposal_digest(proposal)
        slot.requests = requests
        slot.begin = time.monotonic()
        if self.metrics:
            self.metrics.count_txs_in_batch.set(len(requests))

        prepare = Prepare(view=self.number, seq=slot.seq, digest=slot.digest)
        # WAL-first: persist before any dependent send.  Truncation is safe
        # only when this slot is the whole window (all prior seqs
        # delivered) — mid-window the previous decisions' records must
        # survive a crash for restore to rebuild the ladder.
        truncate = slot.seq == self.proposal_sequence
        fut = self._write_state(ProposedRecord(pre_prepare=pp, prepare=prepare), truncate)
        self._prepare_frontier = slot.seq

        def finalize() -> None:
            if self.in_flight is not None:
                self.in_flight.store_proposal_at(slot.seq, proposal)
            slot.prepare_sent = replace(prepare, assist=True)
            slot.phase = PROPOSED
            self._sent_history[slot.seq] = (slot.prepare_sent, None)
            if self.self_id == self.leader_id:
                self.comm.broadcast_consensus(pp)
            self.comm.broadcast_consensus(prepare)
            self.logger.infof("Processed proposal with seq %d", slot.seq)

        return fut, finalize

    async def _verify_proposal(self, slot: _Slot, pp: PrePrepare) -> list:
        """view.go:553-607 adapted to the window: structural + metadata
        checks for every slot; certificate-chain + blacklist verification at
        window boundaries (rotation mode) or rotation-off invariants."""
        proposal = pp.proposal
        requests = self.verifier.verify_proposal(proposal)
        md = decode(ViewMetadata, proposal.metadata)
        if md.view_id != self.number:
            raise ValueError(f"invalid view number: expected {self.number} got {md.view_id}")
        if md.latest_sequence != slot.seq:
            raise ValueError(
                f"invalid proposal sequence: expected {slot.seq} got {md.latest_sequence}"
            )
        expected_dec = self._dec_of(slot.seq)
        if md.decisions_in_view != expected_dec:
            raise ValueError(
                f"invalid decisions in view: expected {expected_dec} got {md.decisions_in_view}"
            )
        expected_seq = self.verifier.verification_sequence()
        if proposal.verification_sequence != expected_seq:
            raise ValueError(
                f"verification sequence mismatch: expected {expected_seq} "
                f"got {proposal.verification_sequence}"
            )
        if not self.rotation:
            # rotation-off invariants (config.validate pins
            # decisions_per_leader to 0 then): no blacklist, no chaining
            if list(md.black_list):
                raise ValueError(
                    f"rotation is inactive but blacklist is not empty: {list(md.black_list)}"
                )
            if pp.prev_commit_signatures:
                raise ValueError(
                    "pipelined mode forbids prev commit signatures in pre-prepares"
                )
            return requests

        if self._is_window_first(slot.seq):
            # window boundary: the staging gate held this slot until every
            # lower sequence delivered, so the checkpoint is exactly the
            # anchor this pre-prepare chains to — the single-slot
            # per-decision verification applies verbatim
            prev_commits = list(pp.prev_commit_signatures)
            prepare_acks = await self._rotation.verify_prev_commit_signatures(
                prev_commits, expected_seq
            )
            self._rotation.verify_blacklist(
                prev_commits, expected_seq, list(md.black_list), prepare_acks
            )
            self._rotation.verify_prev_commit_digest(prev_commits, md)
            self._staged_blacklist = list(md.black_list)
        else:
            # mid-window: no certificate (it does not exist yet) and the
            # blacklist must restate the one the window's first proposal
            # established (staging is in-order, so it is already verified)
            if pp.prev_commit_signatures:
                raise ValueError(
                    "mid-window pre-prepares must not carry prev commit signatures"
                )
            if md.prev_commit_signature_digest:
                raise ValueError(
                    "mid-window pre-prepares must not bind a prev commit digest"
                )
            if list(md.black_list) != self._staged_blacklist:
                raise ValueError(
                    f"mid-window blacklist {list(md.black_list)} differs from the "
                    f"window blacklist {self._staged_blacklist}"
                )
        return requests

    # -- phase 2: prepares --------------------------------------------------

    def _count_prepares(self, slot: _Slot) -> int:
        # incremental bitmask sweep: only signers not counted yet — the
        # common case (no new votes) is one AND + one compare, no iteration
        vs = slot.prepares
        new = vs.mask & ~slot.prepares_taken_mask
        if new:
            slot.prepares_taken_mask |= new
            for idx in iter_bits(new):
                prepare: Prepare = vs.payloads[idx]
                if prepare.digest != slot.digest:
                    self.logger.warnf(
                        "Got wrong digest at processPrepares for prepare with seq %d",
                        prepare.seq,
                    )
                    continue
                slot.prepare_voters.append(vs.signer_id(idx))
        return len(slot.prepare_voters)

    def _stage_commit(self, slot: _Slot):
        """PROPOSED -> PREPARED for one slot (view.go:441-517), stage/
        finalize split like _stage_proposal.  Every arrived prepare is
        already registered (direct ingest), so the witness sweep is just the
        counting pass (PreparesFrom is liveness evidence)."""
        self._count_prepares(slot)
        rec = self.recorder
        if rec.enabled:
            # ingest-wave granularity, like View._process_prepares: ties
            # within the quorum-completing sweep resolve in signer-index
            # order
            rec.record(
                "quorum.prepare", view=self.number, seq=slot.seq,
                # quorum == 1: no peer votes, no voter to name (the [-1]
                # empty-list index would crash the view otherwise)
                extra={"slowest_voter":
                       slot.prepare_voters[self.quorum - 2]
                       if self.quorum >= 2
                       and len(slot.prepare_voters) >= self.quorum - 1
                       else -1,
                       "voters": len(slot.prepare_voters)},
            )
        prp_from = encode(PreparesFrom(ids=slot.prepare_voters))
        sig = self.signer.sign_proposal(slot.proposal, prp_from)
        slot.my_sig = sig
        commit = Commit(
            view=self.number,
            seq=slot.seq,
            digest=slot.digest,
            signature=Signature(signer=sig.signer, value=sig.value, msg=sig.msg),
        )
        fut = self._write_state(CommitRecord(commit=commit), truncate=False)
        self._commit_frontier = slot.seq

        def finalize() -> None:
            if rec.enabled:
                # runs after the shared durability wave: the commit
                # record is on disk (the WAL-first rule), so this is the
                # wal_persist mark of the critical path
                rec.record("wal.persist", view=self.number, seq=slot.seq)
            if self.in_flight is not None:
                self.in_flight.store_prepares_at(slot.seq)
            slot.commit_sent = replace(commit, assist=True)
            slot.phase = PREPARED
            prev_p, _ = self._sent_history.get(slot.seq, (None, None))
            self._sent_history[slot.seq] = (prev_p, slot.commit_sent)
            self.comm.broadcast_consensus(commit)
            self.logger.infof("Processed prepares for proposal with seq %d", slot.seq)

        return fut, finalize

    # -- phase 3: commits (concurrent verification) -------------------------

    def _maybe_flush_verify(self, slot: _Slot) -> None:
        """Quorum-feasibility flush (View._process_commits policy), but as
        an independent task per slot: k slots' waves sit in the coalescer
        concurrently and merge into one device launch."""
        if slot.phase != PREPARED:
            return
        # drain newly registered votes into the slot's pending pool
        # (incremental bitmask sweep — integer ops on the hot path)
        vs = slot.commits
        new = vs.mask & ~slot.commits_taken_mask
        if new:
            slot.commits_taken_mask |= new
            for idx in iter_bits(new):
                commit: Commit = vs.payloads[idx]
                if commit.digest != slot.digest:
                    self.logger.warnf("Got wrong digest at processCommits for seq %d", commit.seq)
                    continue
                if slot.seen_mask >> idx & 1:
                    continue
                slot.pending_sigs.append(commit.signature)
        if slot.verify_inflight or not slot.pending_sigs:
            return
        # quorum-feasibility flush policy (View._process_commits): launch
        # only when the batch could complete the quorum
        if len(slot.valid_sigs) + len(slot.pending_sigs) < self.quorum - 1:
            return
        pending, slot.pending_sigs = slot.pending_sigs, []
        slot.verify_inflight = True
        proposal = slot.proposal
        seq = slot.seq

        async def run():
            try:
                results = await verify_sigs_batch(
                    self.verifier, pending, proposal, self.logger
                )
            except Exception as e:
                results = e
            if not self._aborted:
                self._verify_results.append((seq, pending, results))
                self._work.set()

        t = create_logged_task(
            run(), name=f"wview-verify-{self.self_id}-{seq}", logger=self.logger
        )
        self._verify_tasks.add(t)
        t.add_done_callback(self._verify_tasks.discard)

    def _absorb_verify_results(self, seq: int, sigs, results) -> None:
        slot = self.slots.get(seq)
        if slot is None:
            return
        slot.verify_inflight = False
        if isinstance(results, Exception):
            slot.verify_failures += 1
            plane_down = isinstance(results, VerifyPlaneDown)
            self.logger.warnf(
                "Batched commit verification failed for seq %d (attempt %d): %r",
                seq, slot.verify_failures, results,
            )
            if plane_down or slot.verify_failures >= 3:
                # VerifyPlaneDown means the coalescer already exhausted its
                # deadline+retry budget AND the host fallback — escalate at
                # once; other engine failures get a few view-level retries
                # first.  Either way: sync instead of killing the view task.
                self.logger.errorf(
                    "Verify plane %s at seq %d; aborting view and syncing",
                    "down (retries + host fallback exhausted)" if plane_down
                    else "failing persistently", seq,
                )
                self._stop()
                self.synchronizer.sync()
                return
            # the engine call failed (not the signatures): re-pool the
            # candidates for a retry on the next flush attempt
            index = self._signer_index
            slot.pending_sigs.extend(
                s for s in sigs
                if index.index_of(s.signer) < 0
                or not (slot.seen_mask >> index.index_of(s.signer) & 1)
            )
            return
        slot.verify_failures = 0
        index = self._signer_index
        for sig, aux in zip(sigs, results):
            if aux is None:
                self.logger.warnf("Couldn't verify %d's signature", sig.signer)
                continue
            idx = index.index_of(sig.signer)
            if idx < 0:
                continue  # not a member (cannot complete any quorum)
            bit = 1 << idx
            if slot.seen_mask & bit:
                continue
            # cap at exactly quorum-1 (certificate-size determinism; see
            # View._process_commits)
            if len(slot.valid_sigs) >= self.quorum - 1:
                break
            slot.seen_mask |= bit
            slot.valid_sigs.append(sig)
        if slot.valid_sigs and len(slot.valid_sigs) >= self.quorum - 1 and slot.phase == PREPARED:
            slot.phase = READY
            rec = self.recorder
            if rec.enabled:
                rec.record(
                    "quorum.commit", view=self.number, seq=seq,
                    extra={"slowest_voter": slot.valid_sigs[-1].signer},
                )
            self.logger.infof(
                "%d collected %d commits for seq %d from %s",
                self.self_id, len(slot.valid_sigs), seq,
                sorted(s.signer for s in slot.valid_sigs),
            )

    # -- delivery -----------------------------------------------------------

    async def _deliver(self, slot: _Slot) -> None:
        """In-order decide rendezvous with the Controller (view.go:851-858)."""
        self.logger.infof("Deciding on seq %d", slot.seq)
        if self.metrics:
            self.metrics.count_batch_all.add(1)
            self.metrics.count_txs_all.add(len(slot.requests))
            self.metrics.latency_batch_processing.observe(time.monotonic() - slot.begin)
        signatures = list(slot.valid_sigs) + [slot.my_sig]
        self.my_proposal_sig = slot.my_sig
        del self.slots[slot.seq]
        self.proposal_sequence = slot.seq + 1
        self.decisions_in_view += 1
        if self.metrics:
            self.metrics.proposal_sequence.set(self.proposal_sequence)
            self.metrics.decisions_in_view.set(self.decisions_in_view)
        self.view_sequences.store(
            ViewSequence(view_active=True, proposal_seq=self.proposal_sequence)
        )
        if self.in_flight is not None:
            self.in_flight.clear_below(self.proposal_sequence)
        # prune assist history beyond the window's trailing edge: a correct
        # replica can lag by up to the window depth, so keep a full window
        # of delivered sequences servable
        floor = slot.seq - self.window
        for s in [s for s in self._sent_history if s < floor]:
            del self._sent_history[s]
        if self._drain_pending and not self.slots:
            # WAL drain complete: the window is empty, so the next proposal
            # is frontier-aligned and its ProposedRecord truncates
            self._drain_pending = False
            self.logger.infof(
                "WindowedView %d: window drained at seq %d, proposing resumes "
                "with a truncating append", self.number, slot.seq,
            )
        # Race the decide rendezvous against abort: the controller resolves
        # the decision future from the SAME loop that processes abort events,
        # so a view parked here while an abort is dequeued ahead of its
        # decision would deadlock controller._abort_view (await view.abort()
        # -> await task -> parked here forever).  On abort the decision stays
        # queued — it is committed, and the controller loop (or its shutdown
        # drain) completes the rendezvous after the abort finishes.
        decide = create_logged_task(
            self.decider.decide(slot.proposal, signatures, slot.requests),
            name=f"wview-decide-{self.self_id}-{slot.seq}", logger=self.logger,
        )
        if self._abort_wait_task is None or self._abort_wait_task.done():
            self._abort_wait_task = create_logged_task(
                self._abort_event.wait(),
                name=f"wview-abortwait-{self.self_id}", logger=self.logger,
            )
        await asyncio.wait(
            {decide, self._abort_wait_task}, return_when=asyncio.FIRST_COMPLETED
        )
        if not decide.done():
            # abandoned rendezvous: create_logged_task's observer retrieves
            # (and loudly logs) any eventual failure of the orphaned decide
            raise ViewAborted()
        decide.result()  # propagate decide failures like the plain await did
        if self._aborted:
            raise ViewAborted()

    # ------------------------------------------------------------------ misc

    def _write_state(self, msg, truncate: bool):
        """Write a SavedMessage now; return its durability future (None when
        the write was synchronously durable — blocking WAL or test double)."""
        if truncate:
            self._saves_since_truncate = 0
        else:
            self._saves_since_truncate += 1
            if (
                self._saves_since_truncate >= self._drain_after
                and not self._drain_pending
            ):
                # bound WAL segment growth under saturation: stop admitting
                # proposals until the window drains, so the next proposal
                # lands frontier-aligned with the truncate mark
                self._drain_pending = True
                self.logger.infof(
                    "WindowedView %d: %d saves since last WAL truncation, "
                    "draining the window for a truncating append",
                    self.number, self._saves_since_truncate,
                )
        save_nowait = getattr(self.state, "save_nowait", None)
        if save_nowait is not None:
            return save_nowait(msg, truncate=truncate)
        self.state.save(msg, truncate=truncate)
        return None

    def _handle_prev_seq_message(self, msg_seq: int, sender: int, m: Message) -> None:
        """Lagging-replica assists over the window's trailing edge
        (view.go:718-756)."""
        if isinstance(m, PrePrepare):
            return
        hist = self._sent_history.get(msg_seq)
        if hist is None:
            return
        prev_prepare, prev_commit = hist
        if isinstance(m, Prepare) and not m.assist and prev_prepare is not None:
            self.comm.send_consensus(sender, prev_prepare)
        elif isinstance(m, Commit) and not m.assist and prev_commit is not None:
            self.comm.send_consensus(sender, prev_commit)

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
            if info.seq < self.proposal_sequence + 3 * self.window and info.view == self.number:
                continue  # inside the intake span: not fell-behind evidence
            self.logger.warnf(
                "Seen %d votes for digest %s in view %d, sequence %d but I am in view %d and seq %d",
                count, info.digest, info.view, info.seq, self.number, self.proposal_sequence,
            )
            self._stop()
            self.synchronizer.sync()
            return

    # ------------------------------------------------------------------ restore

    def restore_window(self, records: list) -> None:
        """Rebuild the window from the WAL suffix after a crash.

        ``records`` are the parsed SavedMessages in append order.  The
        in-order save invariants make the suffix unambiguous: ProposedRecord
        seqs ascend, CommitRecord seqs ascend, and C(s) always follows P(s).
        Slots below ``proposal_sequence`` (the delivered frontier per the
        checkpoint) are skipped; restored slots re-enter PROPOSED/PREPARED
        and their prepare/commit are re-broadcast on start
        (state.go:155-247 generalized)."""
        low = self.proposal_sequence
        # Adopt the HIGHEST view present in the records, mirroring the
        # single-slot recovery (state.py _recover_proposed sets
        # view.number = pp.view): a view change's NewViewRecord may have
        # been truncated away by the new view's first proposal, leaving the
        # constructed view number one behind the records.  Filtering those
        # records out instead would forget broadcast commits — a fork risk
        # (the node's ViewData would under-report its in-flight ladder).
        record_views = [
            rec.pre_prepare.view
            for rec in records
            if isinstance(rec, ProposedRecord) and rec.pre_prepare is not None
        ]
        if record_views and max(record_views) > self.number:
            self.logger.infof(
                "WAL records are from view %d, adopting it (constructed with %d)",
                max(record_views), self.number,
            )
            self.number = max(record_views)
        by_seq: dict[int, dict] = {}
        for rec in records:
            if isinstance(rec, ProposedRecord) and rec.pre_prepare is not None:
                if rec.pre_prepare.view != self.number:
                    continue  # superseded by a later view's records
                by_seq.setdefault(rec.pre_prepare.seq, {})["P"] = rec
            elif isinstance(rec, CommitRecord) and rec.commit is not None:
                if rec.commit.view != self.number:
                    continue
                entry = by_seq.get(rec.commit.seq)
                if entry is None:
                    raise ValueError(
                        f"WAL holds a commit for seq {rec.commit.seq} without "
                        "a matching pre-prepare"
                    )
                entry["C"] = rec
        restored = 0
        for seq in sorted(by_seq):
            if seq < low:
                continue
            if seq != self._prepare_frontier + 1:
                break  # a gap: later records belong to an older window shape
            entry = by_seq[seq]
            pp: PrePrepare = entry["P"].pre_prepare
            slot = self.slots[seq] = _Slot(seq=seq, index=self._signer_index)
            slot.pre_prepare = pp
            slot.proposal = pp.proposal
            slot.digest = proposal_digest(pp.proposal)
            slot.begin = time.monotonic()
            slot.prepare_sent = replace(entry["P"].prepare, assist=True)
            slot.phase = PROPOSED
            self._prepare_frontier = seq
            self._sent_history[seq] = (slot.prepare_sent, None)
            self._restored_broadcasts.append(entry["P"].prepare)
            if self.in_flight is not None:
                self.in_flight.store_proposal_at(seq, pp.proposal)
            crec = entry.get("C")
            if crec is not None and seq == self._commit_frontier + 1:
                commit: Commit = crec.commit
                sig = commit.signature
                slot.my_sig = Signature(signer=sig.signer, value=sig.value, msg=sig.msg)
                slot.commit_sent = replace(commit, assist=True)
                slot.phase = PREPARED
                self._commit_frontier = seq
                self._sent_history[seq] = (slot.prepare_sent, slot.commit_sent)
                self._restored_broadcasts.append(commit)
                if self.in_flight is not None:
                    self.in_flight.store_prepares_at(seq)
            restored += 1
        self._next_propose_seq = max(self._next_propose_seq, self._prepare_frontier + 1)
        self.phase = self._lowest_phase()
        if restored and self.rotation:
            # the staging AND proposing frontiers resume mid-window: later
            # slots must restate the blacklist of the last restored
            # (already-verified) proposal, not the checkpoint's possibly
            # older one — a restored LEADER stamps _proposing_blacklist
            # into its next mid-window metadata, so both must advance
            last_slot = self.slots[self._prepare_frontier]
            if last_slot.proposal is not None and last_slot.proposal.metadata:
                self._staged_blacklist = list(
                    decode(ViewMetadata, last_slot.proposal.metadata).black_list
                )
                self._proposing_blacklist = list(self._staged_blacklist)
        if restored:
            self.logger.infof(
                "Restored %d pipelined slot(s), window %d..%d",
                restored, low, self._prepare_frontier,
            )
