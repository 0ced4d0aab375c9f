"""ShardSet: S independent consensus groups behind one front door.

The composition root of sharded mode (README "Sharded mode").  A shard is
an independent consensus group — its own membership, WAL directories, and
totally-ordered chain — and the ShardSet owns everything that spans them:

* the client-facing **front door**: ``submit`` routes by client id through
  a deterministic :class:`~smartbft_tpu_torch.shard.router.ShardRouter` and
  forwards into the owning shard's request pool (per-shard backpressure
  applies; ``occupancy`` exposes the combined surface);
* the **delivery multiplexer**: ``poll_committed`` drains each shard's
  newly committed decisions into one :class:`~smartbft_tpu_torch.shard.mux.
  DeliveryMux` stream, enforcing per-shard exactly-once/gapless, and
  prunes applied entries automatically behind a bounded retention window;
* the **epoch state machine**: ``reshard`` grows or shrinks the set UNDER
  LIVE TRAFFIC — the resize decision commits through each old shard's own
  ordered stream as a barrier command, moved key-ranges drain behind the
  barrier, the router flips atomically to the new epoch, and the mux
  stays gapless/exactly-once across the transition.  Every transition
  edge is journaled (:class:`~smartbft_tpu_torch.shard.epoch.EpochJournal`) so
  a coordinator crash mid-drain, mid-handoff, or mid-flip recovers into
  the correct epoch;
* **metrics roll-up**: ``stats_block`` emits per-shard blocks (decisions,
  committed requests, pool occupancy, protocol-plane delta) plus the
  aggregate, including the shared verify plane's cross-shard wave
  attribution when a coalescer is attached, and a ``reshard`` block
  (epoch, transition count, last transition's barriers/drain/pause).

The live-reshard contract at the front door: submits for UNMOVED clients
never notice a transition; submits for MOVED clients park until the flip
(they then route to their new shard) and raise the single loud
:class:`~smartbft_tpu_torch.shard.epoch.ShardEpochError` only when the bounded
drain deadline expires first.  There are still NO cross-shard
transactions — resharding moves key-ranges between groups, it does not
order across them.

The ShardSet is deliberately generic over a small shard-handle protocol
(duck-typed; see :class:`ShardHandle`) so the same front door drives the
in-process test harness (``testing.sharded.AppShard`` — n test Apps over
one group-namespaced network) and an embedder's production wiring (S
``Consensus`` facades over real transports).  What makes the set more
than S independent processes is the SHARED verify plane: every shard's
CryptoProvider is constructed over ONE ``AsyncBatchCoalescer`` /
``TorchVerifyEngine`` (each provider tagged with its shard id), so
prepare/commit verify waves from all shards coalesce into common device
launches — cross-shard fill is the throughput multiplier, and the fault
plane (deadline / retry / host-fallback breaker) degrades or recovers all
shards coherently because it IS one plane.
"""

from __future__ import annotations

import abc
import asyncio
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from .epoch import (
    RESHARD_CLIENT,
    EpochJournal,
    ShardEpochError,
    barrier_marker,
    recover_epochs,
)
from .mux import DeliveryMux, ShardStreamViolation
from .router import ShardRouter
from ..core.pool import (
    AdmissionRejected,
    ReqAlreadyExistsError,
    ReqAlreadyProcessedError,
    SubmitTimeoutError,
)
from ..metrics import CommitLatencyTracker
from ..utils.tasks import create_logged_task

__all__ = ["ShardHandle", "ShardSet"]


class ShardHandle(abc.ABC):
    """What the ShardSet needs from one consensus group.

    ``testing.sharded.AppShard`` is the in-process implementation; a
    production embedder wraps its per-shard ``Consensus`` facade + ledger
    the same way.  Implementations are matched by duck typing — this ABC
    documents the protocol and provides the registration hook."""

    shard_id: int

    @abc.abstractmethod
    async def start(self) -> None: ...

    @abc.abstractmethod
    async def stop(self) -> None: ...

    @abc.abstractmethod
    async def submit(self, raw_request: bytes) -> None:
        """Forward one raw request into this shard's pool (its leader's
        submit path: blocks on a full pool, raises on closed/no-leader)."""

    @abc.abstractmethod
    def poll_committed(self, since: int) -> list:
        """Committed decisions from chain position ``since`` (0-based) on,
        each as ``(seq, request_ids, decision)``."""

    @abc.abstractmethod
    def pool_occupancy(self) -> dict: ...

    def stats_block(self) -> dict:
        """Optional per-shard extras merged into the roll-up."""
        return {}

    # -- live-reshard surface (optional; reshard() requires them) ----------

    async def submit_barrier(self, epoch: int, old_shards: int,
                             new_shards: int) -> None:
        """Submit epoch ``epoch``'s barrier command into this shard's
        ordered stream (client ``epoch.RESHARD_CLIENT``, request id
        ``epoch.barrier_request_id(epoch)``, payload
        ``epoch.reshard_command_payload(...)`` in the embedder's request
        envelope).  MUST swallow the embedder's already-exists /
        already-processed dedup errors: a recovered coordinator
        re-submits, and the pool's client dedup makes that exactly-once."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support live reshard"
        )

    def pending_client_ids(self) -> Optional[set]:
        """Client ids with requests still pooled (un-committed) anywhere
        in this shard — the drain predicate's input.  None means the
        handle cannot report, and the drain falls back to barrier-only."""
        return None

    def ready(self) -> bool:
        """Can this shard serve submits (e.g. a leader is elected)?  The
        flip waits for every NEW group's readiness so released moved-key
        submitters land on a shard that can actually order them."""
        return True

    def space_waiters(self) -> int:
        """Submitters blocked in this shard's pool space-wait (their
        requests are in NO pool yet, so ``pending_client_ids`` cannot see
        them).  The drain must wait these out too: a waiter admitted
        after the flip would commit its request on the OLD shard — the
        wrong side.  Default reads the occupancy block."""
        occ = self.pool_occupancy() or {}
        return int(occ.get("waiters", 0))

    # -- read plane surface (optional) -------------------------------------

    def read_replies(self, key: str) -> Optional[list]:
        """Stamped committed-state read replies for ``key`` from this
        shard's replicas, as ``(sender, reply)`` pairs — the quorum
        fan-out's input (each reply exposes the ``core.readplane`` stamp
        fields).  None = this handle cannot serve reads."""
        return None

    def read_quorum_need(self) -> int:
        """Matching stamps that prove commitment for this shard's
        membership (``f+1``)."""
        return 1

    def note_read_outliers(self, outliers: list) -> None:
        """Attribute quorum-read outliers (``(sender, why)`` pairs that
        contradicted an accepted f+1 stamp) to the shard's misbehavior
        accounting — OBSERVED-only evidence, never a shun input (read
        replies are unsigned).  Default: unsupported, drop."""

    # -- snapshot handoff surface (optional) -------------------------------

    def capture_snapshot(self) -> Optional[dict]:
        """Donor side of the scale-out handoff: a JSON-able application
        snapshot of this shard's committed state (chained digests,
        committed count, recent request ids).  None = unsupported — new
        groups then start fresh, the pre-snapshot behavior."""
        return None

    def install_snapshot(self, snapshot: dict) -> None:
        """Receiver side: seed this NOT-YET-STARTED group from a donor's
        :meth:`capture_snapshot` so scale-out is O(1) in the donor's
        history (dedup memory armed, digests chained)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not accept snapshot handoff"
        )


@dataclass
class _Transition:
    """One in-flight epoch transition (the reshard coordinator's state)."""

    epoch: int
    old_s: int
    new_s: int
    deadline: float                       # wall-clock (time.monotonic)
    phase: str = "prepare"                # prepare|barrier|drain|flip
    barriers: dict = field(default_factory=dict)   # shard -> barrier seq
    barrier_submitted_at: dict = field(default_factory=dict)  # shard -> mono
    flip_event: asyncio.Event = field(default_factory=asyncio.Event)
    failed: Optional[str] = None
    parked: int = 0
    parked_peak: int = 0
    moved_cache: dict = field(default_factory=dict)
    started: float = field(default_factory=time.monotonic)
    drain_ms: float = 0.0

    def moved(self, router: ShardRouter, client_id) -> bool:
        key = str(client_id)
        if key == RESHARD_CLIENT:
            return False
        hit = self.moved_cache.get(key)
        if hit is None:
            hit = router.moved(client_id, self.old_s, self.new_s)
            self.moved_cache[key] = hit
        return hit


class ShardSet:
    """S shard handles + router + delivery mux + epoch machine behind one
    surface."""

    def __init__(self, shards: Sequence, router: Optional[ShardRouter] = None,
                 coalescer=None, *, journal: Optional[EpochJournal] = None,
                 drain_deadline: float = 30.0, retention: int = 4096,
                 on_deliver: Optional[Callable] = None,
                 on_deliver_batch: Optional[Callable] = None,
                 clock: Optional[Callable[[], float]] = None,
                 recorder=None):
        """``shards``: shard handles, one per group; their ``shard_id``
        must be 0..S-1 (the router's bucket space).  ``coalescer``: the
        SHARED AsyncBatchCoalescer all shards verify through — optional,
        but without it the set is just S processes glued together; with it
        ``stats_block`` reports the cross-shard wave mix and breaker
        state.  ``router`` defaults to a seed-0 ShardRouter over S.

        ``journal``: the epoch journal (None = transitions are not
        durable; fine for tests, not for a deployment that reshards).
        ``drain_deadline``: wall-clock seconds a transition may spend
        waiting for barriers + moved-range drain before it aborts and
        parked submits raise ShardEpochError.  ``retention``: max
        combined entries the mux keeps after they have been handed to the
        embedder (the automatic prune watermark); <= 0 disables pruning.
        ``clock``: time source for the per-request commit-latency tracker
        (default wall ``time.monotonic``; deterministic tests inject the
        logical ``Scheduler.now``)."""
        self.shards = {int(s.shard_id): s for s in shards}
        if sorted(self.shards) != list(range(len(shards))):
            raise ValueError(
                f"shard ids must be 0..{len(shards) - 1}, "
                f"got {sorted(self.shards)}"
            )
        self.router = router or ShardRouter(len(shards))
        if self.router.num_shards != len(shards):
            raise ValueError(
                f"router covers {self.router.num_shards} shards, "
                f"set has {len(shards)}"
            )
        self.coalescer = coalescer
        self.journal = journal
        self.drain_deadline = drain_deadline
        self.retention = retention
        self.mux = DeliveryMux(sorted(self.shards), on_deliver=on_deliver,
                               on_deliver_batch=on_deliver_batch)
        #: per-shard chain cursor for poll_committed
        self._chain_pos: dict[int, int] = {s: 0 for s in self.shards}
        #: shards retired by scale-in flips (stopped, history in the mux)
        self.retired: dict[int, object] = {}
        self.submitted = 0
        #: submit→commit latency + shed accounting (README "Overload
        #: behavior"): ``submit(..., request_key=...)`` stamps arrivals,
        #: ``poll_committed`` resolves them against the combined stream
        self.latency = CommitLatencyTracker(clock=clock)
        #: flight recorder for control-plane transitions (reshard epochs);
        #: the nop singleton when tracing is off (obs.recorder contract)
        from ..obs.recorder import NOP_RECORDER

        self.recorder = recorder if recorder is not None else NOP_RECORDER
        self._epoch = self.router.epoch
        self._next_epoch = self._epoch + 1
        self._transition: Optional[_Transition] = None
        self.reshard_stats: dict = {"transitions": 0, "aborts": 0,
                                    "last": None}
        #: front-door read accounting: quorum reads routed
        #: through :meth:`read` — served/no-quorum/outlier counts for the
        #: ``read`` stats block (per-replica serving counters live on the
        #: handles' replicas)
        self.read_stats: dict = {"reads": 0, "served": 0, "no_quorum": 0,
                                 "unsupported": 0, "outliers": 0}
        self._recovered: Optional[dict] = None
        if journal is not None:
            self._recover(journal)

    # -- journal recovery --------------------------------------------------

    def _recover(self, journal: EpochJournal) -> None:
        """Fold a journal replay into this (re)constructed set.

        Completed epochs re-anchor the epoch counter.  An incomplete
        transition that already journaled its FLIP took effect — the
        caller must have rebuilt the set with the new epoch's handles (we
        verify the count) and we complete it with a ``done``.  One that
        never flipped is aborted (its barrier markers, if any committed,
        are inert history; its epoch number stays burned)."""
        facts = recover_epochs(journal.replay())
        self._recovered = facts
        epoch = facts["epoch"]
        self._next_epoch = max(self._next_epoch, facts["next_epoch"])
        inc = facts["incomplete"]
        if not (inc is not None and inc["flipped"]) and epoch > 0 \
                and facts["shards"] is not None \
                and len(self.shards) != facts["shards"]:
            # a COMPLETED epoch pins the shard count just as hard as a
            # flipped-incomplete one: rebuilding with a stale count would
            # install a mapping that never existed as this epoch, letting
            # a moved client's pre-crash commit recommit elsewhere.  A
            # trailing UNFLIPPED prepare does not relax this — it aborts
            # below and the completed epoch's count still governs.
            raise ShardEpochError(
                f"journal says epoch {epoch} completed with "
                f"{facts['shards']} shards but the set was rebuilt with "
                f"{len(self.shards)} — recover with that epoch's handles"
            )
        if inc is not None:
            if inc["flipped"]:
                epoch = max(epoch, inc["epoch"])
                if len(self.shards) != inc["new"]:
                    raise ShardEpochError(
                        f"journal says epoch {inc['epoch']} flipped to "
                        f"{inc['new']} shards but the set was rebuilt with "
                        f"{len(self.shards)} — recover with the new epoch's "
                        f"handles"
                    )
                journal.append({"t": "done", "epoch": inc["epoch"]})
            else:
                journal.append({
                    "t": "abort", "epoch": inc["epoch"],
                    "reason": "coordinator recovery before flip",
                })
                self.reshard_stats["aborts"] += 1
        if epoch > self._epoch:
            # re-install the recovered epoch so route(epoch=...) history
            # has the correct anchor (mapping = current handle count)
            self.router.reshard(len(self.shards), epoch=epoch)
            self._epoch = epoch
            self.mux.begin_epoch(epoch, sorted(self.shards))
        self._next_epoch = max(self._next_epoch, self._epoch + 1)

    # -- basics ------------------------------------------------------------

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    @property
    def epoch(self) -> int:
        """The ACTIVE epoch this set routes in (the router may know newer
        installed epochs only transiently, mid-flip)."""
        return self._epoch

    @property
    def reshard_in_progress(self) -> bool:
        return self._transition is not None

    @property
    def reshard_phase(self) -> Optional[str]:
        return self._transition.phase if self._transition else None

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        for s in sorted(self.shards):
            await self.shards[s].start()

    async def stop(self) -> None:
        for s in sorted(self.shards):
            await self.shards[s].stop()
        if self.journal is not None:
            self.journal.close()

    # -- the front door ----------------------------------------------------

    def route(self, client_id) -> int:
        return self.router.route(client_id, epoch=self._epoch)

    async def submit(self, client_id, raw_request: bytes,
                     *, request_key: Optional[str] = None) -> int:
        """Route ``client_id``'s request to its owning shard (in the
        ACTIVE epoch) and forward into that shard's pool.  Returns the
        shard id it landed on.

        Backpressure is PER SHARD and real: a full pool parks this
        submitter exactly as a single-group deployment would (Pool.submit
        waits up to its TOTAL submit deadline, then sheds), and other
        shards' intake is unaffected — one hot shard cannot stall the
        set.  With ``admission_high_water`` configured on the shard's
        pool, an over-the-knee submit fails fast with
        :class:`~smartbft_tpu_torch.core.pool.AdmissionRejected` (retry-after
        hint attached) instead of queueing — both shed shapes are counted
        in ``latency.shed`` and re-raised to the caller.

        ``request_key``: the committed-stream id of this request (the
        ``str(RequestInfo)`` form, ``"client:request"``).  When given,
        the front door stamps submit→commit latency for it — arrival is
        stamped HERE, before any admission/park wait, so the measured
        latency is what the client experiences.

        During a live reshard, a client whose key-range is MOVING parks
        here until the epoch flips (then lands on its new shard); if the
        bounded drain deadline expires first, it gets ShardEpochError.
        Unmoved clients submit straight through the whole transition.
        Parked-at-barrier submitters are COUNTED in :meth:`occupancy`
        (``total_waiters`` / ``parked_moved``) — the admission gate and
        the autoscaler must see the same pressure the clients feel."""
        # fresh=False on a retry of a still-pending request: the ORIGINAL
        # stamp keeps measuring from the first submit, and a failure of
        # THIS attempt must not erase it (the pending request still
        # commits) — dedup/shed handling below keys off `fresh`
        fresh = (self.latency.on_submitted(request_key)
                 if request_key is not None else False)
        try:
            tr = self._transition
            if tr is not None and tr.moved(self.router, client_id):
                tr.parked += 1
                tr.parked_peak = max(tr.parked_peak, tr.parked)
                try:
                    await self._wait_for_flip(tr)
                finally:
                    tr.parked -= 1
            sid = self.router.route(client_id, epoch=self._epoch)
            shard = self.shards.get(sid)
            if shard is None:
                raise ShardEpochError(
                    f"client {client_id!r} routes to shard {sid} in epoch "
                    f"{self._epoch}, but this set has shards "
                    f"{sorted(self.shards)} — the router was re-pointed "
                    f"outside ShardSet.reshard(); use the epoch protocol"
                )
            await shard.submit(raw_request)
        except ReqAlreadyExistsError:
            # a retry of a still-pending request: not a shed — the
            # original stamp stays and resolves when the request commits
            raise
        except ReqAlreadyProcessedError:
            # duplicate of an already-committed request: no commit is
            # coming for this stamp, and it was not shed either
            if fresh and request_key is not None:
                self.latency.discard(request_key)
            raise
        except AdmissionRejected:
            self.latency.on_shed(request_key if fresh else None, "admission")
            raise
        except SubmitTimeoutError:
            self.latency.on_shed(request_key if fresh else None, "timeout")
            raise
        except BaseException:
            self.latency.on_shed(request_key if fresh else None, "other")
            raise
        self.submitted += 1
        return sid

    async def _wait_for_flip(self, tr: _Transition) -> None:
        remaining = tr.deadline - time.monotonic()
        try:
            await asyncio.wait_for(
                tr.flip_event.wait(), timeout=max(remaining, 0.001)
            )
        except asyncio.TimeoutError:
            raise ShardEpochError(
                f"epoch {tr.epoch} is still draining its moved key-ranges "
                f"and the {self.drain_deadline:.1f}s drain deadline expired "
                f"(phase {tr.phase}, barriers {sorted(tr.barriers)})"
            ) from None
        if tr.failed is not None:
            raise ShardEpochError(
                f"epoch {tr.epoch} transition failed: {tr.failed}"
            )

    def occupancy(self) -> dict:
        """Combined submit/backpressure surface over the per-shard pools.

        Submitters parked at a reshard barrier (moved clients waiting for
        the flip) hold requests NO pool can see yet, but they are load
        all the same: they count into ``total_waiters`` (and separately
        as ``parked_moved``) so the admission gate's occupancy signal and
        the autoscaler's saturation signal agree with client-experienced
        pressure during a transition."""
        per = {s: self.shards[s].pool_occupancy() for s in sorted(self.shards)}
        live = [o for o in per.values() if o]
        total_size = sum(o.get("size", 0) for o in live)
        total_cap = sum(o.get("capacity", 0) for o in live)
        parked = self._transition.parked if self._transition else 0
        return {
            "per_shard": per,
            "total_size": total_size,
            "total_free": sum(o.get("free", 0) for o in live),
            "total_capacity": total_cap,
            "total_waiters": sum(o.get("waiters", 0) for o in live) + parked,
            "parked_moved": parked,
            "shed_admission": sum(o.get("shed_admission", 0) for o in live),
            "shed_timeout": sum(o.get("shed_timeout", 0) for o in live),
            # the autoscaler's saturation signal: filled fraction of the
            # combined pool capacity (0.0 when nothing is reporting)
            "fill": (total_size / total_cap) if total_cap else 0.0,
        }

    def health_signals(self) -> dict:
        """The front door's contribution to a
        :class:`~smartbft_tpu_torch.obs.health.HealthMonitor` — the set-level
        roll-up of the same signals each replica reports for itself:
        combined pool fill (parked moved-client submitters included, the
        client-felt pressure), whether the gate shed (the monitor's
        latch turns the counter into a recent-window signal), and the
        live submit->commit p99 over the set's latency tracker."""
        occ = self.occupancy()
        cap = occ["total_capacity"]
        # client-FELT fill: pooled requests plus waiters (parked moved
        # submitters included) over capacity — the same definition the
        # per-replica pool_signal_source uses, NOT the autoscaler's
        # pooled-only 'fill' (a resharding front door with stalled
        # clients must not read healthy)
        out = {
            "pool.fill": ((occ["total_size"] + occ["total_waiters"]) / cap)
            if cap else 0.0,
            "pool.shed_total": float(occ["shed_admission"]
                                     + occ["shed_timeout"]),
        }
        if self.latency.aggregate.count:
            out["latency.commit_p99_ms"] = \
                self.latency.aggregate.quantile(0.99) * 1e3
        return out

    def health_source(self, *, clock=None):
        """A zero-arg HealthMonitor source over :meth:`health_signals`
        with the shed counter latched into ``pool.shed_recent`` (the
        rule's signal) — counters are monotone, verdicts need recency."""
        import time as _time

        from ..obs.health import EventLatch

        latch = EventLatch(5.0)
        clock = clock or _time.monotonic
        lat_state = {"buckets": None}

        def signals() -> dict:
            sig = self.health_signals()
            shed_total = sig.pop("pool.shed_total", 0.0)
            sig["pool.shed_recent"] = latch.update(
                shed_total, 1.0, clock()
            )
            # recency window over the latency signal: the
            # verdict judges the p99 of commits landed since the LAST
            # tick, not the lifetime aggregate — a cumulative p99 never
            # clears after one bad spell, so a controller acting on it
            # would remediate history (obs.health.latency_signal_source
            # applies the same rule per replica)
            hist = self.latency.aggregate
            sig.pop("latency.commit_p99_ms", None)
            if hist.count:
                if lat_state["buckets"] is None:
                    lat_state["buckets"] = list(hist.buckets)
                    sig["latency.commit_p99_ms"] = \
                        hist.quantile(0.99) * 1e3
                else:
                    p99 = hist.delta_quantile(0.99, lat_state["buckets"])
                    if p99 > 0.0:
                        lat_state["buckets"] = list(hist.buckets)
                        sig["latency.commit_p99_ms"] = p99 * 1e3
            return sig

        return signals

    # -- the combined committed stream -------------------------------------

    def poll_committed(self) -> list:
        """Drain newly committed decisions from every live shard into the
        mux.

        Returns the new :class:`~smartbft_tpu_torch.shard.mux.CommittedEntry`
        list (combined arrival order).  Raises
        :class:`~smartbft_tpu_torch.shard.mux.ShardStreamViolation` if any
        shard's feed broke gaplessness or exactly-once — the set fails
        loudly rather than applying a forked shard's entries.

        This is also where two pieces of epoch machinery live: barrier
        DETECTION (an in-flight transition scans fresh entries for its
        committed barrier commands and journals each shard's barrier
        sequence) and the automatic PRUNE (entries handed to the embedder
        by earlier polls are applied by contract; everything beyond the
        ``retention`` window below that watermark is dropped, so long
        soaks do not grow mux memory with history)."""
        start = self.mux.total()
        for sid in sorted(self.shards):
            pos = self._chain_pos[sid]
            fresh = self.shards[sid].poll_committed(pos)
            if fresh:
                # wave-batched hand-off: one mux call (and one application
                # callback) per shard per poll, not one per decision
                self.mux.ingest_batch(sid, fresh)
                self._chain_pos[sid] = pos + len(fresh)
        out = self.mux.since(start)
        self.latency.on_committed_batch(out)
        tr = self._transition
        if tr is not None and len(tr.barriers) < tr.old_s:
            marker = barrier_marker(tr.epoch)
            for e in out:
                if (e.shard_id < tr.old_s and e.shard_id not in tr.barriers
                        and marker in e.request_ids):
                    tr.barriers[e.shard_id] = e.seq
                    self._journal({"t": "barrier", "epoch": tr.epoch,
                                   "shard": e.shard_id, "seq": e.seq})
        if self.retention > 0:
            # never prune entries not yet returned: `start` IS the
            # delivered watermark (everything below it left poll_committed
            # in an earlier call)
            self.mux.prune(min(start, max(0, self.mux.total()
                                          - self.retention)))
        return out

    def read(self, client_id, *, max_lag_decisions: int = 0) -> dict:
        """Route a committed-state READ to ``client_id``'s owning shard
        and decide it with the ``f+1`` match rule — no pool,
        no proposer, no verify launch, and never a consensus round.

        The owning shard fans the read across its replicas
        (``read_replies``), and :func:`~smartbft_tpu_torch.core.readplane.
        quorum_read_decide` accepts when ``f+1`` bit-identical
        ``(found, value, height, digest)`` stamps agree.  Returns the
        decided stamp plus the fan-out accounting; ``ok`` False when no
        stamp reached quorum (partition/churn — retry) or the shard
        cannot serve reads."""
        from ..core.readplane import quorum_read_decide

        self.read_stats["reads"] += 1
        sid = self.router.route(client_id, epoch=self._epoch)
        shard = self.shards.get(sid)
        replies = (shard.read_replies(str(client_id))
                   if shard is not None else None)
        if replies is None:
            self.read_stats["unsupported"] += 1
            return {"ok": False, "shard": sid,
                    "error": "shard cannot serve reads"}
        need = shard.read_quorum_need()
        decision = quorum_read_decide(
            replies, need, max_lag_decisions=max_lag_decisions
        )
        self.read_stats["outliers"] += len(decision.outliers)
        if decision.outliers:
            # same attribution the socket plane's quorum edge performs:
            # observed-only `stale_read` evidence against the outlier
            shard.note_read_outliers(list(decision.outliers))
        out = {
            "ok": decision.winner is not None,
            "shard": sid,
            "need": need,
            "matches": decision.matches,
            "outliers": [(s, why) for s, why in decision.outliers],
        }
        w = decision.winner
        if w is None:
            self.read_stats["no_quorum"] += 1
            return out
        self.read_stats["served"] += 1
        out.update(
            found=bool(w.found), value=bytes(w.value),
            height=int(w.height), state_digest=bytes(w.state_digest),
        )
        return out

    def committed_requests(self, shard_id: Optional[int] = None) -> int:
        if shard_id is not None:
            return self.mux.requests_delivered(shard_id)
        # monotone across flips even when a retired id re-enters as a new
        # generation (the dead incarnation's count is preserved)
        return self.mux.requests_total()

    # -- live reshard ------------------------------------------------------

    def _journal(self, record: dict) -> None:
        if self.journal is not None:
            self.journal.append(record)

    async def reshard(self, new_shards: int, *,
                      make_shard: Optional[Callable] = None,
                      drain_deadline: Optional[float] = None,
                      poll_interval: float = 0.005) -> dict:
        """Grow or shrink the set to ``new_shards`` groups UNDER TRAFFIC.

        The epoch protocol, in order (each edge journaled):

        1. **prepare** — allocate the next epoch number (aborted epochs
           stay burned) and, for scale-out, build + start the new groups
           via ``make_shard(shard_id, epoch)`` (they receive no client
           traffic until the flip);
        2. **barrier** — submit the epoch's barrier command into every
           OLD shard's ordered stream (retrying through leader churn) and
           wait until each shard COMMITS it: that sequence is the shard's
           barrier.  From the moment this coroutine starts, moved-client
           submits park at the front door;
        3. **drain** — wait until no OLD shard still pools a moved
           client's request (retiring shards must drain completely —
           every key they own is moving) so nothing can commit on the
           wrong side of the flip;
        4. **flip** — atomically: install the new epoch in the router,
           open the new epoch in the mux (hand-off dedup snapshot +
           watermark), stop retiring shards, release parked submitters
           into their new shards.

        The whole wait (2+3) is bounded by ``drain_deadline`` wall-clock
        seconds; expiry aborts the transition (journaled), raises
        ShardEpochError here AND to every parked submitter, and leaves
        the set serving the OLD epoch.  Returns the transition summary
        also stored in ``reshard_stats['last']``."""
        if self._transition is not None:
            raise ShardEpochError(
                f"reshard to {new_shards} refused: epoch "
                f"{self._transition.epoch} transition already in progress"
            )
        s_old = len(self.shards)
        s_new = int(new_shards)
        if s_new <= 0:
            raise ValueError(f"new_shards must be positive, got {s_new}")
        if s_new == s_old:
            return {"epoch": self._epoch, "old": s_old, "new": s_new,
                    "noop": True}
        if s_new > s_old and make_shard is None:
            raise ValueError("scale-out needs make_shard(shard_id, epoch)")
        epoch = self._next_epoch
        self._next_epoch += 1
        deadline = time.monotonic() + (drain_deadline or self.drain_deadline)
        self._journal({"t": "prepare", "epoch": epoch,
                       "old": s_old, "new": s_new})
        if self.recorder.enabled:
            self.recorder.record("ctl.reshard_prepare", epoch=epoch,
                                 extra={"old": s_old, "new": s_new})
        tr = _Transition(epoch=epoch, old_s=s_old, new_s=s_new,
                         deadline=deadline)
        self._transition = tr
        new_handles: dict[int, object] = {}
        handoffs: dict[int, Optional[int]] = {}
        flipped = False
        try:
            for sid in range(s_old, s_new):
                h = make_shard(sid, epoch)
                # registered BEFORE start(): a partially started group
                # (start raised halfway) must still be stopped by the
                # abort cleanup, not leak its tasks/registrations
                new_handles[sid] = h
                # snapshot-based handoff: seed the new group
                # from a donor's application snapshot BEFORE it starts —
                # scale-out is then O(1) in the donor's history instead
                # of starting fresh.  Donor choice is deterministic
                # (sid % s_old); a handle pair that does not support the
                # surface (capture returns None) keeps the fresh start.
                donor_sid = sid % s_old
                donor = self.shards.get(donor_sid)
                snap = donor.capture_snapshot() if donor is not None \
                    else None
                if snap is not None:
                    h.install_snapshot(snap)
                    handoffs[sid] = donor_sid
                    if self.recorder.enabled:
                        self.recorder.record(
                            "ctl.reshard_handoff", epoch=epoch,
                            seq=int(snap.get("height", 0)),
                            extra={"to": sid, "from": donor_sid},
                        )
                else:
                    handoffs[sid] = None
                await h.start()
                # visible to polling immediately (it commits nothing until
                # the flip routes clients to it), so the flip itself stays
                # a pure metadata operation
                self.shards[sid] = h
                self._chain_pos[sid] = 0
            tr.phase = "barrier"
            await self._drive(tr, lambda: self._barrier_step(tr),
                              poll_interval)
            tr.phase = "drain"
            drain_t0 = time.monotonic()
            retiring = list(range(s_new, s_old))
            await self._drive(tr, lambda: self._drain_step(tr, retiring),
                              poll_interval)
            tr.drain_ms = (time.monotonic() - drain_t0) * 1e3
            # -- flip ------------------------------------------------------
            # journaled first, then applied SYNCHRONOUSLY (no awaits) so a
            # cancellation/crash can only land before the flip exists or
            # after it is fully effective — never in between
            tr.phase = "flip"
            self._journal({"t": "flip", "epoch": epoch,
                           "shards": list(range(s_new))})
            flipped = True
            self.router.reshard(s_new, epoch=epoch)
            self.mux.begin_epoch(epoch, list(range(s_new)),
                                 retire=retiring, barriers=tr.barriers)
            stopping = []
            for sid in retiring:
                h = self.shards.pop(sid)
                self._chain_pos.pop(sid, None)
                self.retired[sid] = h
                stopping.append(h)
            self._epoch = epoch
            if self.recorder.enabled:
                self.recorder.record(
                    "ctl.reshard_flip", epoch=epoch,
                    dur=time.monotonic() - tr.started,
                    extra={"old": s_old, "new": s_new,
                           "drain_ms": round(tr.drain_ms, 2)},
                )
            tr.flip_event.set()
            try:
                self._journal({"t": "done", "epoch": epoch})
            except OSError:
                # the flip edge is durable; recovery completes an
                # unrecorded done identically
                pass
            summary = {
                "epoch": epoch,
                "old": s_old,
                "new": s_new,
                "barriers": dict(sorted(tr.barriers.items())),
                "moved_fraction": round(
                    self.router.moved_fraction(s_old, s_new), 4
                ),
                "drain_ms": round(tr.drain_ms, 2),
                # how long moved-key submits could not land (barrier start
                # to flip) — the "paused submit window" of the bench block
                "paused_submit_ms": round(
                    (time.monotonic() - tr.started) * 1e3, 2
                ),
                "parked_submits_peak": tr.parked_peak,
                # scale-out handoff provenance: new shard -> donor shard
                # (None = fresh start; {} on scale-in)
                "handoffs": handoffs,
            }
            self.reshard_stats["transitions"] += 1
            self.reshard_stats["last"] = summary
            self._transition = None
            # teardown of drained, retired groups happens AFTER the
            # transition is fully committed; noisy stops must not unwind it
            for h in stopping:
                try:
                    await h.stop()
                except asyncio.CancelledError:
                    raise
                except Exception:
                    pass
            return summary
        except BaseException as exc:
            if flipped:
                # the transition is journaled and effective — a post-flip
                # failure (cancelled teardown, done-edge IO error) must
                # neither journal an abort nor un-flip live state
                raise
            tr.failed = f"{type(exc).__name__}: {exc}"
            if self.recorder.enabled:
                self.recorder.record("ctl.reshard_abort", epoch=epoch,
                                     extra={"reason": tr.failed})
            try:
                self._journal({"t": "abort", "epoch": epoch,
                               "reason": tr.failed})
            except OSError:
                # a torn-down coordinator (cancelled mid-transition, journal
                # dir already gone) must surface the ORIGINAL failure, not
                # an abort-bookkeeping IO error; recovery treats a missing
                # abort edge identically (unflipped prepare => abort)
                pass
            self.reshard_stats["aborts"] += 1
            # tear down never-flipped new groups; the old epoch keeps
            # serving exactly as before
            for sid, h in new_handles.items():
                self.shards.pop(sid, None)
                self._chain_pos.pop(sid, None)
                try:
                    await h.stop()
                except Exception:
                    pass
            self._transition = None
            tr.flip_event.set()  # parked submitters wake and see `failed`
            raise

    async def _drive(self, tr: _Transition, step: Callable[[], bool],
                     poll_interval: float) -> None:
        """Run one transition phase: call ``step`` (True = phase done)
        until done or the drain deadline expires."""
        while True:
            if step():
                return
            if time.monotonic() > tr.deadline:
                raise ShardEpochError(
                    f"epoch {tr.epoch} drain deadline expired in phase "
                    f"{tr.phase!r}: barriers={sorted(tr.barriers)}, "
                    f"needed {tr.old_s}"
                )
            await asyncio.sleep(poll_interval)

    #: wall-clock seconds after which an uncommitted barrier is submitted
    #: AGAIN — a replica crash can lose the pooled command entirely (it
    #: lived only in that pool), and re-submission is free under client
    #: dedup, so the barrier phase must keep re-ordering until it COMMITS
    BARRIER_RESUBMIT_INTERVAL = 0.5

    def _barrier_step(self, tr: _Transition) -> bool:
        """(Re)submit barrier commands and poll for their commits."""
        now = time.monotonic()
        for sid in range(tr.old_s):
            if sid in tr.barriers:
                continue
            last = tr.barrier_submitted_at.get(sid)
            if last is not None \
                    and now - last < self.BARRIER_RESUBMIT_INTERVAL:
                continue
            h = self.shards.get(sid)
            if h is None:
                continue
            # fire-and-account: _submit_barrier stamps the attempt time and
            # swallows transient no-leader/full-pool errors so the next
            # step retries — leader churn mid-reshard is normal, and an
            # attempt that LANDED but died with its replica re-submits
            # after the interval above
            create_logged_task(
                self._submit_barrier(h, sid, tr),
                name=f"reshard-barrier-e{tr.epoch}-s{sid}",
            )
        self.poll_committed()
        return len(tr.barriers) >= tr.old_s

    async def _submit_barrier(self, handle, sid: int, tr: _Transition) -> None:
        if sid in tr.barriers:
            return
        tr.barrier_submitted_at[sid] = time.monotonic()
        try:
            await handle.submit_barrier(tr.epoch, tr.old_s, tr.new_s)
        except Exception:
            # transient (no leader yet / pool full / view change): retry
            # on a later step immediately.  Embedder dedup errors are
            # swallowed by submit_barrier itself per the ShardHandle
            # contract.
            tr.barrier_submitted_at.pop(sid, None)

    def _drain_step(self, tr: _Transition, retiring: list[int]) -> bool:
        self.poll_committed()
        for sid in range(tr.old_s, tr.new_s):
            if not self.shards[sid].ready():
                return False
        # submitters parked in a pool's SPACE wait hold requests no pool
        # (and no pending_client_ids) can see yet; one admitted after the
        # flip would commit on the old shard — wait them out (conservative:
        # any old shard's waiter blocks the drain, attribution is unknown)
        for sid in range(tr.old_s):
            h = self.shards.get(sid)
            if h is not None and h.space_waiters():
                return False
        for sid in retiring:
            pend = self.shards[sid].pending_client_ids()
            if pend:
                pend = {c for c in pend if c != RESHARD_CLIENT}
                if pend:  # every key a retiring shard owns is moving
                    return False
        for sid in range(min(tr.old_s, tr.new_s)):
            pend = self.shards[sid].pending_client_ids()
            if not pend:
                continue
            for c in pend:
                if tr.moved(self.router, c):
                    return False
        return True

    # -- metrics roll-up ---------------------------------------------------

    def stats_block(self) -> dict:
        """Per-shard attribution + aggregate, JSON-able for bench rows."""
        per_shard = {}
        for sid in sorted(self.shards):
            shard = self.shards[sid]
            block = {
                "decisions": self.mux.height(sid),
                "committed_requests": self.mux.requests_delivered(sid),
                "pool": shard.pool_occupancy(),
            }
            block.update(shard.stats_block())
            per_shard[sid] = block
        agg = {
            "shards": self.num_shards,
            "epoch": self._epoch,
            "decisions": self.mux.total(),
            "committed_requests": self.committed_requests(),
            "submitted": self.submitted,
        }
        if self.coalescer is not None:
            agg["coalescer"] = self.coalescer.shard_snapshot()
            agg["breaker"] = self.coalescer.fault_snapshot()
            agg["mesh"] = self.coalescer.mesh_snapshot()
        reshard = dict(self.reshard_stats)
        reshard["epoch"] = self._epoch
        reshard["in_progress"] = self.reshard_phase
        reshard["watermarks"] = self.mux.snapshot()["watermarks"]
        return {"per_shard": per_shard, "aggregate": agg, "reshard": reshard,
                "latency": self.latency.snapshot(),
                "read": dict(self.read_stats)}
