"""Scripted fault-schedule chaos harness over the in-process network.

Layered on :mod:`smartbft_tpu_torch.testing.network`'s fault primitives, this
module turns ad-hoc fault tests into DECLARATIVE timelines: a schedule is a
list of :class:`ChaosEvent` (leader-mute, crash, restart, partition, heal,
message-corruption, ...) pinned to logical-clock offsets, executed by
:class:`ChaosCluster` while a request pump keeps the protocol under load.
After the run, :class:`Invariants` checks the four properties every
schedule must preserve:

* **fork-free** — pairwise identical ledger prefixes;
* **exactly-once** — no request delivered twice on any ledger, sequences
  gapless from 1;
* **eventual blacklist** — a deposed faulty leader appears in the
  blacklist carried by committed checkpoint metadata (rotation mode);
* **bounded liveness** — once the last fault heals, draining the
  outstanding requests takes at most the batch-count they need plus a
  small fixed slack, measured in WINDOWS (decisions / pipeline_depth).

The harness is mode-agnostic: the same schedule runs single-slot
(pipeline_depth=1, per-decision rotation) and pipelined
(pipeline_depth>1, window-granular rotation) clusters, which is exactly
the parametrization the scenario tests sweep.

Soak entry point (CI, behind ``-m slow``)::

    python -m smartbft_tpu_torch.testing.chaos --soak [--rounds N] [--depth K]

runs randomized schedules against a rotation-on pipelined cluster and
fails loudly on any invariant violation.  ``--sockets`` re-proves the
fault matrix at the SOCKET level: one OS process per replica over the
real ``smartbft_tpu_torch.net`` transport, with SIGKILL-and-rejoin and
slow-link rounds driven by the same :class:`ChaosEvent` vocabulary
(see ``net.cluster.run_socket_schedule``).  ``--shards S`` (with
``--engine-faults``) runs the engine-fault soak against S consensus
groups sharing ONE coalescer/engine — the sharded deployment shape — and
asserts the breaker open/close cycle affects all shards coherently:
every shard keeps committing through the outage on the host fallback,
every shard's traffic shows in the shared plane's per-tag attribution,
and the post-heal close restores them together.
"""

from __future__ import annotations

import asyncio
import dataclasses
import math
import random
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..codec import decode
from ..config import Configuration
from ..core.pool import AdmissionRejected, SubmitTimeoutError
from ..messages import Commit, Prepare, ViewMetadata
from ..metrics import CommitLatencyTracker
from ..utils.clock import Scheduler
from ..utils.tasks import create_logged_task
from .app import App, SharedLedgers, fast_config, wait_for
from .load import OpenLoopPump, ZipfClients
from .network import Network


def chaos_config(
    i: int,
    *,
    depth: int = 1,
    rotation: bool = True,
    decisions_per_leader: int = 1,
    **overrides,
) -> Configuration:
    """Tight-timeout configuration for fault scenarios, pipelined or not.

    ``decisions_per_leader`` is in the configured granularity's units:
    windows when ``depth > 1`` (rotation_granularity='window'), decisions
    otherwise."""
    base = dict(
        leader_rotation=rotation,
        decisions_per_leader=decisions_per_leader if rotation else 0,
        rotation_granularity="window" if depth > 1 else "decision",
        pipeline_depth=depth,
        request_batch_max_count=2,
        request_batch_max_interval=0.05,
        leader_heartbeat_timeout=2.0,
        leader_heartbeat_count=10,
        view_change_timeout=8.0,
        view_change_resend_interval=2.0,
    )
    base.update(overrides)
    return dataclasses.replace(fast_config(i), **base)


# ---------------------------------------------------------------------- events

@dataclass(frozen=True)
class ChaosEvent:
    """One timeline entry: ``action`` applied at logical offset ``at``.

    ``node`` (and ``groups`` members) may be a concrete node id or one of
    two dynamic targets, resolved when the event FIRES:

    - ``"leader"``: whatever node the live cluster currently follows —
      under rotation the leader at schedule-authoring time is meaningless;
    - ``"faulty"``: the node the run's first ``"leader"`` resolution
      picked, so multi-event schedules (mute -> crash -> restart) stay
      aimed at one victim while the cluster rotates around it.

    Actions:

    - ``mute`` / ``unmute``: outbound-only silence (alive but not sending)
    - ``disconnect`` / ``reconnect``: full isolation both ways
    - ``crash`` / ``restart``: stop the consensus process / start it again
      with WAL recovery (a crash-restart pair with downtime in between)
    - ``partition`` / ``heal``: split the mesh into ``groups`` / undo it
    - ``corrupt`` / ``uncorrupt``: mutate a ``fraction`` of the node's
      outbound prepare/commit digests (message corruption)

    Device-plane actions (require ``ChaosCluster(engine_faults=True)``;
    ``node`` is ignored — the engine is shared by every replica, which is
    exactly the blast radius under test):

    - ``engine_hang``: verify launches block until released (the coalescer
      deadline abandons them); ``engine_fail`` (× ``count``): transient
      tunnel-class errors; ``engine_slow`` (``fraction`` seconds of added
      latency); ``engine_permanent``: compile-class error, trips the
      breaker immediately; ``engine_heal``: clear all device faults.
    - ``engine_device_down`` / ``engine_device_restore`` (``count`` =
      mesh device index): MESH-scoped faults — losing one device of an
      N-device verify mesh fails every launch (one logical launch spans
      the whole mesh), so the breaker degrades ALL shards to host
      together and the canary recovers them back onto the mesh.

    Overload actions (the open-loop pump as a schedulable fault — README
    "Overload behavior"):

    - ``load_spike``: start an OPEN-loop Poisson arrival pump at
      ``fraction`` arrivals per logical second over a Zipf-skewed client
      universe of ``count`` ids (``count`` <= 1 means the default 64 —
      the field's dataclass default is 1); arrivals spawn background
      submits that ack, shed (admission / space-wait timeout), or fail,
      all counted in the report, with submit→commit latency stamped per
      request into the cluster's ``latency`` tracker;
    - ``load_stop``: stop the pump (outstanding submits finish or shed).
      A pump still running when the schedule's last event has fired AND
      the baseline submissions are done gets an implicit stop — the run
      must drain, not pump to the hard cap.

    Elastic-shard actions (consumed by :func:`run_reshard_schedule`
    against a ``ShardedCluster``; ``shard`` scopes node-shaped actions to
    one consensus group):

    - ``reshard`` (``count`` = target S): start a live epoch transition
      (split or merge) under the pump's traffic; held until any earlier
      transition completes — epochs are serial by design;
    - ``crash_during_reshard`` (``shard`` + ``node``): crash that replica
      INSIDE the handoff window — the event holds until a transition is
      actually in flight, so the crash always lands mid-drain/mid-flip;
    - ``crash`` / ``restart`` with ``shard`` set: the plain pair, scoped
      to one group.

    Snapshot actions (socket-level only — consumed by
    :func:`~smartbft_tpu_torch.net.cluster.run_socket_schedule` against a
    ``SocketCluster`` built with ``snapshot_interval_decisions > 0``):

    - ``crash_during_snapshot``: wait (bounded by ``fraction`` seconds,
      default 10) for the node's NEXT snapshot capture to land, then
      SIGKILL immediately — the process dies with the fresh snapshot on
      disk and the ledger-compaction/offer plumbing interrupted at an
      arbitrary point; recovery must reconcile.  The deterministic crash
      points (between snapshot write and ledger truncate, torn files,
      mid-chunk) are pinned by the ``tests/test_snapshot.py`` unit tests;
      :func:`~smartbft_tpu_torch.net.cluster.run_snapshot_rejoin` is the
      snapshot-safe end-to-end runner (``run_socket_schedule``'s
      ``committed_ids`` resubmission oracle sees only the post-horizon
      suffix once a replica compacts).
    """

    at: float
    action: str
    node: Optional[object] = None  # int | "leader" | "faulty"
    groups: tuple = ()
    fraction: float = 1.0
    count: int = 1  # engine_fail: consecutive failures; reshard: target S
    shard: Optional[int] = None  # sharded runs: which group a node action hits


def mute_leader_schedule(*, mute_at=2.0, heal_at=14.0) -> list[ChaosEvent]:
    """The canonical faulty-leader schedule: the CURRENT leader goes mute
    (alive, receiving, silent), the cluster deposes it, then it heals."""
    return [
        ChaosEvent(at=mute_at, action="mute", node="leader"),
        ChaosEvent(at=heal_at, action="unmute", node="faulty"),
    ]


def faulty_leader_full_schedule(
    *, mute_at=2.0, crash_at=12.0, restart_at=20.0
) -> list[ChaosEvent]:
    """The acceptance schedule: mute -> crash-restart -> rejoin.  The
    current leader first goes mute (deposed + blacklisted by the remaining
    quorum), then crashes outright, then restarts from its WAL and
    rejoins as a follower."""
    return [
        ChaosEvent(at=mute_at, action="mute", node="leader"),
        ChaosEvent(at=crash_at, action="crash", node="faulty"),
        ChaosEvent(at=restart_at, action="restart", node="faulty"),
        ChaosEvent(at=restart_at, action="unmute", node="faulty"),
    ]


def engine_fault_schedule(
    *, hang_at=2.0, fail_at=60.0, fail_every=20.0, fail_count=20,
    heal_at=120.0,
) -> list[ChaosEvent]:
    """The verify-plane acceptance schedule: the device engine HANGS (the
    launch deadline abandons waves, retries, and the breaker degrades to
    host verify), then un-hangs into three bursts of transient failures
    (the recovery probe keeps failing, so the breaker stays open and
    consensus keeps committing on the host engine), then HEALS — the next
    probe succeeds, the breaker closes, and waves return to the device.

    ``fail_count`` per burst is sized so the probe cannot drain a burst
    before the next one lands (probes are wall-clock; the schedule is
    logical) — recovery is therefore strictly tied to ``engine_heal``."""
    return [
        ChaosEvent(at=hang_at, action="engine_hang"),
        ChaosEvent(at=fail_at, action="engine_fail", count=fail_count),
        ChaosEvent(at=fail_at + fail_every, action="engine_fail", count=fail_count),
        ChaosEvent(at=fail_at + 2 * fail_every, action="engine_fail", count=fail_count),
        ChaosEvent(at=heal_at, action="engine_heal"),
    ]


# ---------------------------------------------------------------------- report

@dataclass
class ChaosReport:
    submitted: int = 0
    committed_at_heal: int = 0
    decisions_at_heal: int = 0
    final_committed: int = 0
    final_decisions: int = 0
    heal_at: float = 0.0
    leaders_seen: set = field(default_factory=set)
    events_fired: list = field(default_factory=list)
    #: (logical t, status, [breaching slo names]) — one entry per
    #: CLUSTER-verdict change from the continuous SLO evaluation
    verdicts: list = field(default_factory=list)
    #: (first fired event t, last fired event t), logical offsets
    fault_span: Optional[tuple] = None
    final_health: Optional[dict] = None
    # open-loop spike accounting (load_spike / load_stop actions)
    spike_offered: int = 0
    spike_acked: int = 0
    spike_shed_admission: int = 0
    spike_shed_timeout: int = 0
    spike_failed: int = 0
    spike_peak_occupancy: int = 0   # max (pooled + parked) on any live node

    @property
    def decisions_after_heal(self) -> int:
        return self.final_decisions - self.decisions_at_heal

    @property
    def spike_shed(self) -> int:
        return self.spike_shed_admission + self.spike_shed_timeout


def assert_health_verdicts(verdicts: list, fault_span: Optional[tuple],
                           final_health: Optional[dict], *,
                           recovery_s: float = 30.0) -> None:
    """The soak health gate, shared by the logical-clock and
    socket runners: a ``critical`` verdict is only acceptable inside the
    injected-fault window plus a bounded recovery, and the run must not
    END critical.  With NO fault window (no event ever fired) there is
    no excuse: EVERY critical sample fails — a default window would
    blanket-pass exactly the unexplained criticals the gate exists to
    catch."""
    if fault_span is None:
        stray = [(t, names) for t, status, names in verdicts
                 if status == "critical"]
        lo = hi = 0.0
    else:
        lo, hi = fault_span
        hi += recovery_s
        stray = [
            (t, names) for t, status, names in verdicts
            if status == "critical" and not (lo <= t <= hi)
        ]
    assert not stray, (
        f"critical verdict outside the injected-fault window "
        f"[{lo:.1f}s, {hi:.1f}s]: {stray}"
    )
    if final_health is not None:
        assert final_health.get("status") != "critical", (
            f"cluster still critical after the run drained: {final_health}"
        )


# ---------------------------------------------------------------------- cluster

class ChaosCluster:
    """n apps over one logical clock + fault-injection network, driven by a
    declarative fault schedule under continuous request load."""

    def __init__(
        self,
        wal_root,
        *,
        n: int = 4,
        depth: int = 1,
        rotation: bool = True,
        seed: int = 101,
        config_fn: Optional[Callable[[int], Configuration]] = None,
        engine_faults: bool = False,
        byzantine: bool = False,
        trace: bool = False,
        trace_capacity: int = 4096,
        health: bool = True,
        slo_spec=None,
    ):
        self.wal_root = str(wal_root)
        self.n = n
        self.depth = depth
        self.rotation = rotation
        self.scheduler = Scheduler()
        self.network = Network(seed=seed)
        self.shared = SharedLedgers()
        self.rng = random.Random(seed)
        #: engine_faults=True: every replica routes quorum verification
        #: through ONE shared FaultyEngine-wrapped coalescer (the
        #: single-chip deployment shape) so engine_* timeline actions can
        #: hang/fail the device plane under a full fault policy — launch
        #: deadline, retry/backoff, host-fallback breaker, canary probe
        self.engine: Optional[object] = None
        self.coalescer = None
        self.verify_metrics = None  # InMemoryProvider backing the breaker counters
        crypto_fn: Callable[[int], Optional[object]] = lambda i: None
        if engine_faults:
            from ..crypto.provider import AsyncBatchCoalescer, VerifyFaultPolicy
            from ..metrics import InMemoryProvider, TPUCryptoMetrics
            from .engine_faults import (
                CoalescedTrivialCrypto,
                FaultyEngine,
                always_valid_engine,
            )

            self.engine = FaultyEngine(always_valid_engine())
            self.verify_metrics = InMemoryProvider()
            # the fault knobs are WALL-CLOCK: tight values keep the
            # deadline→retry→breaker cycle well inside the real seconds a
            # logical-clock schedule takes to play out
            self.coalescer = AsyncBatchCoalescer(
                self.engine, window=0.001, max_batch=4096,
                policy=VerifyFaultPolicy(
                    launch_timeout=0.15, launch_retries=2,
                    backoff_base=0.02, backoff_max=0.08, backoff_jitter=0.25,
                    breaker_threshold=3, probe_interval=0.05,
                    probe_backoff_max=0.2,
                ),
                fallback_engine=always_valid_engine(),
                metrics=TPUCryptoMetrics(self.verify_metrics),
            )
            crypto_fn = lambda i: CoalescedTrivialCrypto(i, self.coalescer)
            if config_fn is None:
                # device-plane outages stall verification for wall-clock
                # spans the logical clock races past — keep request
                # complaints and heartbeat escalation out of the picture so
                # the scenario exercises the DEVICE plane, not deposition
                config_fn = lambda i: chaos_config(
                    i, depth=depth, rotation=rotation,
                    request_forward_timeout=120.0,
                    request_complain_timeout=240.0,
                    request_auto_remove_timeout=480.0,
                    leader_heartbeat_timeout=30.0,
                    view_change_resend_interval=15.0,
                    view_change_timeout=60.0,
                    verify_launch_timeout=0.15, verify_launch_retries=2,
                    verify_breaker_threshold=3, verify_probe_interval=0.05,
                )
        elif byzantine:
            # byzantine=True: a FORGERY-REJECTING crypto plane.
            # The engine-fault clusters run always-valid trivial crypto —
            # useless against an adversary, whose whole attack is invalid
            # signatures.  Every replica gets a real CryptoProvider over
            # the deterministic toy scheme (millisecond kernel, real
            # binding checks, real per-signer verdicts) sharing one
            # coalescer — the shared verify plane the forgery flood aims
            # at.  Shun threshold is lowered so a vote forger (at most ONE
            # registered vote per sender per decision) crosses it within a
            # few decisions; decay is pushed past the round so the
            # post-run oracles still see the shun.
            from ..crypto.provider import (
                AsyncBatchCoalescer,
                HostVerifyEngine,
                Keyring,
            )
            from . import toy_scheme

            self.engine = HostVerifyEngine(scheme=toy_scheme)
            self.coalescer = AsyncBatchCoalescer(
                self.engine, window=0.001, max_batch=4096, dedupe=True,
            )
            rings = Keyring.generate(
                list(range(1, n + 1)), seed=b"byzantine-chaos",
                scheme=toy_scheme,
            )
            crypto_fn = lambda i: toy_scheme.ToyCryptoProvider(
                rings[i], coalescer=self.coalescer
            )
            if config_fn is None:
                config_fn = lambda i: chaos_config(
                    i, depth=depth, rotation=rotation,
                    misbehavior_shun_threshold=3,
                    misbehavior_decay_interval=600.0,
                )
        #: the installed Byzantine actor, when a schedule arms one
        self.actor = None
        cfg = config_fn or (lambda i: chaos_config(i, depth=depth, rotation=rotation))
        #: per-replica flight recorders: armed with trace=True,
        #: dumped to the run dir on any invariant failure so a failed soak
        #: leaves a timeline, not just an assertion message
        self.trace = trace
        self.recorders: dict[int, object] = {}
        if trace:
            from ..obs import TraceRecorder

            self.recorders = {
                i: TraceRecorder(clock=self.scheduler.now, node=f"n{i}",
                                 capacity=trace_capacity)
                for i in range(1, n + 1)
            }
            if self.coalescer is not None:
                self.recorders[0] = TraceRecorder(
                    clock=self.scheduler.now, node="verify",
                    capacity=trace_capacity,
                )
                self.coalescer.attach_recorder(self.recorders[0])
        self.apps = [
            App(i, self.network, self.shared, self.scheduler,
                wal_dir=f"{self.wal_root}/wal-{i}", config=cfg(i),
                crypto=crypto_fn(i), recorder=self.recorders.get(i))
            for i in range(1, n + 1)
        ]
        self.down: set[int] = set()
        #: nodes under an active injected fault (mute/corrupt/disconnect):
        #: the request pump skips them, like a client avoiding a dead peer
        self.faulted: set[int] = set()
        #: members of partition groups below quorum size (pump skips too)
        self.partition_minority: set[int] = set()
        #: the node the run's first dynamic "leader" target resolved to
        self.faulty_node: Optional[int] = None
        #: active open-loop spike (load_spike action), None when stopped
        self.spike: Optional[dict] = None
        #: request-id sequence shared by EVERY spike of a run — a second
        #: load_spike must not re-issue the first one's ids (pool dedup
        #: would reject its whole burst as duplicates)
        self._spike_seq = 0
        self._spike_pending = 0
        #: per-request submit→commit latency on the LOGICAL clock — fed by
        #: the spike pump, resolved by the run loop's ledger scan, read by
        #: overload scenarios (phase p99s via begin_phase)
        self.latency = CommitLatencyTracker(clock=self.scheduler.now)
        self._latency_scan_pos = 0
        #: continuous SLO evaluation: one HealthMonitor per
        #: node on the LOGICAL clock, ticked by the run loop; sources
        #: rebind across crash-restarts (each restart builds a fresh
        #: Consensus + VC tracker).  slo_spec defaults to the production
        #: default spec — the point is judging chaos runs against the
        #: same objectives an operator would.
        self.health_monitors: dict[int, object] = {}
        if health:
            from ..obs.health import HealthMonitor

            for i in range(1, n + 1):
                mon = HealthMonitor(
                    slo_spec, clock=self.scheduler.now, node=f"n{i}",
                    recorder=self.recorders.get(i),
                )
                mon.add_source(self._node_signal_source(i))
                if self.coalescer is not None:
                    from ..obs.health import coalescer_signal_source

                    mon.add_source(coalescer_signal_source(self.coalescer))
                self.health_monitors[i] = mon
        self._last_cluster_status: Optional[str] = None

    def _node_signal_source(self, node_id: int) -> Callable:
        """A source that follows the node's CURRENT Consensus: restarts
        rebuild consensus (and its VC tracker), so the bound vc/pool
        sources are rebuilt whenever the underlying object changes."""
        from ..obs.health import pool_signal_source, vc_signal_source

        state = {"consensus": None, "sources": []}

        def signals() -> dict:
            app = self.app(node_id)
            c = app.consensus if node_id not in self.down else None
            if c is None:
                state["consensus"], state["sources"] = None, []
                return {}
            if c is not state["consensus"]:
                state["consensus"] = c
                state["sources"] = [
                    vc_signal_source(c.vc_phases, clock=self.scheduler.now),
                    pool_signal_source(c.pool_occupancy,
                                       clock=self.scheduler.now),
                ]
            out: dict = {}
            for fn in state["sources"]:
                out.update(fn())
            return out

        return signals

    def tick_health(self, report: Optional[ChaosReport] = None) -> dict:
        """Tick every live node's monitor, aggregate the cluster verdict,
        and (when ``report`` is given) record verdict CHANGES.  Down
        nodes count as unreachable — exactly the control-channel sweep
        semantics of SocketCluster.cluster_health."""
        from ..obs.health import aggregate_cluster_verdict

        verdicts = {}
        unreachable = []
        for i, mon in self.health_monitors.items():
            if i in self.down:
                unreachable.append(f"n{i}")
                continue
            verdicts[f"n{i}"] = mon.tick()
        agg = aggregate_cluster_verdict(verdicts, unreachable=unreachable)
        if report is not None:
            report.final_health = agg
            if agg["status"] != self._last_cluster_status:
                self._last_cluster_status = agg["status"]
                report.verdicts.append((
                    round(self.scheduler.now(), 2), agg["status"],
                    sorted({r.get("slo", "?") for r in agg["reasons"]}),
                ))
        return agg

    async def wait_healthy(self, timeout: float = 30.0,
                           step: float = 0.05) -> float:
        """Advance logical time until the cluster verdict returns to
        ``healthy``; returns the logical seconds it took.  The
        recovery-bound invariant asserts through this."""
        start = self.scheduler.now()
        elapsed = 0.0
        while elapsed < timeout:
            if self.tick_health()["status"] == "healthy":
                return self.scheduler.now() - start
            await asyncio.sleep(0)
            self.scheduler.advance_by(step)
            await asyncio.sleep(0.001)
            elapsed += step
        raise TimeoutError(
            f"cluster verdict did not return to healthy within {timeout}s: "
            f"{self.tick_health()}"
        )

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        for a in self.apps:
            await a.start()

    async def stop(self) -> None:
        if self.engine is not None and hasattr(self.engine, "heal"):
            self.engine.heal()  # release any verify calls parked in a hang
        for a in self.apps:
            if a.id not in self.down:
                await a.stop()

    def app(self, node_id: int) -> App:
        return self.apps[node_id - 1]

    def install_actor(self, node_id: int):
        """Wrap ``node_id`` in a :class:`testing.byzantine.ByzantineActor`
        (arm modes on the returned actor).  The actor's replica is NOT
        marked faulted: it stays a pump target and must keep committing —
        a Byzantine node is indistinguishable from an honest one except
        where it chooses to lie."""
        from .byzantine import ByzantineActor

        self.actor = ByzantineActor(self.app(node_id), self.network)
        return self.actor

    # -- queries -----------------------------------------------------------

    def committed(self, app: App) -> int:
        return sum(len(app.requests_from_proposal(d.proposal)) for d in app.ledger())

    def live_apps(self) -> list[App]:
        return [a for a in self.apps if a.id not in self.down]

    def leader_of(self) -> int:
        for a in self.live_apps():
            if a.consensus is not None:
                lead = a.consensus.get_leader_id()
                if lead:
                    return lead
        return 0

    def healthy_apps(self) -> list[App]:
        """Live apps with no active injected fault — pump targets."""
        bad = self.down | self.faulted | self.partition_minority
        return [a for a in self.apps if a.id not in bad]

    # -- event execution ---------------------------------------------------

    def _resolve(self, spec) -> Optional[int]:
        """Resolve a dynamic target ("leader" / "faulty") to a node id."""
        if spec == "leader":
            node = self.leader_of()
            if not node:
                raise RuntimeError("no live leader to resolve a dynamic target")
            if self.faulty_node is None:
                self.faulty_node = node
            return node
        if spec == "faulty":
            if self.faulty_node is None:
                raise RuntimeError('"faulty" target used before any "leader" resolution')
            return self.faulty_node
        return spec

    async def _fire(self, evt: ChaosEvent) -> ChaosEvent:
        target = self._resolve(evt.node) if evt.node is not None else None
        groups = tuple(
            tuple(self._resolve(m) for m in g) for g in evt.groups
        )
        evt = dataclasses.replace(evt, node=target, groups=groups)
        node = self.network.nodes.get(evt.node) if evt.node else None
        if evt.action == "mute":
            node.mute()
            self.faulted.add(evt.node)
        elif evt.action == "unmute":
            node.unmute()
            self.faulted.discard(evt.node)
        elif evt.action == "disconnect":
            node.disconnect()
            self.faulted.add(evt.node)
        elif evt.action == "reconnect":
            node.connect()
            self.faulted.discard(evt.node)
        elif evt.action == "crash":
            self.down.add(evt.node)
            self.faulted.add(evt.node)
            await self.app(evt.node).stop()
        elif evt.action == "restart":
            await self.app(evt.node).start()
            self.down.discard(evt.node)
            self.faulted.discard(evt.node)
        elif evt.action == "partition":
            from ..core.util import compute_quorum

            self.network.partition(*[list(g) for g in evt.groups])
            named = {m for g in evt.groups for m in g}
            rest = [i for i in range(1, self.n + 1) if i not in named]
            q, _ = compute_quorum(self.n)
            for g in [list(g) for g in evt.groups] + ([rest] if rest else []):
                if len(g) < q:
                    self.partition_minority.update(g)
        elif evt.action == "heal":
            self.network.heal()
            self.partition_minority.clear()
        elif evt.action == "corrupt":
            node.mutate_send = self._corruptor(evt.fraction)
            self.faulted.add(evt.node)
        elif evt.action == "uncorrupt":
            node.mutate_send = None
            self.faulted.discard(evt.node)
        # device-plane actions: the engine is shared, so no node is marked
        # faulted — the pump keeps submitting everywhere, which is the
        # point (consensus must keep committing through the outage)
        elif evt.action == "engine_hang":
            self._require_engine().hang()
        elif evt.action == "engine_fail":
            self._require_engine().fail_next(max(1, int(evt.count)))
        elif evt.action == "engine_slow":
            self._require_engine().slow(evt.fraction)
        elif evt.action == "engine_permanent":
            self._require_engine().permanent_error()
        elif evt.action == "engine_device_down":
            self._require_engine().lose_device(max(0, int(evt.count)))
        elif evt.action == "engine_device_restore":
            self._require_engine().restore_device(max(0, int(evt.count)))
        elif evt.action == "engine_heal":
            self._require_engine().heal()
        # overload actions: the open-loop pump is a fault like any other —
        # no node is marked faulted, the point is precisely that honest
        # traffic keeps arriving at nodes that must now shed
        elif evt.action == "load_spike":
            rate = evt.fraction if evt.fraction > 0 else 50.0
            # count is the Zipf client universe; the ChaosEvent default
            # (1, shared with engine_fail/reshard semantics) means
            # "unspecified" — a 1-client spike is a degenerate hammer
            # nobody schedules deliberately, so <= 1 takes the default 64
            n_clients = int(evt.count) if int(evt.count) > 1 else 64
            self.spike = {
                "pump": OpenLoopPump(rate, self.rng,
                                     start=self.scheduler.now()),
                "zipf": ZipfClients(n_clients, prefix="spike"),
            }
        elif evt.action == "load_stop":
            self.spike = None
        # Byzantine actions (require install_actor; the actor's armed
        # modes run continuously — only the replay needs a timeline hook,
        # since stale votes only EXIST after the cluster moved past them)
        elif evt.action == "byz_replay":
            if self.actor is None:
                raise RuntimeError(
                    "byz_replay needs ChaosCluster.install_actor first"
                )
            # staleness is judged against the CLUSTER's view, not the
            # actor's recording horizon: after a quiet view change the
            # actor holds only pre-change votes, all of them stale now
            view = max(
                (a.consensus.controller.curr_view_number
                 for a in self.live_apps()
                 if a.consensus is not None
                 and a.consensus.controller is not None),
                default=0,
            )
            self.actor.replay_stale(view)
        else:
            raise ValueError(f"unknown chaos action: {evt.action}")
        return evt

    def _require_engine(self):
        if self.engine is None:
            raise RuntimeError(
                "engine_* chaos actions need ChaosCluster(engine_faults=True)"
            )
        return self.engine

    def scan_latency_commits(self) -> None:
        """Resolve latency stamps against the longest live ledger
        (prefix-consistent, so already-scanned positions are stable).
        Called every run-loop tick; tests that submit stamped requests
        AFTER a schedule call it again to resolve the tail."""
        live = self.live_apps()
        if not live:
            return
        probe = max(live, key=lambda a: a.height())
        ledger = probe.ledger()
        for d in ledger[self._latency_scan_pos:]:
            for info in probe.requests_from_proposal(d.proposal):
                self.latency.on_committed(str(info), 0)
        self._latency_scan_pos = len(ledger)

    def _dump_on_failure(self) -> None:
        """Best-effort artifact dump on an invariant/liveness failure —
        must never mask the failure it documents."""
        try:
            paths = self.dump_flight_recorders()
            if paths:
                print(f"flight-recorder dumps written: {paths}")
        except Exception:  # noqa: BLE001
            pass

    def dump_flight_recorders(self, out_dir: Optional[str] = None) -> list:
        """Write each replica's last spans to ``out_dir`` (default: the
        SIBLING dir ``<wal_root>-flight`` — soaks run under a
        TemporaryDirectory whose cleanup would delete an in-tree dump
        while the failure propagates) as ``flight-<node>.json`` — the
        dump shape ``python -m smartbft_tpu_torch.obs.report`` renders.
        No-op (returns []) unless the cluster was built with
        ``trace=True``."""
        if not self.recorders:
            return []
        import os

        out_dir = out_dir or (self.wal_root.rstrip("/") + "-flight")
        os.makedirs(out_dir, exist_ok=True)
        return [
            rec.dump_to(os.path.join(out_dir, f"flight-{rec.node}.json"))
            for rec in self.recorders.values()
        ]

    def _corruptor(self, fraction: float):
        """Per-target message corruption.

        Copy-on-write contract: broadcasts share ONE frozen decoded message
        object across all recipients (the encode-once plane), so a mutation
        hook must never touch the routed original — the network enforces
        this by handing every mutate_send hook a deep copy
        (``messages.deep_copy_message``), making it impossible for the
        corruption of one recipient's message to leak into another
        replica's ingest (regression-pinned in tests/test_message_plane.py).
        """
        rng = self.rng

        def mutate(_target, msg):
            if isinstance(msg, (Prepare, Commit)) and rng.random() < fraction:
                return dataclasses.replace(msg, digest="corrupted-" + msg.digest[:8])
            return msg

        return mutate

    # -- the run loop ------------------------------------------------------

    async def run_schedule(
        self,
        schedule: list[ChaosEvent],
        *,
        requests: int = 20,
        submit_via: int = 0,
        submit_every: float = 0.3,
        settle_timeout: float = 300.0,
        step: float = 0.05,
        on_tick: Optional[Callable[[float], None]] = None,
    ) -> ChaosReport:
        """Execute the schedule under load and drain to quiescence.

        Requests ``chaos-0..requests-1`` are submitted one per
        ``submit_every`` logical seconds through the ``submit_via`` node
        (0 = rotate over live non-faulted nodes), interleaved with the
        timeline's events.  An active ``load_spike`` additionally pumps
        open-loop Poisson arrivals as background submit tasks (they ack,
        shed, or fail — all counted; ACKED spike requests join the drain
        target, shed ones never will).  After the last event AND last
        submission, the run continues until every live node committed
        every request (or ``settle_timeout`` logical seconds pass, which
        raises)."""
        report = ChaosReport()
        pending = sorted(schedule, key=lambda e: e.at)
        now = 0.0
        submitted = 0
        next_submit = 0.0
        next_health = 0.0
        heal_seen = False
        self._spike_pending = 0

        def target_app() -> Optional[App]:
            if submit_via:
                return self.app(submit_via) if submit_via not in self.down else None
            healthy = self.healthy_apps()
            return healthy[submitted % len(healthy)] if healthy else None

        async def spike_submit(key: str, cid: str, rid: str) -> None:
            healthy = self.healthy_apps()
            app = healthy[report.spike_offered % len(healthy)] \
                if healthy else None
            self.latency.on_submitted(key)
            if app is None or app.consensus is None:
                self.latency.on_shed(key, "other")
                report.spike_failed += 1
                return
            try:
                await app.submit(cid, rid)
                report.spike_acked += 1
            except AdmissionRejected:
                self.latency.on_shed(key, "admission")
                report.spike_shed_admission += 1
            except SubmitTimeoutError:
                self.latency.on_shed(key, "timeout")
                report.spike_shed_timeout += 1
            except Exception:  # noqa: BLE001 — counted, never kills the run
                self.latency.on_shed(key, "other")
                report.spike_failed += 1

        def pump_spike() -> None:
            sp = self.spike
            if sp is None:
                return
            for _ in range(sp["pump"].due(self.scheduler.now())):
                cid = sp["zipf"].sample(self.rng)
                rid = f"spike-{self._spike_seq}"
                self._spike_seq += 1
                report.spike_offered += 1
                # a done-callback counter, not a retained task list: the
                # drain check must not rescan O(offered) tasks per tick
                self._spike_pending += 1
                task = create_logged_task(
                    spike_submit(f"{cid}:{rid}", cid, rid),
                    name=f"chaos-{rid}",
                )
                task.add_done_callback(
                    lambda _t: setattr(self, "_spike_pending",
                                       self._spike_pending - 1)
                )

        def sample_occupancy() -> None:
            for a in self.live_apps():
                occ = a.pool_occupancy()
                pressure = occ.get("size", 0) + occ.get("waiters", 0)
                if pressure > report.spike_peak_occupancy:
                    report.spike_peak_occupancy = pressure

        def all_drained() -> bool:
            live = self.live_apps()
            # spike requests that were ACKED are pooled somewhere and must
            # commit; the count is final once every spike task finished
            need = requests + report.spike_acked
            return bool(live) and all(
                self.committed(a) >= need for a in live
            ) and self._spike_pending == 0

        deadline = None
        while True:
            # 1. fire due events
            while pending and pending[0].at <= now:
                evt = pending.pop(0)
                report.events_fired.append(await self._fire(evt))
                lo, hi = report.fault_span or (now, now)
                report.fault_span = (min(lo, now), max(hi, now))
            # 2. pump load
            if submitted < requests and now >= next_submit:
                app = target_app()
                if app is not None and app.consensus is not None:
                    try:
                        await app.submit("chaos", f"chaos-{submitted}")
                        submitted += 1
                        next_submit = now + submit_every
                    except Exception:
                        next_submit = now + submit_every  # pool full / no leader: retry later
                else:
                    next_submit = now + submit_every
            report.submitted = submitted
            # 2b. open-loop spike arrivals (when a load_spike is active)
            pump_spike()
            # 2c. caller-driven side traffic (read probes that
            # must land DURING faults, not after the drain)
            if on_tick is not None:
                on_tick(now)
            # 3. bookkeeping (latency/occupancy scans only when an
            # overload measurement is live — schedules without a spike
            # must not pay per-tick ledger decoding for an empty tracker)
            if self.spike is not None or self.latency.pending():
                self.scan_latency_commits()
                sample_occupancy()
            # 3b. continuous SLO evaluation (every 0.25 logical s — the
            # burn windows need cadence, not per-step granularity)
            if self.health_monitors and now >= next_health:
                self.tick_health(report)
                next_health = now + 0.25
            lead = self.leader_of()
            if lead:
                report.leaders_seen.add(lead)
            if not heal_seen and not pending and submitted >= requests:
                # schedule end is an implicit load_stop: every event has
                # fired so no load_stop can arrive, and an unstopped pump
                # would push the run to the 1h hard cap instead of
                # draining (a spike meant to outlive the baseline pump
                # schedules its load_stop explicitly)
                self.spike = None
                heal_seen = True
                report.heal_at = now
                live = self.live_apps()
                probe = live[0] if live else self.apps[0]
                report.committed_at_heal = self.committed(probe)
                report.decisions_at_heal = len(probe.ledger())
                deadline = now + settle_timeout
            # 4. exit condition
            if heal_seen and all_drained():
                break
            if deadline is not None and now > deadline:
                live = self.live_apps()
                self._dump_on_failure()  # liveness timeout: keep the trace
                raise TimeoutError(
                    f"chaos run did not drain within {settle_timeout}s of the "
                    f"last event: committed="
                    f"{[self.committed(a) for a in live]} of {requests}"
                )
            if now > 3600.0:
                self._dump_on_failure()
                raise TimeoutError("chaos run exceeded the hard 1h logical cap")
            # 5. advance logical time in lockstep with the loop
            await asyncio.sleep(0)
            self.scheduler.advance_by(step)
            await asyncio.sleep(0.001)
            now += step

        probe = self.live_apps()[0]
        report.final_committed = self.committed(probe)
        report.final_decisions = len(probe.ledger())
        return report


# ---------------------------------------------------------------------- invariants

class Invariants:
    """Post-run safety/liveness checks; every method raises AssertionError
    with a diagnostic on violation."""

    @staticmethod
    def fork_free(cluster: ChaosCluster) -> None:
        apps = cluster.live_apps()
        ref = [(d.proposal.payload, d.proposal.metadata) for d in apps[0].ledger()]
        for a in apps[1:]:
            other = [(d.proposal.payload, d.proposal.metadata) for d in a.ledger()]
            m = min(len(ref), len(other))
            assert ref[:m] == other[:m], (
                f"ledger fork between node {apps[0].id} and node {a.id}"
            )

    @staticmethod
    def exactly_once(cluster: ChaosCluster, expected: Optional[int] = None) -> None:
        for a in cluster.live_apps():
            infos = [
                str(i)
                for d in a.ledger()
                for i in a.requests_from_proposal(d.proposal)
            ]
            dupes = {i for i in infos if infos.count(i) > 1}
            assert not dupes, f"node {a.id} delivered duplicates: {sorted(dupes)}"
            if expected is not None:
                assert len(infos) >= expected, (
                    f"node {a.id} delivered {len(infos)} of {expected} requests"
                )
            seqs = [
                decode(ViewMetadata, d.proposal.metadata).latest_sequence
                for d in a.ledger()
                if d.proposal.metadata
            ]
            assert seqs == list(range(1, len(seqs) + 1)), (
                f"node {a.id} has a sequence gap: {seqs}"
            )

    @staticmethod
    def reads_linearizable(cluster: ChaosCluster, observations: list) -> int:
        """Every stamped read matches the committed state AT ITS HEIGHT.

        ``observations`` are ``(key, found, value, height)`` stamps a
        client collected during the run (any mode — local, follower, or
        the f+1 winner).  The oracle replays a live replica's committed
        prefix into an independent per-height KV timeline (the same
        last-write-per-client fold the serving plane uses, rebuilt from
        scratch here) and asserts each stamp against the state at its
        height — a read that returned a value its stamped height had not
        committed, or missed one it had, is a linearizability violation
        no matter what the cluster was doing when it was served.

        Returns the number of stamps checked.  Stamps below the
        replayer's snapshot base are uncheckable (their prefix was
        compacted away) and skipped."""
        from .app import BatchPayload, TestRequest

        apps = cluster.live_apps()
        assert apps, "no live replica to replay against"
        app = min(apps, key=lambda a: a.base_height)
        kv = dict(app.base_kv)
        timeline = [dict(kv)]  # timeline[i] = state at base_height + i
        for d in app.ledger():
            if d.proposal.payload:
                try:
                    batch = decode(BatchPayload, d.proposal.payload)
                except Exception:  # noqa: BLE001 — foreign payload
                    batch = None
                if batch is not None:
                    for raw in batch.requests:
                        try:
                            req = decode(TestRequest, raw)
                        except Exception:  # noqa: BLE001
                            continue
                        kv[req.client_id] = bytes(req.payload)
            timeline.append(dict(kv))
        base = app.base_height
        checked = 0
        for key, found, value, height in observations:
            idx = int(height) - base
            if idx < 0:
                continue  # pre-base stamp: prefix compacted, uncheckable
            assert idx < len(timeline), (
                f"read of {key!r} stamped height {height} beyond the "
                f"committed frontier {base + len(timeline) - 1}"
            )
            expect = timeline[idx].get(str(key))
            if found:
                assert expect is not None, (
                    f"read of {key!r} at height {height} returned a value "
                    f"but nothing was committed for it by then"
                )
                assert bytes(value) == expect, (
                    f"read of {key!r} at height {height} returned "
                    f"{bytes(value)!r}, committed state says {expect!r}"
                )
            else:
                assert expect is None, (
                    f"read of {key!r} at height {height} found nothing, "
                    f"but {expect!r} was committed by then"
                )
            checked += 1
        return checked

    @staticmethod
    def ever_blacklisted(cluster: ChaosCluster, node_id: int) -> None:
        """The faulty node must appear in the blacklist of SOME committed
        decision's metadata (it may later be redeemed once it rejoins and
        is witnessed alive — util.go:502-541 — so 'currently blacklisted'
        is deliberately not the assertion)."""
        app = cluster.live_apps()[0]
        seen = [
            list(decode(ViewMetadata, d.proposal.metadata).black_list)
            for d in app.ledger()
            if d.proposal.metadata
        ]
        assert any(node_id in bl for bl in seen), (
            f"node {node_id} never entered the committed blacklist; "
            f"blacklists seen: {seen}"
        )

    @staticmethod
    def no_equivocation_commit(cluster: ChaosCluster, actor,
                               max_blacklist_decisions: Optional[int] = None
                               ) -> None:
        """The equivocation oracle: judged against the actor's OWN send
        log.  (a) No two honest replicas committed
        different proposals at any (view, seq) — quorum intersection held
        against a leader telling every follower a different story.
        (b) None of the per-target variant digests the actor fabricated
        was ever committed (each variant reached exactly one follower, so
        no variant can gather a prepare quorum).  (c) The actor entered
        the committed blacklist within a bounded number of decisions of
        its first equivocation — the deposition machinery converged."""
        from ..types import proposal_digest as _pdigest

        apps = [a for a in cluster.live_apps() if a.id != actor.id]
        assert apps, "no honest replicas to check"
        slots = actor.equivocated_slots()
        assert slots, "actor never equivocated — the oracle is vacuous"
        committed: dict = {}
        for a in apps:
            for d in a.ledger():
                if not d.proposal.metadata:
                    continue
                md = decode(ViewMetadata, d.proposal.metadata)
                key = (md.view_id, md.latest_sequence)
                dig = _pdigest(d.proposal)
                got = committed.setdefault(key, dig)
                assert got == dig, (
                    f"equivocation committed: node {a.id} holds "
                    f"{dig[:12]}.. at (view, seq) {key} while another "
                    f"honest replica holds {got[:12]}.."
                )
        variant_digests = {
            dg
            for (v, s) in slots
            for dg in actor.variant_digests(v, s).values()
        }
        leaked = {k: dg for k, dg in committed.items()
                  if dg in variant_digests}
        assert not leaked, (
            f"a per-target variant digest gathered a quorum and "
            f"committed: {leaked}"
        )
        first_eq = min(s for _, s in slots)
        bl_seqs = [
            decode(ViewMetadata, d.proposal.metadata).latest_sequence
            for d in apps[0].ledger()
            if d.proposal.metadata
            and actor.id in decode(ViewMetadata,
                                   d.proposal.metadata).black_list
        ]
        assert bl_seqs, (
            f"equivocator {actor.id} never entered the committed "
            f"blacklist; slots equivocated: {slots}"
        )
        bound = max_blacklist_decisions if max_blacklist_decisions \
            is not None else 6 * max(cluster.depth, 1) + 8
        assert min(bl_seqs) - first_eq <= bound, (
            f"equivocator blacklisted only at seq {min(bl_seqs)}, "
            f"{min(bl_seqs) - first_eq} decisions after its first "
            f"equivocation at seq {first_eq} (bound {bound})"
        )

    @staticmethod
    def forger_shunned_and_shed(cluster: ChaosCluster, actor) -> None:
        """The vote-forgery oracle: every honest replica's
        per-sender accounting attributed the forged verdicts to the actor
        (and ONLY to provable causes from the actor), at least one
        crossed its shun threshold, and intake sheds followed — the flood
        stopped costing verify-plane launches."""
        assert actor.forged > 0, "actor never forged — oracle is vacuous"
        shun_events = 0
        sheds = 0
        for a in cluster.live_apps():
            if a.id == actor.id or a.consensus is None:
                continue
            snap = a.consensus.misbehavior_snapshot()
            by = snap["by_sender"].get(actor.id, {})
            assert by.get("invalid_sig", 0) > 0, (
                f"node {a.id} never attributed an invalid signature to "
                f"forger {actor.id}: {snap['by_sender']}"
            )
            for sender, causes in snap["by_sender"].items():
                if sender != actor.id:
                    assert causes.get("invalid_sig", 0) == 0, (
                        f"node {a.id} misattributed invalid signatures "
                        f"to honest sender {sender}: {causes}"
                    )
            shun_events += snap["shun_events"]
            sheds += sum(snap["shed_votes"].values())
        assert shun_events > 0, (
            f"no honest replica ever shunned forger {actor.id} "
            f"despite {actor.forged} forged votes"
        )
        assert sheds > 0, (
            "no forged vote was ever shed at intake — the accounting "
            "never turned into enforcement"
        )

    @staticmethod
    def stale_replay_observed(cluster: ChaosCluster, actor) -> None:
        """The stale-replay oracle: honest replicas COUNTED
        the actor's replayed old-view votes per sender, and none shunned
        it for them — stale views are an observed cause (honest replicas
        racing a view change emit the same shape), never a provable
        one."""
        assert actor.replayed > 0, "actor never replayed — oracle vacuous"
        observed = 0
        for a in cluster.live_apps():
            if a.id == actor.id or a.consensus is None:
                continue
            snap = a.consensus.misbehavior_snapshot()
            observed += snap["by_sender"].get(actor.id, {}) \
                .get("stale_view", 0)
            assert actor.id not in snap["shunned"], (
                f"node {a.id} shunned {actor.id} over stale-view replays "
                f"— an observed cause must never shun: {snap}"
            )
            assert snap["scores"].get(actor.id, 0) == 0, (
                f"stale-view replays moved {actor.id}'s provable score "
                f"on node {a.id}: {snap['scores']}"
            )
        assert observed > 0, (
            f"{actor.replayed} replayed stale votes were never counted "
            f"by any honest replica"
        )

    @staticmethod
    def liveness_within_windows(
        cluster: ChaosCluster, report: ChaosReport, slack_windows: int = 4
    ) -> None:
        """Bounded post-heal liveness: draining the requests outstanding at
        heal time must take at most the decisions they need (batches) plus
        ``slack_windows`` windows of protocol slack (view changes,
        redeliveries)."""
        batch = cluster.apps[0].config.request_batch_max_count
        outstanding = report.submitted - report.committed_at_heal
        need = math.ceil(outstanding / max(batch, 1))
        depth = max(cluster.depth, 1)
        bound = need + slack_windows * depth
        assert report.decisions_after_heal <= bound, (
            f"liveness took {report.decisions_after_heal} decisions "
            f"(~{math.ceil(report.decisions_after_heal / depth)} windows) to "
            f"drain {outstanding} requests; bound was {bound} decisions "
            f"(~{math.ceil(bound / depth)} windows)"
        )

    @staticmethod
    async def breaker_recovered(cluster: ChaosCluster, timeout: float = 8.0) -> None:
        """Engine-fault runs: after the schedule's final heal, the
        host-fallback breaker must return to CLOSED (the canary probe runs
        on wall-clock time and may lag the logical drain — poll briefly),
        with every open matched by a close."""
        co = cluster.coalescer
        if co is None:
            return
        import time as _time

        deadline = _time.monotonic() + timeout
        while co.breaker_open and _time.monotonic() < deadline:
            await asyncio.sleep(0.02)
        snap = co.fault_snapshot()
        assert not co.breaker_open, (
            f"verify breaker still open after heal: {snap}"
        )
        assert snap["opens"] == snap["closes"], (
            f"unbalanced breaker transitions after heal: {snap}"
        )

    @staticmethod
    def remediation_quiet(
        decisions, windows, grace: float = 0.0
    ) -> None:
        """Self-driving runs: every controller ACTION fell
        inside an injected-fault window (``grace`` extends each window's
        tail for the recovery it triggered).  ``decisions`` is the
        policy's acted-only log ``[(t, action, reason)]``; a controller
        that acts on a healthy, unfaulted cluster is hallucinating
        work — the steady state must be silence."""
        stray = [
            (round(t, 2), action, why)
            for (t, action, why) in decisions
            if not any(a <= t <= b + grace for (a, b) in windows)
        ]
        assert not stray, (
            f"controller acted outside every fault window "
            f"{[(round(a, 1), round(b, 1)) for (a, b) in windows]}: {stray}"
        )

    @staticmethod
    def no_flip_flop(decisions, window: float) -> None:
        """No A→B→A scale oscillation inside the hysteresis window —
        the Mir-BFT thrash lesson, counted by the SAME pure function the
        bench row reports so the invariant and the baseline guard cannot
        drift apart."""
        from ..control.policy import count_reversals

        flips = count_reversals(list(decisions), window)
        assert flips == 0, (
            f"{flips} scale reversal(s) within {window}s hysteresis: "
            f"{[(round(t, 2), a) for (t, a, _r) in decisions]}"
        )

    @classmethod
    def check_all(
        cls,
        cluster: ChaosCluster,
        report: ChaosReport,
        *,
        expected: Optional[int] = None,
        blacklisted: Optional[int] = None,
        slack_windows: int = 4,
    ) -> None:
        cls.fork_free(cluster)
        cls.exactly_once(cluster, expected)
        if blacklisted is not None:
            cls.ever_blacklisted(cluster, blacklisted)
        cls.liveness_within_windows(cluster, report, slack_windows)


def check_with_flight_dump(cluster: ChaosCluster, check: Callable[[], None],
                           out_dir: Optional[str] = None) -> None:
    """Run an invariant ``check``; on failure (AssertionError or
    TimeoutError) dump every replica's flight recorder to the run dir
    first, then re-raise — a failed soak leaves a timeline the
    ``obs.report`` tool can render, not just an assertion message."""
    try:
        check()
    except (AssertionError, TimeoutError):
        try:
            paths = cluster.dump_flight_recorders(out_dir)
            if paths:
                print(f"flight-recorder dumps written: {paths}")
        except Exception:  # noqa: BLE001 — never mask the real failure
            pass
        raise


# ---------------------------------------------------------------------- soak

def random_schedule(
    rng: random.Random, n: int, *, engine_faults: bool = False
) -> list[ChaosEvent]:
    """A randomized but always-heal-by-the-end schedule for soak runs.
    Leader-shaped faults use dynamic targets so they hit the node actually
    leading when the fault fires.  With ``engine_faults`` a device-plane
    fault shape is always present, with a 50% chance of ALSO running a
    protocol fault — device and protocol faults composing is exactly what
    production would see."""
    events: list[ChaosEvent] = []
    if engine_faults:
        t = rng.uniform(1.0, 4.0)
        shape = rng.choice(["hang", "fail", "slow", "permanent"])
        if shape == "hang":
            events.append(ChaosEvent(at=t, action="engine_hang"))
        elif shape == "fail":
            events.append(ChaosEvent(
                at=t, action="engine_fail", count=rng.randrange(1, 8)
            ))
        elif shape == "slow":
            events.append(ChaosEvent(
                at=t, action="engine_slow", fraction=rng.uniform(0.02, 0.1)
            ))
        else:
            events.append(ChaosEvent(at=t, action="engine_permanent"))
        events.append(ChaosEvent(
            at=t + rng.uniform(6.0, 14.0), action="engine_heal"
        ))
        if rng.random() < 0.5:
            return events
    t = rng.uniform(1.0, 3.0)
    shape = rng.choice(["mute", "crash", "partition", "corrupt"])
    if shape == "mute":
        events.append(ChaosEvent(at=t, action="mute", node="leader"))
        events.append(ChaosEvent(at=t + rng.uniform(8.0, 14.0), action="unmute", node="faulty"))
    elif shape == "crash":
        events.append(ChaosEvent(at=t, action="crash", node="leader"))
        events.append(ChaosEvent(at=t + rng.uniform(6.0, 12.0), action="restart", node="faulty"))
    elif shape == "partition":
        events.append(ChaosEvent(at=t, action="partition", groups=(("leader",),)))
        events.append(ChaosEvent(at=t + rng.uniform(6.0, 12.0), action="heal"))
    else:
        victim = rng.randrange(1, n + 1)
        events.append(
            ChaosEvent(at=t, action="corrupt", node=victim, fraction=rng.uniform(0.2, 0.8))
        )
        events.append(
            ChaosEvent(at=t + rng.uniform(6.0, 12.0), action="uncorrupt", node=victim)
        )
    return events


async def soak(
    *, rounds: int = 5, depth: int = 16, rotation: bool = True, seed: int = 1,
    n: int = 4, requests: int = 24, verbose: bool = True,
    engine_faults: bool = False,
) -> None:
    """Run ``rounds`` randomized schedules, checking every invariant.
    ``engine_faults`` adds randomized device-plane faults (hang / transient
    fail / slow / permanent) against a cluster whose verify plane runs
    through a shared FaultyEngine + fault-policy coalescer."""
    import tempfile

    rng = random.Random(seed)
    for r in range(rounds):
        with tempfile.TemporaryDirectory(prefix="chaos-soak-") as wal_root:
            cluster = ChaosCluster(
                wal_root, n=n, depth=depth, rotation=rotation, seed=seed + r,
                engine_faults=engine_faults, trace=True,
            )
            schedule = random_schedule(rng, n, engine_faults=engine_faults)
            await cluster.start()
            try:
                report = await cluster.run_schedule(
                    schedule, requests=requests, settle_timeout=600.0
                )

                def checks() -> None:
                    Invariants.fork_free(cluster)
                    Invariants.exactly_once(cluster, expected=requests)
                    Invariants.liveness_within_windows(
                        cluster, report, slack_windows=8
                    )

                # invariant failures leave per-replica flight-recorder
                # dumps in a SIBLING dir (rendered by obs.report) — the
                # temp run dir itself is deleted on the way out
                check_with_flight_dump(cluster, checks,
                                       out_dir=wal_root + "-flight")
                if engine_faults:
                    await Invariants.breaker_recovered(cluster)
                # health invariants: no critical verdict the injected
                # faults don't explain, and the verdict RETURNS to
                # healthy within a bounded window of the heal (the
                # breaker-trip and forced-VC shapes both ride this)
                assert_health_verdicts(report.verdicts, report.fault_span,
                                       None)
                # the engine-faults soak deliberately configures heartbeat
                # escalation OUT of the picture (its config comment above)
                # — the detection judgment applies to protocol-fault rounds
                muted_leader = not engine_faults and any(
                    e.action == "mute" for e in schedule
                )
                if muted_leader:
                    # detection judgment: a mute-leader round must be
                    # JUDGED as a detection failure — some verdict
                    # transition (cluster log or per-node monitor) names
                    # the viewchange.detection_seconds SLO while
                    # non-healthy.  A soak where the leader dies and the
                    # detection objective never trips means the
                    # instrument, not the cluster, is broken.
                    named = [
                        names
                        for _, status, names in report.verdicts
                        if status != "healthy"
                    ] + [
                        names
                        for mon in cluster.health_monitors.values()
                        for _, status, names in mon.transitions
                        if status != "healthy"
                    ]
                    assert any(
                        "viewchange.detection_seconds" in names
                        for names in named
                    ), (
                        f"mute round never breached "
                        f"viewchange.detection_seconds: {named}"
                    )
                    # ...and recovery is BOUNDED by the detection SLO
                    # machinery, not just "eventually": the detection
                    # sample is latched after it fired, ages out of the
                    # fast burn window, and the bound itself passes —
                    # past latch + fast-window + bound (+2 s of tick
                    # slack) a still-degraded verdict means detection
                    # keeps RE-firing, i.e. leadership is thrashing.
                    # Derived from the live defaults so tuning them
                    # can't silently misalign this judgment.
                    import inspect

                    from ..obs.health import vc_signal_source
                    from ..obs.slo import default_slo_spec
                    det_rule = next(
                        r for r in default_slo_spec().rules
                        if r.name == "viewchange.detection_seconds"
                    )
                    latch_s = inspect.signature(
                        vc_signal_source).parameters["latch_s"].default
                    recovery_bound = (latch_s + det_rule.fast_window_s
                                      + det_rule.bound + 2.0)
                else:
                    recovery_bound = 30.0
                recovery_s = await cluster.wait_healthy(
                    timeout=recovery_bound)
            finally:
                await cluster.stop()
            if verbose:
                kinds = [e.action for e in report.events_fired]
                extra = ""
                if engine_faults and cluster.coalescer is not None:
                    snap = cluster.coalescer.fault_snapshot()
                    extra = (
                        f" breaker opens={snap['opens']}"
                        f" fallback_batches={snap['host_fallback_batches']}"
                    )
                print(
                    f"round {r}: events={kinds} decisions={report.final_decisions} "
                    f"committed={report.final_committed} leaders={sorted(report.leaders_seen)} "
                    f"post-heal decisions={report.decisions_after_heal}{extra} "
                    f"verdicts={report.verdicts} healthy_in={recovery_s:.1f}s — OK"
                )


async def sharded_soak(
    *, rounds: int = 3, shards: int = 2, n: int = 4, depth: int = 4,
    seed: int = 1, requests: int = 8, verbose: bool = True,
) -> None:
    """Engine-fault soak against the SHARED verify plane of a sharded
    cluster: every round rides hang -> transient fail-burst -> heal while
    all S shards stay under load.  Asserts the breaker cycle is coherent
    across shards — one plane means one open, every shard degrades to the
    host fallback together (and keeps committing), every shard's items
    show in the per-tag wave attribution, and one close restores them all.
    Per-shard fork-free/exactly-once/gapless invariants are checked
    through the delivery mux."""
    import tempfile
    import time as _time

    from .sharded import ShardedCluster, sharded_config

    rng = random.Random(seed)
    for r in range(rounds):
        with tempfile.TemporaryDirectory(prefix="chaos-shard-soak-") as root:
            cfg = lambda s, i: sharded_config(
                i, depth=depth,
                request_forward_timeout=120.0,
                request_complain_timeout=240.0,
                request_auto_remove_timeout=480.0,
                leader_heartbeat_timeout=30.0,
                view_change_resend_interval=15.0,
                view_change_timeout=60.0,
                verify_launch_timeout=0.15, verify_launch_retries=2,
                verify_breaker_threshold=3, verify_probe_interval=0.05,
            )
            cluster = ShardedCluster(
                root, shards=shards, n=n, depth=depth, engine_faults=True,
                config_fn=cfg, seed=seed + r,
            )
            await cluster.start()
            try:
                # warm-up decision per shard on the healthy device
                for s in range(shards):
                    await cluster.submit(cluster.client_for_shard(s), f"w{r}-{s}a")
                    await cluster.submit(cluster.client_for_shard(s, 1), f"w{r}-{s}b")
                from .app import wait_for

                await wait_for(
                    lambda: all(sh.committed() >= 2 for sh in cluster.shard_list),
                    cluster.scheduler, 90.0,
                )
                # outage: hang, then a transient fail-burst (the un-wedged
                # but still-sick device), under load on every shard
                cluster.engine.hang()
                for s in range(shards):
                    for j in range(requests):
                        await cluster.submit(
                            cluster.client_for_shard(s, j % 2), f"o{r}-{s}-{j}"
                        )
                cluster.engine.fail_next(rng.randrange(4, 12))
                await wait_for(
                    lambda: all(sh.committed() >= 2 + requests
                                for sh in cluster.shard_list),
                    cluster.scheduler, 240.0,
                )
                snap = cluster.coalescer.fault_snapshot()
                assert snap["opens"] >= 1, snap
                assert snap["host_fallback_batches"] >= 1, snap
                tag_snap = cluster.coalescer.shard_snapshot()
                assert set(tag_snap["per_tag"]) == {
                    str(s) for s in range(shards)
                }, tag_snap
                # heal: the canary probe closes the breaker for everyone
                cluster.engine.heal()
                deadline = _time.monotonic() + 10.0
                while cluster.coalescer.breaker_open \
                        and _time.monotonic() < deadline:
                    await asyncio.sleep(0.02)
                snap = cluster.coalescer.fault_snapshot()
                assert not cluster.coalescer.breaker_open, snap
                assert snap["opens"] == snap["closes"], snap
                cluster.check_invariants()
            finally:
                await cluster.stop()
            if verbose:
                print(
                    f"sharded round {r}: shards={shards} "
                    f"committed={[sh.committed() for sh in cluster.shard_list]} "
                    f"breaker opens={snap['opens']} closes={snap['closes']} "
                    f"mixed_waves={tag_snap['mixed_waves']} — OK"
                )


async def openloop_soak(
    *, rounds: int = 3, shards: int = 2, n: int = 4, depth: int = 2,
    seed: int = 1, rate: float = 600.0, duration: float = 4.0,
    verbose: bool = True,
) -> None:
    """Overload soak: every round drives OPEN-loop Poisson/Zipf arrivals
    far past the knee of a small-pool sharded cluster with admission
    control armed, then drops to a trickle.  Asserts the overload
    contract (README "Overload behavior"): shedding engages, combined
    pool occupancy stays bounded by capacity (no unbounded queue growth),
    committed goodput stays positive THROUGH the spike, and the recovery
    phase's p99 returns under the spike phase's — all on the logical
    clock, so a round costs real milliseconds per offered second."""
    import dataclasses as _dc
    import tempfile

    from .load import run_open_loop
    from .sharded import ShardedCluster, sharded_config

    for r in range(rounds):
        with tempfile.TemporaryDirectory(prefix="chaos-openloop-") as root:
            pool_size = 24
            cfg = lambda s, i: _dc.replace(
                sharded_config(i, depth=depth),
                request_pool_size=pool_size,
                admission_high_water=0.75,
                request_pool_submit_timeout=1.0,
                request_batch_max_count=8,
            )
            cluster = ShardedCluster(
                root, shards=shards, n=n, depth=depth, config_fn=cfg,
                seed=seed + r,
            )
            await cluster.start()
            try:
                capacity = shards * pool_size
                cluster.set.latency.begin_phase("spike")
                # drain=1.0: let the hot shard's admitted backlog commit
                # before the trickle phase starts, or its first arrivals
                # hit a gate still holding the spike's tail
                spike = await run_open_loop(
                    cluster, rate=rate, duration=duration, seed=seed + r,
                    drain=1.0,
                )
                cluster.set.latency.begin_phase("recovery")
                calm = await run_open_loop(
                    cluster, rate=rate / 40.0, duration=duration,
                    drain=6.0, seed=seed + r + 1000,
                    request_prefix="calm",
                )
                cluster.set.latency.end_phase()
                snap = cluster.set.latency.snapshot()
                phases = snap["phases"]
                assert spike.shed > 0, (
                    f"round {r}: a {rate}/s spike at capacity {capacity} "
                    f"must shed, got {spike.block()}"
                )
                assert spike.acked > 0 and phases["spike"]["count"] > 0, (
                    f"round {r}: goodput collapsed under the spike: "
                    f"{spike.block()}"
                )
                assert spike.peak_occupancy <= capacity, (
                    f"round {r}: occupancy {spike.peak_occupancy} exceeded "
                    f"combined capacity {capacity} — admission failed to "
                    f"bound the queue"
                )
                assert calm.shed == 0, (
                    f"round {r}: the trickle phase must not shed: "
                    f"{calm.block()}"
                )
                # "recovers" = not worse than the spike beyond measurement
                # resolution: admission keeps ADMITTED-request latency near
                # baseline even mid-spike, so the two phases can be equal —
                # allow one √2 histogram bucket of quantization slack
                assert phases["recovery"]["p99_ms"] <= \
                    max(phases["spike"]["p99_ms"] * 1.5, 1.0), (
                    f"round {r}: p99 did not recover after the spike: "
                    f"{phases}"
                )
                cluster.check_invariants()
            finally:
                await cluster.stop()
            if verbose:
                print(
                    f"openloop round {r}: offered={spike.offered} "
                    f"acked={spike.acked} shed={spike.shed} "
                    f"peak_occ={spike.peak_occupancy}/{capacity} "
                    f"spike_p99={phases['spike']['p99_ms']}ms "
                    f"recovery_p99={phases['recovery']['p99_ms']}ms — OK"
                )


# ---------------------------------------------------------------------- selfdrive

async def _advance_clock(cluster, seconds: float, step: float = 0.05) -> None:
    """Advance the logical clock (polling commits) without offering load
    or ticking the controller."""
    t_end = cluster.scheduler.now() + seconds
    while cluster.scheduler.now() < t_end:
        cluster.scheduler.advance_by(step)
        await asyncio.sleep(0.001)
        cluster.poll()


async def _drive_segments(
    cluster, ctl, *, rate: float, duration: float, seg: float = 0.5,
    seed: int = 0, prefix: str = "sd", samples=None, fills=None,
) -> None:
    """Drive open-loop arrivals in SEGMENTS of the logical clock with at
    most ONE controller step in flight between segments.

    A step that decides to scale must await ``ShardSet.reshard``, whose
    drain needs the clock to keep advancing — so the step runs as a
    background task while the next segment advances time, and is drained
    (errors propagated) before this helper returns.  ``samples`` collects
    ``(t, verdict_status, decision_status)`` per tick; ``fills`` collects
    ``(t, combined_pool_fill)`` per segment — the before-the-knee
    evidence."""
    from .app import wait_for
    from .load import run_open_loop

    async def _step():
        rem = await ctl.step()
        if samples is not None:
            samples.append((
                rem.at, rem.__dict__.get("_verdict_status", ""), rem.status,
            ))

    step_task = None
    nseg = max(1, int(round(duration / seg)))
    for k in range(nseg):
        await run_open_loop(
            cluster, rate=rate, duration=seg, seed=seed * 4096 + k,
            request_prefix=f"{prefix}{k}",
        )
        if fills is not None:
            fills.append((
                cluster.scheduler.now(),
                float(cluster.set.occupancy().get("fill", 0.0)),
            ))
        if step_task is not None and step_task.done():
            step_task.result()
            step_task = None
        if step_task is None:
            step_task = create_logged_task(_step(), name="ctl-step")
    if step_task is not None:
        await wait_for(lambda: step_task.done(), cluster.scheduler, 180.0)
        step_task.result()


async def remediation_storm_round(
    *, seed: int = 1, shards: int = 2, n: int = 4, depth: int = 2,
    spike_rate: float = 1200.0, verbose: bool = True,
) -> dict:
    """One rotating-fault round against the self-driving control plane:
    load spike past the knee → engine hang→heal → muted
    leader, all on the logical clock.  The controller must scale out on
    the commit-latency burn BEFORE occupancy saturates, scale back in on
    sustained idle, veto while the breaker owns the hang, and answer the
    view-change breach with a derived-knob retune through the ordered
    reconfig path — with ZERO actions outside the fault windows, zero
    A→B→A flips, and every action a ``ctl.remediate`` span."""
    import tempfile

    from ..control import ControlLoop
    from ..obs.slo import default_slo_spec
    from .app import wait_for
    from .sharded import ShardedCluster, sharded_config

    pool_size = 4096
    cfg = lambda s, i: sharded_config(
        i, depth=depth,
        request_pool_size=pool_size,
        admission_high_water=1.0,
        request_pool_submit_timeout=30.0,
        request_batch_max_count=8,
        # verify_flush_hold's derivation ceiling is the batch interval,
        # and the hold is WALL-clock: keep it small so the retuned hold
        # cannot inflate LOGICAL commit latency under compressed time
        request_batch_max_interval=0.01,
        # long protocol timers: an engine stall must not read as a dead
        # leader (the breaker is the remedy there, not a view change)
        request_forward_timeout=120.0,
        request_complain_timeout=240.0,
        request_auto_remove_timeout=480.0,
        leader_heartbeat_timeout=30.0,
        view_change_resend_interval=15.0,
        view_change_timeout=60.0,
        # device-plane fault policy (wall clock, as in sharded_soak)
        verify_launch_timeout=0.15, verify_launch_retries=2,
        verify_breaker_threshold=3, verify_probe_interval=0.05,
        # compressed reflex-arc knobs (logical seconds)
        control_interval=0.5,
        control_cooldown=20.0,
        control_hysteresis=12.0,
        control_idle_hold=5.0,
        control_budget_actions=6,
        control_budget_window=60.0,
        autoscale_min_shards=shards,
        autoscale_max_shards=shards + 2,
    )
    # Tight SLO windows so breach/clear cycles fit a compressed round;
    # the latency bound sits far above trickle latency and far below the
    # spike's queueing delay.
    spec = default_slo_spec(
        fast_window_s=2.0, slow_window_s=20.0,
    ).with_overrides(**{"latency.commit_p99_ms": 1500.0})

    with tempfile.TemporaryDirectory(prefix="chaos-selfdrive-") as root:
        cluster = ShardedCluster(
            root, shards=shards, n=n, depth=depth, engine_faults=True,
            config_fn=cfg, seed=seed, trace=True, collect_entries=True,
            slo_spec=spec,
        )
        await cluster.start()
        try:
            ctl = ControlLoop(cluster)
            sched = cluster.scheduler
            samples: list = []
            fills: list = []
            windows: list = []

            async def drive(rate, dur, pfx, sd):
                await _drive_segments(
                    cluster, ctl, rate=rate, duration=dur, seed=sd,
                    prefix=pfx, samples=samples, fills=fills,
                )

            # ---- warmup: healthy steady state, zero actions expected
            await drive(4.0, 4.0, "wu", seed)
            assert not ctl.executed, (
                f"controller acted on a healthy cluster: {ctl.executed}"
            )

            # ---- fault 1: open-loop spike past the knee, then cooloff.
            # The burn must draw scale-out while the pool is still far
            # from its occupancy trip point; drained idle must draw the
            # matching scale-in after hysteresis.
            t0 = sched.now()
            await drive(spike_rate, 6.0, "sp", seed + 7)
            await drive(3.0, 26.0, "co", seed + 13)
            windows.append((t0, sched.now()))
            acts = list(ctl.executed)
            assert acts and acts[0]["action"] == "scale_out" \
                and acts[0]["cause"] == "latency.commit_p99_ms" \
                and acts[0]["ok"], f"spike did not draw scale-out: {acts}"
            before = [f for (tf, f) in fills if tf <= acts[0]["at"]]
            fill_at_out = before[-1] if before else 0.0
            assert fill_at_out < ctl.policy.high_occupancy, (
                f"scale-out fired AFTER the knee: fill={fill_at_out} at "
                f"t={acts[0]['at']}"
            )
            assert any(
                e["action"] == "scale_in" and e["ok"] for e in acts
            ), f"sustained idle never drew scale-in: {acts}"
            assert cluster.set.num_shards == shards, cluster.set.num_shards

            # ---- calm gap: out of window, must stay silent and green
            await drive(3.0, 4.0, "g1", seed + 17)
            n_gap1 = len(ctl.executed)
            assert n_gap1 == len(acts), (
                f"controller acted between faults: {ctl.executed[len(acts):]}"
            )

            # ---- fault 2: engine hang.  The breaker owns this outage:
            # commits degrade to the host fallback, and the controller's
            # scale-out candidate (the stall's latency burn) must be
            # VETOED while the breaker is open.
            t1 = sched.now()
            cluster.engine.hang()
            base_committed = [sh.committed() for sh in cluster.shard_list]
            for s in range(cluster.set.num_shards):
                await cluster.submit(
                    cluster.client_for_shard(s), f"hg-{seed}-{s}a"
                )
                await cluster.submit(
                    cluster.client_for_shard(s, 1), f"hg-{seed}-{s}b"
                )
            await wait_for(
                lambda: all(
                    sh.committed() >= b + 2
                    for sh, b in zip(cluster.shard_list, base_committed)
                ),
                sched, 240.0,
            )
            assert cluster.coalescer.breaker_open, \
                "engine hang never opened the verify breaker"
            # Pull the fallback commits into the latency tracker so the
            # flush tick SEES the stall's burn: the scale-out candidate
            # it draws is exactly what the breaker veto must suppress.
            cluster.poll()
            veto0 = ctl.policy.counters["veto_breaker"]
            for _ in range(2):
                rem = await ctl.step()
                samples.append((
                    rem.at, rem.__dict__.get("_verdict_status", ""),
                    rem.status,
                ))
            assert ctl.policy.counters["veto_breaker"] > veto0, (
                f"breaker open did not veto: {ctl.policy.snapshot()}"
            )
            cluster.engine.heal()
            await Invariants.breaker_recovered(cluster, timeout=10.0)
            # Let the stall's latency samples age out of the fast SLO
            # window before the reflex arc resumes ticking: the hang was
            # the breaker's fault to fix, not a capacity problem.
            await _advance_clock(cluster, 3.0)
            await drive(3.0, 6.0, "g2", seed + 19)
            windows.append((t1, sched.now()))
            n_hang = len(ctl.executed)
            assert n_hang == n_gap1, (
                f"controller scaled on a device outage: "
                f"{ctl.executed[n_gap1:]}"
            )

            # ---- fault 3: mute shard 0's leader.  Detection rides the
            # heartbeat timer; the view-change breach must draw a RETUNE
            # (derived knobs through the ordered reconfig stream), never
            # a scale action.  Trickle goes to shard 1 only — the muted
            # shard's clients have failed over.  Quiesce first: a tracked
            # request still in shard 0's pool would ride out the whole
            # view change and resurface as a bogus commit-latency burn.
            await _advance_clock(cluster, 2.0)
            t2 = sched.now()
            sh0 = cluster.shard_list[0]
            muted = sh0.mute_leader()
            for k in range(40):
                await _advance_clock(cluster, 1.0)
                await cluster.submit(
                    cluster.client_for_shard(1, k % 2), f"mu-{seed}-{k}"
                )
                rem = await ctl.step()
                samples.append((
                    rem.at, rem.__dict__.get("_verdict_status", ""),
                    rem.status,
                ))
            sh0.unmute(muted)
            retunes = [
                e for e in ctl.executed[n_hang:] if e["action"] == "retune"
            ]
            assert retunes and all(e["ok"] for e in retunes), (
                f"view-change breach drew no retune: {ctl.executed[n_hang:]}"
            )
            assert all(
                e["action"] == "retune" for e in ctl.executed[n_hang:]
            ), f"mute window drew a scale action: {ctl.executed[n_hang:]}"
            assert ctl.current_config.verify_flush_hold > 0.0

            def _retune_committed():
                cluster.poll()
                return any(
                    "ctl-retune" in rid
                    for e in cluster.delivered_entries
                    for rid in e.request_ids
                )

            await wait_for(_retune_committed, sched, 120.0)
            await drive(3.0, 5.0, "g3", seed + 23)
            windows.append((t2, sched.now()))
            n_mute = len(ctl.executed)

            # ---- settle: healthy, idle, and nothing left to do
            await drive(3.0, 4.0, "st", seed + 29)
            assert len(ctl.executed) == n_mute, (
                f"controller acted after all faults healed: "
                f"{ctl.executed[n_mute:]}"
            )

            # ---- the reflex-arc invariants
            stray_unhealthy = [
                (round(t, 1), st) for (t, st, _d) in samples
                if st != "healthy"
                and not any(a <= t <= b + 1.0 for (a, b) in windows)
            ]
            assert not stray_unhealthy, (
                f"SLO verdicts not green outside fault windows "
                f"{[(round(a, 1), round(b, 1)) for (a, b) in windows]}: "
                f"{stray_unhealthy}"
            )
            Invariants.remediation_quiet(
                ctl.policy.decisions, windows, grace=1.0
            )
            Invariants.no_flip_flop(
                ctl.policy.decisions, ctl.policy.hysteresis
            )
            cluster.check_invariants()
            spans = [
                e for e in cluster.trace_events()
                if e.get("kind") == "ctl.remediate"
            ]
            assert len(spans) == len(ctl.executed) >= 3, (
                f"{len(ctl.executed)} actions but {len(spans)} "
                f"ctl.remediate spans"
            )
            clears = [
                e for e in cluster.trace_events()
                if e.get("kind") == "ctl.clear"
            ]
            assert clears, "no ctl.clear span closed a remediation arc"

            pol = ctl.policy.snapshot()
            peak_fill = max(f for (_tf, f) in fills)
            stats = {
                "seed": seed,
                "faults": 3,
                "actions": len(ctl.executed),
                "actions_ok": sum(1 for e in ctl.executed if e["ok"]),
                "scale_out": pol["counters"]["scale_out"],
                "scale_in": pol["counters"]["scale_in"],
                "retune": pol["counters"]["retune"],
                "vetoes": {
                    k: v for k, v in pol["counters"].items()
                    if k.startswith("veto_") and v
                },
                "reversals": pol["reversals"],
                "actions_per_fault": round(len(ctl.executed) / 3.0, 3),
                "ctl_spans": len(spans),
                "clear_spans": len(clears),
                "verdict_samples": len(samples),
                "final_status": samples[-1][1],
                "peak_fill": round(peak_fill, 3),
                "fill_at_scale_out": round(fill_at_out, 3),
                "windows": [
                    (round(a, 1), round(b, 1)) for (a, b) in windows
                ],
            }
        finally:
            await cluster.stop()
    if verbose:
        print(
            f"selfdrive seed {seed}: actions={stats['actions']} "
            f"(out={stats['scale_out']} in={stats['scale_in']} "
            f"retune={stats['retune']}) "
            f"fill@out={stats['fill_at_scale_out']} "
            f"vetoes={stats['vetoes']} reversals={stats['reversals']} "
            f"final={stats['final_status']} — OK"
        )
    return stats


async def selfdrive_soak(
    *, rounds: int = 2, seed: int = 1, depth: int = 2,
    verbose: bool = True,
) -> None:
    """The ``--selfdrive`` remediation-storm soak: rotating faults on the
    logical clock, the controller as the ONLY remediator (the harness
    injects faults but never heals topology or knobs itself)."""
    for r in range(rounds):
        stats = await remediation_storm_round(
            seed=seed + r, depth=depth, verbose=verbose
        )
        assert stats["actions_per_fault"] <= 2.0, stats
        assert stats["reversals"] == 0, stats


# ---------------------------------------------------------------------- byzantine

#: the ``--byzantine`` matrix: one round per attack mode
BYZANTINE_MODES = ("equivocate", "forge", "censor", "stale", "sync_poison")


async def byzantine_round(
    mode: str, *, seed: int = 1, depth: int = 1, requests: int = 18,
    spike_rate: float = 30.0, verbose: bool = True,
) -> dict:
    """One Byzantine-actor round: an n=4 forgery-rejecting cluster
    (``ChaosCluster(byzantine=True)``: real toy-scheme CryptoProvider per
    replica over ONE shared verify plane) with f=1 actor misbehaving on
    the wire, judged by the mode's oracle plus every standard invariant.
    The cluster must stay safe AND live: every pumped request commits on
    every replica, fork-free and exactly-once, and the health verdict
    must not end critical.  Returns the round's observations."""
    import tempfile

    if mode == "sync_poison":
        # state-transfer plane: scripted-donor scenario over a real
        # net.launch rejoiner (testing.byzantine.sync_poison_round)
        from .byzantine import sync_poison_round

        with tempfile.TemporaryDirectory(prefix="chaos-byz-sync-") as root:
            obs = await sync_poison_round(root)
        liar = obs["liar"]
        assert obs["sync_poisoned"].get(liar, 0) >= obs["shun_threshold"], obs
        assert all(obs["sync_poisoned"].get(p, 0) == 0
                   for p in obs["honest_asks"]), obs
        assert obs["liar_asks_total"] == obs["liar_asks_pass1"], (
            f"the liar was asked again after crossing the donor-shun "
            f"threshold: {obs}"
        )
        assert obs["height"] == obs["target_height"], obs
        if verbose:
            print(
                f"byzantine round sync_poison: height={obs['height']}/"
                f"{obs['target_height']} poisoned={obs['sync_poisoned']} "
                f"liar_asks={obs['liar_asks_total']} — OK"
            )
        return obs

    with tempfile.TemporaryDirectory(prefix=f"chaos-byz-{mode}-") as wal_root:
        # censorship needs a STATIC leader: under rotation every replica's
        # pooled requests commit in its own leadership window, so the
        # forward timer never fires and there is nothing to suppress.  The
        # complain machinery deposing the censor IS the scenario.
        cluster = ChaosCluster(
            wal_root, n=4, depth=depth, rotation=(mode != "censor"),
            seed=seed, byzantine=True, trace=True,
        )
        # equivocation and censorship are LEADER attacks: the actor is the
        # initial leader so its window opens immediately.  Forgery and
        # stale replay work from any seat: the actor starts as a follower.
        actor_node = 1 if mode in ("equivocate", "censor") else 4
        await cluster.start()
        try:
            actor = cluster.install_actor(actor_node)
            schedule: list[ChaosEvent] = []
            if mode == "equivocate":
                actor.equivocate()
            elif mode == "forge":
                actor.forge_votes(per_preprepare=3)
            elif mode == "censor":
                # censorship must be judged UNDER OPEN-LOOP LOAD: the
                # complain/forward machinery has to detect suppression
                # while the admission gate is also working
                actor.censor({"chaos"})
                schedule = [
                    ChaosEvent(at=1.0, action="load_spike",
                               fraction=spike_rate),
                    ChaosEvent(at=6.0, action="load_stop"),
                ]
            elif mode == "stale":
                # record view-0 votes, depose the leader so the cluster
                # moves to view 1, then replay the recorded stale votes
                actor.stale_replay()
                schedule = [
                    ChaosEvent(at=2.0, action="mute", node="leader"),
                    ChaosEvent(at=10.0, action="unmute", node="faulty"),
                    ChaosEvent(at=14.0, action="byz_replay"),
                    ChaosEvent(at=16.0, action="byz_replay"),
                ]
            else:
                raise ValueError(f"unknown byzantine mode {mode!r}")
            if mode == "stale":
                # two phases: pump and drain FIRST (the actor records the
                # view-0 votes it will replay), THEN the mute -> view
                # change -> replay timeline with nothing in flight.  A
                # request still pooled at the leader when it goes mute is
                # unrecoverable: its forward and complain retries all fire
                # into the mute and the pool's auto-remove stage then
                # drops it, so the round must not race the pump against
                # the mute.
                await cluster.run_schedule(
                    [], requests=requests, settle_timeout=600.0
                )
                report = await cluster.run_schedule(
                    schedule, requests=0, settle_timeout=600.0
                )
                # the last replay fires on the final event tick; give the
                # inboxes a moment to dispatch it before the oracle counts
                for _ in range(40):
                    await asyncio.sleep(0)
                    cluster.scheduler.advance_by(0.05)
                    await asyncio.sleep(0.001)
            else:
                report = await cluster.run_schedule(
                    schedule, requests=requests, settle_timeout=600.0
                )

            def checks() -> None:
                Invariants.fork_free(cluster)
                Invariants.exactly_once(cluster, expected=requests)
                if mode == "equivocate":
                    Invariants.no_equivocation_commit(cluster, actor)
                elif mode == "forge":
                    Invariants.forger_shunned_and_shed(cluster, actor)
                elif mode == "stale":
                    Invariants.stale_replay_observed(cluster, actor)
                elif mode == "censor":
                    assert actor.censored > 0, (
                        "censor round: no forwarded request was ever "
                        "suppressed — the attack never engaged"
                    )
                    assert len(report.leaders_seen) > 1, (
                        f"censoring leader was never deposed: "
                        f"leaders={report.leaders_seen}"
                    )

            check_with_flight_dump(cluster, checks,
                                   out_dir=wal_root + "-flight")
            # the actor misbehaves from t=0 with no healing event, so the
            # fault window spans the whole run: any critical verdict
            # inside it is explained, ENDING critical is not
            span = report.fault_span or (0.0, report.heal_at)
            assert_health_verdicts(report.verdicts, span,
                                   report.final_health)
        finally:
            await cluster.stop()
        if verbose:
            print(
                f"byzantine round {mode}: actor=n{actor_node} "
                f"decisions={report.final_decisions} "
                f"committed={report.final_committed} "
                f"leaders={sorted(report.leaders_seen)} "
                f"actor_snapshot={actor.snapshot()} — OK"
            )
        return {"mode": mode, "actor": actor.snapshot(),
                "decisions": report.final_decisions,
                "leaders": sorted(report.leaders_seen)}


async def byzantine_soak(
    *, rounds: int = 1, depth: int = 1, seed: int = 1, requests: int = 18,
    verbose: bool = True,
) -> None:
    """The ``--byzantine`` chaos matrix: every attack mode
    (equivocation, vote forgery, leader censorship, stale-view replay,
    sync poisoning), ``rounds`` times each with fresh seeds.  n=3f+1
    clusters with f=1 actor misbehaving must stay safe and live in every
    round."""
    for r in range(rounds):
        for mode in BYZANTINE_MODES:
            await byzantine_round(
                mode, seed=seed + r * len(BYZANTINE_MODES), depth=depth,
                requests=requests, verbose=verbose,
            )


async def byzantine_latency_probe(
    *, forge: bool = False, seed: int = 1, requests: int = 8,
    rate: float = 30.0, spike_s: float = 6.0,
) -> dict:
    """One honest-path latency measurement for the ``--byzantine`` bench
    row: open-loop spike arrivals against the n=4 forgery-rejecting
    cluster, with (``forge=True``) or without a Byzantine actor flooding
    forged votes at the shared verify plane.  The paired snapshots bound
    how much latency an active forger can inflict on honest clients —
    the accounting/shedding machinery is the thing under test.  Returns
    the latency block plus spike accounting."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="byz-probe-") as root:
        cluster = ChaosCluster(root, n=4, depth=1, rotation=True,
                               seed=seed, byzantine=True)
        await cluster.start()
        try:
            if forge:
                cluster.install_actor(4).forge_votes(per_preprepare=3)
            schedule = [
                ChaosEvent(at=0.5, action="load_spike", fraction=rate),
                ChaosEvent(at=0.5 + spike_s, action="load_stop"),
            ]
            report = await cluster.run_schedule(
                schedule, requests=requests, settle_timeout=600.0
            )
            Invariants.fork_free(cluster)
            snap = cluster.latency.snapshot()
            shuns = sheds = 0
            for a in cluster.live_apps():
                if a.consensus is None:
                    continue
                mis = a.consensus.misbehavior_snapshot()
                shuns += mis.get("shun_events", 0)
                sheds += sum(mis.get("shed_votes", {}).values())
            return {
                "latency": snap,
                "spike_offered": report.spike_offered,
                "spike_acked": report.spike_acked,
                "decisions": report.final_decisions,
                "forged": cluster.actor.forged if forge else 0,
                "shun_events": shuns,
                "shed_votes": sheds,
            }
        finally:
            await cluster.stop()


# ---------------------------------------------------------------------- reshard

@dataclass
class ReshardReport:
    """What a reshard schedule run observed (the oracle inputs)."""

    submitted_ok: list = field(default_factory=list)   # "client:rid" acked
    submit_failures: list = field(default_factory=list)
    reshards: list = field(default_factory=list)       # transition summaries
    events_fired: list = field(default_factory=list)
    shard_counts_seen: list = field(default_factory=list)


def reshard_schedule(
    *, out_at=2.0, out_to=4, in_at=10.0, in_to=3,
    crash_shard: Optional[int] = 0, crash_node: int = 2,
    restart_at: Optional[float] = 16.0,
) -> list[ChaosEvent]:
    """The acceptance timeline: S -> ``out_to`` mid-burst with one replica
    crashed inside the handoff window, then -> ``in_to``, then the crashed
    replica rejoins.  The events are held (not dropped) when their
    precondition is not yet true — ``reshard`` waits for the previous
    transition to finish, ``crash_during_reshard`` waits for one to be in
    flight."""
    events = [ChaosEvent(at=out_at, action="reshard", count=out_to)]
    if crash_shard is not None:
        events.append(ChaosEvent(
            at=out_at + 0.1, action="crash_during_reshard",
            shard=crash_shard, node=crash_node,
        ))
    events.append(ChaosEvent(at=in_at, action="reshard", count=in_to))
    if crash_shard is not None and restart_at is not None:
        events.append(ChaosEvent(
            at=restart_at, action="restart", shard=crash_shard,
            node=crash_node,
        ))
    return events


async def run_reshard_schedule(
    cluster,
    schedule: list[ChaosEvent],
    *,
    requests: int = 24,
    submit_every: float = 0.2,
    settle_timeout: float = 400.0,
    step: float = 0.05,
) -> ReshardReport:
    """Drive a ``ShardedCluster`` (built with ``collect_entries=True``)
    through a reshard timeline under continuous front-door load.

    The pump submits through the routed front door as BACKGROUND tasks: a
    moved client's submit legitimately parks at the epoch barrier until
    the flip, and the logical clock must keep advancing underneath it.
    Reshard transitions also run as background tasks (they poll commits
    that only happen while the clock here advances).  After the last
    event and submission, the run continues until every acked request is
    visible in the combined committed stream.

    Returns the report; exactly-once/gapless are enforced LIVE by the
    delivery mux (any violation raises out of the transition or the
    drain), and the caller typically finishes with
    ``assert_exactly_once_across_epochs``."""
    from ..shard.epoch import RESHARD_CLIENT
    from ..utils.tasks import create_logged_task

    assert cluster.set.mux._on_deliver is not None, (
        "run_reshard_schedule needs ShardedCluster(collect_entries=True)"
    )
    report = ReshardReport()
    pending = sorted(schedule, key=lambda e: e.at)
    held: list[ChaosEvent] = []
    submit_tasks: list = []
    reshard_tasks: list = []
    now = 0.0
    submitted = 0
    next_submit = 0.0

    def _spawn_reshard(target: int) -> None:
        async def _go():
            try:
                report.reshards.append(await cluster.reshard(target))
            except Exception as e:  # noqa: BLE001 — recorded, checked below
                report.reshards.append({"failed": repr(e), "target": target})

        reshard_tasks.append(
            create_logged_task(_go(), name=f"chaos-reshard-{target}")
        )

    def _spawn_submit(cid: str, rid: str) -> None:
        async def _go():
            try:
                await cluster.submit(cid, rid)
                report.submitted_ok.append(f"{cid}:{rid}")
            except Exception as e:  # noqa: BLE001 — a parked submit may
                # time out at the drain deadline; the oracle only counts
                # ACKED submissions
                report.submit_failures.append((f"{cid}:{rid}", repr(e)))

        submit_tasks.append(
            create_logged_task(_go(), name=f"chaos-submit-{rid}")
        )

    async def _fire(evt: ChaosEvent) -> bool:
        """True = consumed; False = precondition not met, hold."""
        if evt.action == "reshard":
            if cluster.set.reshard_in_progress:
                return False
            _spawn_reshard(int(evt.count))
        elif evt.action == "crash_during_reshard":
            if not cluster.set.reshard_in_progress:
                # if every reshard already finished, the window is gone —
                # degrade to a plain crash rather than hanging the run
                if pending or not all(t.done() for t in reshard_tasks):
                    return False
            await cluster.shard(evt.shard).crash(evt.node)
        elif evt.action == "crash":
            await cluster.shard(evt.shard).crash(evt.node)
        elif evt.action == "restart":
            sh = next((s for s in cluster.shard_list
                       if s.shard_id == evt.shard), None)
            if sh is not None:
                await sh.restart(evt.node)
        else:
            raise ValueError(f"unknown reshard-schedule action {evt.action}")
        report.events_fired.append(evt)
        return True

    deadline = None
    while True:
        # 1. fire due events (holding the ones whose precondition waits)
        due = [e for e in pending if e.at <= now] + held
        pending = [e for e in pending if e.at > now]
        held = []
        for evt in due:
            if not await _fire(evt):
                held.append(evt)
        # 2. pump load over the ACTIVE epoch's shards
        if submitted < requests and now >= next_submit:
            s_active = cluster.set.router.shards_at(cluster.set.epoch)
            sid = submitted % s_active
            cid = cluster.client_for_shard(sid, submitted % 3)
            _spawn_submit(cid, f"rs-{submitted}")
            submitted += 1
            next_submit = now + submit_every
        if (not report.shard_counts_seen
                or report.shard_counts_seen[-1] != cluster.set.num_shards):
            report.shard_counts_seen.append(cluster.set.num_shards)
        # 3. exit condition: everything fired, every transition + submit
        # task done, and every ACKED request visible in the stream
        idle = (not pending and not held and submitted >= requests
                and all(t.done() for t in submit_tasks)
                and all(t.done() for t in reshard_tasks))
        if idle and deadline is None:
            deadline = now + settle_timeout
        if idle:
            cluster.poll()
            delivered = {
                rid
                for e in cluster.delivered_entries
                for rid in e.request_ids
                if not rid.startswith(RESHARD_CLIENT + ":")
            }
            if set(report.submitted_ok) <= delivered:
                break
        if deadline is not None and now > deadline:
            raise TimeoutError(
                f"reshard run did not drain within {settle_timeout}s: "
                f"acked={len(report.submitted_ok)} "
                f"delivered={len(cluster.delivered_entries)}"
            )
        if now > 3600.0:
            raise TimeoutError("reshard run exceeded the hard 1h logical cap")
        # 4. advance logical time in lockstep with the loop
        await asyncio.sleep(0)
        cluster.scheduler.advance_by(step)
        await asyncio.sleep(0.001)
        now += step
    return report


def assert_exactly_once_across_epochs(cluster, report: ReshardReport) -> None:
    """The reshard oracle: every ACKED request appears EXACTLY once in the
    combined committed stream across all epochs (nothing lost, nothing
    doubled through any handoff), every live shard is fork-free, and at
    least the scheduled transitions completed."""
    from collections import Counter

    from ..shard.epoch import RESHARD_CLIENT

    counts = Counter(
        rid
        for e in cluster.delivered_entries
        for rid in e.request_ids
        if not rid.startswith(RESHARD_CLIENT + ":")
    )
    missing = [r for r in report.submitted_ok if counts[r] == 0]
    dupes = {r: c for r, c in counts.items() if c > 1}
    assert not missing, f"acked requests never committed: {missing}"
    assert not dupes, f"requests delivered more than once: {dupes}"
    failed = [r for r in report.reshards if "failed" in r]
    assert not failed, f"reshard transitions failed: {failed}"
    for shard in cluster.shard_list:
        shard.assert_fork_free()


async def reshard_soak(
    *, rounds: int = 2, n: int = 4, depth: int = 2, seed: int = 1,
    requests: int = 18, crash: bool = True, verbose: bool = True,
) -> None:
    """Elastic-shard soak: every round rides S=2 -> 4 -> 3 mid-burst —
    with one replica crashed inside the handoff window when ``crash`` —
    and must lose NOTHING: every acked request exactly once across the
    epochs, per-shard gapless (mux-enforced live), fork-free."""
    import tempfile

    rng = random.Random(seed)
    for r in range(rounds):
        with tempfile.TemporaryDirectory(prefix="chaos-reshard-") as root:
            from .sharded import ShardedCluster

            cluster = ShardedCluster(
                root, shards=2, n=n, depth=depth, seed=seed + r,
                collect_entries=True, reshard_drain_deadline=120.0,
            )
            schedule = reshard_schedule(
                crash_shard=rng.randrange(2) if crash else None,
                crash_node=rng.randrange(2, n + 1),
            )
            await cluster.start()
            try:
                report = await run_reshard_schedule(
                    cluster, schedule, requests=requests,
                    settle_timeout=600.0,
                )
                assert_exactly_once_across_epochs(cluster, report)
                assert cluster.set.num_shards == 3, cluster.set.num_shards
                assert cluster.set.epoch >= 2, cluster.set.epoch
            finally:
                await cluster.stop()
            if verbose:
                print(
                    f"reshard round {r}: epochs={cluster.set.epoch} "
                    f"shards_seen={report.shard_counts_seen} "
                    f"acked={len(report.submitted_ok)} "
                    f"parked_failures={len(report.submit_failures)} "
                    f"reshards={[x.get('epoch') for x in report.reshards]} "
                    f"— OK"
                )


def main(argv: Optional[list[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="SmartBFT chaos harness (scripted fault schedules)"
    )
    ap.add_argument("--soak", action="store_true", help="run randomized soak rounds")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--depth", type=int, default=16, help="pipeline_depth")
    ap.add_argument("--no-rotation", action="store_true")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument(
        "--engine-faults", action="store_true",
        help="add randomized device-plane faults (hang / transient fail / "
             "slow / permanent) against the shared verify engine",
    )
    ap.add_argument(
        "--shards", type=int, default=0,
        help="run the engine-fault soak against S consensus groups sharing "
             "one verify plane (implies --engine-faults; breaker cycle must "
             "affect all shards coherently)",
    )
    ap.add_argument(
        "--reshard", action="store_true",
        help="run the elastic-shard soak: S=2->4->3 live resharding "
             "mid-burst with a replica crash inside the handoff window; "
             "exactly-once across epochs + fork-free + gapless pinned",
    )
    ap.add_argument(
        "--open-loop", action="store_true",
        help="run the overload soak: open-loop Poisson/Zipf arrivals past "
             "the knee of a small-pool admission-controlled sharded "
             "cluster — shedding engages, occupancy stays bounded, "
             "goodput stays positive, p99 recovers",
    )
    ap.add_argument(
        "--rate", type=float, default=600.0,
        help="--open-loop offered load (arrivals per logical second)",
    )
    ap.add_argument(
        "--sockets", action="store_true",
        help="run the fault matrix at the SOCKET level: one OS process per "
             "replica over real UDS transport (smartbft_tpu_torch.net), SIGKILL-"
             "and-rejoin + slow-link rounds, wall-clock offsets",
    )
    ap.add_argument(
        "--transport", default="uds", choices=("uds", "tcp"),
        help="--sockets / --snapshots transport flavor",
    )
    ap.add_argument(
        "--snapshots", action="store_true",
        help="run the truncating soak at the SOCKET level: "
             "kill-rejoin must come back via snapshot install (the donors "
             "have compacted past the victim's crash height), "
             "crash_during_snapshot races a capture with SIGKILL, a donor "
             "dies mid-chunk; disk stays bounded, no poisoning, fork-free",
    )
    ap.add_argument(
        "--selfdrive", action="store_true",
        help="run the remediation-storm soak: rotating faults "
             "(load spike past the knee, engine hang->heal, muted leader) "
             "against the self-driving control plane; the controller must "
             "scale out on the latency burn before the knee, retune knobs "
             "through ordered reconfig, veto during breaker/transition "
             "windows, and stay SILENT outside fault windows with zero "
             "A->B->A oscillation",
    )
    ap.add_argument(
        "--byzantine", action="store_true",
        help="run the Byzantine actor matrix: equivocation, "
             "vote forgery, leader censorship, stale-view replay and sync "
             "poisoning against n=3f+1 forgery-rejecting clusters; the "
             "cluster must stay safe AND live in every round",
    )
    args = ap.parse_args(argv)
    if not args.soak:
        ap.error("nothing to do: pass --soak")
    if args.selfdrive:
        asyncio.run(
            selfdrive_soak(
                rounds=min(args.rounds, 3),
                depth=min(args.depth, 4),
                seed=args.seed,
            )
        )
        print("chaos soak (selfdrive): all rounds passed")
        return 0
    if args.byzantine:
        asyncio.run(
            byzantine_soak(
                rounds=args.rounds,
                depth=min(args.depth, 4),
                seed=args.seed,
                requests=min(args.requests, 24),
            )
        )
        print("chaos soak (byzantine): all rounds passed")
        return 0
    if args.snapshots:
        from ..net.cluster import snapshot_soak

        snapshot_soak(rounds=args.rounds, transport=args.transport)
        print("chaos soak (snapshots): all rounds passed")
        return 0
    if args.sockets:
        from ..net.cluster import socket_soak

        socket_soak(
            rounds=args.rounds,
            transport=args.transport,
            requests=args.requests,
        )
        print("chaos soak (sockets): all rounds passed")
        return 0
    if args.open_loop:
        asyncio.run(
            openloop_soak(
                rounds=args.rounds,
                depth=min(args.depth, 4),
                seed=args.seed,
                rate=args.rate,
            )
        )
        print("chaos soak (open-loop): all rounds passed")
        return 0
    if args.reshard:
        asyncio.run(
            reshard_soak(
                rounds=args.rounds,
                depth=min(args.depth, 4),
                seed=args.seed,
                requests=args.requests,
            )
        )
        print("chaos soak (reshard): all rounds passed")
        return 0
    if args.shards > 0:
        asyncio.run(
            sharded_soak(
                rounds=args.rounds,
                shards=args.shards,
                depth=min(args.depth, 4),
                seed=args.seed,
                requests=args.requests,
            )
        )
        print("chaos soak (sharded): all rounds passed")
        return 0
    asyncio.run(
        soak(
            rounds=args.rounds,
            depth=args.depth,
            rotation=not args.no_rotation,
            seed=args.seed,
            requests=args.requests,
            engine_faults=args.engine_faults,
        )
    )
    print("chaos soak: all rounds passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
