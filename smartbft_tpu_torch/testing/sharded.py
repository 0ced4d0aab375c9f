"""In-process sharded cluster harness: S App-clusters, ONE verify plane.

The test/bench realization of ``smartbft_tpu_torch.shard``: each shard is an
n-node cluster of :class:`~smartbft_tpu_torch.testing.app.App` replicas over a
group-namespaced slice of ONE in-process :class:`~smartbft_tpu_torch.testing.
network.Network` (shards reuse node ids 1..n with no inbox collisions),
with per-shard WAL directories, per-shard ledgers, and a per-shard
:class:`~smartbft_tpu_torch.metrics.ProtocolPlaneTimers` for cost attribution —
while EVERY replica of EVERY shard verifies through one shared
``AsyncBatchCoalescer`` (each provider tagged with its shard id), so
quorum waves from different shards coalesce into common launches.  That
shared plane is the whole point: it is what the cross-shard-coalescing
tier-1 gate (tests/test_sharded.py) and the ``benchmarks/sharded.py``
sweep measure, and what the ``--shards`` chaos soak stresses.

Crypto modes:

* ``"trivial"`` — :class:`~smartbft_tpu_torch.testing.engine_faults.
  CoalescedTrivialCrypto` over an always-valid host engine: signature
  semantics identical to the crypto-less test App, but quorum checks
  genuinely traverse the shared coalescer (and its fault machinery when
  ``engine_faults=True`` wraps the engine in a FaultyEngine).
* ``"p256"`` / ``"ed25519"`` — real per-shard keyrings + CryptoProviders
  over one shared engine: the caller's, else
  ``TorchVerifyEngine(scheme=...)``, which runs on the card (the bench
  configuration); the CPU tests pass their own engine.
* ``"toy"`` — the real provider stack over :mod:`.toy_scheme`, whose
  batched verify is one torch expression, on a host engine by default.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

from ..codec import decode, encode
from ..config import Configuration
from ..crypto.provider import (
    AsyncBatchCoalescer,
    HostVerifyEngine,
    VerifyFaultPolicy,
)
from ..messages import ViewMetadata
from ..metrics import InMemoryProvider, ProtocolPlaneTimers, TPUCryptoMetrics
from ..shard import ShardHandle, ShardRouter, ShardSet
from ..utils.clock import Scheduler
from .app import App, SharedLedgers, TestRequest, fast_config
from .engine_faults import (
    CoalescedTrivialCrypto,
    FaultyEngine,
    always_valid_engine,
)
from .network import Network

__all__ = ["AppShard", "ShardedCluster", "sharded_config"]


def sharded_config(i: int, *, depth: int = 1, rotation: bool = False,
                   **overrides) -> Configuration:
    """Per-node configuration for sharded runs: the fast test config with
    the pipelined window and (optionally) window-granular rotation, plus
    headroom on the complaint chain — a shard sharing one event loop with
    S-1 siblings must not misread scheduler contention as a dead leader."""
    base = dict(
        leader_rotation=rotation,
        decisions_per_leader=1 if rotation else 0,
        rotation_granularity="window" if (rotation and depth > 1) else "decision",
        pipeline_depth=depth,
        request_batch_max_count=2,
        request_batch_max_interval=0.05,
        leader_heartbeat_timeout=15.0,
        leader_heartbeat_count=10,
        view_change_timeout=30.0,
        view_change_resend_interval=4.0,
        request_forward_timeout=8.0,
        request_complain_timeout=20.0,
        request_auto_remove_timeout=120.0,
    )
    base.update(overrides)
    return dataclasses.replace(fast_config(i), **base)


class AppShard(ShardHandle):
    """One shard: n test Apps over a group-scoped network slice.

    ``group_key`` decouples the network namespace from the shard id: a
    shard id RE-CREATED after an earlier incarnation retired (scale-in
    then scale-out through the same id) is a brand-new consensus group
    and must not collide with the dead incarnation's node registrations
    or WAL directories (``wal_subdir`` likewise)."""

    def __init__(self, shard_id: int, network: Network, scheduler: Scheduler,
                 wal_root: str, *, n: int = 4,
                 config_fn: Callable[[int], Configuration],
                 crypto_fn: Callable[[int], Optional[object]],
                 plane: Optional[ProtocolPlaneTimers] = None,
                 group_key: Optional[int] = None,
                 wal_subdir: Optional[str] = None,
                 recorder_fn: Optional[Callable[[int], object]] = None):
        self.shard_id = int(shard_id)
        self.plane = plane if plane is not None \
            else ProtocolPlaneTimers(name=f"shard-{shard_id}")
        gid = self.shard_id if group_key is None else int(group_key)
        self.net = network.group(gid, plane=self.plane)
        self.shared = SharedLedgers()
        self.scheduler = scheduler
        subdir = wal_subdir or f"shard-{shard_id}"
        self.apps = [
            App(i, self.net, self.shared, scheduler,
                wal_dir=f"{wal_root}/{subdir}/wal-{i}",
                config=config_fn(i), crypto=crypto_fn(i),
                recorder=recorder_fn(i) if recorder_fn is not None else None)
            for i in range(1, n + 1)
        ]
        self.down: set[int] = set()
        self._plane_base = self.plane.snapshot()

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        for a in self.apps:
            if a.id not in self.down:
                await a.start()
        self._plane_base = self.plane.snapshot()

    async def stop(self) -> None:
        for a in self.apps:
            if a.id not in self.down:
                await a.stop()

    def app(self, node_id: int) -> App:
        return self.apps[node_id - 1]

    def live_apps(self) -> list[App]:
        return [a for a in self.apps if a.id not in self.down]

    # -- front-door surface (ShardHandle) ----------------------------------

    def leader_id(self) -> int:
        for a in self.live_apps():
            if a.consensus is not None:
                lead = a.consensus.get_leader_id()
                if lead:
                    return lead
        return 0

    def _submit_app(self) -> App:
        lead = self.leader_id()
        if lead and lead not in self.down:
            return self.app(lead)
        live = self.live_apps()
        if not live:
            raise RuntimeError(f"shard {self.shard_id} has no live node")
        return live[0]

    async def submit(self, raw_request: bytes) -> None:
        await self._submit_app().consensus.submit_request(raw_request)

    async def submit_barrier(self, epoch: int, old_shards: int,
                             new_shards: int) -> None:
        """Order the reshard barrier command through THIS shard's stream
        (ShardHandle live-reshard contract; shared construction + dedup
        swallow in testing.app.submit_barrier_request)."""
        from .app import submit_barrier_request

        await submit_barrier_request(
            self._submit_app().consensus, epoch, old_shards, new_shards
        )

    def pending_client_ids(self) -> set:
        """Clients with requests still pooled ANYWHERE in this shard (the
        union over live replicas: a forwarded copy on a follower is just
        as capable of committing after the flip as the leader's)."""
        out: set = set()
        for a in self.live_apps():
            if a.consensus is not None:
                out.update(
                    i.client_id for i in a.consensus.pool_pending_infos()
                )
        return out

    def probe_app(self) -> App:
        """The live app with the longest chain — the mux feed source (all
        chains are prefix-consistent, so the longest is a safe monotone
        view of the shard's committed stream)."""
        live = self.live_apps()
        if not live:
            raise RuntimeError(f"shard {self.shard_id} has no live node")
        return max(live, key=lambda a: a.height())

    def poll_committed(self, since: int) -> list:
        probe = self.probe_app()
        out = []
        for i, d in enumerate(probe.ledger()[since:]):
            # a metadata-less decision (the shape chaos.py's gapless checker
            # filters) carries no latest_sequence; its chain position IS its
            # sequence in a gapless ledger — don't feed seq 0 into the mux
            if d.proposal.metadata:
                seq = decode(ViewMetadata, d.proposal.metadata).latest_sequence
            else:
                seq = since + i + 1
            infos = probe.requests_from_proposal(d.proposal)
            out.append((seq, [str(r) for r in infos], d))
        return out

    def pool_occupancy(self) -> dict:
        try:
            return self._submit_app().pool_occupancy()
        except RuntimeError:
            return {}

    def ready(self) -> bool:
        """A live replica follows a leader — submits can be ordered."""
        return self.leader_id() != 0

    def space_waiters(self) -> int:
        """Space-wait submitters summed over LIVE replicas (a waiter can
        sit on a deposed leader's pool after a mid-transition view
        change, not just the current submit app's)."""
        total = 0
        for a in self.live_apps():
            if a.consensus is not None:
                total += int(a.consensus.pool_occupancy().get("waiters", 0))
        return total

    # -- read plane surface ------------------------------------------

    def read_replies(self, key: str) -> list:
        """Fan a committed-state read across this shard's LIVE replicas;
        each reply is stamped by :meth:`testing.app.App.serve_read`, so
        the ShardSet's ``f+1`` match rule applies unchanged."""
        return [(a.id, a.serve_read(key)) for a in self.live_apps()]

    def read_quorum_need(self) -> int:
        from ..core.util import compute_quorum

        _q, f = compute_quorum(len(self.apps))
        return f + 1

    def note_read_outliers(self, outliers: list) -> None:
        """Mirror the socket plane's quorum-read attribution: every
        live replica records the outlier as OBSERVED-only ``stale_read``
        evidence (counted for the operator, never fed to the shun
        score — read replies are unsigned)."""
        for a in self.live_apps():
            if a.consensus is None:
                continue
            for sender, _why in outliers:
                a.consensus.misbehavior.note(int(sender), "stale_read")

    def read_stats_block(self) -> dict:
        """Serving-side read counters over this shard's replicas —
        counters sum, the lag gauges keep their worst/weighted shape."""
        totals: dict = {}
        for a in self.apps:
            snap = a.read_stats.snapshot()
            for k, v in snap.items():
                if k == "lag_max":
                    totals[k] = max(totals.get(k, 0), v)
                elif k == "lag_mean":
                    continue  # recomputed below from the sums
                else:
                    totals[k] = totals.get(k, 0) + v
        lag_sum = sum(a.read_stats.lag_sum for a in self.apps)
        served = totals.get("served", 0)
        totals["lag_mean"] = round(lag_sum / served, 3) if served else 0.0
        return totals

    def stats_block(self) -> dict:
        return {
            "height": self.height(),
            "leader": self.leader_id(),
            "plane": ProtocolPlaneTimers.delta(
                self._plane_base, self.plane.snapshot()
            ),
            "read": self.read_stats_block(),
        }

    # -- queries -----------------------------------------------------------

    def height(self) -> int:
        live = self.live_apps()
        return max((a.height() for a in live), default=0)

    def committed(self, app: Optional[App] = None) -> int:
        app = app or self.probe_app()
        return sum(
            len(app.requests_from_proposal(d.proposal)) for d in app.ledger()
        )

    def assert_fork_free(self) -> None:
        apps = self.live_apps()
        ref = [(d.proposal.payload, d.proposal.metadata)
               for d in apps[0].ledger()]
        for a in apps[1:]:
            other = [(d.proposal.payload, d.proposal.metadata)
                     for d in a.ledger()]
            m = min(len(ref), len(other))
            assert ref[:m] == other[:m], (
                f"shard {self.shard_id}: ledger fork between node "
                f"{apps[0].id} and node {a.id}"
            )

    # -- snapshot handoff ---------------------------------------------

    def capture_snapshot(self) -> Optional[dict]:
        """Donor side of the scale-out handoff: the probe app's chained
        application snapshot (None when no replica is live)."""
        try:
            return self.probe_app().capture_snapshot()
        except RuntimeError:
            return None

    def install_snapshot(self, snapshot: dict) -> None:
        """Receiver side: seed every (not-yet-started) replica of this
        NEW group from a donor snapshot — the group starts with the
        donor's digests, committed count, and dedup memory instead of
        fresh, O(1) in the donor's history."""
        self.handoff_base = dict(snapshot)
        for a in self.apps:
            a.install_base_state(snapshot)

    # -- fault injection ----------------------------------------------------

    def mute_leader(self) -> int:
        """Mute the current leader's egress; returns its node id."""
        lead = self.leader_id()
        if not lead:
            raise RuntimeError(f"shard {self.shard_id} has no leader to mute")
        self.net.mute(lead)
        return lead

    def unmute(self, node_id: int) -> None:
        self.net.unmute(node_id)

    async def crash(self, node_id: int) -> None:
        self.down.add(node_id)
        await self.app(node_id).stop()

    async def restart(self, node_id: int) -> None:
        await self.app(node_id).start()
        self.down.discard(node_id)


class ShardedCluster:
    """S AppShards + shared verify plane + ShardSet front door."""

    def __init__(
        self,
        wal_root,
        *,
        shards: int = 2,
        n: int = 4,
        depth: int = 1,
        rotation: bool = False,
        crypto: str = "trivial",
        engine=None,
        engine_faults: bool = False,
        window: float = 0.01,
        seed: int = 7,
        router_seed: int = 0,
        config_fn: Optional[Callable[[int, int], Configuration]] = None,
        naive: bool = False,
        reshard_drain_deadline: Optional[float] = None,
        mux_retention: int = 4096,
        collect_entries: bool = False,
        journal: bool = True,
        trace: bool = False,
        trace_capacity: int = 4096,
        slo_spec=None,
    ):
        """``crypto``: "trivial" | "p256" | "ed25519" | "toy" (see module
        docstring; "toy" is the real provider stack over the array-math
        testing.toy_scheme).  ``engine``: the shared verify engine for the
        real-crypto modes (defaults to ``TorchVerifyEngine(scheme=...)`` on
        the card for "p256" / "ed25519", to a HostVerifyEngine for "toy");
        trivial mode always uses the always-valid host engine, wrapped in
        a :class:`FaultyEngine` when ``engine_faults`` — then the
        ``engine`` attribute exposes hang/fail/heal and the coalescer runs
        the full fault policy (tight wall-clock knobs, like ChaosCluster).
        ``config_fn(shard_id, node_id)`` overrides the per-node config."""
        self.wal_root = str(wal_root)
        self.num_shards = shards
        self.n = n
        self.depth = depth
        self.scheduler = Scheduler()
        self.network = Network(seed=seed, naive=naive)
        self.verify_metrics_provider = InMemoryProvider()
        tpu_metrics = TPUCryptoMetrics(self.verify_metrics_provider)

        # flight recorder: one bounded TraceRecorder per
        # replica (keyed "s<shard>n<node>") plus one for the shared
        # verify plane and one for the set's control plane, all on the
        # cluster's injectable clock.  trace=False keeps every component
        # on the nop recorder — the hot path pays one attribute read.
        self.trace = trace
        self._recorders: dict[str, object] = {}

        def recorder_for(label: str):
            if not trace:
                return None
            from ..obs import TraceRecorder

            rec = self._recorders.get(label)
            if rec is None:
                rec = self._recorders[label] = TraceRecorder(
                    clock=self.scheduler.now, node=label,
                    capacity=trace_capacity,
                )
            return rec

        self._recorder_for = recorder_for

        policy = None
        fallback = None
        if engine_faults:
            if crypto != "trivial":
                raise ValueError("engine_faults requires crypto='trivial'")
            # wall-clock fault knobs sized like ChaosCluster: the deadline →
            # retry → breaker cycle completes well inside the real seconds a
            # logical-clock schedule takes to play out
            policy = VerifyFaultPolicy(
                launch_timeout=0.15, launch_retries=2,
                backoff_base=0.02, backoff_max=0.08, backoff_jitter=0.25,
                breaker_threshold=3, probe_interval=0.05,
                probe_backoff_max=0.2,
            )
            fallback = always_valid_engine()

        if crypto == "trivial":
            base_engine = always_valid_engine()
            self.engine = FaultyEngine(base_engine) if engine_faults \
                else base_engine
            self.coalescer = AsyncBatchCoalescer(
                self.engine, window=window, max_batch=4096,
                policy=policy, fallback_engine=fallback, metrics=tpu_metrics,
            )
            crypto_for = lambda s, i: CoalescedTrivialCrypto(
                i, self.coalescer, tag=s
            )
        elif crypto in ("p256", "ed25519", "toy"):
            from ..crypto import ed25519, p256
            from ..crypto.provider import (
                Ed25519CryptoProvider,
                Keyring,
                P256CryptoProvider,
                TorchVerifyEngine,
            )
            from . import toy_scheme

            # "toy": real CryptoProvider stack + array-math verify
            # (testing.toy_scheme), milliseconds at any batch size
            scheme = {"p256": p256, "ed25519": ed25519,
                      "toy": toy_scheme}[crypto]
            provider_cls = {
                "p256": P256CryptoProvider,
                "ed25519": Ed25519CryptoProvider,
                "toy": toy_scheme.ToyCryptoProvider,
            }[crypto]
            if engine is None:
                engine = HostVerifyEngine(scheme=scheme) if crypto == "toy" \
                    else TorchVerifyEngine(scheme=scheme)
            self.engine = engine
            max_batch = getattr(self.engine, "pad_sizes", (2048,))[-1]
            self.coalescer = AsyncBatchCoalescer(
                self.engine, window=window,
                max_batch=max(2 * depth * max_batch, 4096),
                dedupe=True, metrics=tpu_metrics,
            )
            node_ids = list(range(1, n + 1))
            # per-shard keyrings — shard s's membership signs with its own
            # keys, so cross-shard votes can never validate even if a bug
            # leaked a message across group namespaces.  Generated lazily:
            # a live reshard mints rings for shards born after construction
            self._rings = {}

            def crypto_for(s, i):
                ring = self._rings.get(s)
                if ring is None:
                    ring = self._rings[s] = Keyring.generate(
                        node_ids, seed=b"shard-%d" % s, scheme=scheme
                    )
                p = provider_cls(ring[i], coalescer=self.coalescer)
                p.verify_tag = s
                return p
        else:
            raise ValueError(f"unknown crypto mode {crypto!r}")

        if trace:
            self.coalescer.attach_recorder(recorder_for("verify"))
        cfg = config_fn or (
            lambda s, i: sharded_config(i, depth=depth, rotation=rotation)
        )
        self._config_fn = cfg
        #: boot-time config (shard 0, node 1) — the control plane's
        #: derivation envelope: knob retunes clamp to THESE ceilings, so
        #: repeated self-tuning can never ratchet past the operator's
        #: original settings (control.policy.derive_knobs)
        self.base_config = cfg(0, 1)
        if reshard_drain_deadline is None:
            # the Configuration knob is the source of truth (reconfig
            # round-trips it); an explicit constructor arg still wins
            reshard_drain_deadline = self.base_config.reshard_drain_deadline
        self._crypto_for = crypto_for
        #: incarnation count per shard id — a retired-then-recreated id is
        #: a NEW consensus group with its own network namespace + WAL dirs
        self._incarnations: dict[int, int] = {s: 1 for s in range(shards)}
        self.delivered_entries: list = []
        self.shard_list = [
            AppShard(
                s, self.network, self.scheduler, self.wal_root, n=n,
                config_fn=lambda i, _s=s: cfg(_s, i),
                crypto_fn=lambda i, _s=s: crypto_for(_s, i),
                recorder_fn=lambda i, _s=s: recorder_for(f"s{_s}n{i}"),
            )
            for s in range(shards)
        ]
        from ..shard import EpochJournal

        self.set = ShardSet(
            self.shard_list,
            router=ShardRouter(shards, seed=router_seed),
            coalescer=self.coalescer,
            journal=EpochJournal(f"{self.wal_root}/epoch.journal")
            if journal else None,
            drain_deadline=reshard_drain_deadline,
            retention=mux_retention,
            on_deliver=self.delivered_entries.append
            if collect_entries else None,
            # commit latency on the SHARED clock: logical seconds in
            # manually-advanced tests, wall seconds under WallClockDriver
            clock=self.scheduler.now,
            recorder=recorder_for("set"),
        )
        self._client_ids: dict[int, list[str]] = {}
        self._client_scan_pos: dict[int, int] = {}
        self._client_cache_epoch = self.set.epoch
        #: cluster health plane: ONE monitor over the front
        #: door's roll-up (ShardSet.health_source), the shared verify
        #: plane, and every live replica's VC tracker (rebound across
        #: reshards/restarts) — the in-process twin of
        #: SocketCluster.cluster_health
        from ..obs.health import HealthMonitor, coalescer_signal_source

        self.health = HealthMonitor(
            slo_spec,
            clock=self.scheduler.now, node="cluster",
            recorder=recorder_for("set"),
        )
        self.health.add_source(
            self.set.health_source(clock=self.scheduler.now)
        )
        self.health.add_source(coalescer_signal_source(self.coalescer))
        self.health.add_source(self._vc_signal_source())

    def _vc_signal_source(self):
        """A source folding every LIVE replica's VC tracker signals into
        cluster-level maxima, rebinding per-tracker latches as reshards/
        restarts rebuild Consensus instances."""
        from ..obs.health import vc_signal_source

        bound: dict[int, tuple] = {}

        def signals() -> dict:
            out: dict = {}
            live_keys: set[int] = set()
            for sh in self.shard_list:
                for a in sh.live_apps():
                    c = a.consensus
                    if c is None:
                        continue
                    key = id(c)
                    live_keys.add(key)
                    hit = bound.get(key)
                    if hit is None:
                        hit = bound[key] = (
                            c, vc_signal_source(c.vc_phases,
                                                clock=self.scheduler.now)
                        )
                    for k, v in hit[1]().items():
                        out[k] = max(out.get(k, 0.0), v)
            # prune dead Consensus bindings (restarts/reshards rebuild
            # them): the strong ref in `bound` would otherwise keep every
            # retired instance — pool, trackers and all — alive for the
            # cluster's lifetime under a long autoscaled soak
            for key in list(bound):
                if key not in live_keys:
                    del bound[key]
            return out

        return signals

    def cluster_health(self) -> dict:
        """Tick the cluster monitor and return the verdict (the sharded
        front door's one-call health surface)."""
        return self.health.tick()

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        await self.set.start()

    async def stop(self) -> None:
        if hasattr(self.engine, "heal"):
            self.engine.heal()  # release verify calls parked in a hang
        await self.set.stop()

    def shard(self, sid: int) -> AppShard:
        for sh in self.shard_list:
            if sh.shard_id == sid:
                return sh
        # explicit: StopIteration inside a coroutine surfaces as an
        # opaque "coroutine raised StopIteration" RuntimeError
        raise KeyError(
            f"shard {sid} is not live (retired by a reshard, or never "
            f"existed); live: {[s.shard_id for s in self.shard_list]}"
        )

    # -- live reshard -------------------------------------------------------

    def _make_shard(self, sid: int, epoch: int) -> AppShard:
        """ShardSet.reshard's factory: build + register a NEW consensus
        group for shard id ``sid`` (a fresh incarnation if the id retired
        before)."""
        inc = self._incarnations.get(sid, 0)
        self._incarnations[sid] = inc + 1
        return AppShard(
            sid, self.network, self.scheduler, self.wal_root, n=self.n,
            config_fn=lambda i, _s=sid: self._config_fn(_s, i),
            crypto_fn=lambda i, _s=sid: self._crypto_for(_s, i),
            group_key=sid if inc == 0 else (inc << 20) | sid,
            wal_subdir=f"shard-{sid}" if inc == 0
            else f"shard-{sid}-gen{inc}",
            plane=ProtocolPlaneTimers(name=f"shard-{sid}-gen{inc}"),
            recorder_fn=lambda i, _s=sid, _g=inc: self._recorder_for(
                f"s{_s}n{i}" if _g == 0 else f"s{_s}g{_g}n{i}"
            ),
        )

    async def reshard(self, new_shards: int, **kw) -> dict:
        """Live split/merge to ``new_shards`` groups under traffic (the
        full epoch protocol — see ShardSet.reshard); refreshes the
        harness's shard list and routed-client caches afterwards."""
        summary = await self.set.reshard(
            new_shards, make_shard=self._make_shard, **kw
        )
        self._sync_shard_list()
        return summary

    def _sync_shard_list(self) -> None:
        self.shard_list = [self.set.shards[s] for s in sorted(self.set.shards)]
        self.num_shards = len(self.shard_list)

    # -- the front door -----------------------------------------------------

    async def submit(self, client_id: str, request_id: str,
                     payload: bytes = b"") -> int:
        """Encode a TestRequest and push it through the routed front door;
        returns the shard it landed on.  The request's committed-stream id
        rides along so the set's CommitLatencyTracker can stamp
        submit→commit latency for it."""
        req = encode(TestRequest(
            client_id=client_id, request_id=request_id, payload=payload
        ))
        return await self.set.submit(
            client_id, req, request_key=f"{client_id}:{request_id}"
        )

    def client_for_shard(self, sid: int, j: int = 0) -> str:
        """A deterministic client id that ROUTES to shard ``sid`` in the
        ACTIVE epoch — lets tests and benches place load evenly while
        still going through the real router (no bypass).  Memoized per
        epoch (an epoch flip re-buckets the client space, so the cache is
        dropped at the first lookup after one): benches call this per
        submit, and re-scanning the id space would dominate the timed
        window."""
        if self.set.epoch != self._client_cache_epoch:
            self._client_ids.clear()
            self._client_scan_pos.clear()
            self._client_cache_epoch = self.set.epoch
        cached = self._client_ids.get(sid, [])
        while len(cached) <= j:
            k = self._client_scan_pos.get(sid, 0)
            while True:
                cid = f"s{sid}c{k}"
                k += 1
                if self.set.route(cid) == sid:
                    cached.append(cid)
                    break
                if k > 100_000:  # pragma: no cover — 2^-100000 miss odds
                    raise RuntimeError(f"no client id routes to shard {sid}")
            self._client_scan_pos[sid] = k
        self._client_ids[sid] = cached
        return cached[j]

    # -- queries / invariants ----------------------------------------------

    def poll(self) -> list:
        return self.set.poll_committed()

    def committed_requests(self, sid: Optional[int] = None) -> int:
        self.set.poll_committed()
        return self.set.committed_requests(sid)

    def check_invariants(self) -> None:
        """Fork-free within each shard + per-shard gapless/exactly-once
        across the combined stream (the mux raises on violation)."""
        for shard in self.shard_list:
            shard.assert_fork_free()
        self.set.poll_committed()

    def stats_block(self) -> dict:
        self.set.poll_committed()
        return self.set.stats_block()

    # -- flight recorder ---------------------------------------------

    def trace_recorders(self) -> list:
        """Every live recorder (per-replica + shared-plane), or [] when
        the cluster was built without ``trace=True``."""
        return list(self._recorders.values())

    def trace_block(self) -> dict:
        """The merged ``trace`` bench-row block (pure assemble helper)."""
        from ..obs import assemble_trace_block

        return assemble_trace_block(self.trace_recorders())

    def trace_events(self) -> list[dict]:
        """Every recorder's buffered events merged chronologically — ONE
        timeline already (all recorders share the cluster scheduler
        clock), the input obs.critpath.assemble_critical_path_block
        decomposes.  [] when untraced."""
        events = [e for r in self.trace_recorders() for e in r.snapshot()]
        events.sort(key=lambda e: e.get("t", 0.0))
        return events

    def critical_path_block(self, **kw) -> dict:
        """The per-request critical-path decomposition over this
        cluster's merged timeline (pure assemble; see obs.critpath)."""
        from ..obs import assemble_critical_path_block

        return assemble_critical_path_block(self.trace_events(), **kw)

    def vc_trackers(self) -> list:
        """Every live replica's view-change phase tracker — the
        ``viewchange`` bench-row block's input (always available; the
        tracker runs whether or not event tracing is on)."""
        return [
            a.consensus.vc_phases
            for sh in self.shard_list
            for a in sh.live_apps()
            if a.consensus is not None
        ]

    def viewchange_block(self) -> dict:
        from ..obs import assemble_viewchange_block

        return assemble_viewchange_block(self.vc_trackers())

    def dump_flight_recorders(self, out_dir: str) -> list:
        """Write each recorder's buffered spans to ``out_dir`` as
        ``flight-<label>.json`` (the obs.report dump shape)."""
        import os

        os.makedirs(out_dir, exist_ok=True)
        return [
            rec.dump_to(os.path.join(out_dir, f"flight-{label}.json"))
            for label, rec in sorted(self._recorders.items())
        ]
