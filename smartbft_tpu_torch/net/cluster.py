"""Process-per-replica cluster manager + socket-level chaos runner.

:class:`SocketCluster` spawns one OS process per replica
(``python -m smartbft_tpu_torch.net.launch``), sharing ONLY key material and
the peer address map — the processes find each other over real TCP or
Unix-domain sockets, commit through the ``smartbft_tpu_torch.net`` transport,
and persist ledgers/WALs on disk.  The parent talks to each replica over
a line-JSON control channel (submit / height / digest / stats / fault /
stop) that never touches the consensus transport.

:func:`run_socket_schedule` replays the SAME declarative
``testing.chaos.ChaosEvent`` vocabulary against the live processes, but
the faults are now *physical*:

====================  ====================================================
chaos action          socket-level meaning
====================  ====================================================
``crash``             SIGKILL the replica process (kill -9)
``restart``           respawn it — WAL + ledger-file recovery, then
                      wire-sync catch-up from the peers
``mute``/``unmute``   transport outbound silence (control fault)
``disconnect``        blackhole every link of the node, both directions
``partition``/``heal``  drop_link on each cross-group pair, both endpoints
``slow_link``         per-flush delay on every link of the node
``crash_during_snapshot``  wait (bounded) for the node's next snapshot
                      capture to land, then SIGKILL immediately — the
                      process dies with the fresh snapshot on disk and
                      the compaction/offer plumbing at an arbitrary
                      point (the deterministic between-write-
                      and-truncate points are pinned by the unit tests
                      over SnapshotStore + LedgerFile)
====================  ====================================================

(Framing poison — garbage bytes on a live connection — is exercised by
the frame-robustness tests in ``tests/test_net_framing.py``, where the
blast radius of one corrupted stream is pinned to that connection.)

Offsets are WALL-CLOCK seconds (real processes have no logical clock).
``socket_soak`` is the ``python -m smartbft_tpu_torch.testing.chaos --soak
--sockets`` entry point: SIGKILL-and-rejoin and slow-link rounds over a
UDS cluster, invariant-checked (all committed, fork-free).
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Optional

from ..testing.chaos import ChaosEvent


class ControlError(RuntimeError):
    pass


class ControlRejected(ControlError):
    """A control-channel submit was SHED by the replica's admission
    machinery (the admission contract over the socket): ``kind`` is "admission" or
    "timeout", ``retry_after`` the drain-rate hint in seconds (0.0 = no
    hint), ``occupancy`` the pool snapshot at rejection time.  A socket
    client that backs off by ``retry_after`` arrives when capacity
    plausibly exists; one that hammers gets shed again."""

    def __init__(self, message: str, *, kind: str = "",
                 retry_after: float = 0.0, occupancy: Optional[dict] = None):
        super().__init__(message)
        self.kind = kind
        self.retry_after = retry_after
        self.occupancy = occupancy or {}


class ControlClient:
    """Line-JSON client for one replica's control channel.

    Keeps ONE persistent connection and reconnects on error: the server side of the channel already
    served many requests per connection, but this client used to connect
    per call — and that TCP/UDS handshake was the floor under the read
    path's p99 once reads themselves got cheap.  A call that fails on a
    REUSED connection retries exactly once on a fresh one (the replica
    may have been SIGKILLed and respawned since the last call — the
    reachability property, now one reconnect away instead of free); a
    failure on a fresh connection propagates, since retrying it would
    just fail the same way.  ``stats`` counts connects / calls / reuses /
    reconnects so benches can prove the pooling actually pools.

    The one-retry policy is safe for ``cmd=submit`` because the request
    pool deduplicates by (client_id, request_id): if the first attempt's
    bytes actually landed before the connection died, the retry is
    absorbed, not double-ordered.
    """

    def __init__(self, addr: str, timeout: float = 10.0):
        self.addr = addr
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._buf = b""
        self.stats = {"connects": 0, "calls": 0, "reuses": 0,
                      "reconnects": 0}

    def _connect(self) -> socket.socket:
        from .framing import parse_addr

        scheme, hostpath, port = parse_addr(self.addr)
        if scheme == "tcp":
            sock = socket.create_connection((hostpath, port), self.timeout)
        else:
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.settimeout(self.timeout)
            sock.connect(hostpath)
        self.stats["connects"] += 1
        return sock

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        self._buf = b""

    def _roundtrip(self, payload: bytes) -> dict:
        sock = self._sock
        assert sock is not None
        sock.sendall(payload)
        while b"\n" not in self._buf:
            chunk = sock.recv(65536)
            if not chunk:
                raise ControlError(f"control channel EOF from {self.addr}")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\n", 1)
        return json.loads(line)

    def call(self, **req) -> dict:
        self.stats["calls"] += 1
        payload = (json.dumps(req) + "\n").encode()
        reused = self._sock is not None
        if not reused:
            self._sock = self._connect()
        try:
            resp = self._roundtrip(payload)
            if reused:
                self.stats["reuses"] += 1
        except (OSError, ControlError, json.JSONDecodeError):
            self.close()
            if not reused:
                raise
            # the cached connection went stale (replica restarted, idle
            # teardown): one fresh attempt, whose failure propagates
            self.stats["reconnects"] += 1
            self._sock = self._connect()
            try:
                resp = self._roundtrip(payload)
            except (OSError, ControlError, json.JSONDecodeError):
                self.close()
                raise
        if not resp.get("ok"):
            if resp.get("rejected"):
                raise ControlRejected(
                    resp.get("error", "request shed"),
                    kind=resp["rejected"],
                    retry_after=resp.get("retry_after_ms", 0) / 1000.0,
                    occupancy=resp.get("occupancy"),
                )
            raise ControlError(resp.get("error", "control command failed"))
        return resp


@dataclass
class ReplicaHandle:
    node_id: int
    spec_path: str
    control: ControlClient
    listen: str
    proc: Optional[subprocess.Popen] = None


class SocketCluster:
    """n replica processes over real sockets on this host.

    ``transport``: ``"uds"`` (default; sockets live in a short private
    tempdir — UDS paths are capped at ~107 bytes, pytest tmp dirs are
    not) or ``"tcp"`` (127.0.0.1, ephemeral ports reserved up front).
    ``config_overrides``: JSON-safe Configuration field overrides applied
    on top of ``launch.proc_config`` in every replica.
    """

    def __init__(
        self,
        root,
        *,
        n: int = 4,
        transport: str = "uds",
        config_overrides: Optional[dict] = None,
        cluster_key: bytes = b"smartbft-cluster-key",
        env: Optional[dict] = None,
        trace: bool = False,
        trace_capacity: int = 2048,
    ):
        if transport not in ("uds", "tcp"):
            raise ValueError(f"transport must be 'uds' or 'tcp', got {transport!r}")
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self.n = n
        self.transport = transport
        self.cluster_key = cluster_key
        #: flight recorder armed per replica: each process
        #: keeps a bounded TraceRecorder the parent can pull with
        #: cmd=trace and dump as run artifacts on invariant failure
        self.trace = trace
        self.trace_capacity = trace_capacity
        self.env = dict(os.environ, **(env or {}))
        self._sockdir = (
            tempfile.mkdtemp(prefix="sbft-", dir="/tmp")
            if transport == "uds" else None
        )
        if transport == "uds":
            listen = {i: f"uds://{self._sockdir}/n{i}.sock" for i in self._ids}
            control = {i: f"uds://{self._sockdir}/c{i}.sock" for i in self._ids}
        else:
            listen = {i: f"tcp://127.0.0.1:{_free_port()}" for i in self._ids}
            control = {i: f"tcp://127.0.0.1:{_free_port()}" for i in self._ids}
        self.replicas: dict[int, ReplicaHandle] = {}
        for i in self._ids:
            spec = {
                "node_id": i,
                "listen": listen[i],
                "control": control[i],
                "peers": {str(j): listen[j] for j in self._ids if j != i},
                "cluster_key": cluster_key.hex(),
                "wal_dir": os.path.join(self.root, f"wal-{i}"),
                "ledger_path": os.path.join(self.root, f"ledger-{i}.bin"),
                "config": dict(config_overrides or {}),
                "trace": bool(trace),
                "trace_capacity": int(trace_capacity),
            }
            spec_path = os.path.join(self.root, f"spec-{i}.json")
            with open(spec_path, "w") as fh:
                json.dump(spec, fh)
            self.replicas[i] = ReplicaHandle(
                node_id=i, spec_path=spec_path,
                control=ControlClient(control[i]), listen=listen[i],
            )
        self.down: set[int] = set()

    @property
    def _ids(self) -> list[int]:
        return list(range(1, self.n + 1))

    # ------------------------------------------------------------ lifecycle

    def spawn(self, node_id: int) -> None:
        h = self.replicas[node_id]
        if h.proc is not None and h.proc.poll() is None:
            # A second spawn would fork a TWIN replica sharing the same
            # ledger/WAL/socket paths — the twin survives kill() and
            # silently keeps committing, wrecking every chaos oracle.
            raise RuntimeError(
                f"replica {node_id} is already running (pid "
                f"{h.proc.pid}); kill() it before spawning again"
            )
        # Popen dups the log fd into the child; close the parent's handle
        # so restart-heavy soaks don't accumulate one fd per spawn
        with open(os.path.join(self.root, f"replica-{node_id}.log"), "ab") as log:
            h.proc = subprocess.Popen(
                [sys.executable, "-m", "smartbft_tpu_torch.net.launch",
                 "--spec-file", h.spec_path],
                env=self.env,
                stdout=subprocess.DEVNULL,
                stderr=log,
            )
        self.down.discard(node_id)

    def start(self, *, ready_timeout: float = 30.0) -> None:
        for i in self._ids:
            self.spawn(i)
        for i in self._ids:
            self.wait_ready(i, timeout=ready_timeout)

    def wait_ready(self, node_id: int, timeout: float = 30.0) -> None:
        h = self.replicas[node_id]
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if h.proc is not None and h.proc.poll() is not None:
                raise RuntimeError(
                    f"replica {node_id} exited rc={h.proc.returncode} "
                    f"(see {self.root}/replica-{node_id}.log)"
                )
            try:
                if h.control.call(cmd="ping")["running"]:
                    return
            except (OSError, ControlError, json.JSONDecodeError):
                pass
            time.sleep(0.05)
        raise TimeoutError(f"replica {node_id} not ready within {timeout}s")

    def kill(self, node_id: int) -> None:
        """kill -9: the SIGKILL chaos fault — no shutdown path runs."""
        h = self.replicas[node_id]
        if h.proc is not None and h.proc.poll() is None:
            h.proc.send_signal(signal.SIGKILL)
            h.proc.wait()
        # drop the pooled control connection now: the next call would
        # discover the stale socket anyway, but burning a reconnect on a
        # KNOWN-dead replica skews the reuse stats for no information
        h.control.close()
        self.down.add(node_id)

    def restart(self, node_id: int, *, ready_timeout: float = 30.0) -> None:
        self.spawn(node_id)
        self.wait_ready(node_id, timeout=ready_timeout)

    def stop(self) -> None:
        """Graceful where possible, forceful where not; always reaps."""
        for i, h in self.replicas.items():
            if h.proc is None or h.proc.poll() is not None:
                continue
            try:
                h.control.call(cmd="stop")
            except (OSError, ControlError, json.JSONDecodeError):
                pass
        deadline = time.monotonic() + 10.0
        for h in self.replicas.values():
            if h.proc is None:
                continue
            while h.proc.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            if h.proc.poll() is None:
                h.proc.kill()
                h.proc.wait()
        for h in self.replicas.values():
            h.control.close()
        if self._sockdir is not None:
            import shutil

            shutil.rmtree(self._sockdir, ignore_errors=True)

    def __enter__(self) -> "SocketCluster":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------ operations

    def live_ids(self) -> list[int]:
        return [i for i in self._ids if i not in self.down]

    def control(self, node_id: int) -> ControlClient:
        return self.replicas[node_id].control

    def control_stats(self) -> dict:
        """Aggregate pooled-control-channel stats across every replica's
        client: connects / calls / reuses / reconnects, plus the reuse
        fraction the read benches report (1.0 = after the first call,
        every call rode an existing connection)."""
        total = {"connects": 0, "calls": 0, "reuses": 0, "reconnects": 0}
        for h in self.replicas.values():
            for k in total:
                total[k] += h.control.stats[k]
        total["reuse_fraction"] = (
            total["reuses"] / total["calls"] if total["calls"] else 0.0
        )
        return total

    def leader_of(self) -> int:
        for i in self.live_ids():
            try:
                lead = self.control(i).call(cmd="leader")["leader"]
                if lead:
                    return lead
            except (OSError, ControlError):
                continue
        return 0

    def wait_leader(self, timeout: float = 20.0) -> int:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            lead = self.leader_of()
            if lead:
                return lead
            time.sleep(0.05)
        raise TimeoutError("no leader elected")

    def submit(self, via: int, client: str, rid: str, payload: bytes = b"") -> None:
        self.control(via).call(cmd="submit", client=client, rid=rid,
                               payload=payload.hex())

    def trigger_reshard(self, epoch: int, old_shards: int, new_shards: int,
                        *, via: Optional[int] = None,
                        timeout: float = 30.0) -> dict:
        """Control-plane reshard trigger for a multi-process group: order
        epoch ``epoch``'s barrier command through the (leader's) ordered
        stream, then wait until EVERY live replica's ledger carries it —
        the resize decision is then durable cluster-wide, and the manager
        of S such groups can proceed with drain + flip exactly like the
        in-process ShardSet.  Returns ``{"epoch": e, "barriers": {node:
        ledger seq}}``; raises TimeoutError if any replica fails to order
        it in time (re-triggering is idempotent — pool client dedup)."""
        deadline = time.monotonic() + timeout
        barriers: dict[int, int] = {}
        while time.monotonic() < deadline:
            # (re-)issue the trigger every tick — idempotent under pool
            # client dedup, and exactly what survives the ordering replica
            # dying with the command still pooled (the in-process
            # _barrier_step re-submits on every poll for the same reason)
            try:
                target = via if via is not None else self.wait_leader(
                    timeout=2.0)
                self.control(target).call(cmd="reshard", epoch=epoch,
                                          old=old_shards, new=new_shards)
            except (OSError, ControlError, TimeoutError):
                pass  # leaderless interregnum / target down: retry next tick
            barriers = {}
            for i in self.live_ids():
                try:
                    resp = self.control(i).call(cmd="barrier", epoch=epoch)
                    barriers[i] = int(resp.get("barrier_seq", 0))
                except (OSError, ControlError):
                    barriers[i] = 0
            if barriers and all(v > 0 for v in barriers.values()):
                return {"epoch": epoch, "barriers": barriers}
            time.sleep(0.1)
        raise TimeoutError(
            f"epoch {epoch} barrier not committed on every replica within "
            f"{timeout}s: {barriers}"
        )

    def committed(self, node_id: int) -> int:
        return self.control(node_id).call(cmd="committed")["committed"]

    def heights(self) -> dict[int, int]:
        return {i: h for i, (h, _p) in self.heights_and_pools().items()}

    def heights_and_pools(self) -> dict[int, tuple[int, int]]:
        """node -> (ledger height, request-pool size); (-1, -1) when down."""
        out = {}
        for i in self.live_ids():
            try:
                resp = self.control(i).call(cmd="height")
                out[i] = (resp["height"], resp.get("pool", 0))
            except (OSError, ControlError):
                out[i] = (-1, -1)
        return out

    def wait_committed(self, total: int, timeout: float = 60.0,
                       nodes: Optional[list[int]] = None) -> None:
        """Block until every targeted replica committed >= total requests."""
        targets = nodes if nodes is not None else self.live_ids()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                if all(self.committed(i) >= total for i in targets):
                    return
            except (OSError, ControlError):
                pass
            time.sleep(0.1)
        raise TimeoutError(
            f"cluster did not commit {total} requests within {timeout}s: "
            f"{[(i, self._committed_or(i)) for i in targets]}"
        )

    def _committed_or(self, i: int) -> object:
        try:
            return self.committed(i)
        except (OSError, ControlError) as e:
            return f"down({type(e).__name__})"

    def check_fork_free(self) -> None:
        """Pairwise-identical ledger prefixes via control-channel digests.

        Snapshot-aware: a replica that compacted PAST the
        comparison height cannot recompute that prefix digest (the
        decisions are gone — by design), so it is skipped for the
        prefix comparison; replicas at EQUAL heights are additionally
        compared on their full chained digest AND their chained
        request-id digest, which survive compaction at any horizon.
        """
        heights = self.heights()
        live = [i for i, h in heights.items() if h >= 0]
        if len(live) < 2:
            return
        m = min(heights[i] for i in live)
        resp = {
            i: self.control(i).call(cmd="ledger_digest", upto=m)
            for i in live
        }
        comparable = [i for i in live if int(resp[i].get("base", 0)) <= m]
        if len(comparable) >= 2:
            ref = resp[comparable[0]]["digest"]
            for i in comparable[1:]:
                assert resp[i]["digest"] == ref, (
                    f"ledger fork: node {comparable[0]} and node {i} "
                    f"diverge within the first {m} decisions"
                )
        # equal-height replicas must agree on the FULL digests too —
        # this is the check that still bites when compaction horizons
        # differ (and the exactly-once oracle across snapshot installs)
        by_height: dict[int, list[int]] = {}
        for i in live:
            by_height.setdefault(heights[i], []).append(i)
        for h, group in by_height.items():
            if len(group) < 2:
                continue
            full = {
                i: self.control(i).call(cmd="ledger_digest", upto=h)
                for i in group
            }
            ref_i = group[0]
            for i in group[1:]:
                assert full[i]["digest"] == full[ref_i]["digest"], (
                    f"ledger fork at height {h}: node {ref_i} vs node {i}"
                )
                assert (full[i].get("ids_digest")
                        == full[ref_i].get("ids_digest")), (
                    f"request-id stream diverges at height {h}: "
                    f"node {ref_i} vs node {i} (lost or doubled "
                    f"delivery across a snapshot install)"
                )

    def committed_ids(self, node_id: int) -> list[str]:
        return self.control(node_id).call(cmd="committed_ids")["ids"]

    def wait_quiescent(self, *, quiet: float = 2.0, timeout: float = 60.0,
                       nodes: Optional[list[int]] = None) -> None:
        """Block until the targeted replicas' heights are equal, their
        request pools are EMPTY, and both have held for ``quiet`` seconds.

        The pool condition is what makes the honest-client resubmission
        contract exactly-once-safe: "heights stable" alone can be reached
        mid-view-change while uncommitted requests still sit in follower
        pools waiting to be forwarded to the next leader — resubmitting
        one of those races its original copy into a second decision (the
        forwarded copy reaches the new leader after the resubmission
        committed and cleared the pools, so dedup never sees the pair).
        Pools empty + heights equal means every submitted request either
        committed or died with a killed process's volatile pool."""
        targets = nodes if nodes is not None else self.live_ids()
        deadline = time.monotonic() + timeout
        last: Optional[tuple] = None
        stable_since = time.monotonic()
        while time.monotonic() < deadline:
            hp = self.heights_and_pools()
            hs = tuple(sorted(hp.get(i, (-1, -1))[0] for i in targets))
            drained = all(hp.get(i, (-1, -1))[1] == 0 for i in targets)
            if hs != last or len(set(hs)) != 1 or not drained:
                last = hs
                stable_since = time.monotonic()
            elif time.monotonic() - stable_since >= quiet:
                return
            time.sleep(0.1)
        raise TimeoutError(
            f"cluster never quiesced: heights/pools {self.heights_and_pools()}"
        )

    def transport_stats(self) -> dict[int, dict]:
        out = {}
        for i in self.live_ids():
            try:
                out[i] = self.control(i).call(cmd="stats")["transport"]
            except (OSError, ControlError):
                pass
        return out

    def snapshot_stats(self, node_id: int) -> dict:
        """One replica's snapshot/disk posture (cmd=snapshot):
        ``height``, ``base_height``, ``snapshot_height``,
        ``snapshot_age_decisions``, ``snapshot_disk_bytes``,
        ``ledger_disk_bytes``, ``wal_disk_bytes``, ``sync_poisoned``."""
        return self.control(node_id).call(cmd="snapshot")

    def fault(self, node_id: int, action: str, peer: int = 0,
              delay: float = 0.0) -> None:
        self.control(node_id).call(cmd="fault", action=action, peer=peer,
                                   delay=delay)

    # ------------------------------------------------------------ observability

    def trace_pull(self, node_id: int, last: Optional[int] = None,
                   since: Optional[int] = None) -> dict:
        """Pull one replica's flight-recorder state over the control
        channel: ``{"node", "trace": <summary block>, "events": [...],
        "next_since": <cursor>}`` — the per-replica timeline a
        SocketCluster run can fetch without touching the consensus
        transport.  Pass ``since`` (a previous pull's ``next_since``) to
        ship only NEW events: repeated pulls cost O(new), never a re-send
        of the whole ring."""
        req = {"cmd": "trace"}
        if last is not None:
            req["last"] = last
        if since is not None:
            req["since"] = since
        return self.control(node_id).call(**req)

    def estimate_clock_offsets(self, samples: int = 5) -> dict:
        """Per-replica monotonic-clock offset vs THIS process's clock,
        over the existing control-channel ping (line JSON).

        Classic request/response-midpoint estimation: the replica's
        ``now`` (monotonic, returned by cmd=ping) is assumed to have been
        read at the midpoint of the round trip; ``offset = now_replica -
        midpoint_parent``, and any replica timestamp maps onto the
        parent's timeline as ``t - offset``.  The LOWEST-RTT sample of
        ``samples`` wins (least queueing noise) and the error is bounded
        by RTT/2 — reported per node so the merged timeline's precision
        is stated, not implied.  Returns ``{"n<i>": {"offset_s",
        "rtt_s", "err_bound_s"}}`` for every live, answering replica."""
        out: dict = {}
        for i in self.live_ids():
            best: Optional[tuple[float, float]] = None
            for _ in range(max(1, samples)):
                t0 = time.monotonic()
                try:
                    resp = self.control(i).call(cmd="ping")
                except (OSError, ControlError, json.JSONDecodeError):
                    break
                t1 = time.monotonic()
                now = resp.get("now")
                if now is None:
                    break  # pre-offset replica build: skip
                rtt = t1 - t0
                if best is None or rtt < best[1]:
                    best = (float(now) - (t0 + t1) / 2.0, rtt)
            if best is not None:
                out[f"n{i}"] = {
                    "offset_s": best[0],
                    "rtt_s": round(best[1], 6),
                    "err_bound_s": round(best[1] / 2.0, 6),
                }
        return out

    def cluster_timeline(self, out_dir: Optional[str] = None,
                         last: Optional[int] = None) -> dict:
        """Pull every live replica's flight recorder plus clock offsets
        and merge them into ONE causally-ordered cluster timeline:
        skew-adjusted timestamps (each dump carries its
        ``clock_offset_s``; the merge subtracts it) and per-directed-link
        network time (receiver ingest minus sender send, both mapped onto
        the parent clock).  ``last=None`` (default) pulls each replica's
        WHOLE ring: a deep (e.g. 16k) ring would otherwise be silently
        tail-trimmed, dropping early requests' submit marks from the
        critical-path join with no truncation signal.  Returns
        ``{"offsets", "dumps", "events",
        "hops"}``; with ``out_dir`` the dumps (and an ``offsets.json``)
        are also written in the ``obs.report`` shape so ``python -m
        smartbft_tpu_torch.obs.report out/flight-*.json`` renders the merged
        timeline offline."""
        from ..obs.report import link_summary, merged_events

        offsets = self.estimate_clock_offsets()
        dumps: list[dict] = []
        offsets_missing: list[str] = []
        for i in self.live_ids():
            try:
                resp = self.trace_pull(i, last=last)
            except (OSError, ControlError):
                continue
            node = resp.get("node", f"n{i}")
            known = node in offsets
            if not known:
                # a replica whose ping failed mid-estimation merges with
                # an UNKNOWN clock: flag it loudly (offset_known) instead
                # of silently pretending 0.0 skew — on a real multi-host
                # deployment that skew is unbounded, and link_summary
                # excludes the node's hop rows rather than polluting them
                offsets_missing.append(node)
            dumps.append({
                "node": node,
                "capacity": resp.get("trace", {}).get("capacity", 0),
                "recorded": resp.get("trace", {}).get("recorded", 0),
                "dropped": resp.get("dropped", 0),
                "clock_offset_s": offsets.get(node, {}).get("offset_s", 0.0),
                "offset_known": known,
                "events": resp.get("events", []),
            })
        events = merged_events(dumps)
        hops = link_summary(
            events, {n: o["offset_s"] for n, o in offsets.items()}
        )
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            for d in dumps:
                with open(os.path.join(out_dir,
                                       f"flight-{d['node']}.json"), "w") as fh:
                    json.dump(d, fh)
            with open(os.path.join(out_dir, "offsets.json"), "w") as fh:
                json.dump(offsets, fh)
        return {"offsets": offsets, "offsets_missing": offsets_missing,
                "dumps": dumps, "events": len(events), "hops": hops,
                # the merged (skew-adjusted, sorted) event list itself —
                # callers feeding the critical-path assemble must not pay
                # a second O(E log E) merge over the same dumps
                "merged": events}

    def metrics_text(self, node_id: int) -> str:
        """One replica's Prometheus text exposition (cmd=metrics)."""
        return self.control(node_id).call(cmd="metrics")["text"]

    def health(self, node_id: int) -> dict:
        """One replica's live SLO verdict (cmd=health)."""
        return self.control(node_id).call(cmd="health")

    def cluster_health(self) -> dict:
        """ONE aggregated cluster verdict from a single control-channel
        sweep: poll every live replica's cmd=health, fold the
        per-replica verdicts with
        :func:`~smartbft_tpu_torch.obs.health.aggregate_cluster_verdict` —
        replicas that are down or unreachable degrade the verdict
        themselves (a majority gone is critical).  Returns ``{"status",
        "replicas", "reasons", "unreachable"}``."""
        from ..obs.health import aggregate_cluster_verdict

        verdicts: dict[str, dict] = {}
        unreachable: list[str] = []
        for i in self._ids:
            if i in self.down:
                unreachable.append(f"n{i}")
                continue
            try:
                resp = self.health(i)
                verdicts[resp.get("node", f"n{i}")] = resp["health"]
            except (OSError, ControlError, KeyError,
                    json.JSONDecodeError):
                unreachable.append(f"n{i}")
        return aggregate_cluster_verdict(verdicts, unreachable=unreachable)

    def dump_flight_recorders(self, out_dir: Optional[str] = None,
                              last: int = 2048) -> list[str]:
        """Write each LIVE replica's last ``last`` spans to
        ``out_dir`` (default: the cluster root) as ``flight-n<i>.json``
        — the dump shape ``python -m smartbft_tpu_torch.obs.report`` renders.
        Replicas that are down or untraced are skipped; returns the
        written paths."""
        if not self.trace:
            return []
        out_dir = out_dir or self.root
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for i in self.live_ids():
            try:
                resp = self.trace_pull(i, last=last)
            except (OSError, ControlError):
                continue
            path = os.path.join(out_dir, f"flight-n{i}.json")
            with open(path, "w") as fh:
                json.dump({
                    "node": resp.get("node", f"n{i}"),
                    "capacity": resp.get("trace", {}).get("capacity", 0),
                    "recorded": resp.get("trace", {}).get("recorded", 0),
                    "dropped": resp.get("dropped", 0),
                    "events": resp.get("events", []),
                }, fh)
            paths.append(path)
        return paths


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# --------------------------------------------------------------------------
# socket-level chaos: the ChaosEvent vocabulary against live processes
# --------------------------------------------------------------------------


@dataclass
class SocketChaosReport:
    submitted: int = 0
    final_committed: int = 0
    heights: dict = field(default_factory=dict)
    events_fired: list = field(default_factory=list)
    #: (t_offset_s, status, [breaching slo names]) — one entry per
    #: cluster-verdict CHANGE observed by the periodic health sweep
    verdicts: list = field(default_factory=list)
    #: (first_event_t, last_event_t) run offsets of the fault window
    fault_span: Optional[tuple] = None
    final_health: Optional[dict] = None


def assert_no_critical_outside_faults(report: SocketChaosReport,
                                      *, recovery_s: float = 30.0) -> None:
    """The soak's health gate: a ``critical`` cluster verdict
    is only acceptable while an injected fault (plus a bounded recovery
    window) explains it; any other critical sample fails the run.  The
    final verdict must not be critical at all — the run ends quiesced.
    (Same rule as the logical-clock runner: testing.chaos
    assert_health_verdicts.)"""
    from ..testing.chaos import assert_health_verdicts

    assert_health_verdicts(report.verdicts, report.fault_span,
                           report.final_health, recovery_s=recovery_s)


def run_socket_schedule(
    cluster: SocketCluster,
    schedule: list[ChaosEvent],
    *,
    requests: int = 16,
    submit_every: float = 0.15,
    settle_timeout: float = 90.0,
    health_every: float = 0.5,
) -> SocketChaosReport:
    """Replay a ``testing.chaos`` schedule against real processes.

    Same dynamic-target semantics as the in-process harness: ``"leader"``
    resolves to the live leader when the event fires, ``"faulty"`` to the
    run's first leader resolution.  ``at`` offsets are wall-clock seconds
    from the start of the run.  After the last event and submission, the
    run blocks until every LIVE replica has committed every request, then
    fork-checks the ledgers.
    """
    report = SocketChaosReport()
    pending = sorted(schedule, key=lambda e: e.at)
    faulted: set[int] = set()
    faulty_node: Optional[int] = None
    start = time.monotonic()
    submitted = 0
    next_submit = 0.0
    next_health = 0.0
    last_status: Optional[str] = None

    def sample_health(now: float) -> None:
        """Periodic cluster-verdict sweep; only CHANGES are recorded.
        Health is advisory — a sweep that fails (replica mid-restart)
        must never fail the schedule it observes."""
        nonlocal last_status
        try:
            verdict = cluster.cluster_health()
        except Exception:  # noqa: BLE001 — advisory
            return
        report.final_health = verdict
        if verdict["status"] != last_status:
            last_status = verdict["status"]
            report.verdicts.append((
                round(now, 2), verdict["status"],
                sorted({r.get("slo", "?") for r in verdict["reasons"]}),
            ))

    def resolve(spec) -> Optional[int]:
        nonlocal faulty_node
        if spec == "leader":
            node = cluster.wait_leader()
            if faulty_node is None:
                faulty_node = node
            return node
        if spec == "faulty":
            if faulty_node is None:
                raise RuntimeError('"faulty" used before any "leader" resolution')
            return faulty_node
        return spec

    def fire(evt: ChaosEvent) -> None:
        node = resolve(evt.node) if evt.node is not None else None
        if evt.action == "crash":
            cluster.kill(node)
            faulted.add(node)
        elif evt.action == "restart":
            cluster.restart(node)
            faulted.discard(node)
        elif evt.action == "mute":
            cluster.fault(node, "mute")
            faulted.add(node)
        elif evt.action == "unmute":
            cluster.fault(node, "unmute")
            faulted.discard(node)
        elif evt.action == "disconnect":
            cluster.fault(node, "drop_link")  # peer=0: every link
            for other in cluster.live_ids():
                if other != node:
                    cluster.fault(other, "drop_link", peer=node)
            faulted.add(node)
        elif evt.action == "reconnect":
            cluster.fault(node, "heal_links")
            for other in cluster.live_ids():
                if other != node:
                    cluster.fault(other, "restore_link", peer=node)
            faulted.discard(node)
        elif evt.action == "partition":
            groups = [[resolve(m) for m in g] for g in evt.groups]
            named = {m for g in groups for m in g}
            rest = [i for i in cluster._ids if i not in named]
            allg = groups + ([rest] if rest else [])
            side = {m: gi for gi, g in enumerate(allg) for m in g}
            for a in cluster.live_ids():
                for b in cluster.live_ids():
                    if a < b and side.get(a) != side.get(b):
                        cluster.fault(a, "drop_link", peer=b)
                        cluster.fault(b, "drop_link", peer=a)
            from ..core.util import compute_quorum

            q, _ = compute_quorum(cluster.n)
            for g in allg:
                if len(g) < q:
                    faulted.update(g)
        elif evt.action == "heal":
            for i in cluster.live_ids():
                cluster.fault(i, "heal_links")
            faulted.clear()
        elif evt.action == "slow_link":
            cluster.fault(node, "slow_link", delay=evt.fraction)
        elif evt.action == "unslow_link":
            cluster.fault(node, "slow_link", delay=0.0)
        elif evt.action == "crash_during_snapshot":
            _kill_at_next_snapshot(cluster, node,
                                   window=evt.fraction or 10.0)
            faulted.add(node)
        else:
            raise ValueError(f"unsupported socket chaos action: {evt.action}")
        report.events_fired.append((evt.action, node))
        now = time.monotonic() - start
        lo, hi = report.fault_span or (now, now)
        report.fault_span = (min(lo, now), max(hi, now))

    while True:
        now = time.monotonic() - start
        while pending and pending[0].at <= now:
            fire(pending.pop(0))
        if submitted < requests and now >= next_submit:
            healthy = [i for i in cluster.live_ids() if i not in faulted]
            if healthy:
                via = healthy[submitted % len(healthy)]
                try:
                    cluster.submit(via, "chaos", f"chaos-{submitted}")
                    submitted += 1
                except (OSError, ControlError):
                    pass  # no leader yet / pool full: retry next tick
            next_submit = now + submit_every
        report.submitted = submitted
        if now >= next_health:
            sample_health(now)
            next_health = now + health_every
        if not pending and submitted >= requests:
            break
        time.sleep(0.02)

    # drain to quiescence, then act as an honest BFT client: a request
    # whose only copy sat in a SIGKILLed replica's (volatile) pool is gone
    # — after the heights stop moving, anything absent from the ledgers is
    # absent from every live pool too, so resubmitting it through another
    # replica is exactly-once-safe (and exactly what the reference's
    # client contract prescribes on request timeout)
    expected = {f"chaos:chaos-{k}" for k in range(submitted)}
    deadline = time.monotonic() + settle_timeout
    try:
        while True:
            cluster.wait_quiescent(
                timeout=max(deadline - time.monotonic(), 1.0),
                nodes=[i for i in cluster.live_ids() if i not in faulted],
            )
            probe = [i for i in cluster.live_ids() if i not in faulted][0]
            missing = sorted(expected - set(cluster.committed_ids(probe)))
            if not missing:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"requests never committed after resubmission: {missing}"
                )
            healthy = [i for i in cluster.live_ids() if i not in faulted]
            for j, rid in enumerate(missing):
                cluster.submit(healthy[j % len(healthy)], "chaos",
                               rid.split(":", 1)[1])
            time.sleep(0.5)
        cluster.wait_committed(submitted, timeout=settle_timeout,
                               nodes=[i for i in cluster.live_ids()
                                      if i not in faulted])
        # stragglers that healed late (e.g. a restarted replica) get a
        # bounded grace window to catch up before the invariant checks
        try:
            cluster.wait_committed(submitted, timeout=settle_timeout / 2)
        except TimeoutError:
            pass
        cluster.check_fork_free()
        live = cluster.live_ids()
        # exactly-once: resubmission must never double-deliver
        ids = cluster.committed_ids(live[0])
        dupes = {i for i in ids if ids.count(i) > 1}
        assert not dupes, \
            f"duplicate deliveries after resubmission: {sorted(dupes)}"
    except (AssertionError, TimeoutError):
        # invariant failure: preserve each replica's flight recorder as a
        # run artifact (no-op unless the cluster was built with trace=True)
        try:
            paths = cluster.dump_flight_recorders()
            if paths:
                print(f"flight-recorder dumps written: {paths}",
                      file=sys.stderr)
        except Exception:  # noqa: BLE001 — never mask the real failure
            pass
        raise
    live = cluster.live_ids()
    report.final_committed = cluster.committed(live[0]) if live else 0
    report.heights = cluster.heights()
    sample_health(time.monotonic() - start)
    return report


def _snapshot_height_or(cluster: SocketCluster, node_id: int,
                        default: int = -1) -> int:
    try:
        return int(cluster.snapshot_stats(node_id).get("snapshot_height", 0))
    except (OSError, ControlError, json.JSONDecodeError):
        return default


def _kill_at_next_snapshot(cluster: SocketCluster, node_id: int,
                           *, window: float = 10.0) -> None:
    """SIGKILL ``node_id`` the moment its NEXT snapshot capture lands
    (bounded by ``window`` seconds — kills at the deadline regardless, so
    a schedule can never hang on a capture that does not come).  The
    process dies with the fresh snapshot file on disk and the
    compaction/truncation/offer plumbing interrupted at whatever point
    the race hits; recovery must reconcile."""
    before = _snapshot_height_or(cluster, node_id)
    deadline = time.monotonic() + max(window, 0.1)
    while time.monotonic() < deadline:
        if _snapshot_height_or(cluster, node_id) > before:
            break
        time.sleep(0.01)
    cluster.kill(node_id)


def kill_rejoin_schedule(*, crash_at: float = 2.0,
                         restart_at: float = 5.0) -> list[ChaosEvent]:
    """SIGKILL the current leader mid-burst; respawn it; it must recover
    from WAL + ledger file, wire-sync the gap, and rejoin as a follower."""
    return [
        ChaosEvent(at=crash_at, action="crash", node="leader"),
        ChaosEvent(at=restart_at, action="restart", node="faulty"),
    ]


def slow_link_schedule(*, slow_at: float = 1.0, heal_at: float = 6.0,
                       delay: float = 0.05) -> list[ChaosEvent]:
    """Throttle every link of one non-leader replica (per-flush delay) —
    the cluster must keep committing at quorum speed, and the slow node
    must still converge once healed."""
    return [
        ChaosEvent(at=slow_at, action="slow_link", node=2, fraction=delay),
        ChaosEvent(at=heal_at, action="unslow_link", node=2),
    ]


def socket_soak(*, rounds: int = 2, n: int = 4, transport: str = "uds",
                requests: int = 16, verbose: bool = True) -> None:
    """``chaos --soak --sockets``: the socket-fault matrix end-to-end.
    Each round runs SIGKILL-and-rejoin then slow-link against a fresh
    multi-process cluster, checking commit + fork-free invariants AND
    the continuous SLO verdict: the default spec is evaluated
    on every replica throughout, verdict transitions ride the report,
    and a critical verdict outside the injected-fault window (plus a
    bounded recovery) fails the round."""
    for r in range(rounds):
        for name, schedule in (
            ("kill-rejoin", kill_rejoin_schedule()),
            ("slow-link", slow_link_schedule()),
        ):
            with tempfile.TemporaryDirectory(prefix="sbft-soak-") as root:
                cluster = SocketCluster(root, n=n, transport=transport)
                try:
                    cluster.start()
                    cluster.wait_leader()
                    report = run_socket_schedule(
                        cluster, schedule, requests=requests
                    )
                    assert_no_critical_outside_faults(report)
                finally:
                    cluster.stop()
                if verbose:
                    print(
                        f"socket round {r} [{name}]: events="
                        f"{report.events_fired} committed="
                        f"{report.final_committed} heights={report.heights}"
                        f" verdicts={report.verdicts} — OK"
                    )


# --------------------------------------------------------------------------
# snapshot state transfer: O(1) rejoin over real sockets
# --------------------------------------------------------------------------


@dataclass
class SnapshotRejoinReport:
    """What a snapshot-rejoin run observed (the oracle inputs)."""

    victim: int = 0
    victim_height_at_kill: int = 0
    donor_snapshot_height: int = 0
    victim_base_after: int = 0
    victim_height_after: int = 0
    snap_chunks_received: int = 0
    snap_chunks_sent_total: int = 0
    snap_bytes_received: int = 0
    sync_poisoned_total: int = 0
    rejoin_seconds: float = 0.0
    requests: int = 0
    events: list = field(default_factory=list)


def run_snapshot_rejoin(
    cluster: SocketCluster,
    *,
    victim: int = 2,
    warmup: int = 8,
    history: int = 48,
    crash_during_snapshot: bool = False,
    mid_fetch_donor_kill: bool = False,
    settle_timeout: float = 180.0,
) -> SnapshotRejoinReport:
    """Drive the snapshot state-transfer rejoin end-to-end over real
    processes: commit ``warmup``, SIGKILL ``victim`` (optionally racing
    its own snapshot capture), grow the chain by ``history`` until every
    donor's snapshot horizon has moved PAST the victim's crash height —
    the donors have by then also COMPACTED past it, so a chain-replay
    tail is no longer even possible — then respawn the victim and require
    it to come back via snapshot install + tail.

    ``mid_fetch_donor_kill`` SIGKILLs the serving donor while the victim
    is mid-chunk (then respawns it): the fetch must resume or fail over
    to another offer, never wedge.

    The cluster MUST be built with ``snapshot_interval_decisions > 0``
    in ``config_overrides``.  NOTE: :func:`run_socket_schedule`'s
    resubmission oracle reads ``committed_ids`` (suffix-only once a
    replica compacts) and is NOT snapshot-safe; this runner uses the
    count/ids-digest oracles, which survive compaction.

    Returns the report; raises AssertionError/TimeoutError on any
    violated invariant (rejoined-but-not-via-snapshot counts as one).
    """
    report = SnapshotRejoinReport(victim=victim)
    lead = cluster.wait_leader()
    if victim == lead:
        victim = next(i for i in cluster.live_ids() if i != lead)
        report.victim = victim
    total = 0

    def _submit_one() -> None:
        nonlocal total
        cluster.submit(lead, "snaprejoin", f"sr-{total}")
        total += 1

    for _ in range(warmup):
        _submit_one()
    cluster.wait_committed(total, timeout=settle_timeout)

    # -- kill the victim (racing its own capture when asked) ------------
    victim_h = cluster.heights().get(victim, 0)
    if crash_during_snapshot:
        before = _snapshot_height_or(cluster, victim)
        deadline = time.monotonic() + settle_timeout / 3
        while (_snapshot_height_or(cluster, victim) <= before
               and time.monotonic() < deadline):
            _submit_one()
            try:
                victim_h = cluster.control(victim).call(cmd="height")["height"]
            except (OSError, ControlError):
                pass
            time.sleep(0.05)
        cluster.kill(victim)
        report.events.append("crash_during_snapshot")
    else:
        cluster.kill(victim)
        report.events.append("crash")
    # the crash height is what the victim persisted, read off its ledger
    # file once it is dead: its last answer over the control channel can
    # trail the decision (and with it the capture) that landed before
    # the kill, and donors whose horizon passed only that answer may sit
    # at the victim's own snapshot, so it rejoins by replaying a tail
    from .launch import LedgerFile

    with open(cluster.replicas[victim].spec_path) as fh:
        ledger = LedgerFile(json.load(fh)["ledger_path"])
    persisted = ledger.read_all()
    victim_h = max(victim_h, ledger.base_height + len(persisted))
    report.victim_height_at_kill = victim_h
    donors = [i for i in cluster.live_ids() if i != victim]

    # -- grow history until every donor's horizon passed the victim -----
    for _ in range(history):
        _submit_one()
    cluster.wait_committed(total, timeout=settle_timeout, nodes=donors)
    deadline = time.monotonic() + settle_timeout / 2
    while min(_snapshot_height_or(cluster, d) for d in donors) <= victim_h:
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"donor snapshot horizon never passed the victim's crash "
                f"height {victim_h}: "
                f"{[(d, _snapshot_height_or(cluster, d)) for d in donors]}"
            )
        _submit_one()
        cluster.wait_committed(total, timeout=settle_timeout, nodes=donors)
        time.sleep(0.05)
    report.donor_snapshot_height = min(
        _snapshot_height_or(cluster, d) for d in donors
    )

    # -- respawn: the rejoin itself --------------------------------------
    t0 = time.monotonic()
    cluster.restart(victim)
    report.events.append("restart")
    if mid_fetch_donor_kill:
        fetch_deadline = time.monotonic() + settle_timeout / 2
        while time.monotonic() < fetch_deadline:
            try:
                st = cluster.control(victim).call(cmd="stats")["transport"]
                if int(st.get("snap_chunks_received", 0)) > 0:
                    break
            except (OSError, ControlError):
                pass
            time.sleep(0.005)
        # kill the busiest non-leader donor mid-transfer, then respawn it
        stats = cluster.transport_stats()
        candidates = [d for d in donors if d != lead] or donors
        serving = max(
            candidates,
            key=lambda d: stats.get(d, {}).get("snap_chunks_sent", 0),
        )
        cluster.kill(serving)
        report.events.append(f"donor_kill:{serving}")
        time.sleep(1.0)
        cluster.restart(serving)
        report.events.append(f"donor_restart:{serving}")
    cluster.wait_committed(total, timeout=settle_timeout)
    cluster.wait_quiescent(timeout=settle_timeout)
    report.rejoin_seconds = round(time.monotonic() - t0, 3)
    report.requests = total

    # -- oracles ---------------------------------------------------------
    vs = cluster.snapshot_stats(victim)
    report.victim_base_after = int(vs.get("base_height", 0))
    report.victim_height_after = int(vs.get("height", 0))
    stats = cluster.transport_stats()
    report.snap_chunks_received = int(
        stats.get(victim, {}).get("snap_chunks_received", 0))
    report.snap_bytes_received = int(
        stats.get(victim, {}).get("snap_bytes_received", 0))
    report.snap_chunks_sent_total = sum(
        int(s.get("snap_chunks_sent", 0)) for s in stats.values())
    report.sync_poisoned_total = sum(
        int(s.get("sync_poisoned", 0)) for s in stats.values())
    assert report.victim_base_after > victim_h, (
        f"victim rejoined by CHAIN REPLAY, not snapshot install: base "
        f"{report.victim_base_after} <= crash height {victim_h}"
    )
    assert report.snap_chunks_received > 0, (
        "victim caught up without receiving a single snapshot chunk"
    )
    assert report.snap_chunks_sent_total > 0, "no donor served chunks"
    assert report.sync_poisoned_total == 0, (
        f"honest-cluster run tripped the poisoning guard "
        f"{report.sync_poisoned_total} times"
    )
    heights = cluster.heights()
    assert len(set(heights.values())) == 1, f"heights diverge: {heights}"
    cluster.check_fork_free()
    return report


def snapshot_soak(*, rounds: int = 2, n: int = 4, transport: str = "uds",
                  interval: int = 8, verbose: bool = True) -> None:
    """``chaos --soak --snapshots``: the truncating soak.
    Each round runs rejoin-via-snapshot then crash-during-snapshot (with
    a donor SIGKILLed mid-chunk in the second) against a fresh cluster
    captured every ``interval`` decisions with deliberately tiny chunks
    (multi-chunk transfers even for small states).  Beyond the rejoin
    oracles, each round pins the DISK BOUND: every replica's live ledger
    suffix stays within ~2 capture intervals of its snapshot horizon no
    matter how long the chain grows, and the final cluster verdict is
    not critical (snapshot.lag_intervals unbreached)."""
    overrides = {
        "snapshot_interval_decisions": interval,
        "snapshot_chunk_bytes": 1024,
    }
    for r in range(rounds):
        for name, kwargs in (
            ("rejoin-via-snapshot", {}),
            ("crash-during-snapshot",
             {"crash_during_snapshot": True, "mid_fetch_donor_kill": True}),
        ):
            with tempfile.TemporaryDirectory(prefix="sbft-snap-") as root:
                cluster = SocketCluster(root, n=n, transport=transport,
                                        config_overrides=overrides)
                try:
                    cluster.start()
                    cluster.wait_leader()
                    report = run_snapshot_rejoin(cluster, **kwargs)
                    for i in cluster.live_ids():
                        s = cluster.snapshot_stats(i)
                        suffix = int(s["height"]) - int(s["base_height"])
                        assert suffix <= 2 * interval + 8, (
                            f"node {i} ledger suffix unbounded: {suffix} "
                            f"decisions past its snapshot horizon "
                            f"(interval {interval})"
                        )
                        assert int(s["ledger_disk_bytes"]) > 0
                    verdict = cluster.cluster_health()
                    assert verdict["status"] != "critical", verdict
                finally:
                    cluster.stop()
                if verbose:
                    print(
                        f"snapshot round {r} [{name}]: events="
                        f"{report.events} requests={report.requests} "
                        f"victim_h@kill={report.victim_height_at_kill} "
                        f"base_after={report.victim_base_after} "
                        f"chunks={report.snap_chunks_received} "
                        f"rejoin={report.rejoin_seconds}s — OK"
                    )
