"""One SmartBFT group commits a steady backlog.

All n replicas run in this process on one event loop over the program's
in-process network, with no message delay injected, one shared verify
engine and one shared coalescer with cross-replica dedupe, and a
group-commit WAL a replica in a directory under ``TMPDIR``.  Clients send
to the leader, in turn, requests of ``request_payload_bytes``; a feeder
keeps the leader's pool at ``pooled`` requests or more for the whole run.
Set-up ends once ``warm_decisions`` decisions are committed at every
replica, so the pipeline is full when the window opens.  After the window
the feeder stops and the backlog drains.

Parameters (the cell's ``params``): ``clients``, ``pooled``,
``feed_chunk``, ``warm_decisions``, ``warm_rungs``, ``drain_timeout_s``,
``quorum_sample``.

End to end: ``commit_tx_per_s``, the requests of the decisions that the
last replica committed inside the window, over the window's seconds.
"""

from __future__ import annotations

import asyncio
import shutil
import tempfile
import time

import numpy as np

from .. import deploy, reference


class SpanSink:
    """The recorder the replicas get in a traced run: it keeps the WAL's
    fsync spans, as (host time, seconds), and nothing else."""

    enabled = True

    def __init__(self) -> None:
        self.fsyncs: list[tuple[float, float]] = []

    def record(self, kind: str, *, dur: float = -1.0, **_) -> None:
        if kind == "wal.fsync" and dur >= 0.0:
            self.fsyncs.append((time.perf_counter(), dur))


def stamped_ledgers(n: int):
    """The program's shared ledger set, which also stamps the host time at
    which the n-th replica appended each decision (``done_at``)."""
    from smartbft_tpu_torch.testing.app import SharedLedgers

    class Stamped(SharedLedgers):
        def __init__(self) -> None:
            super().__init__()
            self.copies: list[int] = []
            self.done_at: list[float] = []

        def append(self, node_id, decision) -> None:
            with self.lock:
                ledger = self.ledgers.setdefault(node_id, [])
                ledger.append(decision)
                i = len(ledger) - 1
                while len(self.copies) <= i:
                    self.copies.append(0)
                self.copies[i] += 1
                if self.copies[i] == n:
                    self.done_at.append(time.perf_counter())

    return Stamped()


def plant(apps, fault: str | None) -> None:
    """Tests only: break what one replica delivers.  ``duplicate`` (the
    control): its third decision applied twice; ``altered``: a byte of its
    second decision's payload changed; ``unchanged``: its second decision
    left out of its ledger; ``half_sigs``: every decision delivered with
    half of its commit signatures."""
    from smartbft_tpu_torch.types import Reconfig

    if fault is None:
        return
    app = apps[-1]
    inner = app.deliver
    seen = [0]

    def broken(proposal, signatures):
        seen[0] += 1
        sigs = list(signatures)
        if fault == "half_sigs":
            sigs = sigs[: len(sigs) // 2]
        if fault == "unchanged" and seen[0] == 2:
            return Reconfig(in_latest_decision=False)
        if fault == "altered" and seen[0] == 2:
            payload = bytearray(proposal.payload)
            payload[-1] ^= 1
            proposal = type(proposal)(
                header=proposal.header, payload=bytes(payload),
                metadata=proposal.metadata,
                verification_sequence=proposal.verification_sequence)
        if fault == "duplicate" and seen[0] == 3:
            inner(proposal, sigs)
        return inner(proposal, sigs)

    app.deliver = broken


def check_ledgers(cfg: dict, ledgers: list, keys: list, acked: int,
                  sample: int, seed: int) -> list[tuple]:
    """The reference's checks of the replicas' ledgers: (name, value,
    limit) each.  ``ledgers``: each replica's list of (payload, metadata,
    [(signer, value, msg), ...], header, verification sequence); requests ``0 .. acked - 1`` were
    acknowledged, request k as ``str(k)``."""
    n = cfg["nodes"]
    q, _ = reference.quorum(n)
    verify = reference.VERIFY[cfg["scheme"]]
    first = ledgers[0]
    want = reference.chain_digest(e[:2] for e in first)
    diverged = sum(reference.chain_digest(e[:2] for e in led) != want
                   or len(led) != len(first) for led in ledgers)
    seen = np.zeros(acked, np.int64)
    unknown = 0
    for entry in first:
        for _, rid, _ in reference.decode_batch(entry[0]):
            k = int(rid) if rid.isdigit() else -1
            if 0 <= k < acked:
                seen[k] += 1
            else:
                unknown += 1
    no_quorum, bad_binding = 0, 0
    digests = {}
    for led in ledgers:
        for payload, metadata, sigs, header, vseq in led:
            key = (payload, metadata, header, vseq)
            if key not in digests:
                digests[key] = reference.proposal_digest(
                    header, payload, metadata, vseq)
            signers = {s for s, _, _ in sigs if 1 <= s <= n}
            if len(signers) < q or len(signers) != len(sigs):
                no_quorum += 1
            for _, _, msg in sigs:
                try:
                    digest, _ = reference.split_consenter_sig_msg(msg)
                except (ValueError, UnicodeDecodeError):
                    digest = None
                if digest != digests[key]:
                    bad_binding += 1
    rng = np.random.default_rng(seed ^ 0xC0FFEE)
    forged = 0
    pairs = [(r, d) for r in range(len(ledgers)) for d in range(len(ledgers[r]))]
    for i in rng.choice(len(pairs), min(sample, len(pairs)), replace=False):
        r, d = pairs[i]
        for s, value, msg in ledgers[r][d][2]:
            if not (1 <= s <= n and verify(keys[s - 1][1], msg, value)):
                forged += 1
    return [("replicas_diverged", diverged, 0),
            ("acked_not_once", int((seen != 1).sum()), 0),
            ("unknown_requests", unknown, 0),
            ("decisions_without_quorum", no_quorum, 0),
            ("votes_not_bound", bad_binding, 0),
            ("sampled_votes_invalid", forged, 0)]


def run(cell) -> dict:
    from smartbft_tpu_torch.crypto.provider import Keyring
    from smartbft_tpu_torch.metrics import PROTOCOL_PLANE
    from smartbft_tpu_torch.testing.app import App
    from smartbft_tpu_torch.testing.network import Network
    from smartbft_tpu_torch.utils.clock import Scheduler, WallClockDriver

    from .. import signer

    cfg, params = cell.cfg, cell.params
    n, scheme = cfg["nodes"], cfg["scheme"]
    cell.mark("imported")
    keys = signer.keys(scheme, cell.seed, n)
    ids = list(range(1, n + 1))
    pubs = {i: keys[i - 1][1] for i in ids}
    eng = deploy.engine(cfg, cell.device, pubs.values(), keys[0],
                        params["warm_rungs"])
    cell.mark("engine_warm")
    deploy.zero_counters(eng)
    coal = deploy.coalescer(cfg, eng, dedupe=True)
    provider_cls = deploy.provider_class(scheme)
    rng = np.random.default_rng(cell.seed)
    payloads = [rng.bytes(cfg["request_payload_bytes"]) for _ in range(4096)]
    shared = stamped_ledgers(n)
    sink = SpanSink() if cell.trace else None
    wal_root = tempfile.mkdtemp(prefix="portbench-wal-")
    scheduler = Scheduler()
    driver = WallClockDriver(scheduler, tick_interval=0.01)
    network = Network(seed=cell.seed)
    apps = [App(i, network, shared, scheduler,
                wal_dir=f"{wal_root}/wal-{i}",
                config=deploy.configuration(cfg, i),
                crypto=provider_cls(Keyring(i, keys[i - 1][0], pubs),
                                    engine=eng, coalescer=coal),
                recorder=sink)
            for i in ids]
    plant(apps, cell.fault)
    leader = apps[0]
    state = {"feed": True, "acked": 0, "refused": 0}
    t_sub: list[float] = []

    async def feed() -> None:
        clients = params["clients"]
        while state["feed"]:
            room = params["pooled"] - leader.pool_occupancy()["size"]
            for _ in range(min(room, params["feed_chunk"])):
                k = len(t_sub)
                t_sub.append(time.perf_counter())
                try:
                    await leader.submit(f"c{k % clients}", str(k),
                                        payloads[k % len(payloads)])
                except Exception:  # noqa: BLE001 — a refused request counts
                    state["refused"] += 1
                    t_sub[k] = float("nan")
                    continue
                state["acked"] = k + 1
            await asyncio.sleep(0.002)

    async def wait_until(pred, timeout: float) -> bool:
        deadline = time.perf_counter() + timeout
        while not pred():
            if time.perf_counter() > deadline:
                return False
            await asyncio.sleep(0.01)
        return True

    def committed_everywhere() -> int:
        return len(shared.done_at)

    async def drive() -> dict:
        driver.start()
        try:
            for a in apps:
                await a.start()
            cell.mark("replicas_started")
            feeder = asyncio.ensure_future(feed())
            if not await wait_until(
                    lambda: committed_everywhere() >= params["warm_decisions"],
                    params["drain_timeout_s"]):
                raise RuntimeError("set-up: the group did not commit its "
                                   "warm-up decisions")
            cell.setup_done()
            before = (deploy.read_counters(eng), PROTOCOL_PLANE.snapshot(),
                      committed_everywhere())
            cell.window.start()
            await asyncio.sleep(cell.seconds)
            cell.window.stop()
            after = (deploy.read_counters(eng), PROTOCOL_PLANE.snapshot(),
                     committed_everywhere())
            state["feed"] = False
            await feeder

            def drained() -> bool:
                return leader.pool_occupancy()["size"] == 0 \
                    and all(a.height() >= leader.height() for a in apps)

            state["drained"] = await wait_until(drained,
                                                params["drain_timeout_s"])
        finally:
            for a in apps:
                await a.stop()
            await driver.stop()
        return {"before": before, "after": after}

    try:
        marks = asyncio.run(drive())
    finally:
        shutil.rmtree(wal_root, ignore_errors=True)
    cell.read_memory()
    w = cell.window
    ledgers = [[(d.proposal.payload, d.proposal.metadata,
                 [(s.signer, s.value, s.msg) for s in d.signatures],
                 d.proposal.header, d.proposal.verification_sequence)
                for d in a.ledger()] for a in apps]
    first = ledgers[0]
    done_at = shared.done_at
    in_window = [i for i, t in enumerate(done_at) if w.t0 <= t <= w.t1]
    latencies, tx_in_window = [], 0
    for i in in_window:
        reqs = reference.decode_batch(first[i][0])
        tx_in_window += len(reqs)
        latencies += [done_at[i] - t_sub[int(rid)] for _, rid, _ in reqs]
    checks = check_ledgers(cfg, ledgers, keys, state["acked"],
                           params["quorum_sample"], cell.seed)
    checks.append(("refused_requests", state["refused"], 0))
    checks.append(("drain_timed_out", 0 if state.get("drained") else 1, 0))
    checks += deploy.verify_plane_checks(
        cfg, deploy.read_counters(eng), coal.fault_snapshot(), None,
        kernels=cell.device == "cuda")
    (c0, p0, d0), (c1, p1, d1) = marks["before"], marks["after"]
    plane = {k: p1[k] - p0[k] for k in ("ingest_us", "route_us", "codec_us",
                                         "vote_reg_us", "msgs_ingested")}
    layer = {
        "tx_in_window": tx_in_window,
        "decisions_in_window": len(in_window),
        "latencies_s": latencies,
        "protocol_us": plane["ingest_us"] + plane["route_us"]
        + plane["codec_us"] + plane["vote_reg_us"],
        "messages": plane["msgs_ingested"],
        "launches": c1["launches"] - c0["launches"],
        "fsync_s": [d for t, d in (sink.fsyncs if sink else [])
                    if w.t0 <= t <= w.t1],
    }
    failed = state["refused"] + int(
        next(v for k, v, _ in checks if k == "acked_not_once"))
    return {
        "attempted": len(t_sub),
        "failed": failed,
        "e2e": {"commit_tx_per_s": tx_in_window / w.seconds},
        "checks": checks,
        "layer": layer,
        "info": {"decisions": len(first), "acked": state["acked"],
                 "per_second": np.histogram(
                     [done_at[i] - w.t0 for i in in_window],
                     bins=max(int(w.seconds), 1),
                     range=(0.0, max(int(w.seconds), 1)))[0].tolist(),
                 "inbox_drops_logged": sum(
                     "inbox full" in line for a in apps
                     for line in a.logger.lines),
                 "log_lines": sum(len(a.logger.lines) for a in apps),
                 "commit_p50_ms": float(np.median(latencies)) * 1e3
                 if latencies else None,
                 "decisions_in_window": len(in_window),
                 "rungs": deploy.read_counters(eng)["rung_launches"]},
    }
