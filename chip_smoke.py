#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``smartbft_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, one JSON line each.  A failure prints one line
``{"phase": ..., "ok": false, "error": ...}`` on stdout (an exception's
line also carries the last frames of its traceback) and exits non-zero:

1. build      — nvcc builds every kernel from ``smartbft_tpu_torch/csrc``
                (five, sm_90a, and the P-256 comb and generic kernels at 4
                threads a signature, the Ed25519 comb and generic ones at
                2, the pairing kernel at its other group size and stopped
                after its Miller loop, one nvcc each, all started
                together); prints build seconds and ptxas' registers /
                stack / spills / shared bytes.
2. comb       — the P-256 comb kernel against its plain-torch version at
                B = 16384 and 2048 lanes signed by the 64 replica keys, with
                a seeded rejection matrix (corrupted r, r = 0, s >= n,
                wrong-key kidx, zero-padded lanes): both masks equal bit for
                bit and equal the verdicts of the port's
                ``OpenSSLVerifyEngine`` (the oracle of every signature
                kernel here).
3. generic    — the same for the P-256 generic kernel, on keys outside the
                registry plus off-curve keys.
4. ed_comb    — the Ed25519 comb kernel against its plain version at B =
                16384 and 2048 on the 64 replica keys (and one more, so the
                stack has zero-padded slots), with a seeded rejection matrix
                (corrupted S, tampered message, S >= L, an undecodable R, a
                valid signature claimed under the wrong kidx, ok = 1 on a
                zero-padded stack slot, zero-padded lanes): both masks equal
                bit for bit, equal ``ed25519.verify_item`` on every
                rejection lane and a seeded sample of valid ones, and equal
                OpenSSL's verdicts on every lane where OpenSSL applies (all
                but the padded slot and padded lanes, which have no key).
                Non-canonical encodings and small-order keys, where
                libraries may differ, are left out.
5. ed_generic — the same for the generic Ed25519 kernel, on keys outside
                the registry plus undecodable public keys.
6. bls        — the BLS12-381 pairing kernel against its plain version,
                bit for bit, and against the expected verdicts of a seeded
                rejection matrix, at 2048 and at 128 lanes (wrong
                message, wrong key, a signature moved by the generator, a
                signature that does not decode, an aggregated quorum, an
                aggregate missing one signer, ok = 0 garbage lanes,
                zero-padded lanes), held to ``bls12381.verify_item`` on
                every rejection lane and a seeded sample of valid ones.
7. e2e        — the main path through the user entry points (Keyring ->
                P256CryptoProvider / Ed25519CryptoProvider /
                BlsCryptoProvider -> testing.App /
                Consensus): the n=64 deployment (request batch 500,
                pipeline depth 16, group-commit WAL, one shared dedupe
                coalescer) commits a 32-decision burst.  P-256: on the comb
                kernel (cell A); then a second membership of 64 new keys on
                the same long-lived engine, whose 128-key comb registry
                earlier memberships have filled, so its waves take the
                generic kernel (cell B).  Ed25519 (BASELINE configs [3]):
                the same two cells on a fresh
                ``TorchVerifyEngine(scheme=ed25519)`` (cells C and D).
                BLS12-381 aggregate votes (BASELINE configs [4]): the same
                deployment on ``TorchVerifyEngine(scheme=bls12381)``, every
                key with a proof of possession passed as ``pops`` (cell E);
                it reports lanes per decision and the aggregated lanes
                among them.  All five launch counters are zeroed just
                before each cell's run and read just after; a cell fails if
                any kernel but its own launched.
8. sharded    — sharded mode through its own front door
                (``testing.sharded.ShardedCluster(crypto="p256",
                engine=TorchVerifyEngine(device="cuda"))`` ->
                ``ShardSet.submit`` routed by ``ShardRouter``): consensus
                groups of n=16 (BASELINE config [2]; batch 500, depth 16,
                group-commit WAL) verifying through ONE shared dedupe
                coalescer and engine.  Cell F1: one shard commits 32
                decisions (16,000 requests), the control.  Cell F: four
                shards (64 replicas, 64 keys) commit 8 decisions each, the
                same 16,000 requests, submitted decision-major across the
                shards so their quorum waves mix.  Every ring's keys and
                every pad rung are warmed before the window.  Each cell
                zeroes the five launch counters just before the cluster
                starts and reads them just after it stops; it fails unless
                every replica committed its shard's requests into one
                ledger a shard, the mux invariants hold, the breaker
                stayed shut, only the comb kernel launched (lanes = the
                engine's slots), the coalescer attributed every wave to
                the cell's shards (waves <= comb launches, per-shard items
                >= the engine's verified signatures: only the attribution
                counts items before the dedupe), and ``mixed_waves`` is 0
                in F1 and at least 1 in F.  Prints tx/s (all shards and
                each), launches and launches a decision, fill, items a
                launch, the rung histogram, mixed waves, per-shard items
                and items a verified signature (the dedupe ratio); after
                the kernels line, ``sharded_busy``: busy = launches x the
                comb kernel's ms at each rung from that line, and idle.
9. verify_plane — the coalescer's flush hold, its view-flip warm path and
                the control plane on the comb kernel, through the same
                front door (``ShardedCluster(crypto="p256",
                engine=TorchVerifyEngine(device="cuda"))``) on one fresh
                engine.  Cell G0: cell F's deployment (4 shards of n=16,
                8 decisions each), submission paced 0.03 s between
                decision rounds (the JAX package's ``benchmarks/mesh.py``
                recipe), no hold: the ungated control.  Cell G: the same
                with ``verify_flush_hold = 0.25`` in every replica's
                Configuration; it fails unless the live coalescer's
                ``mesh_snapshot()["hold"]["hold_s"]`` is 0.25 and it held
                a wave, and prints its hold counters and launches a
                decision, fill and tx/s beside G0's.  Cell V: cell F1's
                deployment (1 shard of n=16, 32 decisions); after 8
                decisions the leader is muted until every other replica
                has installed a new view, then unmuted; it fails unless a
                new view came, the coalescer ran its flip warm, the comb
                kernel launched after the flip and every replica holds one
                ledger, and prints the view-change seconds.  Cell K: G's
                cluster with ``control.run_control_loop`` ticking every
                0.25 s for the whole burst; it prints the loop's ticks,
                actions and vetoes, and fails if the loop raised or a
                shard was left with two ledgers.  Every cell passes
                ``read_cell`` for the comb kernel (breaker 0, only the
                comb kernel, lanes cover the signatures) and the mux's
                checks; ``verify_plane_busy`` follows the kernels line.
10. open_loop — open-loop load through the same front door: the JAX
                package's open-loop bench deployment (2 shards of n=4,
                depth 2, pool 2400, admission high water 0.8, batch cap
                128, adaptive proposing, group-commit WAL) on a fresh
                engine with real P-256 votes, pumped by
                ``testing.load.run_open_loop`` on the wall clock (Poisson
                arrivals over 512 Zipf(1.1) clients for 8 s, then a 3 s
                drain).  Cell O1 offers 400 requests a second with the
                flight recorders on, and ``obs.report`` renders their
                dumps into per-span-type percentile rows
                (``open_loop_trace``); cell O2 offers 1600, untraced.
                Each prints offered, acked, shed (admission, timeout),
                failed, goodput in the 8 s window, commit p50/p95/p99,
                peak pool occupancy, the hot client's share, launches a
                decision, rungs and fill, and whether the bench's SLO
                held (goodput >= 90 % of offered, shed < 1 %; reported,
                not gated).  A cell fails if a submit failed with
                anything but a shed, the mux did not deliver every acked
                request once, or a shard's replicas hold two ledgers.
11. byzantine — the chaos harness's Byzantine round on real P-256 votes:
                n=4 (one actor), depth 1, rotation, 18 requests, shun
                threshold 3, as ``testing.chaos.byzantine_round`` sets
                it, built as cell A's cluster is (``Keyring`` ->
                ``P256CryptoProvider`` per replica over one shared dedupe
                coalescer and a fresh engine -> ``testing.App``, wall
                clock) with ``testing.byzantine.ByzantineActor`` arming
                the replica the round arms.  Cell Y1: replica 4 forges
                votes; the chaos invariants (fork-free, exactly once,
                ``forger_shunned_and_shed``) must hold, the forger must be
                shunned at every honest replica, and every signature in
                the kernel's lanes must be one the engine was handed and
                accepted.  Cell Y2: the initial leader equivocates;
                ``no_equivocation_commit`` must hold and the honest ledger
                must go on in a later view.  Cell Y3: the round's censor
                case, rotation off, 8 requests and open-loop spike
                arrivals at 10 a second from 1 s to 6 s; the initial
                leader drops the forwarded requests of client ``chaos``;
                every honest replica must commit every acked request
                once, hold one ledger and end in a view after 0.  All
                three print the actor's counters, the per-replica
                attribution, sheds and shuns, the engine's tally by
                signer, leaders and views.  Every
                cell of phases 10 and 11 passes ``read_cell`` for the
                comb kernel; ``open_loop_busy`` and ``byzantine_busy``
                follow the kernels line.
12. sockets   — BASELINE config [2] over real sockets: n=16, batch 500,
                depth 16, group-commit WAL, a 32-decision burst, rotation
                off, on a fresh engine with real P-256 votes through one
                shared dedupe coalescer, built as cell A.  Its first line
                (``sockets_fds``) is the open-file limit, the soft one
                raised to the hard one when below 4096.  Cell T0 runs the
                deployment on the in-process network; T1 gives each
                replica its own ``net.transport.SocketComm`` over UDS
                (one process, one event loop, frames over kernel
                sockets), T2 over TCP on 127.0.0.1.  Each prints tx/s,
                elapsed, launches a decision, rungs and fill; T1 and T2
                also the transport counters summed over the 16 replicas
                (bytes, frames a flush, reconnects, drops, malformed
                frames) and the seconds their stop took.  A T cell fails
                unless every replica committed exactly the 16,000
                requests into one ledger, it passes ``read_cell`` for the
                comb kernel, no frame was malformed and no transport task
                outlived the stop.  Then the process-per-replica cluster
                (``net.cluster.SocketCluster``: one ``python -m
                smartbft_tpu_torch.net.launch`` process a replica over
                UDS, trivial crypto, no kernel): cell R4 (n=4) SIGKILLs
                the leader mid-burst and respawns it
                (``run_socket_schedule(cluster, kill_rejoin_schedule(),
                requests=16)``), cell R16 (n=16) commits 8 requests.  Each
                prints the events fired, heights and committed requests
                at every replica, fork-freedom, and every replica's exit
                code at ``stop()``; it fails unless R4 fired exactly
                crash and restart, every replica (the restarted one by
                wire sync) reached the cluster's height, the ledgers are
                fork-free, no kernel launched and every replica exited
                with code 0 (a replica still running at ``stop()``'s
                10 s deadline is SIGKILLed).  ``sockets_busy`` follows
                the kernels line.
13. mesh      — the multi-device verify plane (``smartbft_tpu_torch.
                parallel``) at D = ``torch.cuda.device_count()`` cards.
                Parity stage: the JAX package's mesh-bench wave (3
                signers, 23 items, every 5th forged, each message
                signed by all three) through ``MeshVerifyEngine(devices=
                D)`` and ``QuorumMeshVerifyEngine(devices=D)`` against
                ``TorchVerifyEngine`` for P-256 on the comb route, P-256
                on the generic route (every engine's comb registries
                filled first), Ed25519 and BLS12-381: verdicts equal bit
                for bit and equal the scheme's host verify, the 2D
                counts the host's distinct valid votes a message, its
                decisions ``count >= _quorum_threshold()`` of a
                4-replica keyring, and each engine on the route's
                kernel only.  Then cells M1, M2 and M0, each cell G's
                deployment (4 shards of n = 16, 8 decisions, batch 500,
                depth 16, paced 0.03 s, hold 0.25 s) with no engine
                given, so ``ShardedCluster(crypto="p256")`` builds its
                own ``TorchVerifyEngine`` and the replicas' knobs
                graduate the shared coalescer at start.  M1:
                ``verify_mesh_devices = D``, topology "1d": the plane
                must be the port's ``MeshVerifyEngine`` of D devices, no
                downgrade, no fallback engine, a per-device fill.  M2:
                the same in "2d": ``QuorumMeshVerifyEngine`` with quorum
                steps run, and every launch's counts and decisions held
                after the run to OpenSSL's verdicts.  M0:
                ``verify_mesh_devices = D + 1``: exactly one counted
                downgrade, ``TorchVerifyEngine`` kept, every shard
                commits.  Each cell zeroes the five counters once the
                graduated engine is warm, passes ``read_cell`` for the
                comb kernel and the mux's checks, and prints tx/s,
                launches, the kernel's rungs (lanes a card) and the
                logical ones, fill and its ``mesh`` block;
                ``mesh_busy`` follows the kernels line.
14. embedder  — the application layer: the port's
                ``examples/naive_chain.py``, 4 nodes that implement the
                whole SPI over their own channel mesh with real P-256
                commit votes.  Cell N1 runs ``naive_chain.main(32,
                "cuda")`` as a user would (keyring seed
                ``b"naive-chain"``, depth 1, 32 blocks of one transaction,
                one ``TorchVerifyEngine`` on the card shared by every
                node's provider, the offline re-verify of every commit
                signature included); cell N4 builds the same 4 nodes with
                ``pipeline=4`` and submits the 32 transactions as a burst.
                Each zeroes the five counters just before its run and
                reads them just after (only the comb kernel, lanes
                covering every verified vote, breaker shut, no failed
                launch); every node must hold the same chain, each
                transaction once, its links verified, and every commit
                signature must re-verify true through
                ``OpenSSLVerifyEngine`` and through the kernel.  Prints
                blocks/s, tx/s, launches and elapsed.  Then the OpenSSL
                oracle stage: the seeded mixed waves of phases 2-5 at rung
                512 through the four signature kernels, the engine's
                verdicts equal to each mask bit for bit, with the engine's
                µs a signature for each scheme and the host's CPU model
                and core count; then the baseline stage: the port's
                ``obs.baseline.tiny_logical_row()`` validates under
                ``obs.benchschema`` and checks clean against
                ``BASELINE_OBS.json``.  ``embedder_busy`` follows the
                kernels line.
15. kernels   — one line with the five kernels: launches in their cell,
                agreement, time per launch at every rung the cell used
                (CUDA events), at its main rung (most lanes) and at 16384,
                the plain version's time, and the bound.  The comb row
                also carries its launches, lanes and rungs in cells F1,
                F, G0, G, V0, V, K, O1, O2, Y1, Y2, Y3, T0, T1, T2, M1, M2,
                M0, N1 and N4 (``cells``), and is timed at their rungs too.
16. generic_groups — the generic P-256 kernel at each group size (threads
                a signature): the library the wrapper loads (8) and the
                build at 4 (``csrc.VARIANTS``), each held to the plain
                mask at rung 512 and timed in turns (8, 4, 4, 8) at rungs
                128, 512, 2048 and at 16384, with ptxas' registers, stack
                and spills.
17. ed_generic_groups — the same for the generic Ed25519 kernel: the
                library (4 threads a signature) and the build at 2.
18. comb_groups — the same for the P-256 comb kernel: the library (8
                threads a signature) and the build at 4.
19. ed_comb_groups — the same for the Ed25519 comb kernel: the library
                (4 threads a signature) and the build at 2.
20. bls_groups — the same for the BLS12-381 pairing kernel: the library
                and the build at its other group size (threads a lane),
                at 128, 512, 2048 and 16384 lanes (the 2048-lane batch
                eight times over); then the split of a launch between the
                Miller loop and the final exponentiation: the build that
                stops after the Miller loop timed in turns with the
                library (library, Miller, Miller, library) at 512 and
                16384, and each build's dynamic shared memory a block.

The last two lines are the card's name and power limit as nvidia-smi
prints them, then ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

#: int32 multiply-adds a card issues per SM per clock (Hopper: 64 a clock,
#: half the fp32 rate); a 32 x 32 -> 64-bit product counts as two
IMAD_PER_SM_CLOCK = 64
#: 32-bit multiply-adds one 8-word modular product needs, by modulus and
#: kind (the keys of each kernel module's mont_ops): a*b is 64 wide
#: products, a*a 36 (each cross product once, doubled by a shift).
#: Montgomery reduction mod n adds, per word, q = t0 * n0inv (one) and q*N
#: (8 wide products); mod p it needs no multiply, since n0inv = 1 and the
#: words of p are 0, 1 and 2^32 - 1, so q*p is shifts and subtractions.
#: Mod the Ed25519 prime 2^255 - 19 the reduction is a fold, the high
#: eight words times 38 into the low eight: 8 wide products.  Mod the
#: 381-bit BLS12-381 p (12 words, CIOS): 144 wide products for a*b, 78 for
#: a*a, and per word q (one) and q*p (12 wide products) to reduce.
IMADS = {"p_mul": 2 * 64, "p_sqr": 2 * 36,
         "n_mul": 2 * 64 + 8 * (1 + 2 * 8), "n_sqr": 2 * 36 + 8 * (1 + 2 * 8),
         "ed_mul": 2 * 64 + 2 * 8, "ed_sqr": 2 * 36 + 2 * 8,
         "b381_mul": 2 * 144 + 12 * (1 + 2 * 12),
         "b381_sqr": 2 * 78 + 12 * (1 + 2 * 12)}
#: HBM3 bandwidth of an H100 SXM (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


#: the phase that is running, which a failure line on stdout names
CURRENT = {"phase": "setup"}
#: characters of a failure's message kept on its stdout line
ERROR_CHARS = 4000


def report_failure(error: str, **extra) -> None:
    """One JSON line on stdout naming the running phase and the reason it
    failed, so a run whose stderr is lost still says where it stopped."""
    emit({"phase": CURRENT["phase"], "ok": False,
          "error": error[:ERROR_CHARS], **extra})


def fail(msg: str) -> None:
    report_failure(msg)
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def run_phase(name: str, fn, *args):
    """``fn(*args)`` as phase ``name``: a failure inside it is reported on
    stdout under that name.  An exception is reported once, with the last
    frames of its traceback, and raised again; ``fail`` reports its own
    and exits."""
    outer, CURRENT["phase"] = CURRENT["phase"], name
    try:
        out = fn(*args)
    except Exception as exc:
        if not getattr(exc, "chip_smoke_reported", False):
            report_failure(f"{type(exc).__name__}: {exc}", traceback=[
                line for chunk in traceback.format_exception(exc, limit=-6)
                for line in chunk.rstrip().splitlines()][-40:])
            exc.chip_smoke_reported = True
        raise
    CURRENT["phase"] = outer
    return out


def early_exit(reason: str) -> int:
    """An exit before any phase ran: the reason on stdout and on stderr,
    and exit code 2."""
    report_failure(reason)
    print(f"chip_smoke: {reason}", file=sys.stderr, flush=True)
    return 2


def nvidia_smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# batches with a seeded rejection matrix
# ---------------------------------------------------------------------------


def openssl(scheme):
    """The port's OpenSSL engine of ``scheme``: the independent oracle
    every signature kernel's verdicts are held to."""
    from smartbft_tpu_torch.crypto.openssl_engine import OpenSSLVerifyEngine

    return OpenSSLVerifyEngine(scheme=scheme)


def make_batch(bsz: int, keys, rng, p256, tag: str):
    """``bsz`` signed items: lane i is key i % len(keys) signing message
    i // len(keys), so each message carries a full quorum wave.  Returns
    (items, claimed key index per lane, number of trailing zero lanes)."""
    nk = len(keys)
    npad = 64
    real = bsz - npad
    items, claim = [], []
    for i in range(real):
        d, pub = keys[i % nk]
        msg = f"{tag}-{i // nk}".encode()
        items.append(p256.make_item(msg, p256.sign_raw(d, msg), pub))
        claim.append(i % nk)
    for j, lane in enumerate(rng.choice(real, size=40, replace=False)):
        msg, r, s, pub = items[lane]
        kind = j % 4
        if kind == 0:
            items[lane] = (msg, (r + 1) % p256.N, s, pub)   # corrupted r
        elif kind == 1:
            items[lane] = (msg, 0, s, pub)                  # r = 0
        elif kind == 2:
            items[lane] = (msg, r, p256.N, pub)             # s >= n
        else:
            claim[lane] = (claim[lane] + 1) % nk            # wrong key claimed
    return items, claim, npad


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def imads(mont_ops: dict) -> int:
    return sum(IMADS[kind] * count for kind, count in mont_ops.items())


def bound(mont_ops: dict, bytes_moved: int,
          clock_hz: float, sms: int) -> tuple[float, str]:
    ops_s = imads(mont_ops) / (sms * IMAD_PER_SM_CLOCK * clock_hz)
    mem_s = bytes_moved / HBM_BYTES_PER_S
    return (1e3 * max(ops_s, mem_s),
            "operations" if ops_s >= mem_s else "bytes")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build():
    from smartbft_tpu_torch import csrc

    t0 = time.perf_counter()
    report = csrc.build(list(csrc.SOURCES) + list(csrc.VARIANTS), force=True)
    wall = time.perf_counter() - t0
    out = {"phase": "build", "ok": True, "seconds": round(wall, 2),
           "nvcc_flags": " ".join(csrc.NVCC_FLAGS), "kernels": {}}
    for name, rep in report.items():
        out["kernels"][name] = {k: v for k, v in rep.items() if k != "ptxas"}
        print(f"# ptxas {name}:\n# " + rep["ptxas"].replace("\n", "\n# "),
              flush=True)
    emit(out)
    return report


def first_lanes(args, bsz: int):
    """A kernel's arguments cut to their first ``bsz`` lanes: the per-lane
    tensors are sliced, the uint32 tables pass whole."""
    import torch

    return [a if a.dtype == torch.uint32 else a[:bsz] for a in args]


def kernel_phase(name, run_kernel, run_plain, expect, make_args):
    """Kernel vs plain vs the expected verdicts on one batch; returns the
    record."""
    import torch

    args = make_args()
    got = run_kernel(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = run_plain(*args)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    got_l, plain_l = got.cpu().tolist(), plain.cpu().tolist()
    diff = max(abs(a - b) for a, b in zip(got_l, plain_l))
    if got_l != plain_l:
        bad = [i for i, (a, b) in enumerate(zip(got_l, plain_l)) if a != b]
        fail(f"{name}: kernel and plain masks differ at lanes {bad[:16]}")
    if got_l != [int(v) for v in expect]:
        bad = [i for i, (a, b) in enumerate(zip(got_l, expect)) if a != b]
        fail(f"{name}: mask differs from the expected verdicts at lanes "
             f"{bad[:16]}")
    return {"lanes": len(got_l), "accepted": sum(got_l),
            "rejected": len(got_l) - sum(got_l), "max_abs_err": diff,
            "plain_ms": round(plain_ms, 3), "args": args}


def comb_tables(keys):
    """A comb registry of ``keys`` and the (base, key) tables on the card."""
    import torch

    from smartbft_tpu_torch.crypto import cuda_comb as cc

    reg = cc.CombKeyRegistry()
    for _, pub in keys:
        reg.register(pub)
    dev = torch.device("cuda")
    return reg, [torch.from_numpy(cc.g_table()).to(dev),
                 torch.from_numpy(reg.stacked()).to(dev)]


def comb_wave(bsz, keys, rng, reg, tables, tag):
    """A seeded comb wave of ``bsz`` lanes (:func:`make_batch`): the items
    as OpenSSL sees them (message, r, s, the claimed key), the number of
    trailing zero lanes, and the kernel's arguments on the card."""
    import numpy as np
    import torch

    from smartbft_tpu_torch.crypto import cuda_comb as cc
    from smartbft_tpu_torch.crypto import p256

    items, claim, npad = make_batch(bsz, keys, rng, p256, tag)
    e8, r8, s8, _ = cc.pack_items(items, reg)
    z = np.zeros((npad, 32), np.uint8)
    e8, r8, s8 = (np.concatenate([a, z]) for a in (e8, r8, s8))
    kidx = np.array(claim + [0] * npad, np.int32)
    claimed = [(m, r, s, keys[k][1]) for (m, r, s, _), k in zip(items, claim)]
    dev = torch.device("cuda")
    return claimed, npad, [torch.from_numpy(a).to(dev)
                           for a in (e8, r8, s8, kidx)] + tables


def phase_comb(rng, keys):
    from smartbft_tpu_torch.crypto import cuda_comb as cc
    from smartbft_tpu_torch.crypto import p256

    reg, tables = comb_tables(keys)
    oracle = openssl(p256)
    records = {}
    for bsz in (16384, 2048):
        claimed, npad, args = comb_wave(bsz, keys, rng, reg, tables,
                                        f"comb{bsz}")
        expect = oracle.verify(claimed) + [False] * npad
        rec = kernel_phase(f"comb B={bsz}", cc.ecdsa_verify_comb,
                           cc.ecdsa_verify_comb_plain, expect, lambda: args)
        records[bsz] = rec
        emit({"phase": "comb", "ok": True, "B": bsz,
              **{k: v for k, v in rec.items() if k != "args"}})
    return records


def generic_keys() -> list:
    from smartbft_tpu_torch.crypto import p256

    return [p256.keygen(b"smoke-generic-%d" % i) for i in range(64)]


def generic_wave(bsz, keys, rng, tag):
    """A seeded generic P-256 wave of ``bsz`` lanes: :func:`make_batch`
    with each wrong-key lane presenting the other key and 8 more lanes an
    off-curve key.  Returns the items, the number of trailing zero lanes
    and the kernel's arguments on the card."""
    import numpy as np
    import torch

    from smartbft_tpu_torch.crypto import p256

    items, claim, npad = make_batch(bsz, keys, rng, p256, tag)
    items = [(m, r, s, keys[k][1]) for (m, r, s, _), k in zip(items, claim)]
    for lane in rng.choice(len(items), size=8, replace=False):
        m, r, s, (x, y) = items[lane]
        items[lane] = (m, r, s, (x, (y + 1) % p256.P))
    arrays = [np.concatenate([a, np.zeros((npad, 32), np.uint8)])
              for a in p256.verify_bytes(items)]
    dev = torch.device("cuda")
    return items, npad, [torch.from_numpy(a).to(dev) for a in arrays]


def phase_generic(rng):
    from smartbft_tpu_torch.crypto import cuda_ecdsa as ce
    from smartbft_tpu_torch.crypto import p256

    keys = generic_keys()
    oracle = openssl(p256)
    records = {}
    for bsz in (16384, 2048):
        items, npad, args = generic_wave(bsz, keys, rng, f"gen{bsz}")
        expect = oracle.verify(items) + [False] * npad
        rec = kernel_phase(f"generic B={bsz}", ce.ecdsa_verify,
                           ce.ecdsa_verify_plain, expect, lambda: args)
        records[bsz] = rec
        emit({"phase": "generic", "ok": True, "B": bsz,
              **{k: v for k, v in rec.items() if k != "args"}})
    return records


# ---------------------------------------------------------------------------
# Ed25519 batches
# ---------------------------------------------------------------------------


def undecodable_r(rng, ed):
    """A 32-byte encoding with y < p and no x (no square root): a canonical
    encoding that every library rejects."""
    while True:
        y = int.from_bytes(rng.bytes(32), "little") % ed.P
        enc = y.to_bytes(32, "little")
        if ed.decompress(enc) is None:
            return enc


def make_ed_batch(bsz: int, keys, rng, ed, tag: str, kinds: int):
    """``bsz - 64`` Ed25519 votes (lane i: key i % len(keys) on message
    i // len(keys)) and 64 trailing zero lanes.  40 seeded lanes get one of
    ``kinds`` faults: 0 corrupted S, 1 tampered message, 2 S + L, 3 an
    undecodable R, 4 the signature claimed under the next key, 5 (the
    comb batch only) a claim on a zero-padded stack slot.  Returns (items,
    claimed key per lane, faulted lanes by kind, number of zero lanes)."""
    nk = len(keys)
    npad = 64
    real = bsz - npad
    items, claim = [], []
    for i in range(real):
        priv, pub = keys[i % nk]
        msg = f"{tag}-{i // nk}".encode()
        items.append(ed.make_item(msg, ed.sign_raw(priv, msg), pub))
        claim.append(i % nk)
    faults: dict = {}
    for j, lane in enumerate(rng.choice(real, size=40, replace=False)):
        lane, kind = int(lane), j % kinds
        msg, sig, pub = items[lane]
        s_int = int.from_bytes(sig[32:], "little")
        if kind == 0:
            sig = sig[:32] + ((s_int + 1) % ed.L).to_bytes(32, "little")
        elif kind == 1:
            msg = msg + b"-tampered"
        elif kind == 2:
            sig = sig[:32] + (s_int + ed.L).to_bytes(32, "little")
        elif kind == 3:
            sig = undecodable_r(rng, ed) + sig[32:]
        elif kind == 4:
            claim[lane] = (claim[lane] + 1) % nk
        items[lane] = (msg, sig, pub)
        faults.setdefault(kind, []).append(lane)
    return items, claim, faults, npad


def check_ed_expectations(name, items, pubs, truth, no_key, rng, ed):
    """The verdicts a batch must get, held to ``ed25519.verify_item`` on
    every faulted lane and a seeded sample of valid ones, and to the
    OpenSSL engine on every lane; lanes in ``no_key`` (a claim on a padded
    stack slot) have no key to hold them to.  Returns the number of
    verify_item lanes."""
    faulted = [i for i, t in enumerate(truth[:len(items)])
               if not t and i not in no_key]
    valid = [i for i, t in enumerate(truth[:len(items)]) if t]
    sample = faulted + [int(i) for i in
                        rng.choice(valid, min(24, len(valid)), replace=False)]
    for i in sample:
        m, sig, _ = items[i]
        if ed.verify_item((m, sig, pubs[i])) != truth[i]:
            fail(f"{name}: verify_item disagrees with lane {i}'s fault")
    lanes = [i for i in range(len(items)) if i not in no_key]
    got = openssl(ed).verify([(items[i][0], items[i][1], pubs[i])
                              for i in lanes])
    for i, ok in zip(lanes, got):
        if ok != truth[i]:
            fail(f"{name}: OpenSSL disagrees with lane {i}'s fault")
    return len(sample)


def ed_comb_tables(keys):
    """An Ed25519 comb registry of ``keys`` and one more (the stack pads
    to 128 slots, so slots 65..127 are zero and a claim on them must
    fail), and the (base, key) tables on the card."""
    import torch

    from smartbft_tpu_torch.crypto import cuda_ed25519 as ced
    from smartbft_tpu_torch.crypto import ed25519 as ed

    reg = ced.Ed25519CombVerifier("cpu").registry
    for _, pub in keys + [ed.keygen(b"smoke-ed-extra")]:
        reg.register(pub)
    dev = torch.device("cuda")
    return reg, [torch.from_numpy(ced.b_table()).to(dev),
                 torch.from_numpy(reg.stacked()).to(dev)]


def ed_comb_wave(bsz, keys, rng, reg, tables, tag, kinds):
    """A seeded Ed25519 comb wave (:func:`make_ed_batch`, faults of
    ``kinds`` kinds).  Returns the items, each lane's claimed key, the
    expected verdict per lane, the lanes claiming a padded stack slot,
    the faulted lanes by kind, and the kernel's arguments on the card."""
    import numpy as np
    import torch

    from smartbft_tpu_torch.crypto import cuda_ed25519 as ced
    from smartbft_tpu_torch.crypto import ed25519 as ed

    slots = int(tables[1].shape[0])
    items, claim, faults, npad = make_ed_batch(bsz, keys, rng, ed, tag,
                                               kinds=kinds)
    s8, h8, rx8, ry8, ok, kidx = ced.pack_items(items, reg)
    kidx[:] = claim
    for lane in faults.get(5, []):
        kidx[lane] = len(reg) + lane % (slots - len(reg))
        ok[lane] = 1
    z = np.zeros((npad, 32), np.uint8)
    s8, h8, rx8, ry8 = (np.concatenate([a, z]) for a in (s8, h8, rx8, ry8))
    zl = np.zeros(npad, np.int32)
    ok, kidx = np.concatenate([ok, zl]), np.concatenate([kidx, zl])
    faulted = {i for lanes in faults.values() for i in lanes}
    truth = [i not in faulted for i in range(len(items))] + [False] * npad
    pubs = [keys[k][1] for k in claim]
    dev = torch.device("cuda")
    args = [torch.from_numpy(a).to(dev)
            for a in (s8, h8, rx8, ry8, ok, kidx)] + tables
    return items, pubs, truth, set(faults.get(5, [])), faults, args


def phase_ed_comb(rng, keys):
    from smartbft_tpu_torch.crypto import cuda_ed25519 as ced
    from smartbft_tpu_torch.crypto import ed25519 as ed

    reg, tables = ed_comb_tables(keys)
    records = {}
    for bsz in (16384, 2048):
        items, pubs, truth, no_key, faults, args = ed_comb_wave(
            bsz, keys, rng, reg, tables, f"edc{bsz}", kinds=6)
        n_vi = check_ed_expectations(f"ed_comb B={bsz}", items, pubs, truth,
                                     no_key, rng, ed)
        rec = kernel_phase(f"ed_comb B={bsz}", ced.eddsa_verify_comb,
                           ced.eddsa_verify_comb_plain, truth, lambda: args)
        records[bsz] = rec
        emit({"phase": "ed_comb", "ok": True, "B": bsz,
              "stack_slots": int(tables[1].shape[0]), "keys": len(reg),
              "faults": {str(k): len(v) for k, v in sorted(faults.items())},
              "verify_item_lanes": n_vi,
              **{k: v for k, v in rec.items() if k != "args"}})
    return records


def ed_generic_keys() -> list:
    from smartbft_tpu_torch.crypto import ed25519 as ed

    return [ed.keygen(b"smoke-ed-generic-%d" % i) for i in range(64)]


def ed_generic_wave(bsz, keys, rng, tag):
    """A seeded generic Ed25519 wave (:func:`make_ed_batch`, five kinds of
    fault), the claimed key presented and 8 more lanes presenting a key
    that does not decode.  Returns the items, the expected verdict per
    lane, the faulted lanes by kind, the undecodable-key lanes and the
    kernel's arguments on the card."""
    import numpy as np
    import torch

    from smartbft_tpu_torch.crypto import ed25519 as ed

    items, claim, faults, npad = make_ed_batch(bsz, keys, rng, ed, tag,
                                               kinds=5)
    items = [(m, sig, keys[k][1]) for (m, sig, _), k in zip(items, claim)]
    bad_keys = [int(i) for i in rng.choice(len(items), 8, replace=False)]
    for lane in bad_keys:
        m, sig, _ = items[lane]
        items[lane] = (m, sig, undecodable_r(rng, ed))
    arrays = [np.concatenate([a, np.zeros((npad,) + a.shape[1:], a.dtype)])
              for a in ed.verify_inputs(items)]
    faulted = {i for lanes in faults.values() for i in lanes} | set(bad_keys)
    truth = [i not in faulted for i in range(len(items))] + [False] * npad
    dev = torch.device("cuda")
    return items, truth, faults, bad_keys, [torch.from_numpy(a).to(dev)
                                            for a in arrays]


def phase_ed_generic(rng):
    from smartbft_tpu_torch.crypto import cuda_eddsa as cgd
    from smartbft_tpu_torch.crypto import ed25519 as ed

    keys = ed_generic_keys()
    records = {}
    for bsz in (16384, 2048):
        items, truth, faults, bad_keys, args = ed_generic_wave(
            bsz, keys, rng, f"edg{bsz}")
        pubs = [pub for _, _, pub in items]
        n_vi = check_ed_expectations(f"ed_generic B={bsz}", items, pubs, truth,
                                     set(), rng, ed)
        rec = kernel_phase(f"ed_generic B={bsz}", cgd.eddsa_verify,
                           cgd.eddsa_verify_plain, truth, lambda: args)
        records[bsz] = rec
        emit({"phase": "ed_generic", "ok": True, "B": bsz,
              "faults": {str(k): len(v) for k, v in sorted(faults.items())},
              "undecodable_keys": len(bad_keys), "verify_item_lanes": n_vi,
              **{k: v for k, v in rec.items() if k != "args"}})
    return records


# ---------------------------------------------------------------------------
# BLS12-381 batches
# ---------------------------------------------------------------------------


def make_bls_batch(bsz: int, keys, rng, bls, tag: str, nfault: int):
    """BLS12-381 lanes: lane i is key i % len(keys) signing message
    i // len(keys), then trailing zero lanes.  ``nfault`` seeded lanes get
    one of seven faults: 0 a tampered message, 1 the next key, 2 the
    signature plus the generator (in G1, wrong), 3 a flipped byte (does not
    decode to a G1 point), 4 the aggregate of the first 43 votes on the
    lane's message (a quorum, valid), 5 the same aggregate with one
    signature left out (invalid), 6 random bytes (ok = 0).  Returns
    (items, expected verdict per lane, faulted lanes by kind, number of
    zero lanes)."""
    nk = len(keys)
    npad = 64 if bsz > 128 else 16
    real = bsz - npad
    votes = []
    for i in range(real):
        sk, pk = keys[i % nk]
        msg = f"{tag}-{i // nk}".encode()
        votes.append((msg, bls.sign(sk, msg), pk))
    items = list(votes)
    quorum = 43
    faults: dict = {}
    for j, lane in enumerate(rng.choice(real, size=nfault, replace=False)):
        lane, kind = int(lane), j % 7
        msg, sig, pub = items[lane]
        first = (lane // nk) * nk
        if first + quorum > real:
            first = 0
        group = votes[first:first + quorum]
        if kind == 0:
            msg = msg + b"-tampered"
        elif kind == 1:
            pub = keys[(lane + 1) % nk][1]
        elif kind == 2:
            sig = bls.serialize_g1(bls.g1_add_affine(
                bls.deserialize_g1(sig), (bls.G1X, bls.G1Y)))
        elif kind == 3:
            sig = sig[:7] + bytes([sig[7] ^ 1]) + sig[8:]
        elif kind == 4:
            msg, sig, pub = bls.aggregate_items(group)
        elif kind == 5:
            msg = group[0][0]
            sig = bls.aggregate_sigs([g[1] for g in group[1:]])
            pub = bls.aggregate_pubs([g[2] for g in group])
        else:
            sig, pub = rng.bytes(bls.SIG_BYTES), rng.bytes(bls.PUB_BYTES)
        items[lane] = (msg, sig, pub)
        faults.setdefault(kind, []).append(lane)
    bad = {i for kind, lanes in faults.items() if kind != 4 for i in lanes}
    truth = [i not in bad for i in range(real)] + [False] * npad
    return items, truth, faults, npad


def phase_bls(rng, keys):
    """The pairing kernel at 2048 and at 128 lanes against its plain
    version, bit for bit, and against the expected verdicts, held to
    ``bls12381.verify_item`` on every faulted lane and a seeded sample of
    valid ones."""
    import numpy as np
    import torch

    from smartbft_tpu_torch.crypto import bls12381 as bls
    from smartbft_tpu_torch.crypto import cuda_bls as cbl

    dev = torch.device("cuda")
    records = {}
    for bsz, nfault in ((2048, 42), (128, 14)):
        items, truth, faults, npad = make_bls_batch(
            bsz, keys, rng, bls, f"bls{bsz}", nfault)
        faulted = sorted(i for lanes in faults.values() for i in lanes)
        valid = [i for i in range(len(items)) if truth[i]
                 and i not in faulted]
        sample = faulted + [int(i) for i in rng.choice(valid, 24,
                                                       replace=False)]
        for i in sample:
            if bls.verify_item(items[i]) != truth[i]:
                fail(f"bls B={bsz}: verify_item disagrees with lane {i}")
        arrays = [np.concatenate([a, np.zeros((npad,) + a.shape[1:], a.dtype)])
                  for a in cbl.verify_words(items)]
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        got = cbl.bls_verify(*args)
        torch.cuda.synchronize()
        got_l = got.cpu().tolist()
        if got_l != [int(t) for t in truth]:
            bad = [i for i, (a, b) in enumerate(zip(got_l, truth)) if a != b]
            fail(f"bls B={bsz}: mask differs from the expected verdicts at "
                 f"lanes {bad[:16]}")
        t0 = time.perf_counter()
        plain = cbl.bls_verify_plain(*args)
        torch.cuda.synchronize()
        plain_ms = round(1e3 * (time.perf_counter() - t0), 3)
        plain_l = plain.cpu().tolist()
        if plain_l != got_l:
            bad = [i for i, (a, b) in enumerate(zip(got_l, plain_l))
                   if a != b]
            fail(f"bls B={bsz}: kernel and plain masks differ at lanes "
                 f"{bad[:16]}")
        rec = {"lanes": bsz, "accepted": sum(got_l),
               "rejected": bsz - sum(got_l),
               "max_abs_err": max(abs(a - b) for a, b in zip(got_l, plain_l)),
               "plain_ms": plain_ms, "args": args}
        records[bsz] = rec
        emit({"phase": "bls", "ok": True, "B": bsz,
              "faults": {str(k): len(v) for k, v in sorted(faults.items())},
              "verify_item_lanes": len(sample),
              "ok_lanes": int(arrays[-1].sum()),
              **{k: v for k, v in rec.items() if k != "args"}})
    return records


def bench_overrides(cfg, n: int, batch: int, requests: int, **extra):
    """``cfg`` with the overrides every bench cell shares (the JAX
    package's bench recipe): group-commit WAL, ``batch``-request
    proposals, a pool and an inbox that hold the burst, and liveness
    timeouts long enough that a wave in flight never deposes a healthy
    leader; ``extra`` adds a cell's own."""
    return dataclasses.replace(
        cfg,
        wal_group_commit=True,
        request_batch_max_count=batch,
        request_batch_max_interval=0.02,
        request_pool_size=max(2 * requests, 800),
        incoming_message_buffer_size=max(2000, 40 * n),
        request_forward_timeout=300.0,
        request_complain_timeout=600.0,
        request_auto_remove_timeout=1200.0,
        view_change_resend_interval=300.0,
        view_change_timeout=1200.0,
        leader_heartbeat_timeout=900.0,
        **extra,
    )


def committed(app) -> int:
    """Requests in ``app``'s ledger."""
    return sum(len(app.requests_from_proposal(d.proposal))
               for d in app.ledger())


def ledger_digests(apps) -> set:
    """The distinct chained ledger digests (hex) the replicas hold."""
    from smartbft_tpu_torch.testing.app import CHAIN_SEED, chain_update

    digests = set()
    for a in apps:
        h = CHAIN_SEED
        for d in a.ledger():
            h = chain_update(h, d.proposal.payload, d.proposal.metadata)
        digests.add(h.hex())
    return digests


async def wait_committed(groups: dict, requests: int, t0: float,
                         what: str) -> dict:
    """Poll, awaiting so the cluster runs, until every replica of every
    group in ``groups`` (key -> apps) has committed ``requests``; returns
    the seconds from ``t0`` at which each group was done."""
    done_at: dict = {}
    deadline = time.perf_counter() + 600.0
    while len(done_at) < len(groups):
        for key, apps in groups.items():
            if key not in done_at and all(committed(a) >= requests
                                          for a in apps):
                done_at[key] = time.perf_counter() - t0
        if time.perf_counter() > deadline:
            fail(f"{what}: did not commit {requests} requests "
                 f"({sorted(done_at)} of {sorted(groups)} did)")
        await asyncio.sleep(0.02)
    return done_at


async def run_cluster(engine, rings, node_ids, decisions: int, batch: int,
                      pipeline: int, wal_root: str, tag: str, pops=None,
                      transport=None):
    """One n-replica deployment over a shared engine: commit ``decisions``
    x ``batch`` requests; returns the run's measurements.  ``pops``: the
    proofs of possession a BLS12-381 provider is given.  ``transport``:
    None for the in-process ``Network``; ``"uds"`` or ``"tcp"`` gives
    each replica its own ``SocketComm`` (one process, one event loop,
    frames over real kernel sockets), and the run then also returns the
    transport counters summed over the replicas, the seconds the replicas
    took to stop, and the transport tasks left after the stop."""
    from smartbft_tpu_torch.crypto import bls12381, ed25519
    from smartbft_tpu_torch.crypto.provider import (
        AsyncBatchCoalescer,
        BlsCryptoProvider,
        Ed25519CryptoProvider,
        P256CryptoProvider,
    )
    from smartbft_tpu_torch.metrics import PROTOCOL_PLANE, ProtocolPlaneTimers
    from smartbft_tpu_torch.testing.app import App, SharedLedgers, fast_config
    from smartbft_tpu_torch.testing.network import Network
    from smartbft_tpu_torch.utils.clock import Scheduler, WallClockDriver

    n = len(node_ids)
    requests = decisions * batch
    if engine.scheme is bls12381:
        def provider(ring, **kw):
            return BlsCryptoProvider(ring, pops=pops, **kw)
    else:
        provider = (Ed25519CryptoProvider if engine.scheme is ed25519
                    else P256CryptoProvider)

    def cfg(i):
        return bench_overrides(
            fast_config(i), n, batch, requests,
            leader_rotation=False, decisions_per_leader=0,
            pipeline_depth=pipeline)

    coalescer = AsyncBatchCoalescer(
        engine, window=0.02, max_batch=2 * pipeline * engine.pad_sizes[-1],
        dedupe=True)
    scheduler = Scheduler()
    driver = WallClockDriver(scheduler, tick_interval=0.01)
    network = Network(seed=13) if transport is None else None
    comms, reserved = socket_comms(node_ids, transport, wal_root, tag)
    shared = SharedLedgers()
    apps = [
        App(i, network, shared, scheduler,
            wal_dir=os.path.join(wal_root, f"{tag}-wal-{i}"), config=cfg(i),
            crypto=provider(rings[i], engine=engine, coalescer=coalescer),
            comm=comms.get(i))
        for i in node_ids
    ]

    driver.start()
    try:
        try:
            for a in apps:
                await a.start()
        finally:
            for sock in reserved:
                sock.close()
        t0 = time.perf_counter()
        # the default plane, which both the in-process network and the
        # sockets feed: the process-wide aggregate drops the counts of
        # planes collected in the window (earlier phases' shard planes)
        plane0 = PROTOCOL_PLANE.snapshot()
        for k in range(requests):
            await apps[0].submit("bench", f"{tag}-req-{k}")
        elapsed = (await wait_committed({tag: apps}, requests, t0,
                                        f"e2e {tag}"))[tag]
        plane = ProtocolPlaneTimers.delta(plane0, PROTOCOL_PLANE.snapshot())
        net = socket_totals(comms)
    finally:
        t_stop = time.perf_counter()
        for a in apps:
            await a.stop()
        stop_s = time.perf_counter() - t_stop
        await driver.stop()
        if transport == "uds":
            sockdir = comms[node_ids[0]].listen[len("uds://"):]
            shutil.rmtree(os.path.dirname(sockdir), ignore_errors=True)
    digests = ledger_digests(apps)
    out = {
        "nodes": n, "requests": requests,
        "committed_min": min(committed(a) for a in apps),
        "committed_max": max(committed(a) for a in apps),
        "decisions": len(apps[0].ledger()),
        "ledger_digests": len(digests),
        "ledger_digest": sorted(digests)[0][:16],
        "elapsed_s": round(elapsed, 3),
        "tx_per_s": round(requests / elapsed, 1),
        "breaker": coalescer.fault_snapshot(),
        # the message plane in the window: ingest ticks and the messages
        # they carried, and its four disjoint terms (µs, all replicas)
        "protocol_plane": {
            **{k: plane[k] for k in ("msgs_ingested", "batch_ingests",
                                     "ingest_us", "route_us", "codec_us",
                                     "vote_reg_us")},
            "msgs_per_ingest": round(plane["msgs_ingested"]
                                     / max(plane["batch_ingests"], 1), 2)},
    }
    if comms:
        out.update(transport=net, stop_s=round(stop_s, 3),
                   transport_tasks_left=sorted(
                       t.get_name() for t in asyncio.all_tasks()
                       if t.get_name().startswith("net-")))
    return out


def socket_comms(node_ids, transport, wal_root: str, tag: str):
    """One ``SocketComm`` a replica over ``transport`` (``"uds"``: sockets
    in a directory of the run's own under ``wal_root``, or under /tmp
    where that path would pass the ~107-byte UDS limit; ``"tcp"``:
    127.0.0.1, ports reserved up front), or {} for the in-process
    network; and the sockets that hold the TCP ports, to close once every
    replica listens.  A reserving socket stays bound (SO_REUSEADDR, not
    listening, so the replica's server can bind the port beside it)
    because the replicas that start first dial their peers, and the
    kernel gave a dial's source port to a port reserved and released
    (``address already in use`` at a later replica's bind: once in ten
    smoke runs on the card)."""
    import socket
    import tempfile

    from smartbft_tpu_torch.net.transport import SocketComm

    reserved: list = []
    if transport is None:
        return {}, reserved
    if transport == "uds":
        sockdir = os.path.join(wal_root, f"{tag}-s")
        if len(sockdir) > 90:
            sockdir = tempfile.mkdtemp(prefix="sbft-", dir="/tmp")
        os.makedirs(sockdir, exist_ok=True)
        addrs = {i: f"uds://{sockdir}/n{i}.sock" for i in node_ids}
    else:
        addrs = {}
        for i in node_ids:
            sock = socket.socket()
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind(("127.0.0.1", 0))
            reserved.append(sock)
            addrs[i] = f"tcp://127.0.0.1:{sock.getsockname()[1]}"
    return {i: SocketComm(i, addrs[i],
                          {j: a for j, a in addrs.items() if j != i},
                          cluster_key=b"smoke", backoff_base=0.01,
                          backoff_max=0.2)
            for i in node_ids}, reserved


def socket_totals(comms: dict) -> dict:
    """The replicas' ``TransportMetrics`` summed, as the JAX package's
    transport bench reports them: bytes, frames, frames a flush,
    reconnects, drops and malformed frames."""
    if not comms:
        return {}
    from smartbft_tpu_torch.net.transport import TransportMetrics

    total = TransportMetrics()
    connected = 0
    for comm in comms.values():
        snap = comm.transport_snapshot()
        for name in TransportMetrics.__slots__:
            setattr(total, name, getattr(total, name) + snap[name])
        connected += snap["peers_connected"]
    snap = total.snapshot()
    keep = ("bytes_sent", "bytes_received", "frames_sent", "frames_received",
            "flush_batches", "frames_per_flush", "ingest_batches",
            "connects", "reconnects", "connect_failures", "outbox_dropped",
            "link_dropped", "malformed_frames", "connections_dropped",
            "handshake_rejected")
    out = {k: snap[k] for k in keep}
    out["peers_connected"] = connected
    return out


def launch_counters() -> dict:
    """The five kernels' launch counters, by the name each cell uses."""
    from smartbft_tpu_torch.crypto import cuda_bls as cbl
    from smartbft_tpu_torch.crypto import cuda_comb as cc
    from smartbft_tpu_torch.crypto import cuda_ecdsa as ce
    from smartbft_tpu_torch.crypto import cuda_ed25519 as ced
    from smartbft_tpu_torch.crypto import cuda_eddsa as cgd

    return {"comb": cc.LAUNCHES, "generic": ce.LAUNCHES,
            "ed_comb": ced.LAUNCHES, "ed_generic": cgd.LAUNCHES,
            "bls": cbl.LAUNCHES}


def read_cell(engine, kernel, phase, tag, run):
    """Read the launch counters and the engine's stats just after a cell's
    run: the verify plane must have stayed off the host, ``kernel`` and
    no other must have launched, its lanes must be the engine's slots and
    cover its signatures.  Returns the cell's launch fields."""
    counts = {k: (c.launches, c.lanes) for k, c in launch_counters().items()}
    stats, rungs = engine.stats, dict(engine.rung_launches)
    br = run.pop("breaker")
    if br["opens"] or br["host_fallback_batches"] or br["launch_failures"]:
        fail(f"{phase} {tag}: verify plane degraded: {br}")
    if counts[kernel][0] == 0:
        fail(f"{phase} {tag}: the {kernel} kernel was never launched")
    others = {k: v[0] for k, v in counts.items() if k != kernel and v[0]}
    if others:
        fail(f"{phase} {tag}: other kernels ran in the {kernel} cell: "
             f"{others}")
    lanes = counts[kernel][1]
    if lanes != stats.slots_used or lanes < stats.sigs_verified:
        fail(f"{phase} {tag}: kernel lanes {lanes} do not cover the "
             f"engine's {stats.sigs_verified} signatures in "
             f"{stats.slots_used} slots")
    route = "comb" if kernel in ("comb", "ed_comb") else "generic"
    if engine.route_launches != {"comb": 0, "generic": 0,
                                 route: counts[kernel][0]}:
        fail(f"{phase} {tag}: engine routes {engine.route_launches} "
             f"disagree with kernel counters {counts}")
    # the main-path rung carries the most lanes; a tie goes to the larger
    main_rung = max(rungs, key=lambda r: (r * rungs[r], r))
    return {
        "kernel": kernel,
        "kernel_launches": {k: v[0] for k, v in counts.items()},
        "kernel_lanes": {k: v[1] for k, v in counts.items()},
        "launches_per_decision": round(counts[kernel][0] / run["decisions"], 3),
        "sigs_verified": stats.sigs_verified, "slots": stats.slots_used,
        "fill_pct": round(stats.batch_fill_pct, 1),
        "rung_launches": {str(k): v for k, v in sorted(rungs.items())},
        "main_rung": main_rung, "breaker": br,
    }


def drive_cell(engine, kernel, rings, ids, decisions, batch, pipeline,
               wal_root, tag, pops=None):
    """One cell of the main path.  All five launch counters and the
    engine's stats are zeroed just before the run and read just after it;
    the cell must commit, keep every ledger equal, stay off the host, and
    launch ``kernel`` and no other."""
    zero_launch_counters(engine)
    run = asyncio.run(run_cluster(engine, rings, ids, decisions, batch,
                                  pipeline, wal_root, tag, pops))
    if run["committed_min"] < run["requests"]:
        fail(f"e2e {tag}: a replica committed {run['committed_min']} "
             f"of {run['requests']}")
    if run["ledger_digests"] != 1:
        fail(f"e2e {tag}: replicas hold {run['ledger_digests']} "
             "different ledgers")
    run.update(read_cell(engine, kernel, "e2e", tag, run))
    return run


def phase_e2e(wal_root, scheme, n=64, batch=500, pipeline=16,
              decisions=32):
    """Two cells of one scheme on one long-lived engine: its comb kernel
    for the first membership, then its generic kernel for a second one
    after earlier memberships filled the 128-key registry."""
    from smartbft_tpu_torch.crypto import cuda_comb as cc
    from smartbft_tpu_torch.crypto import ed25519
    from smartbft_tpu_torch.crypto.provider import Keyring, TorchVerifyEngine

    ed = scheme is ed25519
    kernels = ("ed_comb", "ed_generic") if ed else ("comb", "generic")
    tags = ("c", "d") if ed else ("a", "b")
    ids_1 = list(range(1, n + 1))
    ids_2 = list(range(n + 1, 2 * n + 1))
    rings_1 = Keyring.generate(ids_1, seed=b"bench-tput", scheme=scheme)
    rings_2 = Keyring.generate(ids_2, seed=b"smoke-membership-b",
                               scheme=scheme)
    engine = TorchVerifyEngine(device="cuda", scheme=scheme)
    engine.prewarm_keys(rings_1[ids_1[0]].public_keys.values())
    ring = rings_1[ids_1[0]]
    warm = scheme.make_item(b"warm", scheme.sign_raw(ring.private_key, b"warm"),
                            ring.public_keys[ids_1[0]])
    t0 = time.perf_counter()
    engine.prewarm_shapes(warm)
    prewarm_s = time.perf_counter() - t0
    run_1 = drive_cell(engine, kernels[0], rings_1, ids_1, decisions, batch,
                       pipeline, wal_root, tags[0])
    # the same long-lived engine has since seen other memberships: keys of
    # earlier configurations fill its comb registry (128 keys), so the
    # second membership's keys overflow it and its waves run the generic
    # kernel.  The fill is set-up: registered and uploaded before the cell.
    room = cc.CombKeyRegistry().cap - n
    engine.prewarm_keys(scheme.keygen(b"smoke-earlier-member-%d" % i)[1]
                        for i in range(room))
    engine.verify([warm])
    run_2 = drive_cell(engine, kernels[1], rings_2, ids_2, decisions, batch,
                       pipeline, wal_root, tags[1])
    name = "ed25519" if ed else "p256"
    emit({
        "phase": "e2e", "ok": True, "scheme": name,
        "prewarm_s": round(prewarm_s, 2),
        "deployment": {"nodes": n, "request_batch_max_count": batch,
                       "pipeline_depth": pipeline, "wal_group_commit": True,
                       "shared_dedupe_coalescer": True, "scheme": name},
        f"{tags[0]}_comb": run_1, f"{tags[1]}_registry_full": run_2,
    })
    return {kernels[0]: run_1, kernels[1]: run_2}


def phase_e2e_bls(wal_root, n=64, batch=500, pipeline=16, decisions=32):
    """Cell E: the A-D deployment with BLS12-381 aggregate votes
    (BASELINE configs [4]) on one engine; every key's proof of possession
    is passed as ``pops``.  Counts the lanes the engine verified in the
    run and the aggregated ones among them (a lane whose key is not a
    member's is a quorum's aggregate)."""
    import threading

    from smartbft_tpu_torch.crypto import bls12381 as bls
    from smartbft_tpu_torch.crypto.provider import Keyring, TorchVerifyEngine

    ids = list(range(1, n + 1))
    rings = Keyring.generate(ids, seed=b"bench-tput", scheme=bls)
    ring = rings[ids[0]]
    pops = {i: bls.pop_prove(rings[i].private_key, rings[i].public_keys[i])
            for i in ids}
    engine = TorchVerifyEngine(device="cuda", scheme=bls)
    warm = bls.make_item(b"warm", bls.sign_raw(ring.private_key, b"warm"),
                         ring.public_keys[ids[0]])
    t0 = time.perf_counter()
    engine.prewarm_shapes(warm)
    prewarm_s = time.perf_counter() - t0
    members = set(ring.public_keys.values())
    tally = {"lanes": 0, "aggregated": 0}
    lock = threading.Lock()
    verify = engine.verify

    def counted(items):
        with lock:
            tally["lanes"] += len(items)
            tally["aggregated"] += sum(it[2] not in members for it in items)
        return verify(items)

    engine.verify = counted
    run = drive_cell(engine, "bls", rings, ids, decisions, batch, pipeline,
                     wal_root, "e", pops=pops)
    run.update({
        "lanes": tally["lanes"], "aggregated_lanes": tally["aggregated"],
        "lanes_per_decision": round(tally["lanes"] / run["decisions"], 3),
        "aggregated_lanes_per_decision": round(
            tally["aggregated"] / run["decisions"], 3),
    })
    emit({
        "phase": "e2e", "ok": True, "scheme": "bls12381",
        "prewarm_s": round(prewarm_s, 2),
        "deployment": {"nodes": n, "request_batch_max_count": batch,
                       "pipeline_depth": pipeline, "wal_group_commit": True,
                       "shared_dedupe_coalescer": True, "scheme": "bls12381",
                       "proofs_of_possession": len(pops)},
        "e_bls_aggregate": run,
    })
    return {"bls": run}


def warm_cluster(engine, cluster, what: str) -> None:
    """A front-door cluster's set-up on ``engine``: it must have taken the
    engine, every shard's ring of keys is registered and every pad rung
    launched once, so no cell's window carries a table build."""
    if cluster.engine is not engine:
        fail(f"{what}: the cluster did not take the CUDA engine")
    warm_engine(engine, cluster)


def warm_engine(engine, cluster) -> None:
    """Register every shard's ring of keys with ``engine`` (each device's
    comb registry) and launch every pad rung once."""
    from smartbft_tpu_torch.crypto import p256

    for ring in cluster._rings.values():
        engine.prewarm_keys(ring[1].public_keys.values())
    ring = cluster._rings[0][1]
    engine.prewarm_shapes(p256.make_item(
        b"warm", p256.sign_raw(ring.private_key, b"warm"),
        ring.public_keys[1]))


async def run_sharded(engine, shards: int, n: int, decisions: int,
                      batch: int, pipeline: int, wal_root: str, tag: str,
                      hold: float = 0.0, pace: float = 0.0,
                      control_interval=None, overrides=None,
                      at_decision=None, on_engine=None):
    """Sharded mode through its front door: ``ShardedCluster(crypto=
    "p256", engine=engine)`` builds ``shards`` consensus groups of ``n``
    replicas (per-shard keyrings, WALs, ledgers) over one shared dedupe
    coalescer, and ``ShardSet.submit`` routes ``decisions`` x ``batch``
    requests a shard through the ``ShardRouter`` — the recipe of the JAX
    package's sharded bench: its config overrides, every ring's keys and
    every pad rung warmed before the window, client ids resolved outside
    it, decision-major submission across the shards, the wall clock.
    The window ends when every replica of every shard has committed its
    shard's requests.  Returns the run's measurements and the coalescer
    (the caller reads its counters).

    ``engine``: None lets the cluster build its own
    ``TorchVerifyEngine(scheme=p256)`` on the card, which the replicas'
    Configuration (``overrides``: ``verify_mesh_devices``) may graduate
    onto a mesh at start; the coalescer's engine is then warmed after the
    start, its counters zeroed, and returned as ``"engine"``;
    ``on_engine(engine)`` is called once it is warm, before the counters
    are zeroed.

    ``hold``: ``Configuration.verify_flush_hold`` of every replica (0, the
    default, for no hold).  ``pace``: seconds slept after each decision
    round of submissions (the JAX package's ``benchmarks/mesh.py``
    recipe), so waves arrive staggered.  ``control_interval``: run the
    control loop (``control.run_control_loop``) every that many seconds
    for the whole window; a reshard it orders moves clients between
    shards, so the window then ends when the front door's mux has
    delivered every request the cell submitted, and each shard is held to
    one ledger.  ``overrides``: more Configuration fields for every
    replica.  ``at_decision``: ``(j, hook)`` awaits ``hook(cluster, t0)``
    once ``j`` decision rounds are submitted and merges the dict it
    returns into the result."""
    from smartbft_tpu_torch.control import run_control_loop
    from smartbft_tpu_torch.testing.sharded import (
        ShardedCluster,
        sharded_config,
    )
    from smartbft_tpu_torch.utils.clock import WallClockDriver

    requests = decisions * batch

    def cfg(s, i):
        return dataclasses.replace(
            bench_overrides(sharded_config(i, depth=pipeline), n, batch,
                            requests, verify_flush_hold=hold),
            **(overrides or {}))

    cluster = ShardedCluster(
        os.path.join(wal_root, tag), shards=shards, n=n, depth=pipeline,
        crypto="p256", engine=engine, window=0.02, config_fn=cfg, seed=13,
        collect_entries=control_interval is not None)
    own_engine = engine is None
    if not own_engine:
        warm_cluster(engine, cluster, f"sharded {tag}")
    for s in range(shards):
        cluster.client_for_shard(s, 3)
    if not own_engine:
        zero_launch_counters(engine)
    driver = WallClockDriver(cluster.scheduler, tick_interval=0.01)
    driver.start()
    stop_control, control, hooked, submitted = asyncio.Event(), None, {}, []
    try:
        await cluster.start()
        if own_engine:
            # the replicas' knobs have graduated (or kept) the plane's
            # engine at start: warm it, then count from zero
            engine = cluster.coalescer.engine
            warm_engine(engine, cluster)
            if on_engine is not None:
                on_engine(engine)
            zero_launch_counters(engine)
        if control_interval is not None:
            control = asyncio.create_task(run_control_loop(
                cluster, interval=control_interval, stop=stop_control))
        t0 = time.perf_counter()
        for j in range(decisions):
            if at_decision is not None and j == at_decision[0]:
                hooked = await at_decision[1](cluster, t0)
            for s in range(shards):
                for k in range(batch):
                    cid = cluster.client_for_shard(s, (j + k) % 4)
                    rid = f"r-{s}-{j}-{k}"
                    await cluster.submit(cid, rid)
                    if control is not None:
                        submitted.append(f"{cid}:{rid}")
            if pace:
                await asyncio.sleep(pace)
        if control is None:
            done_at = await wait_committed(
                {sh.shard_id: sh.apps for sh in cluster.shard_list},
                requests, t0, f"sharded {tag}: shards")
        else:
            done_at = await wait_delivered(cluster, submitted, t0,
                                           f"sharded {tag}")
        elapsed = time.perf_counter() - t0
        cluster.check_invariants()
    finally:
        stop_control.set()
        if control is not None:
            # the loop's own exception, if it raised, fails the cell here
            control = await control
        await cluster.stop()
        await driver.stop()
    per_shard = {}
    for sh in cluster.shard_list:
        digests = ledger_digests(sh.apps)
        per_shard[str(sh.shard_id)] = {
            "committed_min": min(committed(a) for a in sh.apps),
            "decisions": len(sh.apps[0].ledger()),
            "ledger_digests": len(digests),
            "ledger_digest": sorted(digests)[0][:16],
            "views": sorted({a.consensus.controller.curr_view_number
                             for a in sh.apps}),
        }
        if control is None:
            per_shard[str(sh.shard_id)].update(
                elapsed_s=round(done_at[sh.shard_id], 3),
                tx_per_s=round(requests / done_at[sh.shard_id], 1))
    out = {
        "shards": shards, "nodes_per_shard": n, "requests": shards * requests,
        "decisions": sum(v["decisions"] for v in per_shard.values()),
        "elapsed_s": round(elapsed, 3),
        "tx_per_s": round(shards * requests / elapsed, 1),
        "per_shard": per_shard,
        "coalescer": cluster.coalescer.shard_snapshot(),
        "breaker": cluster.coalescer.fault_snapshot(),
        "hold": cluster.coalescer.mesh_snapshot()["hold"],
        **hooked,
    }
    if control is not None:
        out["control"] = control.snapshot()
    if own_engine:
        fallback = cluster.coalescer.fallback_engine
        out["engine"] = engine
        out["mesh"] = {**cluster.coalescer.mesh_snapshot(),
                       "fallback_engine": None if fallback is None
                       else type(fallback).__name__}
    return out


async def wait_delivered(cluster, submitted: list, t0: float, what: str):
    """Poll, awaiting so the cluster runs, until the front door's mux has
    delivered every request id in ``submitted`` (``client:request``),
    each once, across every shard, current or retired, and every replica
    of each current shard has committed as many as its shard's longest
    chain; returns the seconds from ``t0`` at which the mux had them all.
    The cluster must collect its delivered entries: requests that are not
    the cell's (a control loop's retune reconfigs, the reshard barriers)
    are not counted."""
    want, seen, scanned = set(submitted), {}, 0
    deadline = time.perf_counter() + 600.0
    while True:
        cluster.poll()
        entries = cluster.delivered_entries
        for e in entries[scanned:]:
            for rid in e.request_ids:
                if rid in want:
                    seen[rid] = seen.get(rid, 0) + 1
        scanned = len(entries)
        twice = sorted(r for r, c in seen.items() if c > 1)
        if twice:
            fail(f"{what}: the mux delivered {len(twice)} of the cell's "
                 f"requests more than once, e.g. {twice[:3]}")
        if len(seen) == len(want):
            break
        if time.perf_counter() > deadline:
            fail(f"{what}: the mux delivered {len(seen)} of the cell's "
                 f"{len(want)} requests")
        await asyncio.sleep(0.02)
    elapsed = time.perf_counter() - t0
    await wait_settled(cluster, len(want), what, deadline)
    return elapsed


async def wait_settled(cluster, delivered: int, what: str,
                       deadline: float) -> None:
    """Poll, awaiting so the cluster runs, until the front door's mux has
    delivered at least ``delivered`` requests and every replica of each
    current shard has committed as many as its shard's longest chain;
    fails at ``deadline`` (``time.perf_counter()``)."""
    while cluster.committed_requests() < delivered or not all(
            committed(a) == committed(sh.probe_app())
            for sh in cluster.shard_list for a in sh.apps):
        if time.perf_counter() > deadline:
            fail(f"{what}: the mux delivered "
                 f"{cluster.committed_requests()} of {delivered} "
                 "requests, or a replica stopped short of its shard's "
                 "longest chain")
        await asyncio.sleep(0.02)


def zero_launch_counters(engine) -> None:
    """All five launch counters and the engine's stats to 0."""
    from smartbft_tpu_torch.crypto.provider import MeshVerifyStats, VerifyStats

    st = engine.stats
    engine.stats = MeshVerifyStats(devices=st.devices, metrics=st.metrics) \
        if isinstance(st, MeshVerifyStats) else VerifyStats()
    engine.rung_launches.clear()
    engine.route_launches.update(comb=0, generic=0)
    for c in launch_counters().values():
        c.reset()


def sharded_cell(engine, tag, shards, n, decisions, batch, pipeline,
                 wal_root):
    """One sharded cell; its counters are zeroed inside :func:`run_sharded`
    just before the cluster starts and read here just after it stops.
    Fails unless every replica of every shard committed its shard's
    requests into one ledger a shard (the mux invariants are checked in
    the run), the cell passes :func:`read_cell` for the comb kernel, the
    coalescer attributed its waves to exactly the cell's shards and they
    cover what the engine verified, and waves mixed shards exactly when
    there was more than one."""
    run = asyncio.run(run_sharded(engine, shards, n, decisions, batch,
                                  pipeline, wal_root, tag))
    want = decisions * batch
    for sid, sh in run["per_shard"].items():
        if sh["committed_min"] < want:
            fail(f"sharded {tag}: shard {sid} has a replica that committed "
                 f"{sh['committed_min']} of {want}")
        if sh["ledger_digests"] != 1:
            fail(f"sharded {tag}: shard {sid}'s replicas hold "
                 f"{sh['ledger_digests']} different ledgers")
    run.update(read_cell(engine, "comb", "sharded", tag, run))
    co = run.pop("coalescer")
    per_tag = {k: v["items"] for k, v in co["per_tag"].items()}
    # nothing but the attribution counts items before the dedupe merges
    # them, so hold it to what the engine counts on its own: every wave is
    # a shard's and launched the kernel at least once, and every signature
    # the engine verified came from a shard's submission
    if sorted(per_tag) != [str(s) for s in range(shards)] \
            or co["tagged_waves"] != co["waves"] \
            or not 0 < co["waves"] <= run["kernel_launches"]["comb"] \
            or sum(per_tag.values()) < run["sigs_verified"]:
        fail(f"sharded {tag}: per-shard items {per_tag} in "
             f"{co['tagged_waves']} of {co['waves']} waves do not cover the "
             f"engine's {run['sigs_verified']} signatures in "
             f"{run['kernel_launches']['comb']} launches")
    if (co["mixed_waves"] > 0) != (shards > 1):
        fail(f"sharded {tag}: {co['mixed_waves']} mixed waves with "
             f"{shards} shard(s)")
    run.update({
        "items_per_launch": round(
            run["sigs_verified"] / run["kernel_launches"]["comb"], 1),
        "waves": co["waves"], "mixed_waves": co["mixed_waves"],
        "max_shards_in_wave": co["max_tags_in_wave"],
        "per_shard_items": per_tag,
        "items_per_signature": round(
            sum(per_tag.values()) / run["sigs_verified"], 2),
    })
    return run


def phase_sharded(wal_root, n=16, batch=500, pipeline=16):
    """Cells F1 and F: sharded mode on one fresh CUDA engine (the P-256
    comb kernel).  F1: one shard of n = 16 (BASELINE config [2]) commits
    32 decisions through the front door, the control.  F: four shards of
    n = 16 (64 replicas, 64 keys) commit 8 decisions each, 16,000
    requests as in cell A, their waves mixing shards in one coalescer."""
    from smartbft_tpu_torch.crypto import p256
    from smartbft_tpu_torch.crypto.provider import TorchVerifyEngine

    engine = TorchVerifyEngine(device="cuda", scheme=p256)
    f1 = sharded_cell(engine, "f1", 1, n, 32, batch, pipeline, wal_root)
    f = sharded_cell(engine, "f", 4, n, 8, batch, pipeline, wal_root)
    emit({
        "phase": "sharded", "ok": True,
        "deployment": {"nodes_per_shard": n, "request_batch_max_count": batch,
                       "pipeline_depth": pipeline, "wal_group_commit": True,
                       "shared_dedupe_coalescer": True, "window_s": 0.02,
                       "scheme": "p256", "router_seed": 0},
        "f1_one_shard": f1, "f_four_shards": f,
    })
    return {"f1": f1, "f": f}


def busy_line(cells, comb_row, phase="sharded_busy"):
    """Device busy of the comb kernel's cells (phases sharded,
    verify_plane, open_loop, byzantine, sockets and mesh): launches at
    each rung times the comb kernel's ms at that rung from the kernels
    line (a mesh cell's over its cards), and the idle share of the cell's
    elapsed time."""
    out = {}
    for tag, cell in cells.items():
        busy = sum(k * comb_row["ms_by_rung"][r]
                   for r, k in cell["rung_launches"].items())
        # a mesh cell's launches spread over its cards: busy a card
        busy /= cell.get("cards", 1)
        out[tag] = {"busy_ms": round(busy, 3),
                    "idle_pct": round(100.0 * (1.0 - busy / 1e3
                                               / cell["elapsed_s"]), 3),
                    "elapsed_s": cell["elapsed_s"]}
    emit({"phase": phase, "ok": True, "cells": out})
    return out


def plane_cell(engine, tag, hold, pace, control_interval=None, n=16,
               shards=4, decisions=8, batch=500, pipeline=16,
               wal_root=""):
    """One paced cell of phase verify_plane (G0, G, K): cell F's
    deployment through :func:`run_sharded`, its counters zeroed inside it
    just before the cluster starts and read here just after it stops.
    Fails unless every replica of each shard holds one ledger with every
    request of the cell, the cell passes :func:`read_cell` for the comb
    kernel, and the hold reached the live coalescer: without the control
    loop exactly ``hold``, with a wave held when it is above 0; with the
    loop, ``hold`` or the hold of a retune the loop executed (a reshard's
    new replicas configure ``hold`` again)."""
    run = asyncio.run(run_sharded(engine, shards, n, decisions, batch,
                                  pipeline, wal_root, tag, hold=hold,
                                  pace=pace,
                                  control_interval=control_interval))
    # with the control loop, wait_delivered held the mux to every request
    want = decisions * batch
    if control_interval is None and any(
            sh["committed_min"] < want for sh in run["per_shard"].values()):
        fail(f"verify_plane {tag}: a shard's replica committed fewer than "
             f"{want}: {run['per_shard']}")
    for sid, sh in run["per_shard"].items():
        if sh["ledger_digests"] != 1:
            fail(f"verify_plane {tag}: shard {sid}'s replicas hold "
                 f"{sh['ledger_digests']} different ledgers")
    run.update(read_cell(engine, "comb", "verify_plane", tag, run))
    run.pop("coalescer")
    held = run["hold"]["hold_s"]
    if control_interval is None:
        if held != hold:
            fail(f"verify_plane {tag}: verify_flush_hold={hold} did not "
                 f"reach the coalescer: {run['hold']}")
        if hold and not run["hold"]["waves_held"]:
            fail(f"verify_plane {tag}: a hold of {hold} s held no wave: "
                 f"{run['hold']}")
    else:
        retuned = [e["knobs"]["verify_flush_hold"]
                   for e in run["control"]["executed"]
                   if e["action"] == "retune" and e["ok"]
                   and "verify_flush_hold" in e["knobs"]]
        if held not in [hold, *retuned]:
            fail(f"verify_plane {tag}: the coalescer holds {held} s, not "
                 f"the cell's {hold} s nor a retune's {retuned}")
    return run


def flip_cell(engine, tag, span, n=16, decisions=32, batch=500,
              pipeline=16, mute_after=8, heartbeat_s=2.0, wal_root=""):
    """Cells V and V0: a leader failure mid-burst in cell F1's deployment
    (one shard of ``n``) through :func:`run_sharded`.  Once ``mute_after``
    decision rounds have committed, the leader's egress is muted
    (``AppShard.mute_leader``) until every other replica has installed a
    new view with another leader, then unmuted, and the rest of the burst
    commits in the new view.  The liveness timeouts are F1's but for the
    detection ones (``leader_heartbeat_timeout = heartbeat_s``, the view
    change's own timeout 10 x that), so the view changes inside the run.
    ``span``: the coalescer's ``FLIP_WARM_SPAN`` from the mute on (0.25 s
    in V; 0 in V0, the control, where a warm still flushes the pending
    wave but leaves no windowless spell).  Fails unless the new view came
    within 300 s, the coalescer ran its flip warm, the comb kernel
    launched after the flip, every replica holds one ledger with every
    request, and the cell passes :func:`read_cell` for the comb kernel."""
    from smartbft_tpu_torch.crypto import cuda_comb as cc

    async def flip(cluster, t0):
        shard, co = cluster.shard(0), cluster.coalescer
        await wait_committed({0: shard.apps}, mute_after * batch, t0,
                             f"verify_plane {tag}: before the mute")
        co.FLIP_WARM_SPAN = span
        at_mute, rungs = cc.LAUNCHES.launches, dict(engine.rung_launches)
        old = shard.mute_leader()
        t_mute = time.perf_counter()
        others = [a for a in shard.apps if a.id != old]
        while True:
            leads = {a.consensus.get_leader_id() for a in others}
            if len(leads) == 1 and leads != {old} and 0 not in leads:
                break
            if time.perf_counter() - t_mute > 300.0:
                fail(f"verify_plane {tag}: no new view 300 s after muting "
                     f"leader {old} (replicas see leaders {sorted(leads)})")
            await asyncio.sleep(0.01)
        vc_s = time.perf_counter() - t_mute
        # counted when the new view is seen, before the stop deposes every
        # view (a depose runs the same warm path)
        out = {
            "muted_leader": old, "new_leader": leads.pop(),
            "view_change_s": round(vc_s, 3), "flip_warm_span_s": span,
            "comb_launches_at_mute": at_mute,
            "comb_launches_at_flip": cc.LAUNCHES.launches,
            "rung_launches_in_view_change": {
                str(r): k - rungs.get(r, 0)
                for r, k in sorted(engine.rung_launches.items())
                if k > rungs.get(r, 0)},
            "flip_warms_at_flip": co.flip_warms,
        }
        shard.unmute(old)
        return out

    run = asyncio.run(run_sharded(
        engine, 1, n, decisions, batch, pipeline, wal_root, tag,
        overrides={"leader_heartbeat_timeout": heartbeat_s,
                   "view_change_timeout": 10 * heartbeat_s,
                   "view_change_resend_interval": heartbeat_s},
        at_decision=(mute_after, flip)))
    sh = run["per_shard"]["0"]
    if sh["committed_min"] < run["requests"]:
        fail(f"verify_plane {tag}: a replica committed "
             f"{sh['committed_min']} of {run['requests']}")
    if sh["ledger_digests"] != 1:
        fail(f"verify_plane {tag}: replicas hold {sh['ledger_digests']} "
             "different ledgers")
    if run["flip_warms_at_flip"] < 1:
        fail(f"verify_plane {tag}: the view change ran no flip warm")
    run.update(read_cell(engine, "comb", "verify_plane", tag, run))
    run.pop("coalescer")
    after = run["kernel_launches"]["comb"] - run["comb_launches_at_flip"]
    if after < 1:
        fail(f"verify_plane {tag}: the comb kernel never launched after "
             "the flip")
    run.update(
        views=sh["views"], comb_launches_after_flip=after,
        comb_launches_in_view_change=run["comb_launches_at_flip"]
        - run["comb_launches_at_mute"],
        flip_warms=run["breaker"]["flip_warms"],
        flip_warm_bypasses=run["breaker"]["flip_warm_bypasses"])
    return run


def phase_verify_plane(wal_root, pace=0.03):
    """Cells G0, G, V0, V and K on one fresh CUDA engine (the P-256 comb
    kernel).  G0: cell F's deployment (4 shards of n = 16, 8 decisions
    each), submission paced ``pace`` s between decision rounds, no hold —
    the ungated control.  G: the same with ``verify_flush_hold = 0.25``
    set in every replica's Configuration.  V: cell F1's deployment (1
    shard of n = 16, 32 decisions) with its leader muted after 8
    decisions until the view changes; V0: the same with a flip-warm span
    of 0, the control that separates the warm's windowless spell from the
    view change's own verifies.  K: G's cluster with the control loop
    ticking every 0.25 s for the whole burst."""
    from smartbft_tpu_torch.crypto import p256
    from smartbft_tpu_torch.crypto.provider import TorchVerifyEngine

    engine = TorchVerifyEngine(device="cuda", scheme=p256)
    g0 = plane_cell(engine, "g0", 0.0, pace, wal_root=wal_root)
    g = plane_cell(engine, "g", 0.25, pace, wal_root=wal_root)
    v0 = flip_cell(engine, "v0", 0.0, wal_root=wal_root)
    v = flip_cell(engine, "v", 0.25, wal_root=wal_root)
    k = plane_cell(engine, "k", 0.25, pace, control_interval=0.25,
                   wal_root=wal_root)
    ctl = k["control"]
    emit({
        "phase": "verify_plane", "ok": True,
        "deployment": {"nodes_per_shard": 16, "request_batch_max_count": 500,
                       "pipeline_depth": 16, "wal_group_commit": True,
                       "shared_dedupe_coalescer": True, "window_s": 0.02,
                       "pace_s": pace, "scheme": "p256"},
        "g_vs_g0": {
            key: {"g0": g0[key], "g": g[key]}
            for key in ("tx_per_s", "elapsed_s", "launches_per_decision",
                        "fill_pct", "rung_launches")},
        "g_hold": g["hold"], "g0_hold": g0["hold"],
        "v_flip": {tag: {key: cell[key] for key in (
            "flip_warm_span_s", "view_change_s", "muted_leader",
            "new_leader", "views", "flip_warms_at_flip", "flip_warms",
            "flip_warm_bypasses", "comb_launches_at_mute",
            "comb_launches_in_view_change", "rung_launches_in_view_change",
            "comb_launches_after_flip", "tx_per_s", "elapsed_s")}
            for tag, cell in (("v0", v0), ("v", v))},
        "k_control": {"ticks": ctl["policy"]["counters"]["ticks"],
                      "actions": ctl["executed"],
                      "vetoes": {c: ctl["policy"]["counters"][c]
                                 for c in ctl["policy"]["counters"]
                                 if c.startswith("veto_")},
                      "shards_after": len(k["per_shard"]),
                      "tx_per_s": k["tx_per_s"], "hold": k["hold"]},
        "g0": g0, "g": g, "v0": v0, "v": v, "k": k,
    })
    return {"g0": g0, "g": g, "v0": v0, "v": v, "k": k}


def mixed_wave(scheme, n_signers=3, count=23, forge_every=5,
               seed=b"mesh-parity"):
    """The JAX package's mesh-bench parity wave (``benchmarks/mesh.py``'s
    ``_mixed_wave``): ``count`` items round-robined over ``n_signers``
    keys, every ``forge_every``-th signature corrupted, ``count`` no
    device multiple so every width pads.  Here each message is signed by
    all three signers (a quorum row of the 2D engine)."""
    keys = [scheme.keygen(seed + b"-%d" % i) for i in range(n_signers)]
    items = []
    for i in range(count):
        sk, pub = keys[i % n_signers]
        msg = b"mesh-msg-%d" % (i // n_signers)
        sig = scheme.sign_raw(sk, msg)
        if i % forge_every == forge_every - 1:
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        items.append(scheme.make_item(msg, sig, pub))
    return items


def distinct_valid_votes(items, verdicts) -> dict:
    """The host's count of distinct valid votes a message."""
    tally, seen = {}, set()
    for it, ok in zip(items, verdicts):
        tally.setdefault(it[0], 0)
        if ok and it not in seen:
            tally[it[0]] += 1
        seen.add(it)
    return tally


def filler_keys(count: int) -> list:
    """``count`` distinct P-256 points G, 2G, ... (cheap registry fill)."""
    from smartbft_tpu_torch.crypto import p256

    g = (p256.GX, p256.GY)
    pts = [g]
    while len(pts) < count:
        pts.append(p256._point_add_int(pts[-1], g))
    return pts


def mesh_parity(devices: int) -> dict:
    """The parity stage of phase mesh: the mixed wave through
    ``MeshVerifyEngine(devices=D)`` and ``QuorumMeshVerifyEngine(devices=
    D)`` against ``TorchVerifyEngine`` on the same card(s), for P-256 on
    the comb route, P-256 on the generic route (every engine's comb
    registries filled first), Ed25519 and BLS12-381.  Verdicts must be
    equal bit for bit and equal the scheme's host verify; the 2D counts
    must be the host's distinct valid votes a message and its decisions
    ``count >= _quorum_threshold()`` of a 4-replica keyring."""
    from smartbft_tpu_torch.crypto import bls12381, ed25519, p256
    from smartbft_tpu_torch.crypto.provider import (
        Keyring,
        P256CryptoProvider,
        TorchVerifyEngine,
    )
    from smartbft_tpu_torch.parallel import (
        MeshVerifyEngine,
        QuorumMeshVerifyEngine,
    )

    quorum = P256CryptoProvider(
        Keyring.generate([1, 2, 3, 4], seed=b"mesh-quorum")[1])\
        ._quorum_threshold()
    out = {"devices": devices, "quorum": quorum, "routes": {}}
    for route, scheme in (("p256_comb", p256), ("p256_generic", p256),
                          ("ed25519", ed25519), ("bls12381", bls12381)):
        items = mixed_wave(scheme)
        host = [scheme.verify_item(it) for it in items]
        engines = {"single": TorchVerifyEngine(device="cuda", scheme=scheme),
                   "mesh_1d": MeshVerifyEngine(devices=devices,
                                               scheme=scheme),
                   "mesh_2d": QuorumMeshVerifyEngine(devices=devices,
                                                     scheme=scheme,
                                                     quorum=quorum)}
        if route == "p256_generic":
            for eng in engines.values():
                eng.prewarm_keys(filler_keys(128))
        got = {name: eng.verify(items) for name, eng in engines.items()}
        if any(v != got["single"] for v in got.values()) \
                or got["single"] != host:
            fail(f"mesh parity {route}: verdicts differ: {got}, host {host}")
        q = engines["mesh_2d"]
        tally = distinct_valid_votes(items, host)
        if q.last_counts != tally:
            fail(f"mesh parity {route}: 2D counts {q.last_counts} are not "
                 f"the host's distinct valid votes {tally}")
        if q.last_decided != {m: c >= quorum for m, c in tally.items()}:
            fail(f"mesh parity {route}: 2D decisions {q.last_decided}")
        want = "generic" if route in ("p256_generic", "bls12381") else "comb"
        for name, eng in engines.items():
            routes = {k: v for k, v in eng.route_launches.items() if v}
            if set(routes) != {want}:
                fail(f"mesh parity {route}: {name} took routes {routes}")
        out["routes"][route] = {
            "items": len(items), "valid": sum(host),
            "counts": sorted(tally.values()),
            "decided": sum(q.last_decided.values()),
            "psum_steps": q.psum_steps,
            "mesh_1d_launches": engines["mesh_1d"].route_launches[want],
            "mesh_2d_launches": q.route_launches[want]}
    return out


def mesh_cell(tag, devices, topology, cards, wal_root, pace=0.03,
              hold=0.25, shards=4, n=16, decisions=8, batch=500,
              pipeline=16):
    """One cell of phase mesh: cell G's deployment (4 shards of n = 16, 8
    decisions each, batch 500, depth 16, rounds paced ``pace`` s,
    ``verify_flush_hold = hold``) through :func:`run_sharded` with no
    engine given, so the cluster builds ``TorchVerifyEngine(scheme=p256)``
    on the card and every replica's ``verify_mesh_devices = devices`` /
    ``verify_mesh_topology = topology`` graduate the shared coalescer at
    start.  Every launch of a 2D engine is recorded and held, after the
    run, to OpenSSL's verdicts and distinct valid votes a message.  Fails
    unless every replica of each shard holds one ledger with every
    request and the cell passes :func:`read_cell` for the comb kernel."""
    import threading

    from smartbft_tpu_torch.crypto.provider import TorchVerifyEngine
    from smartbft_tpu_torch.parallel import (
        MeshVerifyEngine,
        QuorumMeshVerifyEngine,
    )

    launches, lock = [], threading.Lock()

    def record_launches(engine):
        if not isinstance(engine, QuorumMeshVerifyEngine):
            return
        verify = engine.verify

        def recorded(items):
            with lock:
                got = verify(items)
                launches.append((list(items), got, dict(engine.last_counts),
                                 dict(engine.last_decided)))
            return got

        engine.verify = recorded

    run = asyncio.run(run_sharded(
        None, shards, n, decisions, batch, pipeline, wal_root, tag,
        hold=hold, pace=pace,
        overrides={"verify_mesh_devices": devices,
                   "verify_mesh_topology": topology},
        on_engine=record_launches))
    engine = run.pop("engine")
    for sid, sh in run["per_shard"].items():
        if sh["committed_min"] < decisions * batch \
                or sh["ledger_digests"] != 1:
            fail(f"mesh {tag}: shard {sid} committed {sh['committed_min']} "
                 f"into {sh['ledger_digests']} ledgers")
    psum_steps_run = getattr(engine, "psum_steps", 0)
    run.update(read_cell(engine, "comb", "mesh", tag, run))
    run.pop("coalescer")
    mesh = run["mesh"]
    if mesh["configured_devices"] != devices:
        fail(f"mesh {tag}: verify_mesh_devices={devices} did not reach the "
             f"coalescer: {mesh}")
    want = {"1d": MeshVerifyEngine, "2d": QuorumMeshVerifyEngine}[topology]
    if devices <= cards:
        if type(engine) is not want or engine.devices != devices:
            fail(f"mesh {tag}: the plane runs {type(engine).__name__} "
                 f"of {getattr(engine, 'devices', 0)} device(s), not a "
                 f"{topology} mesh of {devices}")
        if mesh["downgrades"] or mesh["fallback_engine"] is not None:
            fail(f"mesh {tag}: {mesh['downgrades']} downgrades, fallback "
                 f"engine {mesh['fallback_engine']}")
        if len(mesh["device_fill_pct_last"]) != devices:
            fail(f"mesh {tag}: no per-device fill: {mesh}")
    else:
        if type(engine) is not TorchVerifyEngine or mesh["downgrades"] != 1:
            fail(f"mesh {tag}: a mesh of {devices} on {cards} card(s) must "
                 f"keep TorchVerifyEngine with one downgrade, got "
                 f"{type(engine).__name__} and {mesh['downgrades']}")
    if topology == "2d" and devices <= cards:
        if not launches or psum_steps_run < 1:
            fail(f"mesh {tag}: the 2D engine ran no quorum step")
        oracle = openssl(engine.scheme)
        for items, got, counts, decided in launches:
            host = oracle.verify(items)
            tally = distinct_valid_votes(items, host)
            if got != host or counts != tally or decided != {
                    m: c >= engine.quorum for m, c in tally.items()}:
                fail(f"mesh {tag}: a 2D launch of {len(items)} items "
                     f"disagrees with the host: counts {counts} vs {tally}")
        run.update(checked_launches=len(launches), psum_steps=psum_steps_run,
                   quorum=engine.quorum)
    # the kernel launches by lanes a card: a mesh launch of rung r is one
    # launch of r / D lanes on each of the D cards
    d = getattr(engine, "devices", 0) or 1
    run.update(cards=d, engine=type(engine).__name__,
               logical_rung_launches=run["rung_launches"],
               rung_launches={str(int(r) // d): k * d
                              for r, k in run["rung_launches"].items()},
               items_per_launch=round(
                   run["sigs_verified"] / run["kernel_launches"]["comb"], 1))
    return run


def phase_mesh(wal_root, pace=0.03):
    """The multi-device verify plane at D = ``torch.cuda.device_count()``
    (1 on a one-card machine): the parity stage (:func:`mesh_parity`),
    then cells M1 (``verify_mesh_devices = D``, topology "1d"), M2 (the
    same, "2d") and M0 (``verify_mesh_devices = D + 1``: a counted
    downgrade), each cell G's deployment through the knobs."""
    import torch

    cards = torch.cuda.device_count()
    parity = mesh_parity(cards)
    m1 = mesh_cell("m1", cards, "1d", cards, wal_root, pace)
    m2 = mesh_cell("m2", cards, "2d", cards, wal_root, pace)
    m0 = mesh_cell("m0", cards + 1, "1d", cards, wal_root, pace)
    emit({
        "phase": "mesh", "ok": True, "cards": cards,
        "deployment": {"shards": 4, "nodes_per_shard": 16,
                       "request_batch_max_count": 500, "pipeline_depth": 16,
                       "decisions_per_shard": 8, "pace_s": pace,
                       "verify_flush_hold": 0.25, "scheme": "p256"},
        "parity": parity,
        "cells": {tag: {key: cell.get(key) for key in (
            "engine", "cards", "tx_per_s", "elapsed_s", "kernel_launches",
            "launches_per_decision", "logical_rung_launches",
            "rung_launches", "fill_pct", "items_per_launch", "mesh",
            "psum_steps", "checked_launches")}
            for tag, cell in (("m1", m1), ("m2", m2), ("m0", m0))},
    })
    return {"m1": m1, "m2": m2, "m0": m0}


def chain_breaker(nodes) -> dict:
    """The breaker counters of the nodes' coalescers, summed."""
    out: dict = {}
    for node in nodes:
        for k, v in node.crypto._coalescer.fault_snapshot().items():
            if isinstance(v, bool):
                out[k] = out.get(k, False) or v
            else:
                out[k] = out.get(k, 0) + v
    return out


def check_chain(tag, nodes, engine, txs: int) -> dict:
    """Cell checks of phase embedder: every node holds the same chain with
    ``txs`` transactions, each once, and its links verify; every commit
    signature of every decision re-verifies true through the OpenSSL
    engine and through the kernel (comparison launches, after the cell's
    counters were read)."""
    from smartbft_tpu_torch.codec import encode
    from smartbft_tpu_torch.crypto import p256
    from smartbft_tpu_torch.examples.naive_chain import verify_chain

    chains = {tuple(encode(h) for h, _, _ in n.blocks) for n in nodes}
    if len(chains) != 1:
        fail(f"embedder {tag}: nodes hold {len(chains)} different chains, "
             f"heights {[len(n.blocks) for n in nodes]}")
    for n in nodes:
        verify_chain(n)
    got = [raw for _, transactions, _ in nodes[0].blocks
           for raw in transactions]
    if len(got) != txs or len(set(got)) != txs:
        fail(f"embedder {tag}: {len(got)} transactions ({len(set(got))} "
             f"distinct) committed, {txs} submitted")
    items = list(dict.fromkeys(
        n.crypto._item(sig) for n in nodes for d in n.decisions
        for sig in d.signatures))
    if any(len(d.signatures) < 3 for d in nodes[0].decisions):
        fail(f"embedder {tag}: a decision without a quorum of signatures")
    by_openssl = openssl(p256).verify(items)
    by_kernel = engine.verify(items)
    if not all(by_openssl) or by_kernel != by_openssl:
        fail(f"embedder {tag}: commit signatures re-verified "
             f"{sum(by_openssl)} true by OpenSSL and {sum(by_kernel)} by "
             f"the kernel of {len(items)}")
    return {"blocks": len(nodes[0].blocks), "txs": txs,
            "heights": [len(n.blocks) for n in nodes],
            "commit_sigs_reverified": len(items)}


async def run_pipelined_chain(engine, blocks: int, pipeline: int,
                              wal_root: str) -> list:
    """``tests/test_naive_chain.py``'s pipelined embedder: 4 ``ChainNode``s
    built with ``pipeline`` on one engine, ``blocks`` transactions
    submitted to node 1 as a burst; returns the stopped nodes once every
    node holds them all."""
    from smartbft_tpu_torch.crypto.provider import Keyring
    from smartbft_tpu_torch.examples import naive_chain as nc
    from smartbft_tpu_torch.utils.clock import Scheduler, WallClockDriver

    scheduler = Scheduler()
    driver = WallClockDriver(scheduler, tick_interval=0.01)
    mesh = nc.ChannelMesh()
    rings = Keyring.generate([1, 2, 3, 4], seed=b"naive-chain")
    nodes = [nc.ChainNode(i, mesh, scheduler, rings[i],
                          os.path.join(wal_root, f"chain-p{pipeline}-wal-{i}"),
                          pipeline=pipeline, engine=engine)
             for i in range(1, 5)]
    driver.start()
    try:
        for n in nodes:
            await n.start()
        for k in range(blocks):
            await nodes[0].submit("alice", f"txn-{k}",
                                  payload=f"transfer #{k}".encode())
        deadline = time.monotonic() + 120
        while sum(len(t) for _, t, _ in nodes[-1].blocks) < blocks \
                or len({len(n.blocks) for n in nodes}) != 1:
            if time.monotonic() > deadline:
                fail(f"embedder n{pipeline}: heights "
                     f"{[len(n.blocks) for n in nodes]} after 120 s")
            await asyncio.sleep(0.01)
    finally:
        for n in nodes:
            await n.stop()
        await driver.stop()
    return nodes


def embedder_cell(tag, blocks, pipeline, wal_root) -> dict:
    """One cell of phase embedder.  N1 runs ``naive_chain.main(blocks,
    "cuda")`` as a user would; N4 the pipelined embedder of
    :func:`run_pipelined_chain`.  The five launch counters are zeroed
    just before the run and read just after it (:func:`read_cell`: only
    the comb kernel, lanes covering every verified vote, breaker shut, no
    failed launch); then :func:`check_chain`."""
    from smartbft_tpu_torch.crypto import p256
    from smartbft_tpu_torch.crypto.provider import TorchVerifyEngine
    from smartbft_tpu_torch.examples import naive_chain as nc

    for c in launch_counters().values():
        c.reset()
    t0 = time.perf_counter()
    if pipeline == 1:
        nodes = asyncio.run(nc.main(blocks, "cuda"))
        engine = nodes[0].crypto.engine
    else:
        engine = TorchVerifyEngine(scheme=p256, device="cuda")
        nodes = asyncio.run(run_pipelined_chain(engine, blocks, pipeline,
                                                wal_root))
    elapsed = time.perf_counter() - t0
    run = {"pipeline": pipeline, "decisions": len(nodes[0].blocks),
           "breaker": chain_breaker(nodes)}
    run.update(read_cell(engine, "comb", "embedder", tag, run))
    run.update(check_chain(tag, nodes, engine, blocks))
    run.update(elapsed_s=round(elapsed, 3),
               blocks_per_s=round(run["blocks"] / elapsed, 2),
               tx_per_s=round(blocks / elapsed, 2))
    return run


def openssl_oracle(rng, keys, ed_keys, rung=512) -> dict:
    """The OpenSSL oracle stage: at ``rung`` lanes, the smoke's seeded
    mixed waves (P-256 from :func:`make_batch`, Ed25519 from
    :func:`make_ed_batch`, with their forged and malformed lanes) through
    the comb, generic, Ed25519 comb and Ed25519 generic kernels; the
    port's ``OpenSSLVerifyEngine`` verdicts must equal each mask bit for
    bit on every lane that carries an item, the zero lanes must fail, and
    the engine's µs a signature (keys cached) is the CPU baseline."""
    import torch

    from smartbft_tpu_torch.crypto import cuda_comb as cc
    from smartbft_tpu_torch.crypto import cuda_ecdsa as ce
    from smartbft_tpu_torch.crypto import cuda_ed25519 as ced
    from smartbft_tpu_torch.crypto import cuda_eddsa as cgd
    from smartbft_tpu_torch.crypto import ed25519, p256

    reg, tables = comb_tables(keys)
    claimed, _, comb_args = comb_wave(rung, keys, rng, reg, tables, "oracle")
    generic, _, gen_args = generic_wave(rung, generic_keys(), rng,
                                        "oracle-gen")
    ed_reg, ed_tables = ed_comb_tables(ed_keys)
    items, pubs, _, _, _, edc_args = ed_comb_wave(
        rung, ed_keys, rng, ed_reg, ed_tables, "oracle-edc", kinds=5)
    ed_claimed = [(m, sig, pub) for (m, sig, _), pub in zip(items, pubs)]
    ed_generic, _, _, _, edg_args = ed_generic_wave(
        rung, ed_generic_keys(), rng, "oracle-edg")
    out = {"rung": rung, "kernels": {}}
    for name, scheme, kern, args, its in (
            ("comb_verify", p256, cc.ecdsa_verify_comb, comb_args, claimed),
            ("ecdsa_verify", p256, ce.ecdsa_verify, gen_args, generic),
            ("ed_comb_verify", ed25519, ced.eddsa_verify_comb, edc_args,
             ed_claimed),
            ("eddsa_verify", ed25519, cgd.eddsa_verify, edg_args,
             ed_generic)):
        mask = kern(*args)
        torch.cuda.synchronize()
        mask = mask.cpu().tolist()
        oracle = openssl(scheme)
        oracle.verify(its)  # warms the engine's key cache
        t0 = time.perf_counter()
        verdicts = oracle.verify(its)
        us = 1e6 * (time.perf_counter() - t0) / len(its)
        if [bool(v) for v in mask[:len(its)]] != verdicts \
                or any(mask[len(its):]):
            bad = [i for i, (a, b) in enumerate(zip(mask, verdicts))
                   if bool(a) != b]
            fail(f"oracle: OpenSSL and {name} differ at lanes {bad[:16]}")
        out["kernels"][name] = {"lanes": len(mask), "items": len(its),
                                "accepted": sum(verdicts),
                                "rejected": len(its) - sum(verdicts)}
        out.setdefault("openssl_us_per_sig", {}).setdefault(
            scheme.__name__.rsplit(".", 1)[-1], []).append(round(us, 3))
    return out


def host_cpu() -> dict:
    """The host's CPU model and core count (the OpenSSL baseline's
    hardware): ``/proc/cpuinfo``'s model line, else ``lscpu``'s."""
    model = None
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                key, _, value = line.partition(":")
                if key.strip() in ("model name", "Model", "cpu model"):
                    model = value.strip()
                    break
    except OSError:
        pass
    if not model:
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True,
                                 timeout=10).stdout
            model = next((line.split(":", 1)[1].strip()
                          for line in out.splitlines()
                          if line.startswith("Model name")), None)
        except (OSError, subprocess.SubprocessError):
            pass
    import platform

    return {"model": model or platform.processor() or platform.machine(),
            "machine": platform.machine(), "cores": os.cpu_count()}


def baseline_stage() -> dict:
    """The port's tiny logical-clock row (a 4-node in-process cluster on
    the tick-driven scheduler) must validate under the bench-row schema
    and check clean against the repository's ``BASELINE_OBS.json`` (read
    only; the row is host-independent)."""
    from smartbft_tpu_torch.obs.baseline import (
        check_rows,
        load_baseline,
        render_check,
        tiny_logical_row,
    )
    from smartbft_tpu_torch.obs.benchschema import validate_rows

    row = tiny_logical_row()
    errors = validate_rows([row])
    if errors:
        fail(f"baseline: the tiny logical row drifted: {errors}")
    res = check_rows([row], load_baseline(os.path.join(HERE,
                                                       "BASELINE_OBS.json")))
    if not res["ok"] or res["checked"] != ["tiny_logical_commit_ms"]:
        fail(f"baseline: {render_check(res)}")
    return {"metric": row["metric"], "value": row["value"],
            "unit": row["unit"], "decisions": row["decisions"],
            "checked": res["checked"],
            "baseline": res["regressions"] or res["improvements"] or "within"}


def phase_embedder(wal_root, rng, keys, ed_keys, blocks=32) -> dict:
    """The application layer: cells N1 (``naive_chain.main`` as a user
    runs it: 4 nodes, depth 1, ``blocks`` one-transaction blocks, real
    P-256 votes through one ``TorchVerifyEngine`` on the card) and N4 (the
    pipelined embedder, depth 4, the ``blocks`` transactions as a burst);
    then the OpenSSL oracle stage (:func:`openssl_oracle`) and the
    baseline stage (:func:`baseline_stage`)."""
    n1 = embedder_cell("n1", blocks, 1, wal_root)
    n4 = embedder_cell("n4", blocks, 4, wal_root)
    oracle = openssl_oracle(rng, keys, ed_keys)
    base = baseline_stage()
    keep = ("blocks", "txs", "heights", "elapsed_s", "blocks_per_s",
            "tx_per_s", "kernel_launches", "kernel_lanes",
            "launches_per_decision", "rung_launches", "main_rung",
            "sigs_verified", "slots", "fill_pct", "commit_sigs_reverified",
            "breaker")
    emit({"phase": "embedder", "ok": True,
          "cells": {tag: {k: cell.get(k) for k in keep}
                    for tag, cell in (("n1", n1), ("n4", n4))},
          "oracle": oracle, "host_cpu": host_cpu(), "baseline": base})
    return {"n1": n1, "n4": n4}


def openloop_config(s, i):
    """Every replica's Configuration in cells O1 and O2: the JAX package's
    open-loop bench settings (``benchmarks/openloop.py`` ``openloop_config``
    at its defaults: pool 2400, admission high water 0.8, batch cap 128,
    adaptive proposing on), with its group-commit WAL and its forward,
    complain, heartbeat and view-change timeouts.  Its verify fault knobs
    (a 0.15 s launch deadline, 2 retries, breaker after 3) serve the
    bench's engine-outage phase, which these cells do not run, and stay
    at their defaults: the deadline is kept on the event loop, so any
    0.15 s stall of the loop (a full garbage collection, a slow fsync)
    would count a launch that finished on time as failed."""
    from smartbft_tpu_torch.testing.sharded import sharded_config

    return dataclasses.replace(
        sharded_config(i, depth=2),
        wal_group_commit=True,
        request_pool_size=2400,
        admission_high_water=0.8,
        request_pool_submit_timeout=1.0,
        request_batch_max_count=128,
        request_batch_max_interval=0.02,
        request_batch_adaptive=True,
        request_forward_timeout=5.0,
        request_complain_timeout=15.0,
        request_auto_remove_timeout=240.0,
        leader_heartbeat_timeout=3.0,
        leader_heartbeat_count=10,
        heartbeat_rtt_multiplier=20.0,
        view_change_timeout=12.0,
        view_change_resend_interval=3.0,
    )


async def run_open_loop_cell(engine, tag: str, rate: float, wal_root: str,
                             trace: bool, duration: float = 8.0,
                             drain: float = 3.0):
    """One open-loop cell: the JAX package's open-loop bench deployment
    (``benchmarks/openloop.py``: 2 shards of n = 4, depth 2, window
    0.005 s, seed 17, :func:`openloop_config`) on ``engine`` with real
    P-256 votes, pumped by ``testing.load.run_open_loop`` at ``rate``
    requests a second for ``duration`` seconds of the wall clock (Poisson
    gaps, 512 Zipf(1.1) clients, seed 31, a 0.005 s step, ``drain``
    seconds after the last arrival).  Every shard's keys and every pad
    rung are warmed, and the launch counters zeroed, before the cluster
    starts.  Returns the run's measurements; ``trace``: the recorders'
    dumps too."""
    from smartbft_tpu_torch.testing.load import ZipfClients, run_open_loop
    from smartbft_tpu_torch.testing.sharded import ShardedCluster
    from smartbft_tpu_torch.utils.clock import WallClockDriver

    cluster = ShardedCluster(
        os.path.join(wal_root, tag), shards=2, n=4, depth=2, crypto="p256",
        engine=engine, window=0.005, seed=17, config_fn=openloop_config,
        trace=trace, trace_capacity=1 << 16)
    warm_cluster(engine, cluster, f"open_loop {tag}")
    zipf = ZipfClients(512, skew=1.1)
    zero_launch_counters(engine)
    driver = WallClockDriver(cluster.scheduler, tick_interval=0.005)
    driver.start()
    try:
        await cluster.start()
        # the goodput window closes when arrivals stop; commits landing in
        # the drain are real but do not pad the in-window rate
        in_window = {"n": None}
        t_end = cluster.scheduler.now() + duration

        def on_tick(now: float) -> None:
            if in_window["n"] is None and now >= t_end:
                in_window["n"] = cluster.set.committed_requests()

        t0 = time.perf_counter()
        stats = await run_open_loop(
            cluster, rate=rate, duration=duration, clients=zipf, seed=31,
            wall=True, step=0.005, drain=drain, on_tick=on_tick)
        elapsed = time.perf_counter() - t0
        await wait_settled(cluster, stats.acked, f"open_loop {tag}",
                           time.perf_counter() + 120.0)
        cluster.check_invariants()
        latency = cluster.set.latency.snapshot()
        dumps = [r.dump() for r in cluster.trace_recorders()]
    finally:
        await cluster.stop()
        await driver.stop()
    total = cluster.committed_requests()
    goodput = (total if in_window["n"] is None else in_window["n"]) \
        / duration
    block = stats.block()
    per_shard = {}
    for sh in cluster.shard_list:
        digests = ledger_digests(sh.apps)
        per_shard[str(sh.shard_id)] = {
            "committed": committed(sh.probe_app()),
            "decisions": len(sh.probe_app().ledger()),
            "ledger_digests": len(digests),
            "ledger_digest": sorted(digests)[0][:16],
        }
    return {
        "offered_per_s": rate, "duration_s": duration, "drain_s": drain,
        "offered": stats.offered, "acked": stats.acked,
        "shed_admission": stats.shed_admission,
        "shed_timeout": stats.shed_timeout, "failed": stats.failed,
        "shed_rate": block["shed_rate"],
        "goodput_per_s": round(goodput, 1), "committed": total,
        "latency": latency,
        "peak_occupancy": stats.peak_occupancy,
        "peak_fill": block["peak_fill"],
        "hot_client_share": round(zipf.hot_fraction(1), 3),
        "slo_met": goodput >= 0.9 * rate and block["shed_rate"] < 0.01,
        "decisions": sum(v["decisions"] for v in per_shard.values()),
        "elapsed_s": round(elapsed, 3),
        "per_shard": per_shard,
        "breaker": cluster.coalescer.fault_snapshot(),
        "dumps": dumps,
    }


def open_loop_cell(engine, tag, rate, wal_root, trace):
    """Cell O1 or O2 through :func:`run_open_loop_cell`; fails unless
    every submit was acked or shed (none failed), the mux delivered every
    acked request once and each shard's replicas hold one ledger, and the
    cell passes :func:`read_cell` for the comb kernel."""
    run = asyncio.run(run_open_loop_cell(engine, tag, rate, wal_root, trace))
    if run["failed"]:
        fail(f"open_loop {tag}: {run['failed']} submits failed with "
             "something other than a shed")
    if run["committed"] != run["acked"]:
        fail(f"open_loop {tag}: the mux delivered {run['committed']} "
             f"requests for {run['acked']} acked")
    for sid, sh in run["per_shard"].items():
        if sh["ledger_digests"] != 1:
            fail(f"open_loop {tag}: shard {sid}'s replicas hold "
                 f"{sh['ledger_digests']} different ledgers")
    run.update(read_cell(engine, "comb", "open_loop", tag, run))
    return run


def phase_open_loop(wal_root, engine=None):
    """Cells O1 and O2 on one fresh CUDA engine (the P-256 comb kernel):
    the open-loop bench's deployment at 400 requests a second (O1, a
    point of its sweep well below its knee, traced) and 1600 (O2, the top
    of its default sweep, untraced).  O1's recorder dumps are rendered by
    ``obs.report`` into the per-span-type percentile rows."""
    from smartbft_tpu_torch.crypto import p256
    from smartbft_tpu_torch.crypto.provider import TorchVerifyEngine
    from smartbft_tpu_torch.obs.report import render

    if engine is None:
        engine = TorchVerifyEngine(device="cuda", scheme=p256)
    o1 = open_loop_cell(engine, "o1", 400.0, wal_root, trace=True)
    o2 = open_loop_cell(engine, "o2", 1600.0, wal_root, trace=False)
    text = render(o1.pop("dumps"), summary_only=True)
    o2.pop("dumps")
    emit({"phase": "open_loop_trace", "cell": "o1",
          "report": text.rstrip("\n").split("\n")})
    keys = ("offered", "acked", "shed_admission", "shed_timeout", "failed",
            "shed_rate", "goodput_per_s", "peak_occupancy",
            "hot_client_share", "launches_per_decision", "rung_launches",
            "fill_pct", "slo_met", "elapsed_s")
    emit({
        "phase": "open_loop", "ok": True,
        "deployment": {"shards": 2, "nodes_per_shard": 4,
                       "pipeline_depth": 2, "window_s": 0.005,
                       "request_pool_size": 2400,
                       "admission_high_water": 0.8,
                       "request_batch_max_count": 128,
                       "request_batch_adaptive": True,
                       "wal_group_commit": True, "clients": 512,
                       "zipf_skew": 1.1, "duration_s": 8.0, "drain_s": 3.0,
                       "scheme": "p256"},
        "summary": {tag: {"commit_ms": {q: cell["latency"][f"{q}_ms"]
                                        for q in ("p50", "p95", "p99")},
                          **{k: cell[k] for k in keys}}
                    for tag, cell in (("o1", o1), ("o2", o2))},
        "o1": o1, "o2": o2,
    })
    return {"o1": o1, "o2": o2}


async def spike_load(apps, rate: float, start: float, stop: float,
                     t0: float, seed: int = 1) -> dict:
    """The chaos round's ``load_spike``: open-loop Poisson arrivals at
    ``rate`` a second (``testing.load.OpenLoopPump``) over 64 Zipf clients
    (``ZipfClients(64, prefix="spike")``), from ``start`` to ``stop``
    seconds after ``t0`` on the wall clock, each submitted as a task of
    its own to the replicas in turn.  Returns what the front door did
    with them once every submit has finished: offered, the acked ids,
    and the sheds."""
    import random

    from smartbft_tpu_torch.core.pool import (
        AdmissionRejected,
        SubmitTimeoutError,
    )
    from smartbft_tpu_torch.testing.load import OpenLoopPump, ZipfClients

    rng = random.Random(seed)
    clients = ZipfClients(64, prefix="spike")
    out = {"offered": 0, "acked": [], "shed_admission": 0,
           "shed_timeout": 0, "failed": 0}

    async def submit(app, cid: str, rid: str) -> None:
        try:
            await app.submit(cid, rid)
            out["acked"].append(f"{cid}:{rid}")
        except AdmissionRejected:
            out["shed_admission"] += 1
        except SubmitTimeoutError:
            out["shed_timeout"] += 1
        except Exception:  # noqa: BLE001 — counted, as the round counts it
            out["failed"] += 1

    await asyncio.sleep(max(0.0, t0 + start - time.perf_counter()))
    pump = OpenLoopPump(rate, rng, start=time.perf_counter())
    tasks = []
    while time.perf_counter() - t0 < stop:
        for _ in range(pump.due(time.perf_counter())):
            rid = f"spike-{out['offered']}"
            app = apps[out["offered"] % len(apps)]
            out["offered"] += 1
            tasks.append(asyncio.ensure_future(
                submit(app, clients.sample(rng), rid)))
        await asyncio.sleep(0.01)
    await asyncio.gather(*tasks)
    return out


def ledger_ids(app) -> list:
    """The request ids (``client:request``) in ``app``'s ledger, in
    order."""
    return [str(info) for d in app.ledger()
            for info in app.requests_from_proposal(d.proposal)]


async def run_byzantine(engine, tag: str, mode: str, wal_root: str):
    """One Byzantine cell: the chaos harness's Byzantine round
    (``testing.chaos.byzantine_round``: n = 4 with one actor, depth 1,
    rotation on, 18 requests, ``chaos_config`` with
    ``misbehavior_shun_threshold=3``, ``misbehavior_decay_interval=600``)
    on real P-256 keys: ``Keyring.generate(..., scheme=p256)`` -> one
    ``P256CryptoProvider`` a replica over one shared dedupe coalescer and
    ``engine`` -> ``testing.App`` on the wall clock, as cell A's cluster
    is built.  A ``ByzantineActor`` arms the replica the round arms (the
    initial leader to equivocate or to censor, replica 4 to forge votes).
    Requests go in one every 0.3 s through each replica in turn, as the
    round submits them, until every replica has committed all of them.
    Mode ``censor`` is the round's censor case: rotation off (a static
    leader), 8 requests, the leader drops every forwarded request of
    client ``chaos``, and open-loop spike arrivals at 10 a second land
    across the cluster from 1 s to 6 s (:func:`spike_load`); it waits
    until every honest replica has committed the 8 requests and every
    acked spike request.  The round's oracles run before the cluster
    stops.  Returns the run's measurements."""
    import threading
    import types

    from smartbft_tpu_torch.codec import decode
    from smartbft_tpu_torch.crypto import p256
    from smartbft_tpu_torch.crypto.provider import (
        AsyncBatchCoalescer,
        Keyring,
        P256CryptoProvider,
    )
    from smartbft_tpu_torch.messages import ViewMetadata
    from smartbft_tpu_torch.testing.app import App, SharedLedgers
    from smartbft_tpu_torch.testing.byzantine import ByzantineActor
    from smartbft_tpu_torch.testing.chaos import Invariants, chaos_config
    from smartbft_tpu_torch.testing.network import Network
    from smartbft_tpu_torch.utils.clock import Scheduler, WallClockDriver

    censor = mode == "censor"
    n, requests = 4, 8 if censor else 18
    ids = list(range(1, n + 1))
    rings = Keyring.generate(ids, seed=b"byzantine-chaos", scheme=p256)
    ring = rings[1]
    engine.prewarm_keys(ring.public_keys.values())
    engine.verify([p256.make_item(b"warm", p256.sign_raw(
        ring.private_key, b"warm"), ring.public_keys[1])])
    coalescer = AsyncBatchCoalescer(engine, window=0.001, max_batch=4096,
                                    dedupe=True)
    scheduler = Scheduler()
    network = Network(seed=1)
    shared = SharedLedgers()
    apps = [
        App(i, network, shared, scheduler,
            wal_dir=os.path.join(wal_root, f"{tag}-wal-{i}"),
            config=chaos_config(i, depth=1, rotation=not censor,
                                misbehavior_shun_threshold=3,
                                misbehavior_decay_interval=600.0),
            crypto=P256CryptoProvider(rings[i], engine=engine,
                                      coalescer=coalescer))
        for i in ids
    ]
    # what the chaos invariants read of a cluster
    cluster = types.SimpleNamespace(depth=1, live_apps=lambda: list(apps))
    actor_id = 1 if mode in ("equivocate", "censor") else 4
    actor_key = rings[actor_id].public_keys[actor_id]
    # every verify the engine runs, tallied by signer and verdict
    tally = {"items": 0, "accepted": 0, "actor_items": 0,
             "actor_accepted": 0}
    lock = threading.Lock()
    verify = engine.verify

    def counted(items):
        out = verify(items)
        with lock:
            tally["items"] += len(items)
            tally["accepted"] += sum(out)
            mine = [ok for it, ok in zip(items, out) if it[3] == actor_key]
            tally["actor_items"] += len(mine)
            tally["actor_accepted"] += sum(mine)
        return out

    zero_launch_counters(engine)
    engine.verify = counted
    driver = WallClockDriver(scheduler, tick_interval=0.01)
    driver.start()
    try:
        for a in apps:
            await a.start()
        actor = ByzantineActor(apps[actor_id - 1], network)
        if mode == "equivocate":
            actor.equivocate()
        elif censor:
            actor.censor({"chaos"})
        else:
            actor.forge_votes(per_preprepare=3)
        honest = [a for a in apps if a.id != actor_id]
        t0 = time.perf_counter()
        spike = asyncio.ensure_future(
            spike_load(apps, 10.0, 1.0, 6.0, t0) if censor
            else asyncio.sleep(0, {"offered": 0, "acked": []}))
        leaders = set()
        k = 0
        while k < requests:
            app = apps[k % n]
            try:
                await app.submit("chaos", f"chaos-{k}")
                k += 1
            except Exception:  # noqa: BLE001 — no leader yet: retry
                pass
            leaders.update(a.consensus.get_leader_id() for a in apps)
            await asyncio.sleep(0.3)
        spiked = await spike
        expected = requests + len(spiked["acked"])
        elapsed = (await wait_committed({tag: honest if censor else apps},
                                        expected, t0,
                                        f"byzantine {tag}"))[tag]
        leaders.update(a.consensus.get_leader_id() for a in apps)
        try:
            Invariants.fork_free(cluster)
            # the deposed censor may still be catching up: Y3 holds the
            # honest replicas to every acked request
            Invariants.exactly_once(
                types.SimpleNamespace(depth=1, live_apps=lambda: honest)
                if censor else cluster, expected=expected)
            if mode == "equivocate":
                Invariants.no_equivocation_commit(cluster, actor)
            elif censor:
                want = {f"chaos:chaos-{k}" for k in range(requests)} \
                    | set(spiked["acked"])
                for a in honest:
                    missing = want - set(ledger_ids(a))
                    assert not missing, (
                        f"replica {a.id} never committed {sorted(missing)}")
            else:
                Invariants.forger_shunned_and_shed(cluster, actor)
        except AssertionError as exc:
            fail(f"byzantine {tag}: {exc}")
        misbehavior = {a.id: a.consensus.misbehavior_snapshot()
                       for a in honest}
        final_leaders = {a.consensus.get_leader_id() for a in honest}
        views = sorted({a.consensus.controller.curr_view_number
                        for a in apps})
        honest_views = {str(a.id): a.consensus.controller.curr_view_number
                        for a in honest}
    finally:
        engine.verify = verify
        for a in apps:
            await a.stop()
        await driver.stop()
    forged_values = sum(
        s.value == b"\x00" * 16
        for a in honest for d in a.ledger() for s in d.signatures)
    committed_views = sorted({
        decode(ViewMetadata, d.proposal.metadata).view_id
        for d in honest[0].ledger() if d.proposal.metadata})
    digests = ledger_digests(honest)
    return {
        "mode": mode, "actor": actor.snapshot(), "nodes": n,
        "requests": expected,
        "spike": {**{k: v for k, v in spiked.items() if k != "acked"},
                  "acked": len(spiked["acked"])},
        "committed_min": min(committed(a)
                             for a in (honest if censor else apps)),
        "decisions": len(honest[0].ledger()),
        "ledger_digests": len(digests),
        "ledger_digest": sorted(digests)[0][:16],
        "elapsed_s": round(elapsed, 3),
        "tx_per_s": round(expected / elapsed, 1),
        "leaders_seen": sorted(leaders),
        "final_leaders": sorted(final_leaders), "views": views,
        "honest_views": honest_views,
        "committed_views": committed_views,
        "forged_values_committed": forged_values,
        "engine_tally": dict(tally),
        "misbehavior": {
            str(i): {"by_actor": snap["by_sender"].get(actor_id, {}),
                     "shunned": actor_id in snap["shunned"],
                     "shun_events": snap["shun_events"],
                     "shed_votes": sum(snap["shed_votes"].values())}
            for i, snap in misbehavior.items()},
        "actor_commits_resigned": sum(
            r.kind == "commit" and r.mutated for r in actor.send_log),
        "breaker": coalescer.fault_snapshot(),
    }


def byzantine_cell(engine, tag, mode, wal_root):
    """Cell Y1 (``mode`` "forge"), Y2 ("equivocate") or Y3 ("censor")
    through :func:`run_byzantine`, whose chaos oracles must hold
    (fork-free, exactly once, and the mode's own).  Fails unless every
    honest replica holds one ledger with every request, no committed
    decision carries a forged signature, the cell passes
    :func:`read_cell` for the comb kernel (so the breaker never opened),
    and: in Y1 the forger is shunned at every honest replica and every
    signature in the kernel's lanes is one the engine was handed and
    accepted (the forged values never reach a lane); in Y2 every honest
    ledger goes on in a view after the one the leader lied in (the oracle
    also holds the liar to the committed blacklist); in Y3 the censor
    dropped a forwarded request, every honest replica committed every
    acked request once, and every honest replica is in a view after 0
    (the censor was deposed)."""
    run = asyncio.run(run_byzantine(engine, tag, mode, wal_root))
    if run["committed_min"] < run["requests"]:
        fail(f"byzantine {tag}: a replica committed {run['committed_min']} "
             f"of {run['requests']}")
    if run["ledger_digests"] != 1:
        fail(f"byzantine {tag}: honest replicas hold "
             f"{run['ledger_digests']} different ledgers")
    if run["forged_values_committed"]:
        fail(f"byzantine {tag}: {run['forged_values_committed']} forged "
             "signatures were committed")
    run.update(read_cell(engine, "comb", "byzantine", tag, run))
    actor, tally = run["actor"]["id"], run["engine_tally"]
    if mode == "forge":
        unshunned = [i for i, m in run["misbehavior"].items()
                     if not m["shunned"]]
        if unshunned:
            fail(f"byzantine {tag}: forger {actor} is not shunned at "
                 f"replicas {unshunned}: {run['misbehavior']}")
        if not tally["items"] == tally["accepted"] == run["sigs_verified"]:
            fail(f"byzantine {tag}: the kernel's {run['sigs_verified']} "
                 f"signatures are not the {tally['accepted']} accepted of "
                 f"{tally['items']} the engine was handed")
    elif mode == "censor":
        if not run["actor"]["censored"]:
            fail(f"byzantine {tag}: the censor dropped no forwarded "
                 "request: the attack never engaged")
        stuck = {i: v for i, v in run["honest_views"].items() if v == 0}
        if stuck:
            fail(f"byzantine {tag}: the censor {actor} was not deposed: "
                 f"honest replicas still in view 0: {stuck}")
    elif run["committed_views"][-1] <= min(
            v for v, _ in run["actor"]["equivocated_slots"]):
        fail(f"byzantine {tag}: nothing committed in a view after the "
             f"equivocating leader {actor}'s (views "
             f"{run['committed_views']})")
    return run


def phase_byzantine(wal_root, engine=None):
    """Cells Y1, Y2 and Y3 on one fresh CUDA engine (the P-256 comb
    kernel): the chaos harness's Byzantine round on real P-256 votes, with
    a vote forger (Y1), an equivocating leader (Y2) and a censoring
    static leader under open-loop spike arrivals (Y3)."""
    from smartbft_tpu_torch.crypto import p256
    from smartbft_tpu_torch.crypto.provider import (
        TorchVerifyEngine,
        prewarm_verify_engine,
    )

    if engine is None:
        engine = TorchVerifyEngine(device="cuda", scheme=p256)
    prewarm_verify_engine(engine)
    y1 = byzantine_cell(engine, "y1", "forge", wal_root)
    y2 = byzantine_cell(engine, "y2", "equivocate", wal_root)
    y3 = byzantine_cell(engine, "y3", "censor", wal_root)

    def summary(cell):
        mis = cell["misbehavior"].values()
        return {
            "actor": cell["actor"]["id"], "forged": cell["actor"]["forged"],
            "shed_votes": sum(m["shed_votes"] for m in mis),
            "shunned_at": [i for i, m in cell["misbehavior"].items()
                           if m["shunned"]],
            "rejected_before_the_engine": {
                i: m["by_actor"] for i, m in cell["misbehavior"].items()},
            "lanes": cell["kernel_lanes"]["comb"],
            "sigs_in_lanes": cell["sigs_verified"],
            "engine_tally": cell["engine_tally"],
            "equivocated_slots": len(cell["actor"]["equivocated_slots"]),
            "actor_commits_resigned": cell["actor_commits_resigned"],
            "leaders_seen": cell["leaders_seen"],
            "final_leaders": cell["final_leaders"], "views": cell["views"],
            "committed_views": cell["committed_views"],
            "launches_per_decision": cell["launches_per_decision"],
            "tx_per_s": cell["tx_per_s"], "elapsed_s": cell["elapsed_s"],
        }

    def censor_summary(cell):
        return {**summary(cell), "censored": cell["actor"]["censored"],
                "requests": cell["requests"], "spike": cell["spike"],
                "honest_views": cell["honest_views"]}

    emit({
        "phase": "byzantine", "ok": True,
        "deployment": {"nodes": 4, "actors": 1, "pipeline_depth": 1,
                       "leader_rotation": True, "requests": 18,
                       "misbehavior_shun_threshold": 3,
                       "misbehavior_decay_interval_s": 600.0,
                       "shared_dedupe_coalescer": True, "window_s": 0.001,
                       "scheme": "p256"},
        "y3_deployment": {"leader_rotation": False, "requests": 8,
                          "censored_client": "chaos",
                          "spike_per_s": 10.0, "spike_s": [1.0, 6.0]},
        "y1_forge": summary(y1), "y2_equivocate": summary(y2),
        "y3_censor": censor_summary(y3),
        "y1": y1, "y2": y2, "y3": y3,
    })
    return {"y1": y1, "y2": y2, "y3": y3}


def raise_fd_limit() -> dict:
    """This process's open-file limit, its soft limit raised to the hard
    one when it is below 4096 (n = 16 ``SocketComm``s in one process hold
    ~500 sockets besides the WAL files); acts on this process only."""
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    out = {"soft": soft, "hard": hard, "raised_to": None}
    if soft != resource.RLIM_INFINITY and soft < 4096 and hard != soft:
        new = hard if hard != resource.RLIM_INFINITY else 65536
        resource.setrlimit(resource.RLIMIT_NOFILE, (new, hard))
        out["raised_to"] = new
    return out


def socket_cell(engine, tag, transport, rings, ids, decisions, batch,
                pipeline, wal_root):
    """Cell T0 (``transport`` None: the in-process network), T1 (UDS) or
    T2 (TCP): the deployment of :func:`run_cluster` on ``engine``.  The
    launch counters are zeroed just before the run and read just after
    it.  Fails unless every replica committed every request into one
    ledger, the cell passes :func:`read_cell` for the comb kernel, and,
    over sockets, no frame was malformed and no transport task outlived
    the replicas' stop."""
    zero_launch_counters(engine)
    run = asyncio.run(run_cluster(engine, rings, ids, decisions, batch,
                                  pipeline, wal_root, tag,
                                  transport=transport))
    if not run["committed_min"] == run["committed_max"] == run["requests"]:
        fail(f"sockets {tag}: replicas committed {run['committed_min']} to "
             f"{run['committed_max']} of {run['requests']}")
    if run["ledger_digests"] != 1:
        fail(f"sockets {tag}: replicas hold {run['ledger_digests']} "
             "different ledgers")
    run.update(read_cell(engine, "comb", "sockets", tag, run))
    if transport is not None:
        net = run["transport"]
        if net["malformed_frames"] or net["handshake_rejected"]:
            fail(f"sockets {tag}: the transport saw bad frames: {net}")
        if not net["flush_batches"] or net["frames_per_flush"] < 1.0:
            fail(f"sockets {tag}: no flush went out: {net}")
        if run["transport_tasks_left"]:
            fail(f"sockets {tag}: transport tasks outlived the stop: "
                 f"{run['transport_tasks_left']}")
    run["transport_kind"] = transport or "inproc"
    return run


def process_cell(tag, n, wal_root, kill_rejoin: bool) -> dict:
    """Cell R4 (``kill_rejoin``: n = 4, the leader SIGKILLed mid-burst and
    respawned, ``run_socket_schedule(cluster, kill_rejoin_schedule(),
    requests=16)``) or R16 (n = 16, eight requests through every replica
    in turn): one ``python -m smartbft_tpu_torch.net.launch`` process a
    replica over UDS (``SocketCluster``), trivial crypto, so no kernel.
    Fails unless the schedule fired exactly ["crash", "restart"] (R4),
    every request committed, the ledgers are fork-free, every replica
    reached the cluster's height (the restarted one by wire sync), no
    kernel launched, and every replica exited with code 0 at ``stop()``
    (one still running at its 10 s deadline is SIGKILLed: -9)."""
    from smartbft_tpu_torch.net.cluster import (
        SocketCluster,
        kill_rejoin_schedule,
        run_socket_schedule,
    )

    before = {k: c.launches for k, c in launch_counters().items()}
    path = os.pathsep.join([HERE] + [
        p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])
    cluster = SocketCluster(os.path.join(wal_root, tag), n=n,
                            transport="uds", env={"PYTHONPATH": path})
    out = {"nodes": n, "transport": "uds"}
    t0 = time.perf_counter()
    try:
        cluster.start(ready_timeout=60.0)
        out["ready_s"] = round(time.perf_counter() - t0, 3)
        leader = cluster.wait_leader(timeout=60.0)
        t1 = time.perf_counter()
        if kill_rejoin:
            report = run_socket_schedule(cluster, kill_rejoin_schedule(),
                                         requests=16)
            out.update(events=[[a, node] for a, node in report.events_fired],
                       submitted=report.submitted,
                       final_committed=report.final_committed)
            want = 16
        else:
            want = 8
            for k in range(want):
                cluster.submit(cluster.live_ids()[k % n], "scale",
                               f"req-{k}")
        try:
            # every replica, a restarted one by wire sync
            cluster.wait_committed(want, timeout=120.0)
        except TimeoutError as exc:
            fail(f"sockets {tag}: {exc}")
        out["elapsed_s"] = round(time.perf_counter() - t1, 3)
        deadline = time.monotonic() + 30.0
        heights = cluster.heights()
        while len(set(heights.values())) != 1 \
                and time.monotonic() < deadline:
            time.sleep(0.1)
            heights = cluster.heights()
        try:
            cluster.check_fork_free()
            out["fork_free"] = True
        except AssertionError as exc:
            fail(f"sockets {tag}: ledgers fork: {exc}")
        committed_ids = {i: len(cluster.committed_ids(i))
                         for i in cluster.live_ids()}
        out.update(first_leader=leader, heights=heights,
                   committed=committed_ids)
    finally:
        t_stop = time.perf_counter()
        cluster.stop()
        out["stop_s"] = round(time.perf_counter() - t_stop, 3)
        out["exit_codes"] = {str(i): h.proc.returncode
                             for i, h in cluster.replicas.items()
                             if h.proc is not None}
    if kill_rejoin:
        if [a for a, _ in out["events"]] != ["crash", "restart"]:
            fail(f"sockets {tag}: the schedule fired {out['events']}")
        out["restarted"] = out["events"][1][1]
        out["restarted_height"] = heights[out["restarted"]]
        if out["final_committed"] < want:
            fail(f"sockets {tag}: {out['final_committed']} of {want} "
                 "committed")
    if len(set(heights.values())) != 1 or min(committed_ids.values()) < want:
        fail(f"sockets {tag}: replicas stand at heights {heights} with "
             f"{committed_ids} requests, not all {want}")
    if out["exit_codes"] != {str(i): 0 for i in range(1, n + 1)}:
        fail(f"sockets {tag}: replicas exited {out['exit_codes']}")
    after = {k: c.launches for k, c in launch_counters().items()}
    if after != before:
        fail(f"sockets {tag}: a kernel launched in a process cell: "
             f"{before} -> {after}")
    return out


def phase_sockets(wal_root, n=16, batch=500, pipeline=16, decisions=32):
    """BASELINE config [2] over real sockets on one fresh CUDA engine (the
    P-256 comb kernel): cells T0 (in-process network), T1 (a
    ``SocketComm`` a replica over UDS) and T2 (over TCP), each a
    32-decision burst of n = 16, batch 500, depth 16, as cell F1; then the
    process-per-replica cells R4 (kill and rejoin) and R16."""
    from smartbft_tpu_torch.crypto import p256
    from smartbft_tpu_torch.crypto.provider import Keyring, TorchVerifyEngine

    fds = raise_fd_limit()
    emit({"phase": "sockets_fds", "ok": True, "rlimit_nofile": fds})
    ids = list(range(1, n + 1))
    rings = Keyring.generate(ids, seed=b"smoke-sockets")
    ring = rings[ids[0]]
    engine = TorchVerifyEngine(device="cuda", scheme=p256)
    engine.prewarm_keys(ring.public_keys.values())
    engine.prewarm_shapes(p256.make_item(
        b"warm", p256.sign_raw(ring.private_key, b"warm"),
        ring.public_keys[ids[0]]))
    cells = {}
    for tag, transport in (("t0", None), ("t1", "uds"), ("t2", "tcp")):
        cells[tag] = socket_cell(engine, tag, transport, rings, ids,
                                 decisions, batch, pipeline, wal_root)
    digests = {t: c["ledger_digest"] for t, c in cells.items()}
    r4 = process_cell("r4", 4, wal_root, kill_rejoin=True)
    r16 = process_cell("r16", 16, wal_root, kill_rejoin=False)

    def summary(cell):
        keep = ("transport_kind", "tx_per_s", "elapsed_s", "decisions",
                "committed_min", "launches_per_decision", "rung_launches",
                "fill_pct", "sigs_verified", "protocol_plane", "stop_s",
                "transport")
        return {k: cell[k] for k in keep if k in cell}

    emit({
        "phase": "sockets", "ok": True,
        "deployment": {"nodes": n, "request_batch_max_count": batch,
                       "pipeline_depth": pipeline, "wal_group_commit": True,
                       "decisions": decisions, "leader_rotation": False,
                       "shared_dedupe_coalescer": True, "window_s": 0.02,
                       "scheme": "p256"},
        "t0_inproc": summary(cells["t0"]), "t1_uds": summary(cells["t1"]),
        "t2_tcp": summary(cells["t2"]),
        "tx_per_s_vs_t0": {t: round(c["tx_per_s"] / cells["t0"]["tx_per_s"],
                                    3) for t, c in cells.items()},
        "ledger_digests": digests,
        "r4_kill_rejoin": r4, "r16": r16,
        "t0": cells["t0"], "t1": cells["t1"], "t2": cells["t2"],
    })
    return cells


def bls_args16(rec):
    """The pairing kernel's 16384-lane arguments: the 2048-lane batch of
    phase bls eight times over."""
    return [a.repeat(8, *([1] * (a.dim() - 1))) for a in rec[2048]["args"]]


def bls_kernel_row(rec, cell, clock_hz, sms):
    """The pairing kernel's row of the kernels line: time per launch at
    every rung cell E used and at 16384 (the 2048-lane batch eight times
    over), the plain version's time at the main rung, and the bound."""
    import torch

    from smartbft_tpu_torch.crypto import cuda_bls as cbl

    args16 = bls_args16(rec)
    rung = cell["main_rung"]
    args_r = first_lanes(args16, rung)
    ms_by_rung = {}
    for r in cell["rung_launches"]:
        args_b = first_lanes(args16, int(r))
        ms_by_rung[r] = round(time_ms(lambda: cbl.bls_verify(*args_b), 10),
                              4)
    ms_16k = time_ms(lambda: cbl.bls_verify(*args16), 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = cbl.bls_verify_plain(*args_r)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    if not torch.equal(cbl.bls_verify(*args_r), want):
        fail(f"bls_verify: kernel and plain masks differ at rung {rung}")
    # a lane reads 8 values of 48 bytes and ok, and writes its verdict;
    # the constant table is read once
    lane_bytes = 8 * 48 + 4 + 4
    table_bytes = cbl.device_table(args_r[0].device).numel() * 4
    ops_r, ops_16k = cbl.mont_ops(*args_r), cbl.mont_ops(*args16)
    b_rung, by = bound(ops_r, rung * lane_bytes + table_bytes, clock_hz, sms)
    b_16k, _ = bound(ops_16k, len(args16[0]) * lane_bytes + table_bytes,
                     clock_hz, sms)
    return {
        "name": "bls_verify", "route": "cuda",
        "source": "smartbft_tpu_torch/csrc/cuda_bls.cu",
        "replaces": "smartbft_tpu/crypto/bls12381.py:1425",
        "launches": cell["kernel_launches"]["bls"],
        "lanes": cell["kernel_lanes"]["bls"],
        "max_abs_err": max(rec[b]["max_abs_err"] for b in rec),
        "agree_lanes": sum(rec[b]["lanes"] for b in rec),
        "rung": rung,
        "ms": ms_by_rung[str(rung)],
        "plain_ms": round(plain_ms, 3),
        "bound_ms": round(b_rung, 4),
        "bound_by": by,
        "library_ms": None,
        "ms_16384": round(ms_16k, 4),
        "plain_ms_16384": None,
        "plain_ms_128": rec[128]["plain_ms"],
        "plain_ms_2048": rec[2048]["plain_ms"],
        "bound_ms_16384": round(b_16k, 4),
        "launches_per_decision": cell["launches_per_decision"],
        "rung_launches": cell["rung_launches"],
        "ms_by_rung": ms_by_rung,
        "mont_ops": ops_r, "mont_ops_16384": ops_16k,
        "imads": imads(ops_r), "imads_16384": imads(ops_16k),
    }


def phase_kernels(recs, cells, clock_hz, sms, sharded):
    """The kernels line: per kernel, time at every rung its cell used, at
    the main rung and at 16384 (CUDA events), the plain version's time and
    the bound; the pairing kernel's row last (:func:`bls_kernel_row`).
    ``recs``: the kernel phases' records by kernel name; ``cells``: the
    e2e cells by kernel name; ``sharded``: the cells of phases sharded,
    verify_plane, open_loop, byzantine, sockets and mesh by tag, whose comb
    launches and rungs the comb kernel's row carries too."""
    import torch

    from smartbft_tpu_torch.crypto import cuda_comb as cc
    from smartbft_tpu_torch.crypto import cuda_ecdsa as ce
    from smartbft_tpu_torch.crypto import cuda_ed25519 as ced
    from smartbft_tpu_torch.crypto import cuda_eddsa as cgd

    rows = []
    # name, source, TPU kernel replaced, module (its mont_ops counts the
    # operations a batch needs), wrapper, plain version, bytes a lane moves
    # (inputs read once, the mask written once), cell
    specs = (
        ("comb_verify", "cuda_comb.cu", "smartbft_tpu/crypto/pallas_comb.py:333",
         cc, cc.ecdsa_verify_comb, cc.ecdsa_verify_comb_plain, 104, "comb"),
        ("ecdsa_verify", "cuda_ecdsa.cu", "smartbft_tpu/crypto/pallas_ecdsa.py:653",
         ce, ce.ecdsa_verify, ce.ecdsa_verify_plain, 164, "generic"),
        ("ed_comb_verify", "cuda_ed25519.cu",
         "smartbft_tpu/crypto/pallas_ed25519.py:263", ced,
         ced.eddsa_verify_comb, ced.eddsa_verify_comb_plain, 140, "ed_comb"),
        ("eddsa_verify", "cuda_eddsa.cu", "smartbft_tpu/crypto/ed25519.py:187",
         cgd, cgd.eddsa_verify, cgd.eddsa_verify_plain, 200, "ed_generic"),
    )
    for name, src, replaces, mod, kern, plain, lane_bytes, key in specs:
        cell, rec = cells[key], recs[key]
        more = sharded if key == "comb" else {}
        rung = cell["main_rung"]
        top = max(rec)  # 16384 lanes, the top rung
        args16 = rec[top]["args"]
        args_r = first_lanes(args16, rung)
        ms_by_rung = {}
        rungs = set(cell["rung_launches"]).union(
            *(c["rung_launches"] for c in more.values()))
        for r in sorted(rungs, key=int):
            args_b = first_lanes(args16, int(r))
            ms_by_rung[r] = round(time_ms(lambda: kern(*args_b), 20), 4)
        ms_rung = ms_by_rung[str(rung)]
        ms_16k = time_ms(lambda: kern(*args16), 10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain(*args_r)
        torch.cuda.synchronize()
        plain_ms_rung = 1e3 * (time.perf_counter() - t0)
        if not torch.equal(kern(*args_r), want):
            fail(f"{name}: kernel and plain masks differ at rung {rung}")
        table_bytes = sum(a.numel() * a.element_size() for a in args_r
                          if a.dtype == torch.uint32)
        ops_r, ops_16k = mod.mont_ops(*args_r), mod.mont_ops(*args16)
        b_rung, by = bound(ops_r, rung * lane_bytes + table_bytes,
                           clock_hz, sms)
        b_16k, _ = bound(ops_16k, top * lane_bytes + table_bytes,
                         clock_hz, sms)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"smartbft_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": cell["kernel_launches"][key],
            "lanes": cell["kernel_lanes"][key],
            "max_abs_err": max(rec[b]["max_abs_err"] for b in rec),
            "agree_lanes": sum(rec[b]["lanes"] for b in rec),
            "rung": rung,
            "ms": ms_rung,
            "plain_ms": round(plain_ms_rung, 3),
            "bound_ms": round(b_rung, 4),
            "bound_by": by,
            "library_ms": None,
            "ms_16384": round(ms_16k, 4),
            "plain_ms_16384": rec[top]["plain_ms"],
            "bound_ms_16384": round(b_16k, 4),
            "launches_per_decision": cell["launches_per_decision"],
            "rung_launches": cell["rung_launches"],
            "ms_by_rung": ms_by_rung,
            "mont_ops": ops_r, "mont_ops_16384": ops_16k,
            "imads": imads(ops_r), "imads_16384": imads(ops_16k),
        })
        if more:
            rows[-1]["cells"] = {
                tag: {"launches": c["kernel_launches"][key],
                      "lanes": c["kernel_lanes"][key],
                      "launches_per_decision": c["launches_per_decision"],
                      "rung_launches": c["rung_launches"]}
                for tag, c in {"a": cell, **more}.items()}
    rows.append(bls_kernel_row(recs["bls"], cells["bls"], clock_hz, sms))
    return rows


def group_phase(phase, lib, mod, plain, rec, report):
    """A group kernel at each group size it is built with (threads a
    signature): the library ``lib`` that the wrapper loads and its builds
    in ``csrc.VARIANTS``, each held to the plain mask at rung 512 and timed
    in turns (a, b, b, a) at the rungs 128, 512 and 2048 and at 16384
    lanes.  ``mod`` is the kernel's module (``group_size``, ``launch``),
    ``rec`` its kernel phase's records by batch size."""
    import torch

    from smartbft_tpu_torch import csrc

    args16 = rec[max(rec)]["args"]
    # the builds of the source at another group size (not the pairing
    # kernel's Miller-loop build)
    builds = [lib] + [name for name, (src, flags) in csrc.VARIANTS.items()
                      if src == csrc.SOURCES[lib]
                      and any("GROUP=" in f for f in flags)]
    # each build by the group size it reports, the wrapper's first
    groups = {f"G{mod.group_size(name)}": name for name in builds}
    want = plain(*first_lanes(args16, 512))
    ms = {}
    order = list(groups)
    for rung in (128, 512, 2048, 16384):
        args = first_lanes(args16, rung)
        for key in order + order[::-1]:
            name = groups[key]
            if rung == 512 and not torch.equal(mod.launch(name, *args), want):
                fail(f"{phase} at {key}: mask differs from plain")
            t = time_ms(lambda: mod.launch(name, *args),
                        5 if rung == 16384 else 20)
            ms.setdefault(key, {}).setdefault(str(rung), []).append(
                round(t, 4))
    out = {"phase": phase, "ok": True, "group": order[0],
           "ms": {g: {r: round(sum(v) / len(v), 4) for r, v in by.items()}
                  for g, by in ms.items()},
           "ms_turns": ms,
           "ptxas": {key: {k: v for k, v in report[name].items()
                           if k not in ("ptxas", "seconds")}
                     for key, name in groups.items()}}
    emit(out)
    return out


def phase_bls_groups(rec, report):
    """The pairing kernel at each group size (:func:`group_phase` on the
    16384-lane batch), then the split of a launch: the build that stops
    after the Miller loop (``cuda_bls_miller``) in turns with the library
    at rungs 512 and 16384; the final exponentiation's share is the
    difference.  With the dynamic shared memory a block of each build
    takes (the stage program's slots)."""
    from smartbft_tpu_torch.crypto import cuda_bls as cbl

    args16 = bls_args16(rec)
    group_phase("bls_groups", "cuda_bls", cbl, cbl.bls_verify_plain,
                {16384: {"args": args16}}, report)
    turns: dict = {}
    for rung in (512, 16384):
        args = first_lanes(args16, rung)
        for name in ("cuda_bls", "cuda_bls_miller", "cuda_bls_miller",
                     "cuda_bls"):
            t = time_ms(lambda: cbl.launch(name, *args),
                        5 if rung == 16384 else 20)
            turns.setdefault(name, {}).setdefault(str(rung), []).append(
                round(t, 4))
    split = {}
    for rung in ("512", "16384"):
        full = sum(turns["cuda_bls"][rung]) / 2
        miller = sum(turns["cuda_bls_miller"][rung]) / 2
        split[rung] = {"launch_ms": round(full, 4),
                       "miller_ms": round(miller, 4),
                       "final_exp_ms": round(full - miller, 4),
                       "miller_share": round(miller / full, 4)}
    out = {"phase": "bls_split", "ok": True, "group": cbl.group_size(),
           "split": split, "ms_turns": turns,
           "shared_bytes_a_block": {
               name: cbl.shared_bytes(name)
               for name in ("cuda_bls", "cuda_bls_g6", "cuda_bls_miller")},
           "ptxas_miller": {k: v for k, v in report["cuda_bls_miller"].items()
                            if k not in ("ptxas", "seconds")}}
    emit(out)
    return out


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as exc:
        return early_exit(f"{exc}")
    if not torch.cuda.is_available():
        return early_exit("CUDA is not available; this smoke needs an "
                          "NVIDIA card")
    sys.path.insert(0, HERE)
    try:
        import smartbft_tpu_torch.crypto.provider  # noqa: F401
    except ImportError as exc:
        return early_exit(f"the port package is missing ({exc}); run from "
                          "the repository root")
    return run_phase("smoke", smoke, np, torch)


def smoke(np, torch) -> int:
    """Every phase in turn; the caller reports a failure on stdout."""
    from smartbft_tpu_torch.crypto.provider import Keyring

    smi = nvidia_smi("name,power.limit")
    clock_hz = 1e6 * float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "sm_clock_max_mhz": clock_hz / 1e6, "sms": sms})
    rng = np.random.default_rng(20261016)
    wal_root = os.path.join(HERE, "smartbft_tpu_torch", "_build", "chip_smoke")
    shutil.rmtree(wal_root, ignore_errors=True)
    os.makedirs(wal_root)
    from smartbft_tpu_torch.crypto import bls12381, ed25519, p256

    t_start = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = run_phase(name, fn, *args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    ids = list(range(1, 65))

    def ring_keys(scheme):
        rings = Keyring.generate(ids, seed=b"bench-tput", scheme=scheme)
        return [(rings[i].private_key, rings[i].public_keys[i]) for i in ids]

    try:
        report = timed("build", phase_build)
        keys, ed_keys, bls_keys = timed(
            "keys", lambda: [ring_keys(s) for s in (p256, ed25519, bls12381)])
        recs = {"comb": timed("comb", phase_comb, rng, keys),
                "generic": timed("generic", phase_generic, rng),
                "ed_comb": timed("ed_comb", phase_ed_comb, rng, ed_keys),
                "ed_generic": timed("ed_generic", phase_ed_generic, rng),
                "bls": timed("bls", phase_bls, rng, bls_keys)}
        cells = {**timed("e2e_p256", phase_e2e, wal_root, p256),
                 **timed("e2e_ed25519", phase_e2e, wal_root, ed25519),
                 **timed("e2e_bls", phase_e2e_bls, wal_root)}
        sharded = timed("sharded", phase_sharded, wal_root)
        plane = timed("verify_plane", phase_verify_plane, wal_root)
        loads = timed("open_loop", phase_open_loop, wal_root)
        byz = timed("byzantine", phase_byzantine, wal_root)
        socks = timed("sockets", phase_sockets, wal_root)
        meshes = timed("mesh", phase_mesh, wal_root)
        embed = timed("embedder", phase_embedder, wal_root, rng, keys,
                      ed_keys)
        rows = timed("kernels", phase_kernels, recs, cells, clock_hz, sms,
                      {**sharded, **plane, **loads, **byz, **socks,
                       **meshes, **embed})
        for cells, phase in ((sharded, "sharded_busy"),
                             (plane, "verify_plane_busy"),
                             (loads, "open_loop_busy"),
                             (byz, "byzantine_busy"),
                             (socks, "sockets_busy"), (meshes, "mesh_busy"),
                             (embed, "embedder_busy")):
            run_phase(phase, busy_line, cells, rows[0], phase)
        from smartbft_tpu_torch.crypto import cuda_comb as cc
        from smartbft_tpu_torch.crypto import cuda_ecdsa as ce
        from smartbft_tpu_torch.crypto import cuda_ed25519 as ced
        from smartbft_tpu_torch.crypto import cuda_eddsa as cgd

        timed("generic_groups", group_phase, "generic_groups", "cuda_ecdsa",
              ce, ce.ecdsa_verify_plain, recs["generic"], report)
        timed("ed_generic_groups", group_phase, "ed_generic_groups",
              "cuda_eddsa", cgd, cgd.eddsa_verify_plain, recs["ed_generic"],
              report)
        timed("comb_groups", group_phase, "comb_groups", "cuda_comb", cc,
              cc.ecdsa_verify_comb_plain, recs["comb"], report)
        timed("ed_comb_groups", group_phase, "ed_comb_groups",
              "cuda_ed25519", ced, ced.eddsa_verify_comb_plain,
              recs["ed_comb"], report)
        timed("bls_groups", phase_bls_groups, recs["bls"], report)
    finally:
        shutil.rmtree(wal_root, ignore_errors=True)
    emit({"phase": "timing", "seconds": seconds,
          "total_s": round(time.perf_counter() - t_start, 1)})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
