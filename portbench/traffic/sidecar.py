"""The verify plane of one consenter node with its pipeline full.

A channel is a SmartBFT group of the configuration's n consenters; the
cells run one, the group the configuration describes.  For each channel
the benchmark makes a pool of decisions: a proposal of the configured
size and the commit signatures of Q - 1 other consenters over its
``ConsenterSigMsg``, a few of them forged by at most f consenters.  The
node runs one provider a channel over one shared coalescer (dedupe off,
as on a single replica) and one engine.  A closed loop keeps
``outstanding`` decisions of every channel in
``verify_consenter_sigs_batch_async`` (the cells: the configuration's
``pipeline_depth``, the most decisions a replica has in flight) and
replays the pool in a cycle; every call gets a fresh proposal object, so
its digest is worked out again.

Parameters (the cell's ``params``): ``channels``, ``outstanding``,
``decisions_per_channel``, ``forged_one_in``, ``proposal_bytes``,
``warmup_s``, ``warm_rungs``, ``reference_sample``.

End to end: ``verify_sigs_per_s``, the signatures whose verdicts came
back to their callers inside the window over the window's seconds.
"""

from __future__ import annotations

import asyncio
import struct
import time

import numpy as np

from .. import deploy, reference, signer


def build_pool(cfg: dict, params: dict, seed: int, workers: int) -> dict:
    """The seeded pool: keys, and for each channel and decision the
    proposal's fields, the signatures and the verdict each should get."""
    scheme, n = cfg["scheme"], cfg["nodes"]
    q, f = reference.quorum(n)
    rng = np.random.default_rng(seed)
    keys = signer.keys(scheme, seed, n)
    ids = list(range(1, n + 1))
    me = ids[0]
    others = np.array(ids[1:])
    chans, d_per = params["channels"], params["decisions_per_channel"]
    decisions, msgs_by_signer = [], {i: [] for i in ids}
    count = struct.pack(">I", q - 1)
    for c in range(chans):
        row = []
        for j in range(d_per):
            payload = rng.bytes(params["proposal_bytes"])
            metadata = reference.enc_ids([0, j + 1, j + 1])
            digest = reference.proposal_digest(b"", payload, metadata, 0)
            signers = np.sort(rng.choice(others, q - 1, replace=False))
            # each signer's prepare witnesses: q - 1 members, ascending
            wit = np.sort(np.argsort(rng.random((q - 1, n)), axis=1)
                          [:, :q - 1] + 1, axis=1).astype(">u8")
            sigs = []
            for s, w in zip(signers.tolist(), wit):
                aux = count + w.tobytes()
                msg = reference.consenter_sig_msg(digest, aux)
                msgs_by_signer[s].append((c, j, len(sigs)))
                sigs.append([s, msg, aux])
            row.append({"payload": payload, "metadata": metadata,
                        "digest": digest, "sigs": sigs})
        decisions.append(row)
    jobs, where = [], []
    for s, spots in msgs_by_signer.items():
        if spots:
            msgs = [decisions[c][j]["sigs"][k][1] for c, j, k in spots]
            jobs.append((scheme, keys[s - 1][0], msgs))
            where.append(spots)
    for spots, values in zip(where, signer.sign_jobs(jobs, workers)):
        for (c, j, k), v in zip(spots, values):
            decisions[c][j]["sigs"][k].append(v)
    # forgeries: one signature in ``forged_one_in``, all by f consenters
    forgers = set(int(x) for x in rng.choice(others, f, replace=False))
    spots = [(c, j, k) for c in range(chans) for j in range(d_per)
             for k, sig in enumerate(decisions[c][j]["sigs"])
             if sig[0] in forgers]
    total = chans * d_per * (q - 1)
    picked = rng.choice(len(spots), total // params["forged_one_in"],
                        replace=False)
    for i in picked:
        c, j, k = spots[i]
        sig = decisions[c][j]["sigs"][k]
        sig[3] = signer.forge(scheme, sig[3])
    forged = {spots[i] for i in picked}
    for c in range(chans):
        for j in range(d_per):
            dec = decisions[c][j]
            dec["expected"] = [None if (c, j, k) in forged else aux
                               for k, (_, _, aux, _) in enumerate(dec["sigs"])]
    return {"keys": keys, "me": me, "q": q, "f": f,
            "decisions": decisions, "forged": forged, "total": total}


def reference_check(cfg: dict, pool: dict, params: dict, seed: int) -> int:
    """Pool signatures, drawn from the seed (every forged one up to the
    sample's size, and valid ones), whose reference verdict or binding
    differs from the verdict the pool expects.  Returns the count."""
    verify = reference.VERIFY[cfg["scheme"]]
    rng = np.random.default_rng(seed ^ 0x5EED)
    decs = pool["decisions"]
    forged = sorted(pool["forged"])
    valid_want, forged_want = (params["reference_sample"]["valid"],
                               params["reference_sample"]["forged"])
    pick = [forged[i] for i in rng.choice(
        len(forged), min(forged_want, len(forged)), replace=False)]
    chans, d_per = len(decs), len(decs[0])
    while len(pick) < forged_want + valid_want:
        c, j = int(rng.integers(chans)), int(rng.integers(d_per))
        k = int(rng.integers(len(decs[c][j]["sigs"])))
        if (c, j, k) not in pool["forged"]:
            pick.append((c, j, k))
    bad = 0
    for c, j, k in pick:
        dec = decs[c][j]
        s, msg, aux, value = dec["sigs"][k]
        digest, got_aux = reference.split_consenter_sig_msg(msg)
        ok = verify(pool["keys"][s - 1][1], msg, value) \
            and digest == reference.proposal_digest(
                b"", dec["payload"], dec["metadata"], 0)
        if (aux if ok else None) != dec["expected"][k] or got_aux != aux:
            bad += 1
    return bad


def plant(eng, fault: str | None) -> None:
    """Tests only: break the timed path under the providers.  ``accept``
    (the control): every signature accepted unchecked; ``flip``: the
    first verdict of every launch inverted where the engine produces it;
    ``half``: only the first half of every launch verified, the rest
    accepted."""
    if fault is None:
        return
    inner = eng.verify

    def broken(items):
        if fault == "accept":
            return [True] * len(items)
        if fault == "half":
            h = (len(items) + 1) // 2
            return inner(items[:h]) + [True] * (len(items) - h)
        out = inner(items)
        if fault == "flip" and out:
            out[0] = not out[0]
        return out

    eng.verify = broken


def run(cell) -> dict:
    from smartbft_tpu_torch.crypto.provider import Keyring
    from smartbft_tpu_torch.messages import Proposal, Signature

    cfg, params = cell.cfg, cell.params
    cell.mark("imported")
    pool = build_pool(cfg, params, cell.seed, cell.workers)
    cell.mark("pool_signed")
    keys, me = pool["keys"], pool["me"]
    pubs = {i + 1: k[1] for i, k in enumerate(keys)}
    eng = deploy.engine(cfg, cell.device, pubs.values(), keys[0],
                        params["warm_rungs"])
    cell.mark("engine_warm")
    plant(eng, cell.fault)
    coal = deploy.coalescer(cfg, eng, dedupe=False)
    provider_cls = deploy.provider_class(cfg["scheme"])
    providers = []
    for c in range(params["channels"]):
        p = provider_cls(Keyring(me, keys[0][0], pubs), engine=eng,
                         coalescer=coal)
        p.verify_tag = c
        providers.append(p)
    calls = [[([Signature(signer=s, value=v, msg=m) for s, m, _, v
                in dec["sigs"]], dec) for dec in row]
             for row in pool["decisions"]]
    deploy.zero_counters(eng)
    state = {"stop": False, "done": [], "mismatch": 0, "bad_calls": 0,
             "raised": 0, "submitted": 0, "forged_seen": 0}

    async def client(c: int, first: int) -> None:
        prov, row = providers[c], calls[c]
        j = first
        while not state["stop"]:
            sigs, dec = row[j % len(row)]
            prop = Proposal(header=b"", payload=dec["payload"],
                            metadata=dec["metadata"], verification_sequence=0)
            state["submitted"] += len(sigs)
            try:
                got = await prov.verify_consenter_sigs_batch_async(sigs, prop)
            except Exception:  # noqa: BLE001 — a failed call is counted
                state["raised"] += 1
                continue
            finally:
                j += params["outstanding"]
            want = dec["expected"]
            if got != want:
                state["bad_calls"] += 1
                state["mismatch"] += sum(a != b for a, b in zip(got, want)) \
                    + abs(len(got) - len(want))
            state["forged_seen"] += want.count(None)
            state["done"].append((time.perf_counter(), len(sigs)))

    async def drive() -> dict:
        tasks = [asyncio.ensure_future(client(c, k))
                 for c in range(params["channels"])
                 for k in range(params["outstanding"])]
        await asyncio.sleep(params["warmup_s"])
        cell.setup_done()
        before = deploy.read_counters(eng)
        cell.window.start()
        await asyncio.sleep(cell.seconds)
        cell.window.stop()
        after = deploy.read_counters(eng)
        state["stop"] = True
        await asyncio.gather(*tasks)
        return {"before": before, "after": after}

    marks = asyncio.run(drive())
    cell.read_memory()
    w = cell.window
    in_window = [n for t, n in state["done"] if w.t0 <= t <= w.t1]
    sigs_in_window = sum(in_window)
    bad_reference = reference_check(cfg, pool, params, cell.seed)
    counters = deploy.read_counters(eng)
    checks = [("verdict_mismatches", state["mismatch"], 0),
              ("calls_raised", state["raised"], 0),
              ("reference_disagrees", bad_reference, 0)]
    checks += deploy.verify_plane_checks(
        cfg, counters, coal.fault_snapshot(), state["submitted"],
        kernels=cell.device == "cuda")
    b, a = marks["before"], marks["after"]
    layer = {
        "sigs_verified": a["sigs_verified"] - b["sigs_verified"],
        "slots_used": a["slots_used"] - b["slots_used"],
        "launches": a["launches"] - b["launches"],
        "engine_seconds": a["total_kernel_seconds"] - b["total_kernel_seconds"],
        "keys": cfg["nodes"],
    }
    return {
        "attempted": len(state["done"]) + state["raised"],
        "failed": state["raised"] + state["bad_calls"],
        "e2e": {"verify_sigs_per_s": sigs_in_window / w.seconds},
        "checks": checks,
        "layer": layer,
        "info": {"calls_in_window": len(in_window),
                 "forged_verdicts": state["forged_seen"],
                 "rungs": counters["rung_launches"]},
    }
