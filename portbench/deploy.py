"""What both traffic kinds build from a configuration file: the verify
engine on the card with its keys registered and its rungs warmed, the
shared coalescer, a replica's ``Configuration``, and the counters a run
zeroes after set-up and reads after its window.  The program is imported
here and in the traffic generators only."""

from __future__ import annotations

import dataclasses

from . import signer


def scheme_module(name: str):
    from smartbft_tpu_torch.crypto import ed25519, p256

    return {"p256": p256, "ed25519": ed25519}[name]


def provider_class(name: str):
    from smartbft_tpu_torch.crypto.provider import (
        Ed25519CryptoProvider,
        P256CryptoProvider,
    )

    return {"p256": P256CryptoProvider, "ed25519": Ed25519CryptoProvider}[name]


def configuration(cfg: dict, self_id: int):
    """A replica's ``Configuration``: the program's defaults (SmartBFT's
    ``DefaultConfig``) with the configuration file's ``settings``."""
    from smartbft_tpu_torch.config import Configuration

    return dataclasses.replace(Configuration(self_id=self_id),
                               **cfg["settings"])


def engine(cfg: dict, device: str, pubs, warm_key, rungs):
    """The verify engine of ``cfg``'s scheme on ``device`` with ``pubs``
    registered with its comb route and each rung in ``rungs`` launched
    once, with a signature of ``warm_key`` (a (private, public) pair)."""
    from smartbft_tpu_torch.crypto.provider import TorchVerifyEngine

    scheme = scheme_module(cfg["scheme"])
    eng = TorchVerifyEngine(device=device, scheme=scheme,
                            pad_sizes=tuple(cfg["verify_plane"]["pad_sizes"]))
    eng.prewarm_keys(list(pubs))
    msg = b"portbench-warm"
    sig = signer.sign_many(cfg["scheme"], warm_key[0], [msg])[0]
    eng.prewarm_shapes(scheme.make_item(msg, sig, warm_key[1]), list(rungs))
    return eng


def coalescer(cfg: dict, eng, dedupe: bool):
    """One coalescer over ``eng`` with the configuration's window and the
    program's default fault policy (deadlines, retries, breaker), no host
    fallback engine."""
    from smartbft_tpu_torch.crypto.provider import (
        AsyncBatchCoalescer,
        VerifyFaultPolicy,
    )

    vp = cfg["verify_plane"]
    return AsyncBatchCoalescer(eng, window=vp["coalesce_window_s"],
                               max_batch=vp["max_batch"], dedupe=dedupe,
                               policy=VerifyFaultPolicy())


def launch_counters() -> dict:
    """The signature kernels' launch counters, by route name."""
    from smartbft_tpu_torch.crypto import cuda_comb, cuda_ecdsa, cuda_ed25519
    from smartbft_tpu_torch.crypto import cuda_eddsa

    return {"comb": cuda_comb.LAUNCHES, "generic": cuda_ecdsa.LAUNCHES,
            "ed_comb": cuda_ed25519.LAUNCHES, "ed_generic": cuda_eddsa.LAUNCHES}


#: the launch counter of each scheme's comb kernel
COMB_COUNTER = {"p256": "comb", "ed25519": "ed_comb"}


def zero_counters(eng) -> None:
    from smartbft_tpu_torch.crypto.provider import VerifyStats

    eng.stats = VerifyStats()
    eng.rung_launches.clear()
    eng.route_launches.update(comb=0, generic=0)
    for c in launch_counters().values():
        c.reset()


def read_counters(eng) -> dict:
    st = eng.stats
    return {
        "launches": st.launches, "sigs_verified": st.sigs_verified,
        "slots_used": st.slots_used,
        "total_kernel_seconds": st.total_kernel_seconds,
        "rung_launches": {str(k): v for k, v in
                          sorted(eng.rung_launches.items())},
        "route_launches": dict(eng.route_launches),
        "kernels": {k: (c.launches, c.lanes)
                    for k, c in launch_counters().items()},
    }


def verify_plane_checks(cfg: dict, counters: dict, breaker: dict,
                        submitted: int | None, kernels: bool) -> list[tuple]:
    """The checks every cell makes of its verify plane: (name, value,
    limit), each passing when value <= limit.  The breaker never opened
    and no wave went to a host engine or failed; every launch took the
    comb route; with ``kernels`` (the card: the plain versions count no
    launches), only the scheme's comb kernel ran and its lanes are the
    engine's slots, which cover the engine's signatures; with
    ``submitted``, the engine verified exactly the signatures the callers
    submitted."""
    out = [
        ("breaker_opens", breaker["opens"], 0),
        ("host_fallback_waves", breaker["host_fallback_batches"], 0),
        ("launch_failures", breaker["launch_failures"], 0),
        ("generic_route_launches", counters["route_launches"]["generic"], 0),
    ]
    if kernels:
        counter = COMB_COUNTER[cfg["scheme"]]
        lanes = counters["kernels"][counter][1]
        other = sum(v[0] for k, v in counters["kernels"].items()
                    if k != counter)
        out += [
            ("other_kernel_launches", other, 0),
            ("lanes_not_slots", abs(lanes - counters["slots_used"]), 0),
            ("sigs_outside_lanes",
             max(counters["sigs_verified"] - lanes, 0), 0),
        ]
    if submitted is not None:
        out.append(("sigs_not_verified",
                    abs(submitted - counters["sigs_verified"]), 0))
    return out
