"""Signer/Verifier crypto providers and the verify plane.

The crypto seam of the protocol core:

* :class:`Keyring` — node-id -> public key registry + own private key.
* :class:`CryptoProvider` / :class:`P256CryptoProvider` /
  :class:`Ed25519CryptoProvider` / :class:`BlsCryptoProvider` — the crypto
  subset of the Verifier/Signer SPI.  Signing is host-side (one signature
  per decision; never hot).  Verification goes through a pluggable engine:
    - :class:`HostVerifyEngine`  — pure-Python ints; the CPU floor, and
      the breaker's fallback where a caller passes one explicitly.
    - :class:`TorchVerifyEngine` — pads votes into fixed-size lanes and runs
      ONE CUDA kernel launch per flush: the comb kernel for registered keys,
      the generic kernel for a chunk that holds an unregistrable key, for
      P-256 or Ed25519; the pairing kernel for BLS12-381.
* :class:`AsyncBatchCoalescer` — merges concurrent quorum checks (across
  sequences, replicas and view-change validations) into shared launches,
  with dedupe, per-tag attribution, the occupancy-aware flush hold, the
  view-flip warm path, and the deadline / retry / breaker / canary fault
  machinery.

Wire format of a consenter signature (Signature.msg): canonical encoding of
:class:`ConsenterSigMsg` binding the proposal digest and the auxiliary data.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..codec import decode, encode, wiremsg
from ..csrc import KernelBuildError, KernelLaunchError
from ..messages import Proposal, Signature
from ..types import VerifyPlaneDown, proposal_digest
from ..utils.memo import LruMemo
from ..utils.tasks import create_logged_task
from . import bls12381, ed25519, p256
from .cuda_bls import bls_verify, verify_words
from .cuda_comb import CombRegistryFull, CombVerifier
from .cuda_ecdsa import ecdsa_verify
from .cuda_ed25519 import Ed25519CombVerifier
from .cuda_eddsa import eddsa_verify

#: faults of a kernel itself: the verify plane raises them as they are,
#: never retrying them or moving the wave to a host engine
KERNEL_ERRORS = (KernelBuildError, KernelLaunchError)


@wiremsg
class ConsenterSigMsg:
    """The exact bytes a consenter signs for a commit vote."""

    proposal_digest: str = ""
    aux: bytes = b""


class Keyring:
    """Public keys of all replicas + this replica's private key.

    Key types are scheme-opaque: P-256 uses (int, (qx, qy)); Ed25519 uses
    (bytes, bytes).  The keyring never interprets them — only the scheme
    module does.
    """

    def __init__(self, self_id: int, private_key,
                 public_keys: dict[int, object]):
        self.self_id = self_id
        self.private_key = private_key
        self.public_keys = dict(public_keys)

    @classmethod
    def generate(cls, node_ids: Sequence[int], seed: bytes = b"smartbft",
                 scheme=p256):
        """Deterministic keyring set for tests/benches: one per node id."""
        keys = {nid: scheme.keygen(seed + b"-%d" % nid) for nid in node_ids}
        return {
            nid: cls(nid, keys[nid][0], {n: k[1] for n, k in keys.items()})
            for nid in node_ids
        }


# ---------------------------------------------------------------------------
# verify engines
# ---------------------------------------------------------------------------

@dataclass
class VerifyStats:
    """Batch-occupancy + latency accounting (BASELINE.md metrics).

    ``metrics``: optionally the embedder's crypto metrics bundle
    (``MetricsBundle.tpu``) — every record() then also feeds the embedder's metrics
    provider (batch-fill histogram, per-sig latency, counters)."""

    launches: int = 0
    sigs_verified: int = 0
    slots_used: int = 0
    total_kernel_seconds: float = 0.0
    metrics: object = None

    def record(self, n_sigs: int, n_slots: int, seconds: float) -> None:
        self.launches += 1
        self.sigs_verified += n_sigs
        self.slots_used += n_slots
        self.total_kernel_seconds += seconds
        if self.metrics is not None:
            self.metrics.count_batches.add(1)
            self.metrics.count_sigs_verified.add(n_sigs)
            if n_slots:
                self.metrics.batch_fill_percent.observe(100.0 * n_sigs / n_slots)
            if n_sigs:
                self.metrics.verify_latency_per_sig_us.observe(
                    1e6 * seconds / n_sigs
                )

    @property
    def batch_fill_pct(self) -> float:
        return 100.0 * self.sigs_verified / self.slots_used if self.slots_used else 0.0

    @property
    def us_per_sig(self) -> float:
        if not self.sigs_verified:
            return 0.0
        return 1e6 * self.total_kernel_seconds / self.sigs_verified


@dataclass
class MeshVerifyStats(VerifyStats):
    """VerifyStats for a device-mesh engine: every record also accounts
    pad waste and per-device launch fill (a batch-axis-partitioned wave
    places its items contiguously, so padding lands on the TAIL devices —
    the per-device fill vector makes that visible instead of hiding it in
    the overall mean).  Exported through ``MeshVerifyEngine.mesh_snapshot``
    into the coalescer's ``mesh_snapshot``."""

    devices: int = 1
    pad_slots: int = 0
    launches_spanning_all_devices: int = 0
    last_device_fill_pct: list = field(default_factory=list)

    def record(self, n_sigs: int, n_slots: int, seconds: float,
               per_device: Optional[list] = None) -> None:
        """``per_device``: the engine's actual per-device item counts for
        this launch (the strided-placement engine reports them exactly);
        None falls back to the contiguous-placement model (items fill
        devices front to back, padding on the tail)."""
        super().record(n_sigs, n_slots, seconds)
        pad = max(n_slots - n_sigs, 0)
        self.pad_slots += pad
        per_dev = max(1, n_slots // max(1, self.devices))
        if per_device is not None:
            fills = [round(100.0 * got / per_dev, 1) for got in per_device]
        else:
            fills = []
            for d in range(self.devices):
                got = min(max(n_sigs - d * per_dev, 0), per_dev)
                fills.append(round(100.0 * got / per_dev, 1))
        self.last_device_fill_pct = fills
        if fills and min(fills) > 0:
            self.launches_spanning_all_devices += 1
        m = self.metrics
        if m is not None and hasattr(m, "count_mesh_launches"):
            m.count_mesh_launches.add(1)
            m.count_mesh_pad_slots.add(pad)
            if fills:
                m.mesh_device_fill_percent.observe(min(fills))

    def mesh_block(self, capacity: int = 0) -> dict:
        """The JSON-able engine half of the ``mesh`` block."""
        return {
            "devices": self.devices,
            "launches": self.launches,
            "items": self.sigs_verified,
            "slots": self.slots_used,
            "fill_pct": round(self.batch_fill_pct, 1),
            "pad_slots": self.pad_slots,
            "pad_waste_pct": round(100.0 * self.pad_slots / self.slots_used, 1)
            if self.slots_used else 0.0,
            "capacity_items_per_launch": int(capacity),
            "device_fill_pct_last": list(self.last_device_fill_pct),
            "launches_spanning_all_devices": self.launches_spanning_all_devices,
        }


class LaunchTimeout(Exception):
    """A coalescer flush exceeded its launch deadline.  The wave was
    abandoned: the worker thread keeps running, but its late result is
    discarded on arrival (counted in VerifyFaultStats)."""


class VerifyResultMismatch(RuntimeError):
    """An engine returned a different number of results than it was given
    items.  Silently slicing such a batch would mis-assign verdicts across
    every coalesced submitter, so the wave fails loudly instead and the
    mismatch counts as a launch failure."""


@dataclass(frozen=True)
class VerifyFaultPolicy:
    """Fault-tolerance knobs for the verify plane.

    All durations are WALL-CLOCK seconds (the engine runs on worker
    threads, outside any logical test clock).  ``launch_timeout`` is the
    per-flush deadline (None disables deadlines); ``launch_retries`` is
    how many times a failed/timed-out wave is re-submitted with
    exponential backoff (+ jitter) before falling back to the host engine;
    ``breaker_threshold`` consecutive launch failures trip the
    host-fallback circuit breaker open (a permanent kernel error trips it
    immediately); while open, a background canary probe re-tries the
    device every ``probe_interval`` seconds (backing off to
    ``probe_backoff_max``) and flips the breaker closed on success.
    """

    launch_timeout: Optional[float] = 30.0
    launch_retries: int = 2
    backoff_base: float = 0.05
    backoff_max: float = 2.0
    backoff_jitter: float = 0.5
    breaker_threshold: int = 3
    probe_interval: float = 2.0
    probe_backoff_max: float = 30.0

    @classmethod
    def from_config(cls, config) -> "VerifyFaultPolicy":
        """Map the Configuration.verify_* knobs onto a policy."""
        return cls(
            launch_timeout=config.verify_launch_timeout,
            launch_retries=config.verify_launch_retries,
            breaker_threshold=config.verify_breaker_threshold,
            probe_interval=config.verify_probe_interval,
        )


@dataclass
class TagStats:
    """Per-tag (per-shard) attribution of coalesced verify traffic."""

    items: int = 0       # verify items this tag submitted
    waves: int = 0       # flushes containing >=1 of this tag's items
    solo_waves: int = 0  # flushes containing ONLY this tag's items


@dataclass
class ShardAttribution:
    """Wave-composition accounting for a shared coalescer.

    The sharded deployment's whole point is that one device launch carries
    verify items from MANY consensus groups (cross-shard fill); these
    counters make that measured instead of asserted.  Tags are opaque
    (shard ids in practice); untagged submissions are legal and only
    counted in ``waves``.  Updated at flush time — when the wave's
    composition is fixed — so failed launches still attribute."""

    waves: int = 0          # coalesced flushes total
    tagged_waves: int = 0   # flushes with >=1 tagged submission
    mixed_waves: int = 0    # flushes mixing >=2 distinct tags — the
    #                         cross-shard-coalescing witness
    max_tags_in_wave: int = 0
    per_tag: dict = field(default_factory=dict)

    def note_wave(self, futures) -> None:
        self.waves += 1
        counts: dict = {}
        for entry in futures:
            _fut, _start, n, tag = entry
            if tag is None:
                continue
            counts[tag] = counts.get(tag, 0) + n
        if not counts:
            return
        self.tagged_waves += 1
        if len(counts) >= 2:
            self.mixed_waves += 1
        self.max_tags_in_wave = max(self.max_tags_in_wave, len(counts))
        for tag, n in counts.items():
            st = self.per_tag.get(tag)
            if st is None:
                st = self.per_tag[tag] = TagStats()
            st.items += n
            st.waves += 1
            if len(counts) == 1:
                st.solo_waves += 1

    def snapshot(self) -> dict:
        """JSON-able block for bench rows and the tier-1 coalescing gate."""
        return {
            "waves": self.waves,
            "tagged_waves": self.tagged_waves,
            "mixed_waves": self.mixed_waves,
            "max_tags_in_wave": self.max_tags_in_wave,
            "per_tag": {
                str(tag): {"items": st.items, "waves": st.waves,
                           "solo_waves": st.solo_waves}
                for tag, st in sorted(self.per_tag.items(), key=lambda kv: str(kv[0]))
            },
        }


@dataclass
class FlushHoldStats:
    """Occupancy-aware flush-gating accounting.

    Every decision the gate takes is exported (``mesh_snapshot``'s
    ``hold`` block rides every bench row): how many waves were held, for
    how long, how many items the holds actually gained (``depth_gain``
    — the wave-deepening payoff), and the two bounded-latency outs —
    holds that ran out the hard ``verify_flush_hold`` deadline and
    flushes that skipped the hold because the breaker was open (host
    fallback must never wait on device-occupancy predictions)."""

    waves_held: int = 0
    held_ms: float = 0.0
    depth_gain_items: int = 0
    deadline_expired: int = 0
    breaker_bypass: int = 0

    def snapshot(self, hold_s: float) -> dict:
        return {
            "hold_s": float(hold_s),
            "waves_held": self.waves_held,
            "held_ms": round(self.held_ms, 2),
            "depth_gain_items": self.depth_gain_items,
            "deadline_expired": self.deadline_expired,
            "breaker_bypass": self.breaker_bypass,
        }


class TagRateTracker:
    """Per-tag submit-cadence tracking: the occupancy signal behind
    flush gating (a drain-rate EWMA pointed at ARRIVALS).

    Each ``submit(tag=...)`` notes wall time; the inter-submit gap per
    tag folds into an EWMA.  :meth:`any_imminent` answers the gate's one
    question — does any recently-live tag plausibly deliver another wave
    within the remaining hold budget?  A tag is *live* while the time
    since its last submit is within ``slack`` expected gaps (cold tags
    borrow the coalescer window as their gap estimate), and *imminent*
    while its predicted next arrival fits in the remaining budget.
    Untagged submissions track under ``None`` — single-group
    deployments still deepen their waves."""

    __slots__ = ("_last", "_ewma", "slack", "default_gap")

    #: tags silent this long are evicted outright — far beyond any
    #: plausible hold budget (sub-second), so eviction can never hide a
    #: tag a live hold could still be waiting for.  Bounds both memory
    #: and the any_imminent scan under shard churn (the autoscaler
    #: retires shard ids over a long-lived process's life).
    EVICT_AFTER = 60.0
    #: dict size that triggers an eviction sweep in note() — sweeps are
    #: O(tags) but amortized across at least this many submits
    EVICT_SWEEP_AT = 128

    def __init__(self, default_gap: float = 0.002, slack: float = 4.0):
        self._last: dict = {}
        self._ewma: dict = {}
        self.slack = slack
        self.default_gap = default_gap

    def note(self, tag, now: float) -> None:
        prev = self._last.get(tag)
        if prev is not None:
            gap = max(now - prev, 1e-6)
            # sub-window gaps are the SAME logical wave (a shard's n
            # replicas submit the same quorum check within microseconds)
            # — folding them in would teach the tracker a microsecond
            # "cadence" and make every tag look quiet the moment its
            # burst ends; only inter-wave gaps carry cadence signal
            if gap >= self.default_gap:
                old = self._ewma.get(tag)
                self._ewma[tag] = gap if old is None \
                    else 0.5 * old + 0.5 * gap
        elif len(self._last) >= self.EVICT_SWEEP_AT:
            # a NEW tag on a full tracker: sweep out long-dead tags so
            # retired shards can never grow the dict without bound
            dead = [t for t, ts in self._last.items()
                    if now - ts > self.EVICT_AFTER]
            for t in dead:
                del self._last[t]
                self._ewma.pop(t, None)
        self._last[tag] = now

    def any_imminent(self, now: float, remaining: float,
                     budget: Optional[float] = None) -> bool:
        if budget is None:
            budget = self.slack * self.default_gap
        for tag, last in self._last.items():
            gap = self._ewma.get(tag)
            if gap is None:
                # cold tag (one submit seen, no cadence yet): stay
                # optimistic within the hold budget — the hard deadline
                # bounds the cost, and a second wave teaches the cadence
                if now - last <= budget:
                    return True
                continue
            if now - last > self.slack * gap:
                continue  # tag went quiet — stop predicting it
            # overdue counts as "any moment now"; otherwise the predicted
            # arrival must fit inside what is left of the hold budget
            if last + gap <= now + remaining:
                return True
        return False


@dataclass
class VerifyFaultStats:
    """Plain counters for the fault machinery — introspectable without a
    metrics provider; benches export them in every JSON row."""

    launch_failures: int = 0
    launch_timeouts: int = 0
    retries: int = 0
    breaker_opens: int = 0
    breaker_closes: int = 0
    host_fallback_batches: int = 0
    probe_attempts: int = 0
    probe_successes: int = 0
    abandoned_late_arrivals: int = 0


class HostVerifyEngine:
    """Sequential pure-Python verification — the CPU baseline engine."""

    # sequential engine: coalescing gains nothing, don't add window latency
    preferred_coalesce_window = 0.0

    def __init__(self, scheme=p256, metrics=None) -> None:
        self.scheme = scheme
        self.stats = VerifyStats(metrics=metrics)
        self._lock = threading.Lock()

    def _verify_one(self, item) -> bool:
        """Per-item hook; subclasses swap in other sequential backends."""
        return self.scheme.verify_item(item)

    def verify(self, items) -> list[bool]:
        t0 = time.perf_counter()
        out = [self._verify_one(item) for item in items]
        dt = time.perf_counter() - t0
        with self._lock:
            self.stats.record(len(items), len(items), dt)
        return out


def _generic_launch(kernel, arrays, size: int, device) -> torch.Tensor:
    """One generic-kernel launch on host arrays zero-padded to ``size``
    lanes (a padding lane fails: zero r, s for P-256, ok = 0 for Ed25519
    and BLS12-381)."""
    n = arrays[0].shape[0]
    return kernel(*(torch.from_numpy(np.concatenate(
        [a, np.zeros((size - n,) + a.shape[1:], a.dtype)])).to(device)
        for a in arrays))


#: per scheme: the comb verifier (registered keys; None for BLS12-381,
#: whose pairing kernel takes any key), and the generic route's host
#: marshalling and kernel (any key)
_ROUTES = {p256: (CombVerifier, p256.verify_bytes, ecdsa_verify),
           ed25519: (Ed25519CombVerifier, ed25519.verify_inputs,
                     eddsa_verify),
           bls12381: (None, verify_words, bls_verify)}


def on_device(device):
    """The context a launch on ``device`` runs in: that card made current
    (a kernel launches on the current device), nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class TorchVerifyEngine:
    """Padded, batched signature verification on the CUDA card.

    Every chunk pads up to the next rung of ``pad_sizes`` and runs as ONE
    kernel launch: the scheme's comb kernel when every signer key is
    registrable, else its generic kernel — for P-256 :mod:`.cuda_comb` /
    :mod:`.cuda_ecdsa`, for Ed25519 :mod:`.cuda_ed25519` /
    :mod:`.cuda_eddsa`.  That routing is semantics (a key beyond the comb
    registry's 128, or one that does not decode), not error handling: a
    build or launch error raises to the caller.  BLS12-381 has no comb
    route: every chunk is one launch of the pairing kernel
    (:mod:`.cuda_bls`), counted as ``generic``; a lane is one signature or
    one aggregated quorum.

    ``device="cuda"`` is the default and raises when no card is visible;
    ``device="cpu"`` runs the kernels' plain-torch versions (tests).
    Thread-safe: the coalescer calls :meth:`verify` from worker threads.
    The mesh engines of :mod:`smartbft_tpu_torch.parallel` are this engine
    over several devices, one comb verifier (registry and tables) each.
    """

    preferred_coalesce_window = 0.002  # batched engine: wait for fan-in

    def __init__(self, device="cuda",
                 pad_sizes: Sequence[int] = (8, 32, 128, 512, 2048, 4096,
                                             8192, 16384),
                 scheme=p256, metrics=None):
        """``pad_sizes``: the top rung bounds how much of a large cluster's
        quorum wave one launch absorbs (n=128 -> 10880 signatures).
        ``scheme``: :mod:`.p256`, :mod:`.ed25519` or :mod:`.bls12381`."""
        self._init_plane([torch.device(device)], pad_sizes, scheme, metrics,
                         _ROUTES.get(scheme))

    def _init_plane(self, devices, pad_sizes, scheme, metrics, route) -> None:
        """Set the engine up over ``devices`` (the first one is
        :attr:`device`) with ``route``: (comb verifier class or None,
        generic host marshalling, generic kernel)."""
        if route is None:
            raise ValueError(f"{type(self).__name__}: no kernels for scheme "
                             f"{getattr(scheme, '__name__', scheme)}")
        if any(d.type == "cuda" for d in devices) \
                and not torch.cuda.is_available():
            raise RuntimeError(
                f"{type(self).__name__}: CUDA is not available; pass "
                "device='cpu' to run the plain-torch versions")
        self.device = devices[0]
        self._devices = list(devices)
        self.scheme = scheme
        comb_cls, self._generic_inputs, self._generic_kernel = route
        self.pad_sizes = tuple(sorted(pad_sizes))
        #: one comb verifier a device (its own registry, tables uploaded
        #: to its own device); None for a scheme without a comb route
        self._combs = [comb_cls(d) if comb_cls is not None else None
                       for d in devices]
        self._comb = self._combs[0]
        self._lock = threading.Lock()
        #: plain-torch launches (a CPU device) run one at a time: several
        #: coalescers launching at once only contend for the interpreter
        #: (four concurrent P-256 comb launches took ~28 s against ~1 s
        #: each alone on an 8-core host)
        self._host_launch = threading.Lock()
        self.stats = VerifyStats(metrics=metrics)
        #: launches per pad rung, and per kernel route ("comb"/"generic")
        self.rung_launches: dict[int, int] = {}
        self.route_launches: dict[str, int] = {"comb": 0, "generic": 0}

    def _pad_to(self, n: int) -> int:
        for s in self.pad_sizes:
            if n <= s:
                return s
        return self.pad_sizes[-1]

    def verify(self, items) -> list[bool]:
        """items: scheme.make_item tuples -> validity per item."""
        if not items:
            return []
        out: list[bool] = []
        # oversized batches run in chunks of the largest lane size
        cap = self.pad_sizes[-1]
        for off in range(0, len(items), cap):
            out.extend(self._verify_chunk(items[off : off + cap]))
        return out

    def prewarm_keys(self, pubs) -> None:
        """Register a known key set (e.g. the whole keyring) with every
        device's comb registry up front (no registry for BLS12-381)."""
        pubs = list(pubs)
        for comb in self._combs:
            if comb is not None:
                comb.prewarm_keys(pubs)

    def prewarm_shapes(self, item, sizes: Optional[Sequence[int]] = None) -> None:
        """Run every pad rung once with copies of ``item`` (a verify item
        whose key is registrable), so the kernel build and the table upload
        happen before protocol traffic."""
        for size in (self.pad_sizes if sizes is None else sizes):
            self.verify([item] * size)

    def _launch(self, d: int, items, size: int):
        """One kernel launch on device ``d`` of the plane: ``items``
        zero-padded to ``size`` lanes, on the comb route when the device's
        registry takes every key, else the generic one.  Returns the
        (len(items),) mask on the device, not yet read, and the route."""
        comb = self._combs[d]
        mask = comb.verify(items, size) if comb is not None else None
        if mask is not None:
            return mask, "comb"
        mask = _generic_launch(self._generic_kernel,
                               self._generic_inputs(items), size,
                               self._devices[d])
        return mask[:len(items)], "generic"

    def _record(self, n: int, size: int, seconds: float, routes: list,
                per_device: Optional[list] = None) -> None:
        """Account one logical launch of ``size`` slots for ``n`` items,
        made of the device launches whose routes are ``routes``
        (``per_device``: its real items by device, for mesh stats)."""
        with self._lock:
            if per_device is None:
                self.stats.record(n, size, seconds)
            else:
                self.stats.record(n, size, seconds, per_device=per_device)
            self.rung_launches[size] = self.rung_launches.get(size, 0) + 1
            for route in routes:
                self.route_launches[route] += 1

    def _verify_chunk(self, items) -> list[bool]:
        n = len(items)
        size = self._pad_to(n)
        t0 = time.perf_counter()
        with self._host_launch if self.device.type == "cpu" \
                else contextlib.nullcontext():
            mask, route = self._launch(0, items, size)
            out = [bool(v) for v in mask.cpu().tolist()]  # waits for the kernel
        self._record(n, size, time.perf_counter() - t0, [route])
        return out


def prewarm_verify_engine(engine, scheme=None,
                          sizes: Optional[Sequence[int]] = None) -> None:
    """Run every pad-ladder rung of ``engine`` once with a generated probe
    item, so kernel builds, table uploads and first launches happen before
    protocol traffic.  No-op for engines without a pad ladder."""
    prewarm = getattr(engine, "prewarm_shapes", None)
    if prewarm is None:
        return
    scheme = scheme if scheme is not None else engine.scheme
    sk, pub = scheme.keygen(b"smartbft-prewarm-probe")
    item = scheme.make_item(b"p", scheme.sign_raw(sk, b"p"), pub)
    prewarm(item, sizes)


class AsyncBatchCoalescer:
    """Merges concurrent verify calls into shared kernel launches.

    The protocol core awaits ``submit(items)``; submissions that arrive
    within ``window`` seconds (or until ``max_batch`` fills) are flushed as
    one engine call on a worker thread.  This is the batched analog of the
    reference's per-signature goroutine fan-out — except the fan-*in* is
    explicit, so one launch serves many sequences and replicas.
    """

    def __init__(self, engine, window: float = 0.002, max_batch: int = 2048,
                 dedupe: bool = False,
                 policy: Optional[VerifyFaultPolicy] = None,
                 fallback_engine=None, metrics=None,
                 hold: Optional[float] = None, sleep=None):
        """``dedupe``: verify each DISTINCT item once per flush and fan the
        verdict out to every submitter.  Verification is a pure function of
        (message, signature, key), so this is sound; it pays off when many
        colocated replicas share one engine — a quorum wave then contains
        each commit signature up to n times (every replica checks the same
        votes), and deduplication collapses an n*(quorum-1) wave to at most
        n distinct lanes.  The reference never shares a verifier across
        replicas, so it has no analogous seam (view.go:537-541 is
        per-replica fan-out).  Off by default: single-replica engines see
        no repeats, and the dict pass would be pure overhead.

        ``policy``: a :class:`VerifyFaultPolicy` arming launch deadlines,
        retry/backoff, and the host-fallback circuit breaker.  None keeps
        the legacy contract: one attempt, failures surface to submitters as
        plain RuntimeError.  With a policy, transient failures are retried,
        exhausted waves route to ``fallback_engine`` when the caller passed
        one (consensus keeps committing at CPU speed, counted in
        ``host_fallback_batches``), and a wave that exhausts retries and any
        fallback raises :class:`~smartbft_tpu_torch.types.VerifyPlaneDown`.
        A kernel build or launch error is never retried nor degraded: it
        reaches the submitters as it was raised.
        ``metrics``: an optional crypto metrics bundle counting launch
        failures/timeouts/retries and breaker transitions.

        ``hold``: occupancy-aware flush gating (the
        ``Configuration.verify_flush_hold`` knob).  When > 0, a flush
        whose wave is below a pad-ladder rung briefly HOLDS — up to
        ``hold`` wall-clock seconds, the hard latency bound — while the
        per-tag submit-rate tracker predicts more waves inbound, so one
        deeper launch replaces several shallow ones (a launch has a fixed
        overhead).  The hold never engages when the breaker is open (host
        fallback must not wait), never past ``max_batch``, and flushes the
        moment the wave lands exactly on a rung (zero pad waste beats more
        depth).  None/0 keeps the eager-window contract.

        ``sleep``: the coroutine function the coalescing window waits
        with: ``asyncio.sleep`` (the wall clock) by default; a logical
        scheduler's :meth:`~smartbft_tpu_torch.utils.clock.Scheduler.sleep`
        puts the window on the logical clock, so a test counts waves
        independently of the host's speed."""
        self.engine = engine
        self._sleep = asyncio.sleep if sleep is None else sleep
        self.window = window
        self.max_batch = max_batch
        self.dedupe = dedupe
        self.policy = policy
        #: a constructor-supplied policy is EXPLICIT and never overridden;
        #: defaulted/config-wired policies stay re-wirable (configure())
        self._policy_explicit = policy is not None
        self.fallback_engine = fallback_engine
        self.metrics = metrics
        if metrics is not None:
            metrics.breaker_state.set(0.0)  # healthy until proven otherwise
        self.fault_stats = VerifyFaultStats()
        self.shard_stats = ShardAttribution()
        #: occupancy-aware flush gating: hold budget seconds (0 = eager
        #: flushing), per-tag arrival tracker, and the exported decision
        #: accounting.  A constructor-supplied hold is EXPLICIT like a
        #: constructor policy (configure_hold never overrides it);
        #: config-wired holds stay re-wirable.
        self.hold = float(hold) if hold else 0.0
        self._hold_explicit = hold is not None
        self.hold_stats = FlushHoldStats()
        self._tag_rates = TagRateTracker(default_gap=max(window, 0.001))
        self.mesh_configured = 0   # Configuration.verify_mesh_devices wired
        self.mesh_downgrades = 0   # loud unbuildable-mesh downgrades
        #: (width, topology) of the last downgrade: a colocated replica
        #: wiring the same unbuildable mesh counts no second one
        self.mesh_downgraded_for: Optional[tuple] = None
        #: flight recorder (obs.TraceRecorder; nop singleton when tracing
        #: is off) — verify enqueue/hold/launch spans + breaker
        #: transitions, correlated by a per-coalescer launch id.  Shared
        #: like the breaker: ONE recorder serves every colocated shard.
        from ..obs.recorder import NOP_RECORDER

        self.recorder = NOP_RECORDER
        self._launch_seq = 0
        self._pending: list[tuple] = []
        self._futures: list[tuple[asyncio.Future, int, int, object]] = []
        self._flush_scheduled = False
        self._launch_inflight = False
        self._lock = asyncio.Lock()
        self._log = logging.getLogger("smartbft_tpu_torch.crypto")
        self._breaker_is_open = False
        self._consecutive_failures = 0
        self._probe_task: Optional[asyncio.Task] = None
        #: a known-well-formed item from the last wave, re-verified by the
        #: breaker probe as the device-health canary
        self._canary: Optional[tuple] = None
        #: flip-warm mode: until this wall-clock instant the plane flushes
        #: EAGERLY — no coalescing window, no occupancy hold.  Armed by
        #: note_view_flip when a view change installs a new view: the
        #: device idled through the depose, and the flip's first
        #: deep-window waves must launch at once so the stalled backlog
        #: lands on a warm plane instead of re-paying the batching latency
        #: it was tuned for in steady state.
        self._warm_until = 0.0
        self.flip_warms = 0
        self.flip_warm_bypasses = 0

    # -- late wiring ---------------------------------------------------------

    def configure(self, policy: Optional[VerifyFaultPolicy] = None,
                  fallback_engine=None, metrics=None,
                  explicit: bool = False) -> None:
        """Late fault-plane wiring (the Consensus facade calls this at
        start AND on every reconfig with Configuration-derived values).

        A policy supplied at construction is explicit and is never
        overridden; a defaulted or previously config-wired policy IS
        replaced, so Configuration.verify_* knobs (and reconfigs carrying
        new ones) actually reach the plane.  Fallback engine and metrics
        fill only when unset — the coalescer may be shared across
        colocated replicas and churning instances would be pointless."""
        if policy is not None and (explicit or not self._policy_explicit):
            self.policy = policy
            self._policy_explicit = self._policy_explicit or explicit
        if fallback_engine is not None and self.fallback_engine is None:
            self.fallback_engine = fallback_engine
        if metrics is not None and self.metrics is None:
            self.metrics = metrics
            self.metrics.breaker_state.set(1.0 if self._breaker_is_open else 0.0)

    def attach_recorder(self, recorder) -> None:
        """Point the verify plane's trace events at ``recorder`` (the
        harness/embedder wires this when tracing is on; the default nop
        recorder keeps the hot path at one attribute read per site)."""
        from ..obs.recorder import NOP_RECORDER

        self.recorder = recorder if recorder is not None else NOP_RECORDER

    def configure_hold(self, hold: Optional[float],
                       explicit: bool = False) -> None:
        """Late flush-gating wiring (``Consensus._wire_verify_plane``
        applies ``Configuration.verify_flush_hold`` here at start and on
        every reconfig).  Same precedence contract as :meth:`configure`:
        a constructor-supplied hold is explicit and never overridden; a
        defaulted or previously config-wired one IS replaced."""
        if hold is None:
            return
        if explicit or not self._hold_explicit:
            self.hold = max(0.0, float(hold))
            self._hold_explicit = self._hold_explicit or explicit

    #: how long flip-warm mode lasts (wall seconds): long enough for the
    #: new view's first deep windows to stage and launch their quorum
    #: waves, short enough that steady-state coalescing resumes within
    #: the same failover transient
    FLIP_WARM_SPAN = 0.25

    def note_view_flip(self, span: Optional[float] = None) -> None:
        """A view change just installed a new view: flush any pending
        wave immediately and run windowless/holdless for ``span``
        seconds.  Safe from any caller on the event loop; a caller
        without a running loop (unit code) just arms the mode."""
        self._warm_until = time.monotonic() + (
            span if span is not None else self.FLIP_WARM_SPAN
        )
        self.flip_warms += 1
        rec = self.recorder
        if rec.enabled:
            rec.record("verify.flip_warm", extra={"pending": len(self._pending)})
        if self._pending and not self._launch_inflight:
            # flush NOW even when a windowed flush is already parked in
            # its sleep: the immediate task swaps the batch out and the
            # stale sleeper later wakes to an empty (or fresher) batch —
            # exactly the race _flush_after is already written to absorb.
            # Probe for the loop BEFORE building the coroutine: a no-loop
            # caller just arms the mode (the next submit flushes eagerly),
            # and an abandoned coroutine would warn "never awaited".
            try:
                asyncio.get_running_loop()
            except RuntimeError:
                return
            create_logged_task(
                self._flush_after(0.0), name="coalescer-flush-flip"
            )
            self._flush_scheduled = True

    def note_view_depose(self, span: Optional[float] = None) -> None:
        """The current view is being torn down for a view change: same
        eager-flush transient as the flip — in-window waves already
        handed to the plane launch NOW instead of idling in the
        coalescing window/hold while the view-change sub-protocol runs,
        so the plane stays busy through the depose and the flip lands
        warm."""
        self.note_view_flip(span)

    def _flip_warm(self) -> bool:
        return time.monotonic() < self._warm_until

    @property
    def breaker_open(self) -> bool:
        return self._breaker_is_open

    def fault_snapshot(self) -> dict:
        """One JSON-able dict for bench rows: breaker state + fault counts,
        so a degraded run is never silently reported as a device run."""
        s = self.fault_stats
        return {
            "policy_configured": self.policy is not None,
            "open": self._breaker_is_open,
            "degraded": self._breaker_is_open or s.host_fallback_batches > 0,
            "opens": s.breaker_opens,
            "closes": s.breaker_closes,
            "launch_failures": s.launch_failures,
            "launch_timeouts": s.launch_timeouts,
            "retries": s.retries,
            "host_fallback_batches": s.host_fallback_batches,
            "probe_attempts": s.probe_attempts,
            "probe_successes": s.probe_successes,
            "abandoned_late_arrivals": s.abandoned_late_arrivals,
            # view-flip warm transients (eager windowless flushing) and
            # the occupancy holds they bypassed
            "flip_warms": self.flip_warms,
            "flip_warm_bypasses": self.flip_warm_bypasses,
        }

    def shard_snapshot(self) -> dict:
        """Wave-composition attribution (see :class:`ShardAttribution`)."""
        return self.shard_stats.snapshot()

    def mesh_snapshot(self) -> dict:
        """The ``mesh`` block: which verify plane ran (single device or an
        N-device mesh), per-launch fill per device, pad waste, and the
        loud-downgrade count — so a run measured on a downgraded
        single-device plane is never mistaken for a mesh run.
        ``shard_map_available`` keeps the JAX package's key: the port's
        quorum step needs no optional API, so it is always True.  ``hold``
        is the occupancy-aware flush gate's accounting: every hold it
        took, its cost, and its depth payoff."""
        eng = self.engine
        devices = int(getattr(eng, "devices", 0))
        out = {
            "enabled": devices > 0,
            "devices": devices if devices > 0 else 1,
            "configured_devices": self.mesh_configured,
            "downgrades": self.mesh_downgrades,
            "topology": getattr(eng, "topology", "1d"),
            "hold": self.hold_stats.snapshot(self.hold),
        }
        from ..parallel.engine import shard_map_available

        out["shard_map_available"] = shard_map_available()
        snap = getattr(eng, "mesh_snapshot", None)
        if snap is not None:
            try:
                out.update(snap())
            except Exception:  # noqa: BLE001 — a stats hiccup must not
                pass           # poison a snapshot
        return out

    async def submit(self, items, tag=None) -> list[bool]:
        """``tag``: opaque attribution label (the submitter's shard id in
        sharded mode) — flush composition is tracked per tag in
        :attr:`shard_stats`, so cross-shard launch mixing is measurable."""
        if not items:
            return []
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        rec = self.recorder
        if rec.enabled:
            rec.record("verify.enqueue",
                       extra={"items": len(items), "tag": str(tag)})
        self._tag_rates.note(tag, time.monotonic())
        async with self._lock:
            start = len(self._pending)
            self._pending.extend(items)
            self._futures.append((fut, start, len(items), tag))
            # _flush_scheduled covers exactly the CURRENT batch: it resets
            # when a flush swaps the batch out.  While a launch is already
            # in flight nothing is scheduled here — completion-triggered
            # flushing (below) drains whatever accumulated the moment the
            # engine frees, which is what lets k pipelined decisions'
            # quorum waves merge into one launch: queueing a second launch
            # behind a busy device would only split the batch without
            # finishing any earlier.
            if self._launch_inflight:
                pass
            elif len(self._pending) >= self.max_batch:
                create_logged_task(
                    self._flush_after(0.0), name="coalescer-flush-full"
                )
                self._flush_scheduled = True
            elif not self._flush_scheduled:
                self._flush_scheduled = True
                # flip-warm mode: the failover transient flushes eagerly
                # (no coalescing window) so the new view's first waves
                # launch at once
                delay = 0.0 if self._flip_warm() else self.window
                create_logged_task(
                    self._flush_after(delay), name="coalescer-flush"
                )
        return await fut

    def _rung_exact(self, n: int) -> bool:
        """A wave sitting exactly on a pad-ladder rung has zero pad
        waste — holding it can only trade guaranteed-perfect fill for
        speculative depth, so the gate flushes it immediately."""
        sizes = getattr(self.engine, "pad_sizes", None)
        return bool(sizes) and n in sizes

    async def _maybe_hold(self) -> None:
        """Occupancy-aware flush gating: briefly hold this flush while
        the per-tag arrival tracker predicts more waves inbound, bounded
        by the hard ``hold`` deadline.  See the constructor docstring
        for the never-hold conditions (breaker open, full batch,
        rung-exact wave)."""
        budget = self.hold
        if budget <= 0.0:
            return
        if self._flip_warm():
            # the failover transient must not trade latency for depth
            self.flip_warm_bypasses += 1
            return
        start = time.monotonic()
        start_depth: Optional[int] = None
        quantum = max(min(self.window, budget / 4.0), 0.001)
        expired = False
        while True:
            now = time.monotonic()
            held = now - start
            async with self._lock:
                if self._launch_inflight or not self._pending:
                    break  # another flush task took the batch
                n = len(self._pending)
                if self._breaker_is_open:
                    if start_depth is None:
                        self.hold_stats.breaker_bypass += 1
                    break  # host fallback must not wait on predictions
                if n >= self.max_batch or self._rung_exact(n):
                    break
                if held >= budget:
                    expired = True
                    break
                if not self._tag_rates.any_imminent(now, budget - held,
                                                    budget):
                    break
                if start_depth is None:
                    start_depth = n
            await asyncio.sleep(quantum)
        if start_depth is not None:
            held_s = time.monotonic() - start
            self.hold_stats.waves_held += 1
            self.hold_stats.held_ms += 1e3 * held_s
            async with self._lock:
                gain = max(len(self._pending) - start_depth, 0)
            self.hold_stats.depth_gain_items += gain
            if expired:
                self.hold_stats.deadline_expired += 1
            if self.metrics is not None \
                    and hasattr(self.metrics, "count_waves_held"):
                self.metrics.count_waves_held.add(1)
                self.metrics.count_hold_depth_gain.add(gain)
            rec = self.recorder
            if rec.enabled:
                rec.record("verify.hold", dur=held_s,
                           extra={"depth_gain": gain, "expired": expired})

    async def _flush_after(self, delay: float) -> None:
        if delay:
            await self._sleep(delay)
        await self._maybe_hold()
        # swap under the lock, verify outside it — submissions arriving
        # during the kernel launch accumulate into the NEXT batch
        async with self._lock:
            if self._launch_inflight:
                # a completion-triggered flush will pick the batch up
                self._flush_scheduled = False
                return
            pending, futures = self._pending, self._futures
            self._pending, self._futures = [], []
            self._flush_scheduled = False
            if pending:
                self._launch_inflight = True
        if not pending:
            return
        # attribution happens when the wave's composition is fixed, so a
        # failed launch still counts its shard mix
        self.shard_stats.note_wave(futures)
        self._launch_seq += 1
        launch_id = self._launch_seq
        rec = self.recorder
        t_launch = time.monotonic() if rec.enabled else 0.0
        try:
            results = await self._launch_wave(pending)
        except Exception as exc:
            if rec.enabled:
                rec.record("verify.launch", launch=launch_id,
                           dur=time.monotonic() - t_launch,
                           extra={"items": len(pending), "failed": True})
            err = exc if isinstance(exc, (VerifyPlaneDown, *KERNEL_ERRORS)) \
                else RuntimeError(f"batch verify failed: {exc!r}")
            for fut, _, _, _ in futures:
                if not fut.done():
                    fut.set_exception(err)
            await self._launch_done()
            return
        if rec.enabled:
            rec.record("verify.launch", launch=launch_id,
                       dur=time.monotonic() - t_launch,
                       extra={"items": len(pending)})
        for fut, start, count, _tag in futures:
            if not fut.done():
                fut.set_result(results[start : start + count])
        await self._launch_done()

    async def _launch_done(self) -> None:
        """Completion-triggered flush: drain accumulated submissions now."""
        async with self._lock:
            self._launch_inflight = False
            if self._pending and not self._flush_scheduled:
                self._flush_scheduled = True
                create_logged_task(
                    self._flush_after(0.0), name="coalescer-flush-drain"
                )

    # -- the fault machinery -------------------------------------------------

    async def _launch_wave(self, pending: list) -> list[bool]:
        """One coalesced wave through the fault machinery: deadline ->
        retry/backoff -> host fallback (when configured).  Raises
        VerifyPlaneDown when every stage is exhausted, and a kernel build or
        launch error at once: those are faults of the kernel, which no
        retry mends and no host wave may hide."""
        pol = self.policy
        if pol is None:  # legacy contract: one attempt, no deadline
            return await asyncio.to_thread(self._verify_batch, pending)
        self._canary = pending[0]
        attempts = 1 + max(0, pol.launch_retries)
        delay = pol.backoff_base
        last_exc: Optional[Exception] = None
        for attempt in range(attempts):
            if self._breaker_is_open:
                break  # degraded mode: don't queue waves behind a dead device
            try:
                results = await self._call_engine_with_deadline(
                    self.engine, pending, pol.launch_timeout
                )
            except KERNEL_ERRORS:
                raise
            except Exception as exc:  # noqa: BLE001 — classified below
                last_exc = exc
                self._note_launch_failure(exc)
                if self._breaker_is_open or attempt + 1 >= attempts:
                    continue
                self.fault_stats.retries += 1
                if self.metrics is not None:
                    self.metrics.count_launch_retries.add(1)
                await asyncio.sleep(
                    delay * (1.0 + pol.backoff_jitter * random.random())
                )
                delay = min(delay * 2.0, pol.backoff_max)
                continue
            self._consecutive_failures = 0
            return results
        if self.fallback_engine is not None:
            try:
                results = await asyncio.to_thread(
                    self._verify_batch, pending, self.fallback_engine
                )
            except Exception as exc:  # noqa: BLE001 — terminal either way
                raise VerifyPlaneDown(
                    f"batch verify failed: device path exhausted "
                    f"({last_exc!r}) and the host fallback failed too: "
                    f"{exc!r}"
                ) from exc
            self.fault_stats.host_fallback_batches += 1
            if self.metrics is not None:
                self.metrics.count_host_fallback_batches.add(1)
            return results
        if last_exc is None:
            # breaker already open on entry: no device attempt was made
            raise VerifyPlaneDown(
                "batch verify failed: circuit breaker open (failing fast) "
                "and no fallback engine is configured"
            )
        raise VerifyPlaneDown(
            f"batch verify failed after {attempts} launch attempt(s) and "
            f"no fallback engine is configured: {last_exc!r}"
        ) from last_exc

    def _spawn_engine_call(self, engine, pending: list) -> asyncio.Future:
        """Run one engine call on a dedicated DAEMON thread; the returned
        future resolves with the result/exception whenever the thread
        finishes — possibly long after every awaiter gave up."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()

        def resolve(setter, payload) -> None:
            if not fut.done():
                setter(payload)

        def run() -> None:
            try:
                res = self._verify_batch(pending, engine)
            except BaseException as exc:  # noqa: BLE001 — ferried to the loop
                setter, payload = fut.set_exception, exc
            else:
                setter, payload = fut.set_result, res
            try:
                loop.call_soon_threadsafe(resolve, setter, payload)
            except RuntimeError:
                pass  # loop closed while the launch was in flight

        threading.Thread(
            target=run, name="smartbft-verify-launch", daemon=True
        ).start()
        return fut

    def _discard_late(self, fut: asyncio.Future) -> None:
        """Mark an abandoned launch: count + log its late arrival and
        retrieve any exception so asyncio never warns at GC time."""

        def discard(f: asyncio.Future) -> None:
            self.fault_stats.abandoned_late_arrivals += 1
            exc = f.exception()
            self._log.warning(
                "abandoned verify launch completed late (%s)",
                "successfully" if exc is None else f"with {exc!r}",
            )

        fut.add_done_callback(discard)

    async def _call_engine_with_deadline(self, engine, pending: list,
                                         timeout: Optional[float]):
        """Run one engine call on a worker thread under the launch
        deadline.  On expiry the launch is ABANDONED: the (daemon) thread
        keeps running, its late result is discarded on arrival, and the
        caller gets LaunchTimeout — a hung device can no longer wedge the
        flush pipeline."""
        if timeout is None:
            return await asyncio.to_thread(self._verify_batch, pending, engine)
        fut = self._spawn_engine_call(engine, pending)
        try:
            return await asyncio.wait_for(asyncio.shield(fut), timeout)
        except asyncio.TimeoutError:
            self._discard_late(fut)
            raise LaunchTimeout(
                f"verify launch exceeded its {timeout:.3f}s deadline; "
                "wave abandoned"
            ) from None

    def _note_launch_failure(self, exc: Exception) -> None:
        self._consecutive_failures += 1
        self.fault_stats.launch_failures += 1
        timed_out = isinstance(exc, LaunchTimeout)
        if timed_out:
            self.fault_stats.launch_timeouts += 1
        if self.metrics is not None:
            self.metrics.count_launch_failures.add(1)
            if timed_out:
                self.metrics.count_launch_timeouts.add(1)
        self._log.warning(
            "verify launch failure (consecutive %d): %s: %s",
            self._consecutive_failures, type(exc).__name__, exc,
        )
        if self._consecutive_failures >= max(1, self.policy.breaker_threshold):
            self._open_breaker(
                f"{self._consecutive_failures} consecutive launch failures")

    def _open_breaker(self, reason: str) -> None:
        if self._breaker_is_open:
            return
        self._breaker_is_open = True
        self.fault_stats.breaker_opens += 1
        if self.metrics is not None:
            self.metrics.count_breaker_open.add(1)
            self.metrics.breaker_state.set(1.0)
        if self.recorder.enabled:
            self.recorder.record("ctl.breaker_open",
                                 extra={"reason": reason})
        self._log.warning(
            "verify-plane circuit breaker OPEN (%s); %s",
            reason,
            "waves degrade to the host fallback engine"
            if self.fallback_engine is not None else
            "NO fallback engine configured — waves fail fast until the "
            "device recovers",
        )
        if self._probe_task is None or self._probe_task.done():
            self._probe_task = create_logged_task(
                self._probe_loop(), name="verify-breaker-probe"
            )

    def _close_breaker(self) -> None:
        self._breaker_is_open = False
        self._consecutive_failures = 0
        self.fault_stats.breaker_closes += 1
        if self.metrics is not None:
            self.metrics.count_breaker_close.add(1)
            self.metrics.breaker_state.set(0.0)
        if self.recorder.enabled:
            self.recorder.record("ctl.breaker_close")
        self._log.warning(
            "verify-plane circuit breaker CLOSED: device engine recovered"
        )

    async def _probe_loop(self) -> None:
        """Background canary: while the breaker is open, periodically
        re-verify ONE item on the device — off the hot path, live waves
        stay on the fallback — and flip the breaker closed on the first
        call that completes.

        A probe whose thread is still PARKED in a hung device is re-awaited
        on the next round instead of spawning a fresh thread, so a
        long-lived outage holds at most one outstanding probe thread (plus
        the abandoned wave that tripped the breaker), not one per probe."""
        pol = self.policy
        delay = pol.probe_interval
        fut: Optional[asyncio.Future] = None
        try:
            while self._breaker_is_open:
                await asyncio.sleep(delay)
                item = self._canary
                if item is None:
                    continue
                self.fault_stats.probe_attempts += 1
                if fut is not None and fut.done():
                    # the parked probe concluded during the sleep: consume
                    # it — a late success still proves the device healthy,
                    # and a late failure must be retrieved (else asyncio
                    # warns at GC) before a fresh probe spawns
                    exc = fut.exception()
                    fut = None
                    if exc is None:
                        self.fault_stats.probe_successes += 1
                        self._close_breaker()
                        return
                    self._log.info(
                        "verify-plane probe completed late with %r", exc
                    )
                if fut is None:
                    fut = self._spawn_engine_call(self.engine, [item])
                try:
                    await asyncio.wait_for(
                        asyncio.shield(fut), pol.launch_timeout
                    )
                except asyncio.TimeoutError:
                    self._log.info(
                        "verify-plane probe still pending after %.2fs; "
                        "re-checking in %.2fs", pol.launch_timeout, delay,
                    )
                    delay = min(delay * 2.0, pol.probe_backoff_max)
                    continue
                except Exception as exc:  # noqa: BLE001 — device still down
                    fut = None  # concluded (handled here), not parked
                    self._log.info(
                        "verify-plane probe failed (%r); next probe in %.2fs",
                        exc, delay,
                    )
                    delay = min(delay * 2.0, pol.probe_backoff_max)
                    continue
                self.fault_stats.probe_successes += 1
                self._close_breaker()
                return
        finally:
            if fut is not None and not fut.done():
                self._discard_late(fut)  # loop torn down mid-probe

    # -- the engine call -----------------------------------------------------

    def _verify_batch(self, pending: list, engine=None) -> list[bool]:
        """One engine call for the flushed batch, optionally deduplicated."""
        engine = self.engine if engine is None else engine
        if not self.dedupe:
            return self._engine_call(engine, pending)
        try:
            first: dict = {}
            for it in pending:
                first.setdefault(it, len(first))
        except TypeError:
            # unhashable scheme items — dedupe silently degrades to 1:1
            return self._engine_call(engine, pending)
        if len(first) == len(pending):
            return self._engine_call(engine, pending)
        distinct = self._engine_call(engine, list(first))
        return [distinct[first[it]] for it in pending]

    @staticmethod
    def _engine_call(engine, items: list) -> list[bool]:
        """engine.verify + the result-length guard: a short/long result
        would silently mis-slice every submitter's future."""
        results = engine.verify(items)
        if len(results) != len(items):
            raise VerifyResultMismatch(
                f"engine {type(engine).__name__} returned {len(results)} "
                f"results for {len(items)} items — refusing to mis-slice "
                "the coalesced wave"
            )
        return results


# ---------------------------------------------------------------------------
# SPI provider
# ---------------------------------------------------------------------------

class CryptoProvider:
    """Crypto subset of the Signer/Verifier SPI over a :class:`Keyring`.

    The application's Verifier implementation delegates
    sign/verify-signature duties here and keeps request/proposal semantics
    (payload checks, request extraction) to itself.  ``scheme`` selects the
    signature system (:mod:`p256` by default; :mod:`ed25519` — BASELINE.md
    configs[3] — through :class:`Ed25519CryptoProvider`); the engine must
    be built for the same scheme.  With no engine and no coalescer the
    provider verifies on a :class:`HostVerifyEngine` of its scheme: the
    reference's per-replica CPU verifier, which a caller picks by passing
    no engine (not a fallback from a device engine).
    """

    scheme = p256

    def __init__(self, keyring: Keyring, engine=None,
                 coalesce_window: Optional[float] = None,
                 coalescer: Optional[AsyncBatchCoalescer] = None,
                 fault_policy: Optional[VerifyFaultPolicy] = None,
                 fallback_engine=None):
        """``coalescer``: share one AsyncBatchCoalescer across providers —
        the cross-REPLICA batching axis of BASELINE configs[2]: when many
        replicas run against one chip, their concurrent quorum checks merge
        into shared kernel launches instead of queueing per-replica ones.

        ``fault_policy`` / ``fallback_engine``: verify-plane fault
        tolerance (see AsyncBatchCoalescer).  Device-shaped engines (those
        with a pad ladder) default to launch deadlines, retry/backoff and
        the breaker, so a hung device fails waves fast instead of wedging
        consensus; a wave moves to a host engine only when the caller
        passes ``fallback_engine``, so no device fault hides as a slow
        commit.  Host engines keep the legacy single-attempt contract
        unless a policy is supplied (or wired later by the Consensus
        facade)."""
        self.keyring = keyring
        #: opaque attribution tag (the shard id in sharded deployments) —
        #: every coalesced submission from this provider carries it, so a
        #: shared coalescer can report per-shard items and cross-shard
        #: launch mixing (ShardAttribution).  Settable post-construction;
        #: None = untagged (single-group deployments).
        self.verify_tag: Optional[object] = None
        # LRU-bounded with an eviction counter: the keys are adversary-
        # chosen wire bytes, so a Byzantine flood of unique sig messages
        # churns the tail one entry at a time instead of wiping the honest
        # working set (and can never grow memory past the bound)
        self._sig_msg_memo: LruMemo[bytes, "ConsenterSigMsg"] = LruMemo(8192)
        # per-signer invalid-verdict attribution: every failed
        # consenter-sig verdict names WHO signed it instead of vanishing
        # into the aggregate failure count.  invalid_by_signer is the
        # always-on local export; the labeled counter and misbehavior
        # table are wired late (configure_fault_policy /
        # configure_misbehavior) by the Consensus facade.
        self.invalid_by_signer: dict[int, dict[str, int]] = {}
        self._invalid_vote_counter = None
        self.misbehavior = None
        if coalescer is not None and engine is not None \
                and coalescer.engine is not engine:
            raise ValueError("shared coalescer wraps a different engine")
        self.engine = (
            engine if engine is not None
            else coalescer.engine if coalescer is not None
            else HostVerifyEngine(scheme=self.scheme)
        )
        eng_scheme = getattr(self.engine, "scheme", self.scheme)
        if eng_scheme is not self.scheme:
            raise ValueError("engine scheme does not match provider scheme")
        # membership keys are static per configuration: register them with
        # the engine's comb-table path up front (no-op for other engines)
        if hasattr(self.engine, "prewarm_keys"):
            try:
                self.engine.prewarm_keys(self.keyring.public_keys.values())
            except ValueError as exc:
                if not isinstance(exc, CombRegistryFull):
                    raise ValueError(
                        f"invalid key in keyring: {exc}") from exc
                # A long-lived shared engine can accumulate more distinct
                # keys than the comb registry holds (e.g. across many
                # reconfigs).  That only disables the comb fast path for
                # this provider's overflow keys — the generic kernel still
                # verifies them — so degrade loudly instead of failing
                # construction.
                logging.getLogger("smartbft_tpu_torch.crypto").warning(
                    "comb key registry full; provider %s falls back to the "
                    "generic verify kernel for unregistered keys: %s",
                    self.keyring.self_id, exc,
                )
        if coalescer is not None:
            self._coalescer = coalescer
            coalescer.configure(
                policy=fault_policy, fallback_engine=fallback_engine,
                explicit=fault_policy is not None,
            )
            return
        if coalesce_window is None:
            coalesce_window = getattr(
                self.engine, "preferred_coalesce_window", 0.002
            )
        # let one coalesced flush fill the engine's largest launch — a
        # smaller max_batch would split big quorum waves into multiple
        # launches and multiply the fixed per-launch overhead
        max_batch = getattr(self.engine, "pad_sizes", (2048,))[-1]
        default_policy = None
        if getattr(self.engine, "pad_sizes", None) is not None \
                and fault_policy is None:
            # device-shaped engine: arm deadlines and the breaker by
            # default.  The default policy is wired as NON-explicit so
            # Configuration.verify_* knobs (via Consensus._wire_verify_plane)
            # still take effect.
            default_policy = VerifyFaultPolicy()
        self._coalescer = AsyncBatchCoalescer(
            self.engine, window=coalesce_window, max_batch=max_batch,
            policy=fault_policy, fallback_engine=fallback_engine,
        )
        if default_policy is not None:
            self._coalescer.configure(policy=default_policy)

    @property
    def coalescer(self) -> AsyncBatchCoalescer:
        return self._coalescer

    def configure_fault_policy(self, policy: Optional[VerifyFaultPolicy] = None,
                               metrics=None, fallback_engine=None) -> None:
        """Late verify-plane wiring (Consensus.start calls this with
        Configuration-derived values + the metrics bundle).  Fills only
        unset pieces, so explicit construction and shared-coalescer setups
        win.  No host fallback is added: only a caller's explicit
        ``fallback_engine`` may take a device wave."""
        if metrics is not None and self._invalid_vote_counter is None:
            self._invalid_vote_counter = getattr(
                metrics, "count_invalid_votes", None)
        self._coalescer.configure(
            policy=policy, fallback_engine=fallback_engine, metrics=metrics
        )

    def _quorum_threshold(self) -> int:
        """ceil((n+f+1)/2) over this keyring's membership — the quorum
        the 2D engine's summed vote counts decide against (the same
        expression every View uses; verdicts do NOT depend on it)."""
        n = len(self.keyring.public_keys)
        f = (n - 1) // 3
        return (n + f + 2) // 2

    def configure_verify_mesh(self, devices: int, metrics=None,
                              topology: str = "1d") -> None:
        """Graduate the coalescer's engine onto an N-device mesh — the
        ``Configuration.verify_mesh_devices`` knob, wired by
        ``Consensus._wire_verify_plane`` at start and on every reconfig.

        Idempotent and shared-coalescer-safe: the first provider wired
        swaps the engine in; colocated providers (sharded mode — S groups,
        ONE coalescer) see a mesh of the requested width already installed
        (``devices`` attribute, delegated through fault-injection wrappers)
        and no-op.  The fault contract then holds per MESH launch: the
        deadline/retry/breaker machinery wraps ``engine.verify``, so
        expiry abandons the whole mesh launch and retries re-dispatch it.

        ``topology`` selects the mesh shape (the
        ``Configuration.verify_mesh_topology`` knob): ``"1d"`` (default)
        is the batch-axis :class:`~smartbft_tpu_torch.parallel.
        MeshVerifyEngine`; ``"2d"`` graduates onto the seq×vote
        :class:`~smartbft_tpu_torch.parallel.QuorumMeshVerifyEngine`, whose
        per-sequence quorum counts sum across the 'vote' mesh axis on the
        devices, while per-item verdicts stay bit-identical to the 1D
        engine.

        **Degraded mode**: when the mesh is unbuildable (fewer visible
        devices than configured) the current single-device engine stays,
        LOUDLY, with a counted downgrade (``coalescer.mesh_downgrades`` +
        ``consensus.tpu.count_mesh_downgrades``), once per shared plane
        and requested (width, topology) — a mis-provisioned host serves at
        reduced width instead of dying.  Unlike the JAX package, no host
        fallback engine is installed on graduation: only a caller's
        explicit ``fallback_engine`` may take a device wave."""
        if devices <= 0:
            return
        co = self._coalescer
        co.mesh_configured = int(devices)
        # prefer the coalescer's own metrics bundle (the shared one every
        # provider feeds) over a caller-supplied per-node bundle; fill the
        # unset slot like configure_fault_policy so later wirings and the
        # downgrade counter read the same bundle
        if metrics is not None and co.metrics is None:
            co.configure(metrics=metrics)
        metrics = co.metrics if co.metrics is not None else metrics
        current = co.engine
        if int(getattr(current, "devices", 0)) == int(devices) \
                and getattr(current, "topology", "1d") == topology:
            self.engine = current
            return  # already this mesh (possibly FaultyEngine-wrapped)
        if co.mesh_downgraded_for == (int(devices), topology):
            return  # this plane already downgraded this very mesh
        from ..parallel.engine import (
            MeshUnavailable,
            MeshVerifyEngine,
            QuorumMeshVerifyEngine,
        )

        try:
            if topology == "2d":
                engine = QuorumMeshVerifyEngine(
                    devices=int(devices), scheme=self.scheme,
                    quorum=self._quorum_threshold(), metrics=metrics,
                )
            else:
                # the current engine donates its pad ladder ONLY when it
                # actually carries a batch ladder: a 2D engine's
                # pad_sizes is the single seq_tile*vote_tile rung, and
                # inheriting it on a 2d->1d reconfig would silently cap
                # the rebuilt 1D mesh far below the derived
                # MESH_PER_DEVICE_LANES ladder
                donor = None if getattr(current, "topology", "1d") == "2d" \
                    else getattr(current, "pad_sizes", None)
                engine = MeshVerifyEngine(
                    devices=int(devices), scheme=self.scheme,
                    pad_sizes=donor, metrics=metrics,
                )
        except MeshUnavailable as exc:
            co.mesh_downgrades += 1
            co.mesh_downgraded_for = (int(devices), topology)
            if metrics is not None and hasattr(metrics, "count_mesh_downgrades"):
                metrics.count_mesh_downgrades.add(1)
            logging.getLogger("smartbft_tpu_torch.crypto").warning(
                "verify mesh UNBUILDABLE (%s); DOWNGRADED to the "
                "single-device %s (downgrade %d counted)",
                exc, type(current).__name__, co.mesh_downgrades,
            )
            return
        co.mesh_downgraded_for = None
        inner = getattr(current, "inner", None)
        if inner is not None:
            # a fault-injection wrapper (testing.engine_faults.FaultyEngine)
            # around a single-device engine: graduate INSIDE it — swapping
            # the wrapper out would silently disconnect chaos fault
            # injection from the live plane
            current.inner = engine
            current.scheme = engine.scheme
            current.pad_sizes = engine.pad_sizes
            current.devices = engine.devices
            current.topology = engine.topology
            engine = current
        else:
            co.engine = engine
        # one coalesced flush should be able to fill the mesh's largest
        # launch — a smaller cap would split waves and waste the new width
        co.max_batch = max(co.max_batch, engine.pad_sizes[-1])
        if metrics is not None and hasattr(metrics, "mesh_devices"):
            metrics.mesh_devices.set(float(engine.devices))
        self.engine = engine

    def configure_flush_hold(self, hold: Optional[float],
                             explicit: bool = False) -> None:
        """Late occupancy-gating wiring: apply the
        ``Configuration.verify_flush_hold`` knob to the (possibly
        shared) coalescer.  Same precedence as the fault policy — an
        explicitly constructed hold wins over config-wired values."""
        self._coalescer.configure_hold(hold, explicit=explicit)

    def note_view_flip(self) -> None:
        """Controller seam: a view change installed a new view — run the
        (possibly shared) coalescer flip-warm so the new view's first
        quorum waves launch without coalescing latency."""
        self._coalescer.note_view_flip()

    def note_view_depose(self) -> None:
        """View seam: the view is aborting for a view change — flush its
        in-flight waves eagerly (see the coalescer's note_view_depose)."""
        self._coalescer.note_view_depose()

    def configure_misbehavior(self, table) -> None:
        """Late misbehavior wiring (Consensus._wire_verify_plane): every
        per-signer invalid verdict this provider attributes also feeds the
        node's :class:`~smartbft_tpu_torch.core.misbehavior.MisbehaviorTable`,
        which the Controller reads to shed shunned senders at intake."""
        self.misbehavior = table

    def _note_invalid(self, signer, cause: str) -> None:
        """Attribute one failed verdict to ``signer`` — local dict, the
        labeled ``consensus.tpu.count_invalid_votes`` counter, and the
        misbehavior table when wired.  Never raises: attribution must not
        turn a clean rejection into a verify-plane error."""
        try:
            by_cause = self.invalid_by_signer.setdefault(int(signer), {})
            by_cause[cause] = by_cause.get(cause, 0) + 1
            if self._invalid_vote_counter is not None:
                self._invalid_vote_counter.with_labels(str(signer)).add(1)
            if self.misbehavior is not None:
                self.misbehavior.note(int(signer), cause)
        except Exception:
            logging.getLogger("smartbft_tpu_torch.crypto").warning(
                "invalid-vote attribution failed for signer %r", signer,
                exc_info=True,
            )

    # -- Signer -------------------------------------------------------------

    def sign(self, data: bytes) -> bytes:
        return self.scheme.sign_raw(self.keyring.private_key, data)

    def sign_proposal(self, proposal: Proposal, auxiliary_input: bytes) -> Signature:
        msg = encode(ConsenterSigMsg(
            proposal_digest=proposal_digest(proposal), aux=auxiliary_input
        ))
        return Signature(signer=self.keyring.self_id, value=self.sign(msg), msg=msg)

    # -- Verifier (crypto methods) -------------------------------------------

    def _item(self, signature: Signature):
        pub = self.keyring.public_keys.get(signature.signer)
        if pub is None:
            raise ValueError(f"unknown signer {signature.signer}")
        return self.scheme.make_item(signature.msg, signature.value, pub)

    def _malformed(self, signature: Signature) -> str:
        """The cause of a vote that did not become a verify item: a signer
        outside the membership, or else a member's signature value the
        scheme cannot read (a wrong length), which is an invalid
        signature of that member."""
        return ("unknown_signer"
                if signature.signer not in self.keyring.public_keys
                else "invalid_sig")

    def _check_binding(self, signature: Signature, proposal: Proposal,
                       digest: Optional[str] = None) -> bytes:
        """Digest binding check; returns aux.  Raises on mismatch.

        ``digest``: the proposal's digest if the caller already computed it
        — hashing a batch-sized proposal costs ~50 us, and quorum
        validation checks one proposal against dozens of signatures.  The
        sig-msg decode is memoized: every replica sharing this provider's
        process re-checks the same wire bytes (~42k decodes per n=64 bench
        run before the memo)."""
        decoded = self._sig_msg_memo.get_or(
            signature.msg, lambda: decode(ConsenterSigMsg, signature.msg)
        )
        if digest is None:
            digest = proposal_digest(proposal)
        if decoded.proposal_digest != digest:
            raise ValueError(
                f"signature of {signature.signer} binds digest "
                f"{decoded.proposal_digest[:12]}.. not the proposal's"
            )
        return decoded.aux

    def verify_consenter_sig(self, signature: Signature, proposal: Proposal) -> bytes:
        try:
            aux = self._check_binding(signature, proposal)
        except Exception:
            self._note_invalid(signature.signer, "binding_mismatch")
            raise
        try:
            item = self._item(signature)
        except Exception:
            self._note_invalid(signature.signer, self._malformed(signature))
            raise
        ok = self.engine.verify([item])[0]
        if not ok:
            self._note_invalid(signature.signer, "invalid_sig")
            raise ValueError(f"invalid consenter signature from {signature.signer}")
        return aux

    # batch verification = collect/bind (shared below) + the mask step
    # (_verify_items); BLS puts its canonical split around that step

    def _verify_items(self, items) -> list[bool]:
        return self.engine.verify(items)

    async def _verify_items_async(self, items) -> list[bool]:
        return await self._coalescer.submit(items, tag=self.verify_tag)

    def _collect(self, signatures: Sequence[Signature], proposal: Proposal):
        auxes: list[Optional[bytes]] = []
        items, idxs = [], []
        digest = proposal_digest(proposal)  # once per batch, not per sig
        for i, sig in enumerate(signatures):
            # the two pre-engine rejections attribute separately: a digest-
            # binding forgery is a different lie than an out-of-membership
            # signer claim, and both are cheaper than the engine verdict
            # they used to be indistinguishable from
            try:
                aux = self._check_binding(sig, proposal, digest)
            except Exception:
                auxes.append(None)
                self._note_invalid(sig.signer, "binding_mismatch")
                continue
            try:
                items.append(self._item(sig))
            except Exception:
                auxes.append(None)
                self._note_invalid(sig.signer, self._malformed(sig))
                continue
            idxs.append(i)
            auxes.append(aux)
        return auxes, items, idxs

    def _apply_mask(self, auxes, idxs, mask, signatures=None):
        for pos, i in enumerate(idxs):
            if not mask[pos]:
                auxes[i] = None
                if signatures is not None:
                    self._note_invalid(signatures[i].signer, "invalid_sig")
        return auxes

    def verify_consenter_sigs_batch(
        self, signatures: Sequence[Signature], proposal: Proposal
    ) -> list[Optional[bytes]]:
        auxes, items, idxs = self._collect(signatures, proposal)
        return self._apply_mask(auxes, idxs, self._verify_items(items),
                                signatures)

    async def verify_consenter_sigs_batch_async(
        self, signatures: Sequence[Signature], proposal: Proposal
    ) -> list[Optional[bytes]]:
        """Async path the View prefers: coalesces with concurrent callers."""
        auxes, items, idxs = self._collect(signatures, proposal)
        return self._apply_mask(auxes, idxs,
                                await self._verify_items_async(items),
                                signatures)

    def verify_signature(self, signature: Signature) -> None:
        try:
            item = self._item(signature)
        except Exception as exc:
            self._note_invalid(signature.signer, self._malformed(signature))
            raise ValueError(f"malformed signature from {signature.signer}: {exc}")
        try:
            ok = self.engine.verify([item])[0]
        except KERNEL_ERRORS:
            raise  # a broken kernel is not a malformed signature
        except Exception as exc:
            raise ValueError(f"malformed signature from {signature.signer}: {exc}")
        if not ok:
            self._note_invalid(signature.signer, "invalid_sig")
            raise ValueError(f"invalid signature from {signature.signer}")

    def auxiliary_data(self, msg: bytes) -> bytes:
        try:
            return decode(ConsenterSigMsg, msg).aux
        except Exception:
            return b""


class P256CryptoProvider(CryptoProvider):
    """ECDSA P-256 provider (the default scheme)."""

    scheme = p256


class Ed25519CryptoProvider(CryptoProvider):
    """Ed25519 provider — the alt-curve variant of BASELINE.md configs[3]."""

    scheme = ed25519


class BlsCryptoProvider(CryptoProvider):
    """BLS12-381 aggregate provider, BASELINE.json configs[4]: one pairing
    equation per quorum.

    Same-message aggregation requires every consenter to sign identical
    bytes, so this provider signs the PROPOSAL DIGEST ONLY; the per-signer
    auxiliary data (PreparesFrom witness lists) still travels in
    ``Signature.msg`` but is NOT covered by the signature.  Deployments
    that rely on authenticated aux for blacklist redemption should use the
    P-256/Ed25519 providers (or treat redemption as advisory); that is the
    price of quorum collapse.

    Verification strategy (the FastAggregateVerify shape of the IETF BLS
    draft): aggregate the batch into ONE kernel lane (sum of G1 sigs, sum
    of G2 pubkeys); only if that single pairing check fails, verify the
    signatures one lane each to attribute the bad vote.  Two consequences:

    * **Rogue keys.** Same-message aggregation is sound only when every
      registered public key has a verified proof of possession (otherwise
      pk_b = b*g2 - pk_a lets b fabricate a "quorum" containing a vote a
      never cast).  Pass ``pops`` (signer id -> ``bls12381.pop_prove``
      output) to enforce this at construction; deployments that omit it
      MUST verify possession during key registration instead.
    * **Set-level attestation.** When the aggregate check passes, it
      attests that the quorum *as a set* signed the digest; the individual
      ``Signature.value`` byte strings are not separately attested (a relay
      could offset two of them by equal-and-opposite G1 points without
      changing the sum).  All quorum-cert validation goes through this
      batch path, so replicas agree; code that needs a single signature
      attributable on its own must call :meth:`verify_consenter_sig`, which
      never aggregates.
    """

    scheme = bls12381

    def __init__(self, keyring: Keyring, engine=None,
                 coalesce_window: Optional[float] = None,
                 coalescer=None, pops: Optional[dict[int, bytes]] = None):
        super().__init__(keyring, engine, coalesce_window, coalescer)
        if pops is not None:
            for nid, pub in keyring.public_keys.items():
                pop = pops.get(nid)
                if pop is None or not bls12381.pop_verify(pub, pop):
                    raise ValueError(
                        f"missing/invalid proof of possession for node {nid}"
                    )

    def _signed_bytes(self, msg: bytes) -> bytes:
        """The digest-only bytes actually covered by the BLS signature."""
        decoded = decode(ConsenterSigMsg, msg)
        return encode(ConsenterSigMsg(proposal_digest=decoded.proposal_digest))

    def sign(self, data: bytes) -> bytes:
        try:
            data = self._signed_bytes(data)
        except Exception:
            pass  # non-consenter payloads (e.g. ViewData) sign as-is
        return self.scheme.sign_raw(self.keyring.private_key, data)

    def _item(self, signature: Signature):
        pub = self.keyring.public_keys.get(signature.signer)
        if pub is None:
            raise ValueError(f"unknown signer {signature.signer}")
        try:
            msg = self._signed_bytes(signature.msg)
        except Exception:
            msg = signature.msg
        return self.scheme.make_item(msg, signature.value, pub)

    def _quorum_minus_one(self) -> int:
        n = len(self.keyring.public_keys)
        f = (n - 1) // 3
        return max(2, (n + f + 1 + 1) // 2 - 1)  # ceil((n+f+1)/2) - 1

    def _canonical_split(self, signatures, items, idxs):
        """Canonicalized aggregation: the CANONICAL quorum subset, the
        lowest quorum-1 signer ids present, aggregates into one lane;
        leftovers get a lane each.

        Cross-replica dedupe: without canonicalization every replica
        aggregates ITS OWN collected subset, so the aggregated items of two
        replicas checking the same decision never match and the shared
        coalescer's dedupe pass cannot collapse them.  Sorting by signer id
        and capping at quorum-1 makes replicas that hold the same votes
        produce BYTE-IDENTICAL aggregate items (aggregation is a
        commutative point sum over the canonical codec's byte encodings),
        so an n-replica wave dedupes to one lane.

        Returns (lane, chosen_positions, rest_positions) or None when no
        aggregation applies (<=1 item / mixed messages)."""
        if len(items) <= 1:
            return None
        order = sorted(range(len(items)),
                       key=lambda p: signatures[idxs[p]].signer)
        chosen = order[: self._quorum_minus_one()]
        if len(chosen) <= 1:
            return None
        rest = order[len(chosen):]
        try:
            lane = self.scheme.aggregate_items([items[p] for p in chosen])
        except ValueError:
            return None  # mixed messages / degenerate sums
        return lane, chosen, rest

    @staticmethod
    def _merge_split_verdicts(split, results, chosen_results,
                              n_items) -> list[bool]:
        """Fan the [lane, rest...] result vector (plus, on lane failure,
        the per-item re-attribution of the chosen subset) onto positions.
        Rest verdicts are REUSED either way: a failed canonical lane only
        costs re-verifying the chosen items, never the whole batch."""
        _, chosen, rest = split
        mask = [False] * n_items
        for j, p in enumerate(rest):
            mask[p] = results[1 + j]
        if results[0]:
            for p in chosen:
                mask[p] = True
        else:
            for j, p in enumerate(chosen):
                mask[p] = chosen_results[j]
        return mask

    def verify_consenter_sigs_batch(
        self, signatures: Sequence[Signature], proposal: Proposal
    ) -> list:
        auxes, items, idxs = self._collect(signatures, proposal)
        split = self._canonical_split(signatures, items, idxs)
        if split is None:
            return self._apply_mask(auxes, idxs, self._verify_items(items),
                                    signatures)
        lane, chosen, rest = split
        results = self.engine.verify([lane] + [items[p] for p in rest])
        chosen_results = None
        if not results[0]:
            # canonical lane failed: attribute only the chosen subset
            chosen_results = self.engine.verify([items[p] for p in chosen])
        mask = self._merge_split_verdicts(split, results, chosen_results,
                                          len(items))
        return self._apply_mask(auxes, idxs, mask, signatures)

    async def verify_consenter_sigs_batch_async(
        self, signatures: Sequence[Signature], proposal: Proposal
    ) -> list:
        auxes, items, idxs = self._collect(signatures, proposal)
        split = self._canonical_split(signatures, items, idxs)
        if split is None:
            return self._apply_mask(auxes, idxs,
                                    await self._verify_items_async(items),
                                    signatures)
        lane, chosen, rest = split
        results = await self._coalescer.submit(
            [lane] + [items[p] for p in rest], tag=self.verify_tag
        )
        chosen_results = None
        if not results[0]:
            chosen_results = await self._coalescer.submit(
                [items[p] for p in chosen], tag=self.verify_tag
            )
        mask = self._merge_split_verdicts(split, results, chosen_results,
                                          len(items))
        return self._apply_mask(auxes, idxs, mask, signatures)
