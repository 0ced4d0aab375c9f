"""Device-fault injection for the verify plane.

:class:`FaultyEngine` wraps any verify engine and injects the device fault
classes the reference's per-goroutine host verify could never exhibit
(view.go:537-541 cannot hang or fail as a unit):

* **hang** — ``verify`` blocks until healed; the coalescer's launch
  deadline abandons the wave (the late result is discarded on arrival);
* **fail-next-K** — the next K calls raise a transient tunnel-class error
  (``UNAVAILABLE``), exercising retry/backoff and breaker accounting;
* **slow** — every call pays a fixed sleep (deadline-edge testing);
* **permanent-error** — calls raise a kernel build error
  (:class:`~smartbft_tpu_torch.csrc.KernelBuildError`), which the
  coalescer never retries nor moves to a host engine: it reaches every
  submitter of the wave as it was raised.

:class:`CoalescedTrivialCrypto` is the chaos harness's crypto provider: it
keeps the test App's trivial signature semantics (signature = node id, aux
travels in ``Signature.msg``) but routes batched verification through a
REAL :class:`~smartbft_tpu_torch.crypto.provider.AsyncBatchCoalescer`, so a
whole chaos cluster shares one engine + coalescer exactly like the
single-chip deployment shape — and engine faults hit every replica at
once, which is the failure mode this PR hardens.
"""

from __future__ import annotations

import threading
import time

from ..crypto.provider import HostVerifyEngine
from ..csrc import KernelBuildError
from ..messages import Proposal, Signature


class _AlwaysValidScheme:
    """Trivial scheme for HostVerifyEngine: every item verifies.  Chaos
    runs exercise the fault MACHINERY (deadline/retry/breaker), not the
    arithmetic — real-crypto engines are covered by the provider tests."""

    @staticmethod
    def verify_item(item) -> bool:
        return True


def always_valid_engine() -> HostVerifyEngine:
    """A real HostVerifyEngine over the trivial scheme — used both as the
    chaos 'device' engine (wrapped in FaultyEngine) and as the breaker's
    host fallback, so degrade/recover paths run the production classes."""
    return HostVerifyEngine(scheme=_AlwaysValidScheme)


class FaultyEngine:
    """Engine wrapper with schedulable fault modes (thread-safe: ``verify``
    runs on coalescer worker threads while the chaos timeline flips modes
    from the event loop)."""

    def __init__(self, inner):
        self.inner = inner
        self.scheme = getattr(inner, "scheme", None)
        self.preferred_coalesce_window = getattr(
            inner, "preferred_coalesce_window", 0.0
        )
        # a wrapped device engine must still LOOK device-shaped: the
        # provider's coalescer sizing and the "arm a host fallback" default
        # both key off the pad ladder
        if hasattr(inner, "pad_sizes"):
            self.pad_sizes = inner.pad_sizes
        # ...and a wrapped MESH engine must still look mesh-shaped: the
        # configure_verify_mesh idempotence check and the bench `mesh`
        # block key off `devices` / `topology` / `mesh_snapshot`
        if hasattr(inner, "devices"):
            self.devices = inner.devices
        if hasattr(inner, "topology"):
            self.topology = inner.topology
        self._lock = threading.Lock()
        self._fail_next = 0
        self._slow_s = 0.0
        self._permanent = False
        #: mesh-scoped device faults: indices of "lost" mesh devices.  One
        #: lost device fails the WHOLE launch — that is the semantics of a
        #: mesh (one logical launch spans every device), and it is exactly
        #: why a single sick chip degrades ALL shards to host together.
        self._down_devices: set[int] = set()
        #: set = not hanging; cleared by hang(), re-set by heal()/fail_next
        self._release = threading.Event()
        self._release.set()
        self.injected_failures = 0
        self.injected_hangs = 0

    # -- delegation --------------------------------------------------------

    @property
    def stats(self):
        return self.inner.stats

    def prewarm_keys(self, pubs) -> None:
        if hasattr(self.inner, "prewarm_keys"):
            self.inner.prewarm_keys(pubs)

    def mesh_snapshot(self) -> dict:
        snap = getattr(self.inner, "mesh_snapshot", None)
        return snap() if snap is not None else {}

    # -- fault modes -------------------------------------------------------

    def hang(self) -> None:
        """Every verify call blocks until the next heal/fail_next — the
        stuck-tunnel shape.  Abandoned (deadlined) calls stay parked on a
        daemon worker thread and return late after release."""
        with self._lock:
            self.injected_hangs += 1
            self._release.clear()

    def fail_next(self, k: int = 1) -> None:
        """The next ``k`` calls raise a transient tunnel-class error.  Also
        releases a hang: a device cannot be both stuck and failing fast —
        this models 'the tunnel un-wedged but the device is still sick'."""
        with self._lock:
            self._fail_next = int(k)
            self._release.set()

    def slow(self, seconds: float) -> None:
        with self._lock:
            self._slow_s = float(seconds)

    def permanent_error(self, on: bool = True) -> None:
        """Calls raise a kernel build error (permanent: never retried);
        releases a hang like fail_next."""
        with self._lock:
            self._permanent = on
            self._release.set()

    def lose_device(self, idx: int = 0) -> None:
        """Mesh-scoped fault: device ``idx`` of the (wrapped) mesh is
        lost.  Every verify call — one logical launch spanning the whole
        mesh — raises a transient tunnel-class error until the device is
        restored, so the coalescer's retry/breaker machinery sees exactly
        what a real interconnect/device loss produces: the WHOLE mesh launch
        failing, for every shard at once."""
        with self._lock:
            self._down_devices.add(int(idx))

    def restore_device(self, idx: int = 0) -> None:
        with self._lock:
            self._down_devices.discard(int(idx))

    def heal(self) -> None:
        """Clear every fault mode and release any parked verify calls."""
        with self._lock:
            self._fail_next = 0
            self._slow_s = 0.0
            self._permanent = False
            self._down_devices.clear()
            self._release.set()

    # -- the engine surface ------------------------------------------------

    def verify(self, items) -> list[bool]:
        self._release.wait()
        with self._lock:
            slow = self._slow_s
            permanent = self._permanent
            failing = self._fail_next > 0
            down = sorted(self._down_devices)
            if failing or down:
                self._fail_next -= 1 if failing else 0
                self.injected_failures += 1
        if slow:
            time.sleep(slow)
        if permanent:
            raise KernelBuildError(
                "kernel build failed (injected permanent device fault)"
            )
        if failing:
            raise RuntimeError(
                "UNAVAILABLE: injected transient device fault"
            )
        if down:
            raise RuntimeError(
                f"UNAVAILABLE: injected mesh device fault (device(s) "
                f"{down} lost; the whole mesh launch fails)"
            )
        return self.inner.verify(items)


class CoalescedTrivialCrypto:
    """Trivial-crypto Signer/Verifier crypto subset over a shared
    coalescer (see module docstring).  Matches the test App's trivial
    semantics exactly — signature value is the node id, the auxiliary data
    IS ``Signature.msg`` — so chaos clusters behave identically to the
    crypto-less default except that quorum verification now traverses the
    verify plane under test."""

    def __init__(self, node_id: int, coalescer, tag=None):
        """``tag``: shard-attribution label forwarded with every coalesced
        submission (see AsyncBatchCoalescer.submit) — the sharded chaos
        harness tags each replica's traffic with its shard id."""
        self.node_id = node_id
        self._coalescer = coalescer
        self.verify_tag = tag

    # -- Signer ------------------------------------------------------------

    def sign(self, data: bytes) -> bytes:
        return b"sig-%d" % self.node_id

    def sign_proposal(self, proposal: Proposal, auxiliary_input: bytes) -> Signature:
        return Signature(
            signer=self.node_id, value=b"sig-%d" % self.node_id,
            msg=auxiliary_input,
        )

    # -- Verifier (crypto methods) -----------------------------------------

    def verify_consenter_sig(self, signature: Signature, proposal: Proposal) -> bytes:
        return signature.msg

    def verify_signature(self, signature: Signature) -> None:
        return None

    def auxiliary_data(self, msg: bytes) -> bytes:
        return msg

    def verify_consenter_sigs_batch(self, signatures, proposal: Proposal):
        return [s.msg for s in signatures]

    async def verify_consenter_sigs_batch_async(self, signatures,
                                                proposal: Proposal):
        items = [("sig", s.signer, bytes(s.msg)) for s in signatures]
        mask = await self._coalescer.submit(items, tag=self.verify_tag)
        return [s.msg if ok else None for s, ok in zip(signatures, mask)]

    def configure_fault_policy(self, policy=None, metrics=None,
                               fallback_engine=None) -> None:
        """Forwarded by the test App so the Consensus facade's wiring seam
        reaches the shared coalescer (fills unset pieces only)."""
        self._coalescer.configure(
            policy=policy, fallback_engine=fallback_engine, metrics=metrics
        )

    def configure_flush_hold(self, hold=None, explicit: bool = False) -> None:
        """Forward the ``verify_flush_hold`` knob to the shared coalescer
        (same explicit-wins precedence as the real CryptoProvider), so
        trivial clusters exercise occupancy gating through the
        Configuration path too."""
        self._coalescer.configure_hold(hold, explicit=explicit)

    def note_view_flip(self) -> None:
        """Forward the Controller's view-flip warmth hint to the shared
        coalescer, like the real CryptoProvider."""
        self._coalescer.note_view_flip()

    def note_view_depose(self) -> None:
        self._coalescer.note_view_depose()
