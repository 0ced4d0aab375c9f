"""The reference's message-plane and verify-plane case matrices against
the port: ``tests/test_message_plane.py`` and ``test_verify_plane.py``,
compiled against ``smartbft_tpu_torch`` by :mod:`torch_reference` and
collected here as items of their own (``<file stem>__<case>``), under an
exact count guard.

Left out: the two cases that load ``benchmarks/throughput.py`` (the port
has no benchmark), the two that build ``JaxVerifyEngine``, and the two
that expect a kernel build error to open the breaker and move the wave to
the host engine.  The last four have port counterparts at the end of this
file.  Also left out: the wall-clock case of deep-window launch
amortization, which fails now and then on both packages when the suite
runs in parallel workers: its coalescer waits a wall-clock window and
verifies on a worker thread while the protocol's request timers run on
the logical clock, so a host stall longer than those timers adds
forwarding, complaints and waves.  That is the design of the case, not a
fault of the coalescer; ``tests/test_torch_deep_window.py`` holds the
same bound with both clocks pinned.  The device engine is ``TorchVerifyEngine(device="cpu",
pad_sizes=(4,))``: the port arms the same default fault policy, and by
design adds no host fallback engine.  A kernel build or launch error
reaches the submitters as it was raised, with no retry, no breaker and no
host wave, so no fault of a kernel hides as a slow commit.
"""

import asyncio

import pytest


from smartbft_tpu_torch.config import Configuration
from smartbft_tpu_torch.csrc import KernelBuildError
from smartbft_tpu_torch.crypto.provider import (
    AsyncBatchCoalescer,
    HostVerifyEngine,
    Keyring,
    P256CryptoProvider,
    TorchVerifyEngine,
    VerifyFaultPolicy,
)
from smartbft_tpu_torch.metrics import InMemoryProvider, TPUCryptoMetrics
from smartbft_tpu_torch.testing.engine_faults import (
    FaultyEngine,
    always_valid_engine,
)
from torch_reference import check_matrices, reference_tests

#: where the port differs from the reference by design
BY_DESIGN = {
    "test_permanent_kernel_error_trips_breaker_immediately":
        "a kernel build error raises to the submitters; no host wave",
    "test_breaker_transitions_are_counted_in_tpu_metrics":
        "a kernel build error raises to the submitters; no host wave",
}
#: unsteady on both packages on a loaded CPU: the JAX package's own
#: tests/test_message_plane.py fails it as the port's copy does
UNSTEADY = {
    "test_launches_much_fewer_than_decisions_deep_windows":
        "wall-clock design: the coalescer's window and worker thread run on "
        "the wall clock and the request timers on the logical clock, so a "
        "host stall adds waves; pinned with both clocks logical in "
        "tests/test_torch_deep_window.py",
}
LEAVE_OUT = {**BY_DESIGN, **UNSTEADY}
CASES = {"test_message_plane.py": 13, "test_verify_plane.py": 8}
LEFT_OUT: dict = {
    "test_message_plane.py": [
        "test_launches_much_fewer_than_decisions_deep_windows",
        "test_throughput_row_carries_protocol_plane_block"],
    "test_verify_plane.py": [
        "test_breaker_transitions_are_counted_in_tpu_metrics",
        "test_configure_fault_policy_explicit_wins_defaults_rewire",
        "test_device_provider_arms_fault_stack_by_default",
        "test_permanent_kernel_error_trips_breaker_immediately",
        "test_throughput_row_carries_breaker_metrics"],
}

for _file in CASES:
    globals().update(reference_tests(_file, leave_out=LEAVE_OUT))


def test_reference_matrices_are_whole_and_ported():
    check_matrices(CASES, LEFT_OUT, leave_out=LEAVE_OUT)


def _engine():
    return TorchVerifyEngine(device="cpu", pad_sizes=(4,))


def _tight_policy() -> VerifyFaultPolicy:
    return VerifyFaultPolicy(launch_timeout=0.08, launch_retries=2,
                             backoff_base=0.01, backoff_max=0.04,
                             backoff_jitter=0.0, breaker_threshold=3,
                             probe_interval=0.02, probe_backoff_max=0.05)


def test_device_provider_arms_fault_stack_by_default():
    """``test_verify_plane.py::test_device_provider_arms_fault_stack_by_
    default`` on the port's device engine: the provider comes out of
    ``__init__`` with deadlines armed and, unlike the JAX package, no
    host engine behind them (a wave moves to the host only where the
    caller passes one); host engines keep the single-attempt contract."""
    rings = Keyring.generate([1, 2, 3, 4], seed=b"vp")
    prov = P256CryptoProvider(rings[1], engine=_engine())
    co = prov.coalescer
    assert co.policy is not None
    assert co.fallback_engine is None
    host = HostVerifyEngine()
    prov = P256CryptoProvider(rings[2], engine=_engine(),
                              fallback_engine=host)
    assert prov.coalescer.fallback_engine is host
    host_prov = P256CryptoProvider(rings[3], engine=HostVerifyEngine())
    assert host_prov.coalescer.policy is None


def test_configure_fault_policy_explicit_wins_defaults_rewire():
    """``test_verify_plane.py::test_configure_fault_policy_explicit_wins_
    defaults_rewire`` with the port's device engine in place of the JAX
    one: an explicit constructor policy is never overridden, while the
    default-armed device policy yields to Configuration-derived wiring
    and to a later re-wire."""
    rings = Keyring.generate([1, 2], seed=b"vp2")
    explicit = _tight_policy()
    prov = P256CryptoProvider(rings[1], engine=HostVerifyEngine(),
                              fault_policy=explicit)
    prov.configure_fault_policy(policy=VerifyFaultPolicy(),
                                metrics=TPUCryptoMetrics(InMemoryProvider()))
    assert prov.coalescer.policy is explicit
    assert prov.coalescer.metrics is not None

    dev = P256CryptoProvider(rings[2], engine=_engine())
    assert dev.coalescer.policy is not None
    from_cfg = VerifyFaultPolicy.from_config(
        Configuration(self_id=2, verify_launch_timeout=7.5))
    dev.configure_fault_policy(policy=from_cfg)
    assert dev.coalescer.policy is from_cfg
    rewired = VerifyFaultPolicy.from_config(
        Configuration(self_id=2, verify_launch_timeout=9.0))
    dev.configure_fault_policy(policy=rewired)
    assert dev.coalescer.policy is rewired


@pytest.mark.parametrize("with_metrics", [False, True])
def test_permanent_kernel_error_reaches_the_submitters(with_metrics):
    """``test_verify_plane.py::test_permanent_kernel_error_trips_breaker_
    immediately`` and ``::test_breaker_transitions_are_counted_in_tpu_
    metrics`` on the port's contract: the same injected kernel build error
    under the same policy, with a fallback engine configured, reaches the
    submitter as raised after one attempt.  The breaker stays closed, no
    wave goes to the host, and the metrics count no transition; once the
    engine heals, the next wave verifies on it."""
    mem = InMemoryProvider()
    engine = FaultyEngine(always_valid_engine())
    co = AsyncBatchCoalescer(
        engine, window=0.001, policy=_tight_policy(),
        fallback_engine=always_valid_engine(),
        metrics=TPUCryptoMetrics(mem) if with_metrics else None)

    async def run():
        engine.permanent_error()
        with pytest.raises(KernelBuildError):
            await asyncio.wait_for(co.submit([("a",)]), 10)
        assert not co.breaker_open
        assert co.fault_stats.launch_failures == 0
        assert co.fault_stats.retries == 0
        assert co.fault_stats.host_fallback_batches == 0
        engine.heal()
        assert await asyncio.wait_for(co.submit([("b",)]), 10) == [True]

    asyncio.run(run())
    if with_metrics:
        assert mem.gauges["consensus.tpu.verify_breaker_open"] == 0.0
        for name in ("count_breaker_open", "count_breaker_close",
                     "count_launch_failures", "count_host_fallback_batches"):
            assert mem.counters.get(f"consensus.tpu.{name}", 0) == 0
