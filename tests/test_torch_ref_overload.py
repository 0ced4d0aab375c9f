"""The reference's overload and open-loop cases against the port:
``tests/test_overload.py`` (the admission gate, space waiters, the
log-scale histogram and commit-latency tracker, per-cause sheds, the
open-loop pump and Zipf clients, chaos load spikes on the logical clock),
compiled against ``smartbft_tpu_torch`` by :mod:`torch_reference` and
collected here as items of their own (``<file stem>__<case>``), under an
exact count guard.  Left out: the case that loads
``benchmarks/openloop.py`` (the port has no benchmark)."""

from torch_reference import check_matrices, reference_tests

#: the reference imports the benchmark inside the function, so the
#: compiler cannot see it
UNPORTED = {
    "test_openloop_bench_sweep_point_row_shape":
        "imports benchmarks/openloop.py (the port has no benchmark)",
}
CASES = {"test_overload.py": 23}
LEFT_OUT = {"test_overload.py": ["test_openloop_bench_sweep_point_row_shape"]}

for _file in CASES:
    globals().update(reference_tests(_file, leave_out=UNPORTED))


def test_reference_matrices_are_whole_and_ported():
    check_matrices(CASES, LEFT_OUT, UNPORTED)
    got = reference_tests("test_overload.py", leave_out=UNPORTED)
    assert got["test_overload__test_zipf_and_pump_shapes"] \
        .__globals__["run_open_loop"].__module__ \
        == "smartbft_tpu_torch.testing.load"
