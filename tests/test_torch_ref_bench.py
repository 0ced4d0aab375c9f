"""The reference's bench-row schema and baseline-guard cases against the
port: ``tests/test_baseline.py`` and ``tests/test_benchschema.py``,
compiled against ``smartbft_tpu_torch`` by :mod:`torch_reference` and
collected here as items of their own (``<file stem>__<case>``), under an
exact count guard.  The baseline CLI cases spawn ``python -m
smartbft_tpu_torch.obs.baseline`` (the compiler points the ``-m``
argument at the port like every other ``smartbft_tpu`` name).

Left out, for the benchmark work that ports the repository root's
``bench.py``: ``test_baseline.py``'s ``bench.check_baseline`` case and
the eight ``test_benchschema.py`` cases that build their rows with
``bench.assemble_*`` / ``bench.*_guard_rows``."""

from torch_reference import case_time_limit, check_matrices, reference_tests

BENCH_PY = "calls the repository root's bench.py, which the benchmark work ports"
LEAVE_OUT = {name: BENCH_PY for name in (
    "test_bench_check_baseline_entry_point",
    "test_assembled_rows_pass_schema",
    "test_health_block_rides_open_loop_row",
    "test_drift_missing_required_key_is_caught",
    "test_drift_type_change_is_caught",
    "test_nested_block_drift_is_caught",
    "test_viewchange_guard_rows_validate_and_degrade_gracefully",
    "test_byzantine_row_validates_and_guards_missing_p99",
    "test_read_rows_validate_and_guard_bad_inputs")}
CASES = {"test_baseline.py": 9, "test_benchschema.py": 2}
LEFT_OUT = {
    "test_baseline.py": ["test_bench_check_baseline_entry_point"],
    "test_benchschema.py": sorted(n for n in LEAVE_OUT
                                  if n != "test_bench_check_baseline_entry_point"),
}

time_limit = case_time_limit(60)

for _file in CASES:
    globals().update(reference_tests(_file, leave_out=LEAVE_OUT))


def test_reference_matrices_are_whole_and_ported():
    check_matrices(CASES, LEFT_OUT, leave_out=LEAVE_OUT)
    got = reference_tests("test_baseline.py", leave_out=LEAVE_OUT)
    fn = got["test_baseline__test_committed_baseline_gates_tiny_logical_row"]
    assert fn.__globals__["tiny_logical_row"].__module__ \
        == "smartbft_tpu_torch.obs.baseline"
