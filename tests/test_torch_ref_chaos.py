"""The reference's chaos-harness cases against the port:
``tests/test_chaos.py`` (mute leader at every depth and rotation mode,
minority partition, message corruption, crash-restart, fault-free
rotation, the engine-fault acceptance run), compiled against
``smartbft_tpu_torch`` by :mod:`torch_reference` and collected here as
items of their own (``<file stem>__<case>``), under an exact count guard.
Left out: the two randomized soaks, which the reference marks slow."""

from torch_reference import check_matrices, reference_tests

CASES = {"test_chaos.py": 9}
LEFT_OUT = {"test_chaos.py": ["test_chaos_soak_engine_faults",
                              "test_chaos_soak_randomized"]}

for _file in CASES:
    globals().update(reference_tests(_file))


def test_reference_matrices_are_whole_and_ported():
    check_matrices(CASES, LEFT_OUT)
    got = reference_tests("test_chaos.py")
    assert got["test_chaos__test_chaos_mute_leader"] \
        .__globals__["ChaosCluster"].__module__ \
        == "smartbft_tpu_torch.testing.chaos"
