"""The reference's socket-transport, replica-process, snapshot, read-plane
and observability-surface cases against the port: ``tests/test_net_framing.py``,
``test_net_transport.py``, the UDS smoke gate of ``test_net_cluster.py``,
``test_snapshot.py``, ``test_readplane.py``, ``test_obs_surfaces.py`` and
``test_task_audit.py``, compiled against ``smartbft_tpu_torch`` by
:mod:`torch_reference` and collected here as items of their own
(``<file stem>__<case>``), under an exact count guard.

Left out: the cases the reference marks slow.  The two rejoin-row cases
of ``test_snapshot.py`` run on the port's bench-row schema and baseline
guard (``obs.benchschema``, ``obs.baseline``); their guard row comes
from the repository root's ``bench.rejoin_guard_rows``, a pure function
of the rows, as ``test_overload.py``'s open-loop row case takes
``bench.assemble_open_loop_row``.  Every case runs under a time limit of
its own: a close that hangs fails its case instead of holding a worker."""

from torch_reference import case_time_limit, check_matrices, reference_tests

CASES = {"test_net_framing.py": 8, "test_net_transport.py": 9,
         "test_net_cluster.py": 1, "test_snapshot.py": 23,
         "test_readplane.py": 18, "test_obs_surfaces.py": 11,
         "test_task_audit.py": 3}
LEFT_OUT = {
    "test_net_cluster.py": [
        "test_control_plane_reshard_trigger", "test_n16_uds_scale",
        "test_sigkill_and_rejoin", "test_slow_link_keeps_quorum_speed",
        "test_tcp_multiprocess_commits"],
    "test_snapshot.py": [
        "test_socket_snapshot_rejoin_crash_during_capture_and_donor_kill",
        "test_socket_snapshot_rejoin_end_to_end"],
}

time_limit = case_time_limit(60)

for _file in CASES:
    globals().update(reference_tests(_file))


def test_reference_matrices_are_whole_and_ported():
    check_matrices(CASES, LEFT_OUT)
