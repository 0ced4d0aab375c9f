"""The reference's unit case matrices against the port: the four
``*_units`` files (core, controller, view, view changer), the WAL and its
group commit, the codec, the in-process network, the Prometheus lint and
RTT-derived forwarding, compiled against ``smartbft_tpu_torch`` by
:mod:`torch_reference` and collected here as items of their own
(``<file stem>__<case>``), under an exact count guard, each case under
a time limit of its own (the RTT case runs a socket transport).

Left out by design: the view case that expects a lower-view message of
the leader to complain and stop the view.  The port drops such a message
(a NewView can overtake its sender's last view-0 votes, and the lone
complaint stalled the chaos censor round); its port counterparts are in
``tests/test_torch_stale_view.py``."""

from torch_reference import case_time_limit, check_matrices, reference_tests

#: where the port differs from the reference by design
BY_DESIGN = {
    "test_wrong_view_from_leader_complains_and_stops":
        "the port drops a lower-view message of the leader: no complaint, "
        "no stop (tests/test_torch_stale_view.py)",
}
CASES = {"test_core_units.py": 22, "test_controller_units.py": 25,
         "test_view_units.py": 25, "test_viewchanger_units.py": 27,
         "test_wal.py": 14, "test_wal_group_commit.py": 13,
         "test_codec.py": 9, "test_network.py": 11, "test_promlint.py": 5,
         "test_rtt_forward.py": 6}
LEFT_OUT: dict = {
    "test_view_units.py": ["test_wrong_view_from_leader_complains_and_stops"],
}

time_limit = case_time_limit(60)

for _file in CASES:
    globals().update(reference_tests(_file, leave_out=BY_DESIGN))


def test_reference_matrices_are_whole_and_ported():
    check_matrices(CASES, LEFT_OUT, leave_out=BY_DESIGN)
