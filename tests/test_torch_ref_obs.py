"""The reference's flight-recorder and trace-report cases against the
port: ``tests/test_obs.py`` (ring buffer, span histograms, the
view-change phase tracker, ``obs.report`` round trips, tracing overhead,
a recorder under chaos) and ``tests/test_cluster_trace.py`` (trace
frames, event cursors, clock offsets, link summaries, request-forward
hop chains, heartbeat detection, WAL spans), compiled against ``smartbft_tpu_torch`` by
:mod:`torch_reference` and collected here as items of their own
(``<file stem>__<case>``), under an exact count guard.  ``test_obs.py``
borrows ``tests/test_basic.py``'s helpers through its port-compiled copy.
The socket cases of ``test_cluster_trace.py`` (a forwarded request's hop
chain and the wire-tracing sidecar) run on the port's transport; every
case runs under a time limit of its own."""

from torch_reference import case_time_limit, check_matrices, reference_tests

CASES = {"test_obs.py": 13, "test_cluster_trace.py": 15}
LEFT_OUT: dict = {}

time_limit = case_time_limit(60)

for _file in CASES:
    globals().update(reference_tests(_file))


def test_reference_matrices_are_whole_and_ported():
    check_matrices(CASES, LEFT_OUT)
