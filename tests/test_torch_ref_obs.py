"""The reference's flight-recorder and trace-report cases against the
port: ``tests/test_obs.py`` (ring buffer, span histograms, the
view-change phase tracker, ``obs.report`` round trips, tracing overhead,
a recorder under chaos) and the in-process cases of
``tests/test_cluster_trace.py`` (trace frames, event cursors, clock
offsets, link summaries, request-forward hop chains, heartbeat
detection, WAL spans), compiled against ``smartbft_tpu_torch`` by
:mod:`torch_reference` and collected here as items of their own
(``<file stem>__<case>``), under an exact count guard.  ``test_obs.py``
borrows ``tests/test_basic.py``'s helpers through its port-compiled copy.
Left out: the cases of ``test_cluster_trace.py`` that run a socket
cluster (``net.transport`` is not ported)."""

from torch_reference import check_matrices, reference_tests

CASES = {"test_obs.py": 13, "test_cluster_trace.py": 13}
LEFT_OUT = {"test_cluster_trace.py": [
    "test_request_forward_continues_hop_chain",
    "test_wire_tracing_sidecar_and_overhead_gate"]}

for _file in CASES:
    globals().update(reference_tests(_file))


def test_reference_matrices_are_whole_and_ported():
    check_matrices(CASES, LEFT_OUT)
