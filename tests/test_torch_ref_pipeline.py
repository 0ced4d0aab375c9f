"""The reference's pipelined-window and commit-path case matrices against
the port: ``tests/test_pipeline.py`` and ``test_commitpath.py``, compiled
against ``smartbft_tpu_torch`` by :mod:`torch_reference` and collected
here as items of their own (``<file stem>__<case>``), under an exact
count guard."""

from torch_reference import check_matrices, reference_tests

CASES = {"test_pipeline.py": 37, "test_commitpath.py": 15}
LEFT_OUT: dict = {}

for _file in CASES:
    globals().update(reference_tests(_file))


def test_reference_matrices_are_whole_and_ported():
    check_matrices(CASES, LEFT_OUT)
