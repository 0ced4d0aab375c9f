"""The reference's cluster case matrices against the port's protocol
core: ``tests/test_basic.py``, ``test_viewchange.py``,
``test_scenarios.py`` and ``test_scenarios_more.py``, compiled against
``smartbft_tpu_torch`` by :mod:`torch_reference` and collected here as
items of their own (``<file stem>__<case>``).  The guard holds the number
of cases each file gives the port exact, so a case that drops out fails
it."""

from torch_reference import check_matrices, reference_tests

CASES = {"test_basic.py": 5, "test_viewchange.py": 4,
         "test_scenarios.py": 14, "test_scenarios_more.py": 14}
LEFT_OUT: dict = {}

for _file in CASES:
    globals().update(reference_tests(_file))


def test_reference_matrices_are_whole_and_ported():
    check_matrices(CASES, LEFT_OUT)
