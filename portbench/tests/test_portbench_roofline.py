"""The yardstick's roofline: frozen constants, not read from the port."""

import ast
import os

import pytest

from portbench import roofline

PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "roofline.py")


def test_roofline_imports_nothing_and_holds_literal_constants():
    tree = ast.parse(open(PATH).read())
    imports = [n for n in ast.walk(tree)
               if isinstance(n, (ast.Import, ast.ImportFrom))]
    assert [getattr(n, "module", None) for n in imports] == ["__future__"]
    for node in tree.body:
        if isinstance(node, ast.Assign):
            names = {n.id for n in ast.walk(node.value)
                     if isinstance(n, ast.Name)}
            assert names <= {"IMADS"}, names


def test_per_signature_work():
    assert roofline.imads_per_sig("p256_comb") == pytest.approx(221922.1,
                                                                abs=0.5)
    assert roofline.imads_per_sig("ed25519_comb") == pytest.approx(97174.8,
                                                                   abs=0.5)
    assert roofline.BYTES_PER_SIG == {"p256_comb": 104, "ed25519_comb": 140}


def test_bound_is_operations_at_the_main_rungs():
    peak = 132 * 64 * 1.98e9
    sigs = 16384
    want = sigs * roofline.imads_per_sig("p256_comb") / peak
    assert roofline.bound_s("p256_comb", sigs, 1, 64) == pytest.approx(want)
    assert want == pytest.approx(0.2174e-3, rel=2e-3)
    # a launch of a few lanes is bound by its table bytes
    few = roofline.bound_s("ed25519_comb", 1, 1, 16)
    assert few == pytest.approx((140 + 17 * roofline.TABLE_BYTES) / 3.35e12)
