"""Nothing the benchmark runs imports JAX or the JAX package, by whole
top-level module name, and the yardstick imports nothing of the port."""

import ast
import os
import sys

import pytest

from portbench import run

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sources():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_imports(path):
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not _top_imports(path) & set(run.FORBIDDEN), path


@pytest.mark.parametrize("mod", ["reference", "roofline", "signer"])
def test_the_yardstick_imports_nothing_of_the_program(mod):
    tops = _top_imports(os.path.join(HERE, f"{mod}.py"))
    assert "smartbft_tpu_torch" not in tops and "torch" not in tops


@pytest.mark.parametrize("name,flagged", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax", True), ("smartbft_tpu", True), ("smartbft_tpu.crypto", True),
    ("smartbft_tpu_torch", False), ("smartbft_tpu_torch.crypto", False),
    ("jaxtyping", False), ("flaxen", False)])
def test_forbidden_modules_compares_whole_top_level_names(
        monkeypatch, name, flagged):
    monkeypatch.setitem(sys.modules, name, object())
    assert (name in run.forbidden_modules()) == flagged
