"""The port stands alone: no module of ``smartbft_tpu_torch`` (nor
``chip_smoke.py``) imports jax or anything of the JAX package.

A static AST scan, so a lazy import inside a function counts too."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "smartbft_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "smartbft_tpu")


def _sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    return [pytest.param(f, id=str(f.relative_to(ROOT))) for f in files]


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _sources())
def test_port_module_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [name for name in _imported_roots(tree)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_scan_covers_the_kernel_modules():
    names = {p.name for p in PORT.rglob("*.py")}
    assert {"cuda_comb.py", "cuda_ecdsa.py", "cuda_ed25519.py",
            "cuda_eddsa.py", "ed25519.py", "provider.py",
            "consensus.py", "bls12381.py", "cuda_bls.py"} <= names
    assert {p.name for p in (PORT / "csrc").glob("*.cu")} >= {
        "cuda_comb.cu", "cuda_ecdsa.cu", "cuda_ed25519.cu", "cuda_eddsa.cu",
        "cuda_bls.cu"}


def test_scan_covers_the_sharded_slice():
    """Sharded mode and what it imports, under the JAX package's names."""
    have = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"shard/__init__.py", "shard/router.py", "shard/epoch.py",
            "shard/mux.py", "shard/set.py", "shard/autoscale.py",
            "obs/slo.py", "obs/health.py", "obs/critpath.py",
            "snapshot/__init__.py", "snapshot/store.py", "net/__init__.py",
            "net/framing.py", "testing/engine_faults.py",
            "testing/toy_scheme.py", "testing/sharded.py"} <= have


def test_scan_covers_the_control_plane():
    """The control plane, under the JAX package's names."""
    have = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"control/__init__.py", "control/loop.py",
            "control/policy.py"} <= have


def test_scan_covers_the_mesh_plane():
    """The multi-device verify plane and its device helpers, under the
    JAX package's names (``utils/torchenv.py`` in place of
    ``utils/jaxenv.py``)."""
    have = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"parallel/__init__.py", "parallel/engine.py",
            "utils/torchenv.py"} <= have


def test_importing_the_port_loads_no_jax():
    import subprocess
    import sys

    code = ("import sys, pkgutil, importlib, smartbft_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'smartbft_tpu')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_scan_covers_the_fault_and_load_harnesses():
    """The chaos, open-loop load and Byzantine harnesses and the trace
    report, under the JAX package's names."""
    have = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"testing/load.py", "testing/chaos.py", "testing/byzantine.py",
            "obs/report.py"} <= have


def test_scan_covers_the_socket_transport():
    """The socket transport, the replica process and its cluster, under
    the JAX package's names."""
    have = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"net/transport.py", "net/launch.py", "net/cluster.py"} <= have


def test_a_replica_process_touches_no_cuda():
    """``python -m smartbft_tpu_torch.net.launch`` is the replica process
    that ``SocketCluster`` spawns; its crypto is trivial, so importing it
    loads no kernel module and leaves CUDA uninitialised (on the card's
    machine n such processes share the card with the parent)."""
    import subprocess
    import sys

    code = ("import sys, smartbft_tpu_torch.net.launch, "
            "smartbft_tpu_torch.net.cluster\n"
            "kern = sorted(k for k in sys.modules "
            "if k.rsplit('.', 1)[-1].startswith('cuda_'))\n"
            "torch = sys.modules.get('torch')\n"
            "print(kern, torch is not None and torch.cuda.is_initialized())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] False"


def test_scan_covers_the_bench_rows_openssl_and_the_embedder():
    """The bench-row schema, the baseline guard, the OpenSSL engine and
    the standalone embedder, under the JAX package's names (the embedder
    moves from the repository's ``examples/`` into the package)."""
    have = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"obs/benchschema.py", "obs/baseline.py",
            "crypto/openssl_engine.py", "examples/__init__.py",
            "examples/naive_chain.py"} <= have


#: the JAX package's modules the port has under another name
RENAMED = {"crypto/pallas_comb.py": "crypto/cuda_comb.py",
           "crypto/pallas_ecdsa.py": "crypto/cuda_ecdsa.py",
           "crypto/pallas_ed25519.py": "crypto/cuda_ed25519.py",
           "utils/jaxenv.py": "utils/torchenv.py"}


def test_every_module_of_the_jax_package_has_its_port():
    """A file-tree diff of the two packages: every module of
    ``smartbft_tpu`` (and the repository's ``examples/naive_chain.py``)
    has its counterpart, under its own name or its documented rename."""
    ref = {str(p.relative_to(ROOT / "smartbft_tpu"))
           for p in (ROOT / "smartbft_tpu").rglob("*.py")}
    ref.add("examples/naive_chain.py")
    have = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {RENAMED.get(m, m) for m in ref} - have == set()
