"""The JAX package's own test cases, compiled against the port.

:func:`reference_tests` returns the test functions of a reference file
``tests/<fname>`` as the port sees them: the file's source with every
``smartbft_tpu`` name pointed at ``smartbft_tpu_torch``, compiled (asserts
rewritten as pytest rewrites them) into a module of its own.  A
``test_torch_*`` file puts them into its globals, so pytest collects them
as its own items: fixtures, ``parametrize`` and marks work as they do in
the reference file.

What the reference files share resolves to port copies too:

* ``from tests.test_X import ...`` (and ``tests.conftest``) imports the
  port-compiled ``tests/test_X.py``, cached per file under the package
  ``torch_ref`` — never the JAX module of the same file;
* a case that path-loads another test file
  (``importlib.util.spec_from_file_location(.., "test_X.py")``) gets the
  port-compiled copy of that file.

A statement is left out when it needs what the port does not have: a
module (``parallel``, ``obs.benchschema``, ...), a name
such a module would give (``JaxVerifyEngine``), a file outside ``tests/``
(``benchmarks/*.py``), or a top-level name left out for one of these
reasons.  So a missing name drops only the helpers and cases that use
it.  Cases marked slow are left out as well.  :func:`dropped_tests` names
each case left out, with its reason, so a guard can hold the list exact.
:func:`case_time_limit` gives a file a time limit on every case.
"""

from __future__ import annotations

import ast
import importlib
import importlib.abc
import importlib.util
import pathlib
import re
import signal
import sys
import threading

import pytest
from _pytest.assertion.rewrite import rewrite_asserts

TESTS = pathlib.Path(__file__).resolve().parent
PKG = "torch_ref"
_PORT = "smartbft_tpu_torch"
_SPEC_HOOK = "_torch_ref_spec_from_file_location"


def port_has(module: str) -> bool:
    try:
        return importlib.util.find_spec(module) is not None
    except ModuleNotFoundError:
        return False


def _module_lacks(module: str, name: str) -> bool:
    """True when ``from module import name`` fails on the port (or on a
    port-compiled test module)."""
    if module != PKG and not module.startswith(PKG + ".") \
            and not port_has(module):
        return True
    mod = importlib.import_module(module)
    return not hasattr(mod, name) and not (
        module.startswith(_PORT) and port_has(f"{module}.{name}"))


def _names(node) -> set:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _file_loads(node) -> list:
    """The ``.py`` files a statement path-loads with
    ``spec_from_file_location`` (the string constants beside the call)."""
    calls = [n for n in ast.walk(node) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute)
             and n.func.attr == "spec_from_file_location"]
    if not calls:
        return []
    return [n.value for n in ast.walk(node) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and n.value.endswith(".py")]


_CATCH_IMPORT = {"ImportError", "ModuleNotFoundError", "Exception",
                 "BaseException"}


def _guarded_imports(node) -> set:
    """The imports inside a ``try`` whose handler catches a failed import
    (the case then runs without the module, as on a host that lacks it)."""
    out = set()
    for t in ast.walk(node):
        if isinstance(t, ast.Try) and any(
                h.type is None or _names(h.type) & _CATCH_IMPORT
                for h in t.handlers):
            out.update(id(n) for stmt in t.body for n in ast.walk(stmt))
    return out


def _lacks(node, missing: set):
    """Why the port cannot run ``node`` (None when it can)."""
    gone = _names(node) & missing
    if gone:
        return "needs " + ", ".join(sorted(gone))
    guarded = _guarded_imports(node)
    for n in ast.walk(node):
        if id(n) in guarded:
            continue
        if isinstance(n, ast.ImportFrom) and n.level == 0 and n.module \
                and (n.module.startswith(_PORT) or n.module.startswith(PKG)):
            if n.module.startswith(_PORT) and not port_has(n.module):
                return f"imports {n.module}"
            lacking = [a.name for a in n.names
                       if _module_lacks(n.module, a.name)]
            if lacking:
                return f"imports {', '.join(lacking)} from {n.module}"
        elif isinstance(n, ast.Import):
            for a in n.names:
                if a.name.startswith(_PORT) and not port_has(a.name):
                    return f"imports {a.name}"
    for f in _file_loads(node):
        if not re.fullmatch(r"test_\w+\.py", f) or not (TESTS / f).exists():
            return f"loads {f}"
    return None


class _SpecHook(ast.NodeTransformer):
    """``importlib.util.spec_from_file_location(..)`` -> the hook that
    hands out port-compiled test files."""

    def visit_Call(self, node):
        self.generic_visit(node)
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr == "spec_from_file_location":
            node.func = ast.copy_location(
                ast.Name(id=_SPEC_HOOK, ctx=ast.Load()), node.func)
        return node


def _port_tree(path: pathlib.Path):
    """The reference file's AST against the port, minus what the port
    cannot run; returns (tree, {dropped top-level name: reason})."""
    src = re.sub(r"\bsmartbft_tpu\b", _PORT, path.read_text())
    src = re.sub(r"\btests\.(test_\w+|conftest)\b", PKG + r".\1", src)
    tree = ast.parse(src, filename=str(path))
    missing: dict = {}
    body = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module and node.module.split(".")[0] in (_PORT, PKG):
            keep = []
            for a in node.names:
                if _module_lacks(node.module, a.name):
                    missing[a.asname or a.name] = f"{node.module} lacks {a.name}"
                else:
                    keep.append(a)
            if not keep:
                continue
            node.names = keep
        body.append(node)
    # a statement that needs a missing name goes, and so do its own names,
    # until nothing more needs to go
    changed = True
    while changed:
        changed = False
        kept = []
        for node in body:
            why = None if isinstance(node, (ast.Import, ast.ImportFrom)) \
                else _lacks(node, set(missing))
            if why is None:
                kept.append(node)
                continue
            changed = True
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                missing[node.name] = why
            else:
                for t in ast.walk(node):
                    if isinstance(t, ast.Name) and isinstance(t.ctx, ast.Store):
                        missing[t.id] = why
        body = kept
    tree.body = body
    tree = ast.fix_missing_locations(_SpecHook().visit(tree))
    rewrite_asserts(tree, src.encode(), str(path))
    return tree, missing


class _Loader(importlib.abc.Loader):
    def __init__(self, path: pathlib.Path):
        self.path = path

    def create_module(self, spec):
        return None

    def exec_module(self, module) -> None:
        tree, missing = _port_tree(self.path)
        module.__file__ = str(self.path)
        module.__dict__[_SPEC_HOOK] = _spec_from_file_location
        module.__dict__["__torch_ref_dropped__"] = missing
        exec(compile(tree, str(self.path), "exec"), module.__dict__)


class _Finder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """``torch_ref`` and ``torch_ref.<stem>``: the port-compiled copies
    of ``tests/<stem>.py``."""

    def find_spec(self, name, path=None, target=None):
        if name == PKG:
            return importlib.util.spec_from_loader(name, self, is_package=True)
        if name.startswith(PKG + "."):
            file = TESTS / (name.split(".", 1)[1] + ".py")
            if file.exists():
                return importlib.util.spec_from_loader(
                    name, _Loader(file), origin=str(file))
        return None

    def create_module(self, spec):
        return None

    def exec_module(self, module) -> None:
        module.__path__ = []


def _spec_from_file_location(name, location, *args, **kw):
    file = pathlib.Path(location)
    if file.parent != TESTS:
        raise ImportError(f"{file}: the port runs test files only")
    return importlib.util.spec_from_loader(name, _Loader(file),
                                           origin=str(file))


if not any(isinstance(f, _Finder) for f in sys.meta_path):
    sys.meta_path.insert(0, _Finder())


def _module(fname: str):
    return importlib.import_module(f"{PKG}.{pathlib.Path(fname).stem}")


def _slow(fn) -> bool:
    return any(m.name == "slow" for m in getattr(fn, "pytestmark", []))


def _defs(fname: str, first: int, last: int):
    tree = ast.parse((TESTS / fname).read_text())
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n.name.startswith("test_") and first <= n.lineno <= last]


def reference_tests(fname: str, first: int = 1, last: int = 10 ** 9,
                    leave_out: dict = None) -> dict:
    """The test functions of ``tests/<fname>`` defined on lines
    ``first..last``, compiled against the port, keyed by their item name
    ``<file stem>__<case>`` (e.g. ``test_basic__test_basic_happy_path``),
    minus those the port cannot run, those marked slow and those named in
    ``leave_out`` ({case: reason}: where the port differs by design, or
    the case is unsteady on both packages)."""
    stem = pathlib.Path(fname).stem
    gone = dropped_tests(fname, first, last, leave_out)
    mod = _module(fname)
    return {f"{stem}__{name}": mod.__dict__[name]
            for name in _defs(fname, first, last) if name not in gone}


def dropped_tests(fname: str, first: int = 1, last: int = 10 ** 9,
                  leave_out: dict = None) -> dict:
    """{case: why the port leaves it out} over the same lines."""
    mod = _module(fname)
    dropped = mod.__dict__["__torch_ref_dropped__"]
    out = {}
    for name in _defs(fname, first, last):
        fn = mod.__dict__.get(name)
        if fn is None:
            out[name] = dropped[name]
        elif _slow(fn):
            out[name] = "marked slow"
        elif leave_out and name in leave_out:
            out[name] = leave_out[name]
    return out


def jax_globals(fn) -> list:
    """The globals of a compiled case that come from the JAX package
    (none, when the case runs on the port)."""
    out = []
    for name, v in fn.__globals__.items():
        mod = v.__name__ if isinstance(v, type(sys)) \
            else getattr(v, "__module__", None)
        if isinstance(mod, str) and mod.split(".")[0] in ("smartbft_tpu",
                                                          "jax"):
            out.append(name)
    return out


def check_matrices(cases: dict, left_out: dict, leave_out: dict = None):
    """The guard of a file that runs reference matrices: ``cases`` maps
    each reference file to the exact number of its cases the port runs,
    ``left_out`` to the exact names it leaves out (files leaving none out
    absent), and every case runs compiled against the port."""
    got = {f: reference_tests(f, leave_out=leave_out) for f in cases}
    assert {f: len(c) for f, c in got.items()} == cases
    assert {f: sorted(d) for f in cases
            if (d := dropped_tests(f, leave_out=leave_out))} == left_out
    for found in got.values():
        for fn in found.values():
            assert fn.__module__.startswith(PKG + ".")
            assert not jax_globals(fn), fn.__name__


def case_time_limit(seconds: int = 60, cases: dict = None):
    """An autouse fixture that fails a case still running after
    ``seconds`` (``SIGALRM``; the suite runs without pytest-timeout), so
    a case that hangs, as a socket close did, fails on its own instead
    of holding its worker until the run is cut.  ``cases`` gives the
    cases named in it (``{item name: seconds}``) limits of their own.
    Bind it to a name in a test file's globals to arm it for every case
    of that file."""

    @pytest.fixture(autouse=True)
    def _case_time_limit(request):
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError("the case time limit needs the main thread")
        limit = (cases or {}).get(request.node.originalname, seconds)

        def expire(signum, frame):
            pytest.fail(f"{request.node.nodeid} still running after "
                        f"{limit} s", pytrace=False)

        old = signal.signal(signal.SIGALRM, expire)
        signal.alarm(limit)
        try:
            yield
        finally:
            signal.alarm(0)
            signal.signal(signal.SIGALRM, old)

    return _case_time_limit


def virtual_devices(n: int = 8):
    """A module-scoped autouse fixture that gives the port ``n`` virtual
    CPU devices (``torchenv.force_cpu(virtual_devices=n)``) for the cases
    of a file and puts the previous device list back after them, so no
    file depends on which files ran before it in a worker.  Bind it to a
    name in a test file's globals to arm it."""

    @pytest.fixture(scope="module", autouse=True)
    def _virtual_devices():
        from smartbft_tpu_torch.utils import torchenv

        previous = torchenv.force_cpu(virtual_devices=n)
        yield
        torchenv.restore(previous)

    return _virtual_devices
