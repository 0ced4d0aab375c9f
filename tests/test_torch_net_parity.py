"""The port's socket transport, replica process and cluster held to the
JAX package's.

``net/transport.py``, ``net/launch.py`` and ``net/cluster.py`` are
copies.  Each module's AST, docstrings stripped, is compared with the
reference's function by function (a method is ``Class.method``; a
class's or module's other statements go under the class or
``<module>``).  Only the functions listed in ``DIFFERS`` may differ, and
each difference is checked for what it is:

* the shutdown repair, the port's one semantic change:
  ``SocketComm.close`` closes the connections it accepted before it
  awaits the server's ``wait_closed()``, and ``ControlServer`` keeps the
  writers ``_serve`` holds so that ``close`` can shut them first
  (``tests/test_torch_net_shutdown.py`` shows both outcomes);
* the replica entry point in ``SocketCluster.spawn``'s argv;
* ``SocketCluster.__init__``'s child environment, which no longer sets
  ``JAX_PLATFORMS`` (the replica process imports no JAX);
* ``run_snapshot_rejoin``'s crash height, read off the dead victim's
  ledger file instead of only its last control-channel answer
  (``tests/test_torch_snapshot_rejoin_oracle.py`` shows both outcomes)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
COPIES = ["net/transport.py", "net/launch.py", "net/cluster.py"]

DIFFERS = {
    "net/transport.py": {"SocketComm.close"},
    "net/launch.py": {"ControlServer.__init__", "ControlServer.close",
                      "ControlServer._serve"},
    "net/cluster.py": {"SocketCluster.__init__", "SocketCluster.spawn",
                       "run_snapshot_rejoin"},
}


def _strip_docstrings(tree):
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and body \
                and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return tree


def _units(src: str) -> dict:
    """{qualified function name: its AST node} of a module."""
    tree = _strip_docstrings(ast.parse(src))
    out: dict = {"<module>": []}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            rest = []
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{item.name}"] = item
                else:
                    rest.append(item)
            out[node.name] = (node.bases, node.decorator_list, rest)
        else:
            out["<module>"].append(node)
    return out


def _dump(unit) -> str:
    if isinstance(unit, (list, tuple)):
        return repr([_dump(u) for u in unit])
    return ast.dump(unit, include_attributes=False)


def _pair(rel):
    ref = _units((ROOT / "smartbft_tpu" / rel).read_text())
    port = _units((ROOT / "smartbft_tpu_torch" / rel).read_text())
    return ref, port


@pytest.mark.parametrize("rel", COPIES)
def test_copy_differs_only_where_listed(rel):
    ref, port = _pair(rel)
    assert sorted(port) == sorted(ref)
    differ = {name for name in ref if _dump(ref[name]) != _dump(port[name])}
    assert differ == DIFFERS[rel]


def test_the_comparison_sees_a_changed_statement():
    src = (ROOT / "smartbft_tpu_torch" / "net" / "transport.py").read_text()
    changed = src.replace("backoff = min(backoff * 2,", "backoff = min(backoff * 3,", 1)
    assert changed != src
    a, b = _units(src), _units(changed)
    assert {n for n in a if _dump(a[n]) != _dump(b[n])} == {
        "SocketComm._peer_sender"}


def _calls(node, attr):
    return [n for n in ast.walk(node) if isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute) and n.func.attr == attr]


def _line_of_first(node, attr):
    return min(c.lineno for c in _calls(node, attr))


def test_socket_comm_close_shuts_accepted_connections_before_waiting():
    ref, port = _pair("net/transport.py")
    close = port["SocketComm.close"]
    # the server's wait_closed comes after every inbound writer is closed
    # and every reader cancelled; in the reference it comes first
    waited = _line_of_first(close, "wait_closed")
    closes = [c for c in _calls(close, "close")
              if isinstance(c.func.value, ast.Name)
              and c.func.value.id == "writer"]
    assert closes and all(c.lineno < waited for c in closes)
    assert _line_of_first(close, "cancel") < waited
    r_close = ref["SocketComm.close"]
    assert _line_of_first(r_close, "wait_closed") < min(
        c.lineno for c in _calls(r_close, "cancel"))


def test_control_server_tracks_and_closes_its_connections():
    ref, port = _pair("net/launch.py")
    init, close, serve = (port[f"ControlServer.{m}"]
                          for m in ("__init__", "close", "_serve"))
    assert "_writers" in ast.dump(init) and "_writers" not in ast.dump(
        ref["ControlServer.__init__"])
    assert _line_of_first(close, "close") < _line_of_first(close, "wait_closed")
    assert [ast.unparse(c) for c in _calls(serve, "add")] == [
        "self._writers.add(writer)"]
    assert [ast.unparse(c) for c in _calls(serve, "discard")] == [
        "self._writers.discard(writer)"]


def test_spawn_names_the_port_entry_point_and_nothing_else_changed():
    ref, port = _pair("net/cluster.py")
    mapped = ast.dump(ref["SocketCluster.spawn"]).replace(
        "'smartbft_tpu.net.launch'", "'smartbft_tpu_torch.net.launch'")
    assert ast.dump(port["SocketCluster.spawn"]) == mapped
    assert "'smartbft_tpu_torch.net.launch'" in mapped


def test_child_environment_drops_only_jax_platforms():
    ref, port = _pair("net/cluster.py")
    r_init = ref["SocketCluster.__init__"]
    for call in ast.walk(r_init):
        if isinstance(call, ast.Call) and any(
                k.arg == "JAX_PLATFORMS" for k in call.keywords):
            call.keywords = [k for k in call.keywords
                             if k.arg != "JAX_PLATFORMS"]
    assert ast.dump(port["SocketCluster.__init__"]) == ast.dump(r_init)
    assert "JAX" not in ast.dump(port["SocketCluster.__init__"])


def test_package_exports_the_transport_as_the_reference_does():
    import smartbft_tpu.net as j_net
    import smartbft_tpu_torch.net as t_net

    assert t_net.__all__ == j_net.__all__
    assert {"SocketComm", "TransportMetrics"} <= set(t_net.__all__)
    assert t_net.SocketComm.__module__ == "smartbft_tpu_torch.net.transport"


def test_snapshot_rejoin_differs_only_in_the_persisted_crash_height():
    """Take out of the port's ``run_snapshot_rejoin`` the statements that
    read the victim's ledger file and raise the crash height to it: what
    is left is the reference's function."""
    ref, port = _pair("net/cluster.py")
    fn = port["run_snapshot_rejoin"]
    added = [n for n in fn.body if isinstance(n, (ast.ImportFrom, ast.With))
             or (isinstance(n, ast.Assign) and ast.unparse(n) in (
                 "persisted = ledger.read_all()",
                 "victim_h = max(victim_h, ledger.base_height + "
                 "len(persisted))"))]
    assert [type(n).__name__ for n in added] == [
        "ImportFrom", "With", "Assign", "Assign"]
    assert ast.unparse(added[0]) == "from .launch import LedgerFile"
    assert "LedgerFile(json.load(fh)['ledger_path'])" in ast.unparse(added[1])
    rest = [n for n in fn.body if n not in added]
    trimmed = ast.FunctionDef(name=fn.name, args=fn.args, body=rest,
                              decorator_list=fn.decorator_list,
                              returns=fn.returns, type_comment=None,
                              type_params=[])
    assert _dump(trimmed) == _dump(ref["run_snapshot_rejoin"])
