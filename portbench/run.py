"""Run one cell of the benchmark of ``smartbft_tpu_torch`` on the card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name from ``BENCHMARK.json``: the cell's file
``workloads/<cell>.json`` (its configuration, its traffic generator and
parameters), the configuration's file, the generator
``traffic/<generator>.py``, and with ``--trace 1`` each per-layer metric's
reader ``metrics/<metric>.py``.  The last line on standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(and ``breakdown`` in a traced run), with the numbers the run compared,
each beside its limit, under ``checks``; the same numbers close standard
error.  A run that cannot measure prints one line naming why, and exits
with a nonzero code.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level modules that must not be loaded when the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "smartbft_tpu")


class Unmeasurable(Exception):
    """The run cannot measure: no card, too few cards, or a missing part."""


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(rel: str) -> dict:
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> tuple[dict, dict, dict]:
    """(manifest entry, cell file, configuration file) of cell ``name``."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise Unmeasurable(f"no workload named {name!r} in BENCHMARK.json")
    cell = load_json(f"portbench/workloads/{name}.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cfg = load_json(conf["file"])
    if cell["config"] != entry["config"] or cell["traffic"] != entry["traffic"]:
        raise Unmeasurable(f"workloads/{name}.json disagrees with "
                           "BENCHMARK.json on its configuration or traffic")
    return entry, cell, cfg


def metrics_of(bench: dict, name: str, key: str) -> list[dict]:
    """The ``key`` metrics ("end_to_end" or "per_layer") cell ``name``
    reports."""
    return [m for m in bench[key]
            if "workloads" not in m or name in m["workloads"]]


def reader(metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


class Cell:
    """One run of a cell: what the generator needs, and what it reports
    back through ``setup_done`` and ``read_memory``."""

    def __init__(self, name: str, cell: dict, cfg: dict, seed: int,
                 seconds: float, trace: bool, device: str = "cuda",
                 workers: int | None = None, fault: str | None = None,
                 params: dict | None = None, nodes: int | None = None):
        from . import signer
        from .trace import Window

        self.name, self.seed = name, seed
        self.cfg = cfg if nodes is None else dict(cfg, nodes=nodes)
        self.params = dict(cell["params"], **(params or {}))
        self.seconds, self.trace, self.device = seconds, trace, device
        self.workers = signer.default_workers() if workers is None else workers
        self.fault = fault
        self.window = Window(trace, device == "cuda")
        self.setup_s = None
        self.memory_peak_bytes = 0
        self.marks: dict[str, float] = {}
        self.gc_s: dict[str, float] = {}

    def mark(self, what: str) -> None:
        """Note the seconds since the process started at the end of a
        step of set-up (reported under ``info``)."""
        self.marks[what] = round(time.perf_counter() - T_START, 3)

    def setup_done(self) -> None:
        """The generator's set-up is over: the next operation is timed.
        Every object made so far (the benchmark's pool of inputs above
        all) leaves the cyclic collector's generations, so that the
        collector does not scan the harness's data inside the window."""
        gc.collect()
        gc.freeze()
        gc.callbacks.append(self._gc_timer)
        self.setup_s = time.perf_counter() - T_START

    def _gc_timer(self, phase: str, info: dict) -> None:
        """Seconds the cyclic collector held the interpreter inside the
        window, by generation (reported under ``info``)."""
        if self.window.t1:
            return
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif hasattr(self, "_gc_t0"):
            key = f"gen{info['generation']}"
            self.gc_s[key] = self.gc_s.get(key, 0.0) \
                + time.perf_counter() - self._gc_t0

    def read_memory(self) -> None:
        """Read the card's peak memory; the generator calls this when the
        window has closed, before its reference runs."""
        if self.device == "cuda":
            import torch

            self.memory_peak_bytes = torch.cuda.max_memory_allocated()


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", **kw) -> dict:
    """Run cell ``name`` and return the result object of the last line."""
    entry, cell_file, cfg = find_cell(bench, name)
    cell = Cell(name, cell_file, cfg, seed, seconds, trace, device, **kw)
    gen = importlib.import_module(
        f"portbench.traffic.{cell_file['generator']}")
    out = gen.run(cell)
    checks = [{"name": k, "value": v, "limit": lim}
              for k, v, lim in out["checks"]]
    correct = all(c["value"] <= c["limit"] for c in checks) \
        and out["failed"] == 0
    metrics = {}
    layer_run = dict(out["layer"], cfg=cell.cfg, window_s=cell.window.seconds,
                     timeline=cell.window.timeline)
    if trace:
        for m in metrics_of(bench, name, "per_layer"):
            value = reader(m["name"])(layer_run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in metrics_of(bench, name, "end_to_end"):
            value = cell.setup_s if m["name"] == "setup_s" \
                else out["e2e"].get(m["name"])
            if value is None:
                raise RuntimeError(f"cell {name} reports no {m['name']}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": device_block(device, entry["chips"],
                                     cell.memory_peak_bytes,
                                     cell.window.timeline),
              "info": dict(out["info"], setup_s=cell.setup_s, marks=cell.marks,
                           gc_s=cell.gc_s,
                           window_s=cell.window.seconds,
                           **{k: v for k, v in out["e2e"].items()})}
    if cell.window.timeline is not None:
        tl = cell.window.timeline
        result["breakdown"] = {"device_ops": tl["device_ops"],
                               "idle_gaps": tl["idle_gaps"]}
    result["checks"] = checks
    return result


def device_block(device: str, chips: int, peak: int, timeline) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips, "memory_peak_bytes": peak}
    if timeline is not None:
        out["busy_s"] = timeline["busy_s"]
        out["window_s"] = timeline["window_s"]
    return out


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def require_cards(chips: int) -> None:
    try:
        import torch
    except ImportError as exc:
        raise Unmeasurable(f"torch does not import: {exc}") from exc
    if not torch.cuda.is_available():
        raise Unmeasurable("no CUDA card is visible")
    if torch.cuda.device_count() < chips:
        raise Unmeasurable(f"the cell needs {chips} cards, "
                           f"{torch.cuda.device_count()} are visible")


def main(argv=None) -> int:
    args = parse(argv)
    phase = "setup"
    try:
        bench = manifest()
        entry, _, _ = find_cell(bench, args.workload)
        require_cards(entry["chips"])
        phase = "run"
        result = run_cell(bench, args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except Unmeasurable as exc:
        print(json.dumps({"phase": phase, "ok": False, "error": str(exc)}))
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    except Exception as exc:  # noqa: BLE001 — one line naming the phase
        import traceback

        traceback.print_exc()
        print(json.dumps({"phase": phase, "ok": False,
                          "error": f"{type(exc).__name__}: {exc}"}))
        return 1
    found = forbidden_modules()
    if found:
        msg = f"loaded after the window: {', '.join(found)}"
        print(json.dumps({"phase": "imports", "ok": False, "error": msg}))
        print(f"portbench: {msg}", file=sys.stderr)
        return 3
    print(f"correct: {result['correct']}", file=sys.stderr)
    for c in result["checks"]:
        print(f"check {c['name']}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
