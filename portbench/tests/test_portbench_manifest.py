"""BENCHMARK.json against the contract's form, and every name it holds
found as a file of the harness."""

import importlib
import json
import os
import re

import pytest

from portbench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TEXT_KEYS = ("why", "layer", "source")


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "-m", "portbench.run"]
    assert bench["paths"] == ["portbench"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    path = os.path.join(run.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024


def test_a_full_check_fits_its_time_with_24_cells(bench):
    runs = 2 + 14 * 24
    seconds = runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert seconds <= 43200


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end",
                                 "per_layer"])
def test_names_are_unique_and_of_allowed_characters(bench, key):
    names = [e["name"] for e in bench[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_entries_have_exactly_the_contract_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_units_texts_and_bounds(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for e in bench["configs"] + bench["workloads"] + bench["per_layer"]:
        for k in TEXT_KEYS:
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] \
                    and "\t" not in e[k]
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    setup = next(m for m in bench["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup and setup["bound"] <= 0.25


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(bench):
    for w in bench["workloads"]:
        e2e = run.metrics_of(bench, w["name"], "end_to_end")
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert run.metrics_of(bench, w["name"], "per_layer")


def test_each_layer_metric_moves_an_end_to_end_metric_of_its_cells(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])


def test_the_harness_finds_every_name(bench):
    for c in bench["configs"]:
        cfg = json.load(open(os.path.join(run.ROOT, c["file"])))
        assert c["file"].startswith("portbench/configs/")
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert all(k in cfg for k in c["reduced"])
    for w in bench["workloads"]:
        entry, cell, cfg = run.find_cell(bench, w["name"])
        assert cell["why"] == w["why"] and cell["chips"] == w["chips"]
        gen = importlib.import_module(f"portbench.traffic.{cell['generator']}")
        assert callable(gen.run)
    for m in bench["per_layer"]:
        assert callable(run.reader(m["name"]))


def test_an_unknown_cell_is_refused(bench):
    with pytest.raises(run.Unmeasurable):
        run.find_cell(bench, "no-such.cell")


def test_every_configuration_is_used_and_each_pair_appears_once(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
