"""BENCHMARK.json keeps to the benchmark's contract, and every cell in it
resolves by name to its configuration, traffic mix, driver and metric
readers."""

import importlib
import json
import os
import re

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
BENCH_PATH = os.path.join(ROOT, "BENCHMARK.json")
BENCH = json.load(open(BENCH_PATH))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def metrics_of(cell):
    from portbench import harness as H

    c = H.load_cell(cell)
    return c, [m["name"] for m in c.end_to_end], [m["name"] for m in c.per_layer]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert os.path.getsize(BENCH_PATH) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and len(BENCH["command"]) <= 32
    for path in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", path) and ".." not in path
        assert os.path.isdir(os.path.join(ROOT, path))
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


def test_entries_have_exactly_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
             + [w["traffic"] for w in BENCH["workloads"]] + [w["config"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    for name in names:
        assert NAME.match(name), name
    for group in (BENCH["configs"], BENCH["workloads"], BENCH["end_to_end"] + BENCH["per_layer"]):
        assert len({x["name"] for x in group}) == len(group)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in BENCH["configs"]] + [w["why"] for w in BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]] + [c["source"] for c in BENCH["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_sources_bounds_and_window():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    seconds = BENCH["run_seconds"]
    assert isinstance(seconds, int) and 1 <= seconds <= 51
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (seconds + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configurations_are_used_and_their_files_lie_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p.rstrip("/") + "/") for p in BENCH["paths"])
        config = json.load(open(os.path.join(ROOT, c["file"])))
        assert sorted(config.get("reduced", [])) == sorted(c["reduced"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    from portbench import harness as H

    c, end_to_end, per_layer = metrics_of(cell)
    assert c.chips == 1
    driver = H.driver_module(c)
    assert hasattr(driver, "Driver")
    for name in end_to_end + per_layer:
        if name != "setup_s":
            assert callable(H.metric_reader(name)), name
    assert "setup_s" in end_to_end and len(end_to_end) >= 2 and per_layer


@pytest.mark.parametrize("cell", CELLS)
def test_per_layer_metrics_move_what_their_cells_report(cell):
    c, end_to_end, _ = metrics_of(cell)
    for m in c.per_layer:
        assert m["moves"] in end_to_end, (cell, m["name"])


def test_a_layer_has_one_name():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    perf = open(os.path.join(ROOT, "PERF.md")).read()
    for layer in layers:
        assert f"`{layer}`" in perf, layer


def test_every_driver_and_reader_imports():
    for name in os.listdir(os.path.join(HERE, "drivers")):
        if name.endswith(".py") and name != "__init__.py":
            importlib.import_module("portbench.drivers." + name[:-3])

