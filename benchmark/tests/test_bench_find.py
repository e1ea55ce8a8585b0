"""The harness finds every cell, configuration, mix and per-layer metric
by the name ``BENCHMARK.json`` gives it, and the entries keep to the
shape the benchmark's format asks for."""
import os
import re

import pytest

from benchmark import harness
from benchmark.tests.common import ROOT, bench

B = bench()
CELLS = [w["name"] for w in B["workloads"]]
PER_LAYER = [m["name"] for m in B["per_layer"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["benchmark"]
    assert B["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= B["run_seconds"] <= 51


@pytest.mark.parametrize("name", CELLS)
def test_cell_finds_its_files(name):
    cell = harness.find_cell(B, name)
    w = next(w for w in B["workloads"] if w["name"] == name)
    assert cell.config["name"] == w["config"]
    assert isinstance(cell.mix["refactor"], bool)
    assert cell.steps.__name__ == "benchmark.steps." + cell.mix["step"]
    for fn in ("make_inputs", "make_system", "prepare", "window", "check"):
        assert callable(getattr(cell.steps, fn))
    assert "x_err" in cell.limits
    # every end-to-end metric of the cell is a statistic its mix names
    for m in cell.end_to_end:
        assert m["name"] == "setup_s" or m["name"] in cell.mix["metrics"]
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_a_mix_names_its_step_kind(tmp_path):
    """A mix added as a data file, naming a kind, is found with no edit."""
    import json
    import shutil
    here = os.path.join(ROOT, "benchmark")
    for sub in ("configs", "traffic", "limits"):
        shutil.copytree(os.path.join(here, sub), tmp_path / sub)
    mix = harness.load_json(os.path.join(here, "traffic", "resolve.json"))
    (tmp_path / "traffic" / "resolve_long.json").write_text(
        json.dumps(dict(mix, rhs=64)))
    shutil.copy(tmp_path / "limits" / f"{CELLS[0].split('.')[0]}.resolve.json",
                tmp_path / "limits" / "x.resolve_long.json")
    bench = dict(B, workloads=[{"name": "x.resolve_long",
                                "config": CELLS[0].split(".")[0],
                                "traffic": "resolve_long", "chips": 1,
                                "why": "w"}])
    cell = harness.find_cell(bench, "x.resolve_long", here=str(tmp_path))
    assert cell.mix["rhs"] == 64 and cell.steps.__name__.endswith(mix["step"])


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.find_cell(B, "no_such.cell")


@pytest.mark.parametrize("name", PER_LAYER)
def test_metric_file_agrees_with_benchmark(name):
    """The reader is found by the metric's name; its unit, layer and the
    metric it moves live in BENCHMARK.json alone."""
    entry = next(m for m in B["per_layer"] if m["name"] == name)
    mod = harness.load_metric(name)
    assert callable(mod.read)
    assert not {"UNIT", "LAYER", "SOURCE", "MOVES"} & set(vars(mod))
    # each cell it lists reports the end-to-end metric it moves
    for cell in entry.get("workloads", CELLS):
        e2e = {m["name"] for m in harness.find_cell(B, cell).end_to_end}
        assert entry["moves"] in e2e


def test_every_config_file_and_use():
    used = {w["config"] for w in B["workloads"]}
    for c in B["configs"]:
        assert c["name"] in used
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        cfg = harness.load_json(os.path.join(ROOT, c["file"]))
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}


def test_names_units_and_lines():
    names = ([c["name"] for c in B["configs"]] + CELLS
             + [m["name"] for m in B["end_to_end"]] + PER_LAYER)
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in B["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert "\n" not in w["why"] and "\t" not in w["why"]
    for c in B["configs"]:
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
