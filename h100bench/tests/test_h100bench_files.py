"""The benchmark's files: BENCHMARK.json against its contract, and every
cell, configuration, traffic mix, metric and count found by name."""

import json
import re
import shutil

import pytest

from h100bench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100bench"]
    assert BENCH["command"] == ["python3", "h100bench/run.py"]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # A full check of 24 cells fits: 2 + 14 runs a cell of rs + 60 s, two
    # compiles of 90 s a cell and 1200 s spare, in 43200 s.
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_entries():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("h100bench/")
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["config"] in names
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for group in (names, CELLS, [m["name"] for m in metrics]):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0]


def test_every_cell_reports_what_the_contract_asks():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", CELLS)
        assert set(m["workloads"]) <= set(moved), m["name"]
    for name in CELLS:
        cell = harness.Cell(name, BENCH)
        reported = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_load_by_name(name):
    cell = harness.Cell(name, BENCH)
    for key in ("scene", "reference_scene", "nx", "ny", "spp", "max_depth",
                "precision", "source", "reduced", "assumed"):
        assert key in cell.config
    assert set(cell.limits["limits"]) and cell.limits["readings"] is not None
    for fn in ("setup", "window", "traced", "free", "check"):
        assert callable(getattr(cell.driver, fn))
    for m in cell.per_layer:
        assert callable(cell.metric_reader(m["name"]).read)


@pytest.mark.parametrize("kernel", ["b1", "fwd"])
def test_counts_load_by_name(kernel):
    assert callable(harness.count_module(kernel).bound)


def test_a_cell_config_and_metric_added_as_files(tmp_path):
    """A later change adds a configuration, a traffic mix, a metric and a
    cell by new files and entries alone."""
    here = tmp_path / "h100bench"
    shutil.copytree(harness.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((here / "configs" / "cornell.json").read_text())
    cfg.update(name="cornell_small", nx=16, ny=16, spp=8)
    (here / "configs" / "cornell_small.json").write_text(json.dumps(cfg))
    tr = json.loads((here / "traffic" / "render.json").read_text())
    (here / "traffic" / "render_burst.json").write_text(
        json.dumps(dict(tr, trace_items=2)))
    (here / "limits" / "cornell_small.burst.json").write_text(
        (here / "limits" / "cornell.render.json").read_text())
    (here / "metrics" / "device_busy_s.py").write_text(
        "def read(tr):\n    return tr.busy_s or None\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "cornell_small", "source": "x",
                             "file": "h100bench/configs/cornell_small.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "cornell_small.burst",
                               "config": "cornell_small",
                               "traffic": "render_burst", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "device_busy_s", "unit": "s",
                               "better": "lower", "source": "device_trace",
                               "layer": "x", "moves": "setup_s",
                               "workloads": ["cornell_small.burst"]})
    cell = harness.Cell("cornell_small.burst", bench, here=here)
    assert cell.config["nx"] == 16 and cell.traffic["trace_items"] == 2
    assert [m["name"] for m in cell.per_layer] == ["device_busy_s"]
    tr = harness.Trace([(0.0, 5e5, "k")], 1.0, {}, {})
    assert cell.metric_reader("device_busy_s").read(tr) == 0.5
