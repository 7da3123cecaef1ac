"""The harness finds a cell, its configuration, traffic and metrics from
its files alone, and BENCHMARK.json keeps to the benchmark's contract."""

import json
import os
import re

import pytest

from vo_bench import cells
from vo_bench.tests import tiny_cell

REPO = tiny_cell.REPO
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keeps_to_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["vo_bench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    assert len({x["name"] for x in bench["end_to_end"] + bench["per_layer"]}) \
        == len(bench["end_to_end"]) + len(bench["per_layer"])
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("vo_bench/")
        assert os.path.exists(os.path.join(REPO, c["file"]))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("workload", ["kitti00_default.lockstep8"])
def test_cell_found_from_its_files(workload):
    cell = cells.load(workload, REPO)
    assert cell.config["name"] == workload.split(".")[0]
    assert cell.traffic["name"] == workload.split(".")[1]
    assert cell.traffic["lidar_stride"] == 1
    assert {m["name"] for m in cell.end_to_end} == {"fleet_fps",
                                                    "mib_per_seq", "setup_s"}
    assert cell.per_layer


def test_every_per_layer_metric_has_a_reader_that_agrees(bench):
    for m in bench["per_layer"]:
        mod = cells.reader(m["name"], REPO)
        assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == \
            (m["layer"], m["unit"], m["source"], m["moves"])
        assert callable(mod.read)


def test_a_cell_defined_only_in_data(tmp_path):
    """A new configuration, traffic mix and metric are files and entries
    of their own: the harness finds them with no edit to its code."""
    root = tiny_cell.make(str(tmp_path))
    with open(os.path.join(root, "vo_bench", "metrics",
                           "fleet.rounds_in_window.py"), "w") as f:
        f.write('LAYER = "fleet (system/multi.MultiSystem)"\nUNIT = "rounds"\n'
                'SOURCE = "host_clock"\nMOVES = "fleet_fps"\n\n\n'
                'def read(ctx):\n    return ctx["rounds"]\n')
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        b = json.load(f)
    b["per_layer"].append(dict(name="fleet.rounds_in_window", unit="rounds",
                               better="higher", source="host_clock",
                               layer="fleet (system/multi.MultiSystem)",
                               moves="fleet_fps"))
    with open(path, "w") as f:
        json.dump(b, f)
    cell = cells.load(tiny_cell.CELL, root)
    assert cell.config["camera"]["w"] == 320 and cell.traffic["lanes"] == 2
    assert "fleet.rounds_in_window" in {m["name"] for m in cell.per_layer}
    assert cells.reader("fleet.rounds_in_window", root).read(
        {"rounds": 7}) == 7
    # no list of cells: every cell that reports `fleet_fps` reports it
    other = cells.load("kitti00_default.lockstep8", root)
    assert "fleet.rounds_in_window" in {m["name"] for m in other.per_layer}
    assert not any("workloads" in m for m in b["per_layer"])
