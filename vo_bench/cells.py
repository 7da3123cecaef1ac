"""A cell from its files alone.

`BENCHMARK.json` names the cells; a cell's configuration is
`vo_bench/configs/<config>.json`, its traffic mix
`vo_bench/traffic/<traffic>.json`, each per-layer metric is read by
`vo_bench/metrics/<name>.py`, and each comparison that decides `correct`
is a check, `vo_bench/checks/<name>.py` (`vo_bench/check.py` says what
it declares), which a cell runs when its configuration's `limits` name
one of its numbers. Adding a configuration, a traffic mix, a metric or a
check adds files and entries, and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = "vo_bench"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    root: str

    def path(self, rel):
        return os.path.join(self.root, rel)


def _applies(metric, cell, moves_ok):
    """A metric's `workloads` list, where it has one, names its cells;
    otherwise an end-to-end metric is every cell's, and a per-layer one
    every cell's that reports the end-to-end metric it moves."""
    ws = metric.get("workloads")
    return cell in ws if ws is not None else moves_ok


def load(name, root=ROOT):
    """The cell `name` of `root`'s BENCHMARK.json, with its configuration,
    traffic and the metrics it reports."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, BENCH_DIR, "traffic",
                           wl["traffic"] + ".json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, True)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _applies(m, name, m["moves"] in names)]
    return Cell(name, wl["chips"], config, traffic, e2e, layer, root)


def _module(kind, name, root):
    path = os.path.join(root, BENCH_DIR, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"vo_bench_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name, root=ROOT):
    """The module that reads per-layer metric `name`."""
    return _module("metrics", name, root)


def check(name, root=ROOT):
    """The check module `name`."""
    return _module("checks", name, root)


def checks(cell):
    """The checks `cell` runs: those of its root's `vo_bench/checks/`
    whose numbers its configuration's `limits` name, by file name."""
    folder = os.path.join(cell.root, BENCH_DIR, "checks")
    names = sorted(f[:-3] for f in os.listdir(folder) if f.endswith(".py"))
    mods = [check(n, cell.root) for n in names]
    return [m for m in mods if set(m.NUMBERS) & set(cell.config["limits"])]
