"""A cell defined only in data, for the CPU tests: a copy of the
benchmark's files under a temporary root, with a 320x96 configuration
(`tiny`), a two-lane traffic mix (`lockstep2`) and the cell
`tiny.lockstep2` added to its BENCHMARK.json. On the CPU the port runs
its kernels' plain versions, whose float32 sums and solves stand in for
K3's, K4's and K5's float64 ones: the configuration allows K3, K4 and K5
the gaps of that arithmetic."""

from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = "tiny.lockstep2"


def make(root):
    bench = os.path.join(root, "vo_bench")
    for sub in ("configs", "traffic", "metrics", "checks"):
        shutil.copytree(os.path.join(REPO, "vo_bench", sub),
                        os.path.join(bench, sub), dirs_exist_ok=True)
    with open(os.path.join(bench, "configs", "kitti00_default.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny", camera=dict(w=320, h=96, fx=192.0, fy=192.0,
                                        cx=159.5, cy=47.5),
               warmup=dict(min_rounds=3, quiet_rounds=1, max_rounds=4),
               rounds_per_s_ceiling=2.0, traced_rounds=2,
               checked_rounds=[0, 2])
    cfg["limits"]["k3_row_err"] = 1e-4
    cfg["limits"]["k4_rel_err"] = 0.05
    cfg["limits"]["k5_px_err"] = 0.01
    with open(os.path.join(bench, "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "lockstep8.json")) as f:
        tr = json.load(f)
    tr.update(name="lockstep2", lanes=2)
    with open(os.path.join(bench, "traffic", "lockstep2.json"), "w") as f:
        json.dump(tr, f)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append(dict(name="tiny", source="test",
                             file="vo_bench/configs/tiny.json", reduced=[],
                             why="test"))
    b["workloads"].append(dict(name=CELL, config="tiny", traffic="lockstep2",
                               chips=1, why="test"))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    return root


def run(root, seed=9876543210123, seconds=3.0, trace=False):
    """One CPU run of the tiny cell: (result line, numbers compared)."""
    import torch

    from vo_bench import cells
    from vo_bench import run as bench_run

    torch.set_num_threads(2)
    return bench_run.execute(cells.load(CELL, root), seed, seconds, trace,
                             "cpu")
