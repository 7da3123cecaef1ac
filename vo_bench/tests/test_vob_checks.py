"""The check is driven by files: a cell runs the checks of
`vo_bench/checks/` whose numbers its configuration's `limits` name, a
check added only as a file (with a configuration and a cell of its own)
is run and judged, and the harness's generic parts name no kernel and no
stage program."""

import json
import os
import re

from vo_bench import cells, check
from vo_bench.tests import tiny_cell

REPO = tiny_cell.REPO
TOY = '''"""Counts the distance-transform calls of the activation program."""

PROGRAMS = {"activate": "next"}
TAPS = (("sdv_loam_tpu_torch.ops.distmap", "distance_transform", "K2"),)
NUMBERS = ("toy_k2_calls",)


def reference(kernel, args, kwargs, out, low=False):
    return None


def numbers(compared):
    return dict(toy_k2_calls=sum(1 for _ in compared))
'''


def _names():
    """Every kernel, dispatcher and stage program the checks name."""
    folder = os.path.join(REPO, "vo_bench", "checks")
    out = set()
    for f in sorted(os.listdir(folder)):
        if f.endswith(".py"):
            mod = cells.check(f[:-3], REPO)
            out |= set(mod.PROGRAMS)
            out |= {x for _, attr, kernel in mod.TAPS for x in (attr, kernel)}
    return out


def test_generic_parts_name_no_kernel_and_no_program():
    names = _names()
    assert {"track", "kf_opt", "K7", "linearize_residuals_lanes"} <= names
    for part in ("check.py", "fleet.py"):
        with open(os.path.join(REPO, "vo_bench", part)) as f:
            words = set(re.findall(r"[A-Za-z_][A-Za-z0-9_.]*", f.read()))
        assert not names & words, (part, names & words)


def test_the_default_configuration_runs_every_check():
    cell = cells.load("kitti00_default.lockstep8", REPO)
    run = [m.__name__.rsplit("_", 1)[-1] for m in cells.checks(cell)]
    assert run == ["k1", "k2", "k3", "k4", "k5", "k7", "k8"]
    # the same programs at the same rounds as the fixed list before
    assert check.programs(cells.checks(cell)) == {
        "kf_opt": "next", "activate": "next", "track": "round"}


def test_recorder_arms_by_when():
    rec = check.Recorder([3], {"track": "round", "kf_opt": "next"})
    rec.start_round(2)
    assert rec.armed == set()
    rec.start_round(3)
    assert rec.armed == {"track", "kf_opt"}
    rec.end_round()
    assert rec.armed == {"kf_opt"}


def test_a_check_added_only_as_a_file_is_run_and_judged(tmp_path):
    root = tiny_cell.make(str(tmp_path))
    bench = os.path.join(root, "vo_bench")
    with open(os.path.join(bench, "checks", "toy.py"), "w") as f:
        f.write(TOY)
    with open(os.path.join(bench, "configs", "tiny.json")) as f:
        cfg = json.load(f)
    # a limit the count exceeds: the run is judged by it
    cfg.update(name="toy", limits=dict(lost_lanes=0, toy_k2_calls=0,
                                       kernels_not_compared=0))
    with open(os.path.join(bench, "configs", "toy.json"), "w") as f:
        json.dump(cfg, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        b = json.load(f)
    b["configs"].append(dict(name="toy", source="test",
                             file="vo_bench/configs/toy.json", reduced=[],
                             why="test"))
    b["workloads"].append(dict(name="toy.lockstep2", config="toy",
                               traffic="lockstep2", chips=1, why="test"))
    with open(path, "w") as f:
        json.dump(b, f)

    import torch

    from vo_bench import run as bench_run

    cell = cells.load("toy.lockstep2", root)
    assert [m.__name__ for m in cells.checks(cell)] == ["vo_bench_checks_toy"]
    torch.set_num_threads(2)
    line, lines = bench_run.execute(cell, 9876543210123, 3.0, False, "cpu")
    by = {c["name"]: c for c in lines}
    assert list(by) == ["lost_lanes", "toy_k2_calls", "kernels_not_compared"]
    assert by["toy_k2_calls"]["value"] >= 1 and not by["toy_k2_calls"]["ok"]
    assert by["kernels_not_compared"]["value"] == 0
    assert line["correct"] is False
    assert line["checks"]["toy_k2_calls"]["limit"] == 0
