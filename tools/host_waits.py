"""Where a benchmark cell's rounds spend the host's time, and where the
host waits for the card.

    python3 tools/host_waits.py [--workload kitti00_default.lockstep8] \
        [--seed N] [--rounds 40] [--traced 6] [--sync-rounds 20] \
        [--out profile_out/host_waits.json] [--root DIR] [--device cuda:0]

Builds the cell's fleet as `vo_bench.fleet.run` does (its drives rendered
on the card, the warm-up until the programs are captured; a fixed seed
gives the same rounds to every checkout), then:

1. `--rounds` rounds on the host clock: every span of the systems'
   telemetry over them (ms a frame, calls a frame; a fleet span counts in
   each lane's table, as the benchmark's stage metrics read them),
   `device_loop.counts()`, and for each stage program the host's ms a
   replay: the whole call and the graph launch (`CUDAGraph.replay`) in it;
2. `--traced` rounds under the profiler (`vo_bench/trace.py`): their wall
   time, the card's idle share and every idle gap by the innermost span
   open on the host (the benchmark's rule, all labels, not ten);
3. `--sync-rounds` rounds under `torch.cuda.set_sync_debug_mode("warn")`:
   every synchronizing call's site (the innermost frame in
   `sdv_loam_tpu_torch/`, with two callers there) and its calls a round.

It measures the program of the checkout it runs from (`--root`; a
checkout without the port's own spans shows fewer). On the CPU
(`--device cpu`, a rehearsal) step 3 is skipped.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import warnings


def _site(stack, package):
    """The innermost frames of `stack` inside the port, innermost first."""
    mine = [f for f in reversed(stack) if f.filename.startswith(package)]
    return [f"{f.filename[len(package):]}:{f.lineno} {f.name}"
            for f in mine[:3]]


def _gaps(rec):
    """Idle gaps of a traced record by the innermost open `stage:` span,
    as `vo_bench.trace.summarize` labels them, every label kept."""
    from vo_bench import trace as vt

    evs = rec["events"]
    win = [e for e in evs if e.get("name") == vt.WINDOW
           and e.get("cat") == "user_annotation"][0]
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    busy = vt._union([(e["ts"], e["ts"] + e["dur"]) for e in evs
                      if e.get("cat") in vt.DEVICE_ACTIVITIES])
    stages = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len(vt.STAGE):])
                    for e in evs if e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith(vt.STAGE))
    gaps = {}
    edges = [w0, *(x for a, b in busy for x in (a, b)), w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        open_ = [s for s in stages if s[0] <= mid <= s[1]]
        label = max(open_)[2] if open_ else "host outside stages"
        gaps[label] = gaps.get(label, 0.0) + (g1 - g0) / 1e6
    return dict(sorted(gaps.items(), key=lambda kv: -kv[1]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="kitti00_default.lockstep8")
    ap.add_argument("--seed", type=int, default=3141592653589)
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--traced", type=int, default=6)
    ap.add_argument("--sync-rounds", type=int, default=20)
    ap.add_argument("--out", default="profile_out/host_waits.json")
    ap.add_argument("--root", default=os.getcwd())
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    from sdv_loam_tpu_torch.utils import device_loop as dl
    from vo_bench import cells, scene
    from vo_bench import fleet as vf
    from vo_bench import trace as vt

    cuda = torch.device(args.device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        print("host_waits: no CUDA device", file=sys.stderr)
        return 2
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cell = cells.load(args.workload, root)
    cfg, tr = cell.config, cell.traffic
    warm = cfg["warmup"]
    n = warm["max_rounds"] + args.rounds + args.traced + args.sync_rounds
    rig = vf.make_rig(cell)
    drives = scene.lane_drives(args.seed % (1 << 63), tr["lanes"], n, tr)
    rendered = scene.render_lanes(rig, drives, n, args.device)
    frames = [[(img, None if vf.dropped(tr, i) else cloud, 0.1 * i)
               for i, (img, cloud) in enumerate(lane)] for lane in rendered]
    del rendered
    fleet = vf.Fleet(cell, rig, drives, frames, args.device)
    warmup_rounds, captured = vf.warm_up(fleet, warm, dl)
    sync()
    out = dict(workload=args.workload, seed=args.seed, root=root,
               device=torch.cuda.get_device_name(0) if cuda else "cpu",
               warmup_rounds=warmup_rounds, warmup_captures=captured)

    # 1. spans and counters over plain rounds
    B = len(fleet.systems)
    stage0 = vf._stage_totals(fleet.systems)
    count0 = {fs: dict(fs.telemetry.stage_count) for fs in fleet.systems}
    loops0 = dl.counts().get("all", {})
    replays, launching = {}, []
    graph_program, replay = dl._graph_program, torch.cuda.CUDAGraph.replay

    def timed_program(stage, *a):
        r = replays.setdefault(stage, dict(calls=0, call_ms=0.0,
                                           launch_ms=0.0))
        launching.append(r)
        t = time.perf_counter()
        try:
            return graph_program(stage, *a)
        finally:
            launching.pop()
            r["calls"] += 1
            r["call_ms"] += 1000.0 * (time.perf_counter() - t)

    def timed_replay(graph):
        t = time.perf_counter()
        replay(graph)
        if launching:
            launching[-1]["launch_ms"] += 1000.0 * (time.perf_counter() - t)

    dl._graph_program, torch.cuda.CUDAGraph.replay = \
        timed_program, timed_replay
    t0 = time.perf_counter()
    try:
        for _ in range(args.rounds):
            fleet.step()
        sync()
    finally:
        dl._graph_program, torch.cuda.CUDAGraph.replay = \
            graph_program, replay
    wall = time.perf_counter() - t0
    frames_done = B * args.rounds
    stage1 = vf._stage_totals(fleet.systems)
    calls = {}
    for fs in fleet.systems:
        for k, v in fs.telemetry.stage_count.items():
            calls[k] = calls.get(k, 0) + v - count0[fs].get(k, 0)
    loops1 = dl.counts().get("all", {})
    out["plain"] = dict(
        rounds=args.rounds, wall_s=wall, round_ms=1000.0 * wall / args.rounds,
        span_ms_per_frame={k: 1000.0 * (v - stage0.get(k, 0.0)) / frames_done
                           for k, v in sorted(stage1.items(),
                                              key=lambda kv: -kv[1])
                           if v - stage0.get(k, 0.0) > 0},
        span_calls_per_frame={k: v / frames_done for k, v in calls.items()
                              if v},
        loops_per_frame={k: (loops1.get(k, 0) - loops0.get(k, 0))
                         / frames_done for k in loops1},
        program_host_ms_per_call={
            k: dict(calls_per_round=v["calls"] / args.rounds,
                    call_ms=v["call_ms"] / v["calls"],
                    launch_ms=v["launch_ms"] / v["calls"])
            for k, v in replays.items()})

    # 2. traced rounds
    if args.traced:
        rec = vt.traced(lambda k: fleet.step(), args.traced, cuda)
        summ = vt.summarize(rec, B * args.traced, B,
                            tuple(vf.make_settings(cfg).track_ref_caps))
        gaps = _gaps(rec)
        idle = sum(gaps.values())
        out["traced"] = dict(
            rounds=args.traced, wall_s=rec["wall_s"],
            window_s=summ["window_s"], busy_s=summ["busy_s"],
            idle_share=summ["idle_share"],
            launch_calls_per_frame=summ["launch_calls_per_frame"],
            kernels_per_frame=summ["kernels_per_frame"], idle_s=idle,
            outside_share=gaps.get("host outside stages", 0.0) / idle
            if idle else None, idle_gaps=gaps)

    # 3. synchronizing calls
    sites = {}

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return
        where = _site(traceback.extract_stack()[:-1], package)
        key = " <- ".join(where) if where else f"{filename}:{lineno}"
        sites[key] = sites.get(key, 0) + 1

    package = os.path.join(root, "sdv_loam_tpu_torch") + os.sep
    if cuda and args.sync_rounds:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for _ in range(args.sync_rounds):
                    fleet.step()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        out["sync_sites_per_round"] = {
            k: v / args.sync_rounds
            for k, v in sorted(sites.items(), key=lambda kv: -kv[1])}
    out["lanes_lost"] = sum(bool(fs.is_lost) for fs in fleet.systems)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
