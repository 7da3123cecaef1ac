"""One run of a cell: render the lanes' drives, build the fleet, warm it
up, measure rounds of `MultiSystem.add_frames` for the window, trace a
few more rounds when asked, and check what the window produced.

Set-up (`setup_s`): from the process's start to the window's start: the
imports, the kernels' library (built with nvcc at a checkout's first run,
into the port's `build/` directory in the checkout), the render on the
card, the B systems and their `MultiSystem`, and the warm-up: rounds
until the stage programs have been captured for the keys the cell's
drives reach (at least `min_rounds`, then until `quiet_rounds` rounds in
a row captured nothing, at most `max_rounds`; the configuration's
`warmup`).

The window is a closed loop: the fleet's next round starts when the last
has returned. A round waits for its device work (the lockstep's systems
are sequential: every stage ends when its stream has finished), and the
window ends with a device synchronize. When the lanes reach the end of
their drives, the next B sequences start in new systems, as an operator's
queue does, and the window counts their set-up.
"""

from __future__ import annotations

import contextlib
import gc
import math
import sys
import time

import numpy as np

from vo_bench import cells, check, scene
from vo_bench import trace as tracing


def _log(msg):
    print(f"[vo_bench] {msg}", file=sys.stderr, flush=True)


def make_rig(cell):
    cam, lid = cell.config["camera"], cell.config["lidar"]
    with open(cell.path(cell.config["sensor_file"])) as f:
        rows = [ln.split() for ln in f if ln.strip()][1:4]
    T = np.eye(4)
    T[:3] = np.array(rows, dtype=np.float64)
    return scene.Rig(w=cam["w"], h=cam["h"], fx=cam["fx"], fy=cam["fy"],
                     cx=cam["cx"], cy=cam["cy"], T_cam_lidar=T,
                     n_scan=lid["n_scan"], horizon_scan=lid["horizon_scan"],
                     ang_res_x=lid["ang_res_x"], ang_res_y=lid["ang_res_y"],
                     ang_bottom=lid["ang_bottom"],
                     lidar_stride=cell.traffic["lidar_stride"])


def make_settings(config):
    from sdv_loam_tpu_torch.config import Settings

    make = Settings.preset_fast if config["preset"] == "fast" else Settings
    return make(**config.get("settings", {}))


def dropped(traffic, i):
    d = traffic.get("dropout")
    return d is not None and i >= d["from"] and i % d["every"] == d["offset"]


class Fleet:
    """B sequential systems in one batched lockstep `MultiSystem`, fed
    the rendered drives one frame per lane a round."""

    def __init__(self, cell, rig, drives, frames, device):
        from sdv_loam_tpu_torch.data.calib import SensorCalib
        from sdv_loam_tpu_torch.utils.camera import make_pyramid_calib

        self.cell, self.drives, self.frames = cell, drives, frames
        self.device = device
        self.calib = make_pyramid_calib(rig.w, rig.h, rig.fx, rig.fy,
                                        rig.cx, rig.cy)
        self.sensor = SensorCalib(np.array([rig.fx, rig.fy, rig.cx, rig.cy]),
                                  rig.T_cam_lidar[:3, :3].copy(),
                                  rig.T_cam_lidar[:3, 3].copy())
        self.generations = []
        self._start()

    def _start(self):
        from sdv_loam_tpu_torch.system.full_system import FullSystem
        from sdv_loam_tpu_torch.system.multi import MultiSystem

        systems = [FullSystem(self.calib, self.sensor,
                              make_settings(self.cell.config),
                              device=self.device)
                   for _ in self.drives]
        self.multi = MultiSystem(systems,
                                 batch_track=self.cell.traffic["batch_track"])
        self.generations.append(systems)
        self.frame = 0

    @property
    def systems(self):
        return self.generations[-1]

    def step(self):
        if self.frame >= len(self.frames[0]):
            _log("the lanes reached the end of their drives: the next "
                 f"{len(self.drives)} sequences start in new systems")
            self._start()
        self.multi.add_frames([lane[self.frame] for lane in self.frames])
        self.frame += 1

    def trajectories(self):
        """(estimated, ground truth, lost) per lane of every generation."""
        out = []
        for systems in self.generations:
            for fs, d in zip(systems, self.drives):
                est = fs.get_trajectory()
                out.append((est, d.poses_wc[:len(est)], fs.is_lost))
        return out


def _stage_totals(systems):
    tot = {}
    for fs in systems:
        for k, v in fs.telemetry.stage_time.items():
            tot[k] = tot.get(k, 0.0) + v
    return tot


def _captures(dl):
    return dl.counts().get("all", {}).get("captures", 0)


def warm_up(fleet, warm, dl):
    """Rounds until the stage programs are captured for the keys the
    drives reach: at least `min_rounds`, then until `quiet_rounds` rounds
    in a row captured nothing, at most `max_rounds`. Returns (rounds,
    the rounds that captured)."""
    n, quiet, captured = 0, 0, []
    while n < warm["max_rounds"]:
        c0 = _captures(dl)
        fleet.step()
        if _captures(dl) != c0:
            captured.append(n)
            quiet = 0
        else:
            quiet += 1
        n += 1
        if n >= warm["min_rounds"] and quiet >= warm["quiet_rounds"]:
            break
    return n, captured


def run(cell, seed, seconds, trace, device, control=False, t_start=None):
    """One run; returns dict(result fields, numbers compared, per-layer
    context)."""
    import torch

    from sdv_loam_tpu_torch.ops import hopper_kernels as hk
    from sdv_loam_tpu_torch.utils import device_loop as dl
    from sdv_loam_tpu_torch.utils import hbm

    cuda = torch.device(device).type == "cuda"
    seed = int(seed) % (1 << 63)     # NumPy's seed sequences take no sign
    if control:
        # the program's own lower precision: TF32 products
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
    cfg, tr = cell.config, cell.traffic
    B = tr["lanes"]
    n_traced = cfg["traced_rounds"] if trace else 0
    warm = cfg["warmup"]
    n_frames = (warm["max_rounds"] + n_traced
                + math.ceil(cfg["rounds_per_s_ceiling"] * seconds))
    rig = make_rig(cell)
    drives = scene.lane_drives(B, n_frames, tr)
    t = time.perf_counter()
    rendered = scene.render_lanes(rig, drives, n_frames, device)
    render_s = time.perf_counter() - t
    frames = [[(img, None if dropped(tr, i) else cloud, 0.1 * i)
               for i, (img, cloud) in enumerate(lane)] for lane in rendered]
    host_bytes = sum(img.nbytes + cloud.nbytes for lane in rendered
                     for img, cloud in lane)
    del rendered
    gc.collect()
    mem0 = 0
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    fleet = Fleet(cell, rig, drives, frames, device)
    warmup_rounds, capture_rounds = warm_up(fleet, warm, dl)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    _log(f"warm-up: {warmup_rounds} rounds, captures in rounds "
         f"{capture_rounds}")

    cell_checks = cells.checks(cell)
    sample = np.random.default_rng([seed, 1]).choice(
        np.arange(*cfg["checked_rounds"]), size=2, replace=False)
    recorder = check.Recorder((int(r) for r in sample),
                              check.programs(cell_checks))
    gens0 = len(fleet.generations)
    stage0 = _stage_totals(fleet.systems)
    counts0 = dl.counts()
    loops0 = counts0.get("all", {})
    launches0, lanes0 = dict(hk.LAUNCHES), dict(hk.LANES)
    round_s = []
    # a traced run times every program replay of its window on the card
    timing = dl.program_timing() if trace else contextlib.nullcontext({})
    window_captures = []
    with recorder.installed(), timing as program_ms:
        t0 = time.perf_counter()
        prev = t0
        while True:
            recorder.start_round(len(round_s))
            c0 = _captures(dl)
            fleet.step()
            if _captures(dl) != c0:
                window_captures.append(len(round_s))
            recorder.end_round()
            now = time.perf_counter()
            round_s.append(now - prev)
            prev = now
            if now - t0 >= seconds:
                break
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    peak = int(torch.cuda.max_memory_allocated()) if cuda else None
    rounds = len(round_s)
    frames_done = B * rounds
    counts1 = dl.counts()
    loops1 = counts1.get("all", {})
    captured = {k: v.get("captures", 0) - counts0.get(k, {}).get("captures", 0)
                for k, v in counts1.items() if k not in ("all", "programs")}
    capture_s = (loops1.get("capture_s", 0.0) + loops1.get("instantiate_s", 0.0)
                 - loops0.get("capture_s", 0.0)
                 - loops0.get("instantiate_s", 0.0))
    in_window = [s for g in fleet.generations[gens0 - 1:] for s in g]
    stage1 = _stage_totals(in_window)
    ctx = dict(
        lanes=B, rounds=rounds, frames=frames_done, round_s=round_s,
        window_s=window_s,
        stage_s={k: v - stage0.get(k, 0.0) for k, v in stage1.items()},
        loops={k: loops1.get(k, 0) - loops0.get(k, 0) for k in loops1},
        kernel_launches={k: v - launches0[k]
                         for k, v in hk.LAUNCHES.items()},
        kernel_lanes={k: v - lanes0[k] for k, v in hk.LANES.items()},
        persistent_bytes=[hbm.system_device_bytes(fs)
                          for fs in fleet.systems] if cuda else None,
        program_ms=program_ms, settings=make_settings(cfg), trace=None)
    if trace:
        rec = tracing.traced(lambda k: fleet.step(), n_traced, cuda)
        ctx["trace"] = tracing.summarize(
            rec, B * n_traced, B, tuple(ctx["settings"].track_ref_caps))
        _log("traced: " + str({k: v for k, v in ctx["trace"].items()
                               if not isinstance(v, (list, dict))}))

    # the check, once the window has closed and the fleet is freed
    lanes = fleet.trajectories()
    lost_frames = sum(1 for *_, lost in lanes[-B:] if lost) * rounds
    del fleet, frames
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = check.trajectory_numbers(lanes)
    _log(f"window: {rounds} rounds; captures by stage "
         f"{ {k: v for k, v in captured.items() if v} } in rounds "
         f"{window_captures} ({capture_s:.3f} s); worst lane's ATE "
         f"{numbers['ate_path_pct']:.4f} % of its path (not compared)")
    knums, seen, leaves = check.run(cell_checks, recorder.records, device,
                                    control=control)
    numbers.update(knums)
    correct, lines = check.judge(numbers, cfg["limits"])
    _log("numbers not compared: "
         f"{ {k: v for k, v in numbers.items() if k not in cfg['limits']} }")
    names = (c.__name__.removeprefix("vo_bench_checks_") for c in cell_checks)
    _log(f"check: {', '.join(names)} over {len(recorder.records)} programs "
         f"({', '.join(r['stage'] for r in recorder.records)}), "
         f"{leaves} outputs, kernel calls {seen}, "
         f"{time.perf_counter() - t:.1f} s")
    ctx["warmup_rounds"] = warmup_rounds
    return dict(correct=correct, lines=lines, attempted=frames_done,
                failed=lost_frames, setup_s=setup_s, window_s=window_s,
                fleet_fps=frames_done / window_s, peak=peak, mem0=mem0,
                mib_per_seq=(peak - mem0) / B / 2**20 if cuda else None,
                ctx=ctx, render_s=render_s, host_bytes=host_bytes,
                rounds=rounds)
