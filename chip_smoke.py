"""Chip smoke test of the PyTorch / CUDA port (sdv_loam_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits nonzero; each prints its results):
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles the Hopper kernels (csrc/*.cu, nvcc sm_90a);
  3. kernels: K1 (dilate_pyramid, build_track_ref's whole 4-level chain)
     and K2 (distance_transform) against their plain PyTorch versions on
     the card (exact equality required) at the main-path shapes, the fast
     preset's, odd shapes and L = 4 lanes, K2 at 32 and 64 sweeps; at the
     main-path shapes each lane of an L = 4 launch against its one-lane
     launch (exact); determinism of build_track_ref; at the main-path
     shapes each kernel's device time (torch.profiler), wrapper and plain
     CUDA-event times, bound and share; the CUDA kernels behind the
     windowed BA's dense solve (one window, and four in one batched call);
  4. slice: the 30-frame default-preset synthetic KITTI scene (1200x360)
     through the port's run_sequence with the default Settings on cuda;
     requires not lost, >= 2 keyframes, ATE <= 0.10 m, one K1 launch per
     build_track_ref call and at least one K2 launch;
  5. fleet: bench.py's two default-preset scenes (16 frames each) alone in
     pipelined mode (scene A also with the deferred keyframe readback),
     then B = 4 sequences (A, B, A, B) on the card as InterleavedFleet
     (serial, and one thread and stream per system) and as the lockstep
     MultiSystem: unbatched (every stage per sequence), and batched
     (pyramid, LiDAR, track, trace, selection, activation and the keyframe
     optimization as lanes of one call per round; host work on one
     thread, the CUDA default, and on a thread per system); requires every
     lane not lost, ATE <= 0.10 m, its scene's keyframe count, (for the
     interleaved fleets) its scene's trajectory to 1e-5, and of the
     batched lockstep K1 and K2 launches that took two lanes or more and
     fewer K1 launches than its lanes made keyframes; prints aggregate
     frames/s, scaling efficiency, peak memory, kernel launches and the
     lanes they took, and the keyframe stages' ms per frame per
     composition;
  6. CLI and camera-only, each part with its own kernel launch counts, its
     frames/s and stage ms per frame:
     (a) phase 4's 30 frames written as a KITTI directory (the port's own
         PNG codec) and run through `python -m sdv_loam_tpu_torch.run`'s
         `main` with every observer flag and a checkpoint; requires rc 0,
         30 trajectory rows, ATE <= 0.10 m, cam_pose and keyframes events,
         viewer and debug-plot PNGs that decode, and a checkpoint that
         loads back to the trajectory;
     (b) LiDAR dropout: the same frames, every third frame after the first
         two without a cloud, sequential with the deep logs, then
         pipelined; requires not lost, ATE <= 0.10 m and one Hessian line
         per optimized keyframe;
     (c) the monocular bootstrap: a 1200x360 scene with no cloud on any
         frame; requires initialized, not lost, >= 2 keyframes, no sensor
         points and a scale-aligned error below 0.15 x path; prints each
         knn call's time and peak memory (level 0 first);
     each part requires at least one K1 and one K2 launch;
then one JSON line with the kernels, and the device JSON as the last line.
The script imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# K1: level-0 shapes of build_track_ref's 4-level chain (the default and
# fast presets and two odd shapes); K2: the level-1 grid at the default and
# fast presets and one odd shape, at 32 and 64 sweeps
K1_SHAPES = ((360, 1200), (320, 424), (90, 300), (45, 70))
K2_SHAPES = ((180, 600), (160, 212), (37, 91))
K2_ITERS = (32, 64)
LANES = 4
LEVELS = 4
MAIN_K1 = (360, 1200)
MAIN_K2 = (180, 600)
ATE_LIMIT_M = 0.10
# bench.py's default operating point (bench.py:122-132): two scenes
SCENE = dict(w=1200, h=360, fx=718.856, cy_offset=0.0, step=0.7,
             lidar_stride=2, half_width=16.0, ground_contrast=0.25,
             follow_path=True)
FLEET_SCENES = {"A": dict(seed=7, yaw_rate=0.004),
                "B": dict(seed=13, yaw_rate=-0.006)}
FLEET_FRAMES = 16
FLEET_B = 4
FLEET_TRAJ_TOL = 1e-5
# the stages phase 5 reports per composition: per sequence, and batched
STAGES = ("track", "track.batch", "trace", "trace.batch", "keyframe",
          "kf.select", "kf.select.batch", "kf.activate", "kf.activate.batch",
          "kf.opt", "kf.opt.batch")
# phase 6: where its files go (under chiprun_out/, which .gitignore lists
# and the card's tool brings back), the dropout pattern
# and the camera-only scene (tests/test_mono_init.py's, at full width)
OUT_DIR = os.path.join(ROOT, "chiprun_out", "phase6")
MONO_SCENE = dict(w=1200, h=360, fx=718.856, step=0.4, lidar_stride=8)
MONO_FRAMES = 16
MONO_ERR_FRAC = 0.15


def dropped(i):
    """LiDAR dropout: every third frame after the first two has no cloud."""
    return i >= 2 and i % 3 == 2


def _fail(msg):
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def sparse_splat(shape, rng, frac=0.04):
    """Realistic splat maps: ~frac of the cells filled with idepth sums and
    weights, as splat_idepth leaves them."""
    wt = np.zeros(shape, np.float32)
    idp = np.zeros(shape, np.float32)
    m = rng.random(shape) < frac
    wt[m] = rng.uniform(1.0, 300.0, m.sum()).astype(np.float32)
    idp[m] = wt[m] * rng.uniform(0.01, 0.5, m.sum()).astype(np.float32)
    return idp, wt


def seed_map(h, w, rng, n_seeds=2000):
    seed = np.full((h, w), 1000.0, np.float32)
    seed.reshape(-1)[rng.choice(h * w, min(n_seeds, h * w // 2),
                                replace=False)] = 0.0
    return seed


def _max_err(a, b):
    return max(float((x - y).abs().max()) if x.numel() else 0.0
               for x, y in zip(a, b))


def check_kernels(device):
    """Phase 3. Returns per-kernel records: max_abs_err over every check;
    at the main-path shape the wrapper's CUDA-event time (ms), the device
    time of the kernel (device_ms, torch.profiler), the plain version's
    time, the bound and its share."""
    import torch

    from sdv_loam_tpu_torch.eval import kernel_timing as kt
    from sdv_loam_tpu_torch.ops import hopper_kernels as hk
    from sdv_loam_tpu_torch.ops.photometric import (build_track_ref,
                                                    splat_idepth)
    from sdv_loam_tpu_torch.ops.pyramid import make_images

    rng = np.random.default_rng(0)
    rec = {"dilate_pyramid": dict(max_abs_err=0.0),
           "distance_transform": dict(max_abs_err=0.0)}

    def flat(pyr):
        return [t for lv in pyr for t in lv]

    def hold(name, what, got, ref):
        err = _max_err(got, ref)
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)
        eq = all(torch.equal(a, b) for a, b in zip(got, ref))
        print(f"{name} {what}: equal={eq} max_abs_err={err}", flush=True)
        if not eq:
            _fail(f"{name} differs from its plain version at {what}")

    def times(name, kernel, plain, bound):
        t_dev = kt.device_ms(kernel)
        t_k = kt.wrapper_ms(kernel)
        t_p = kt.wrapper_ms(plain)
        share = bound[0] / t_dev if t_dev else None
        print(f"{name} time: device {t_dev} ms, wrapper {t_k:.4f} ms, "
              f"plain {t_p:.4f} ms, bound {bound[0]:.6f} ms "
              f"({bound[1]}), share of the bound {share}", flush=True)
        rec[name].update(ms=t_k, plain_ms=t_p, device_ms=t_dev,
                         bound_ms=bound[0], bound_us=1e3 * bound[0],
                         bound_by=bound[1], share=share, library_ms=None,
                         library="none")

    for lanes in (None, LANES):
        for (h, w) in K1_SHAPES:
            shape = (h, w) if lanes is None else (lanes, h, w)
            idp, wt = sparse_splat(shape, rng)
            ti = torch.as_tensor(idp, device=device)
            tw = torch.as_tensor(wt, device=device)
            got = flat(hk.dilate_pyramid(ti, tw, LEVELS))
            ref = flat(hk.dilate_pyramid_plain(ti, tw, LEVELS))
            torch.cuda.synchronize()
            hold("dilate_pyramid", f"{shape} levels={LEVELS}", got, ref)
            if lanes and (h, w) == MAIN_K1:
                one = [flat(hk.dilate_pyramid(ti[j], tw[j], LEVELS))
                       for j in range(lanes)]
                hold("dilate_pyramid", f"{shape} lanes against one-lane "
                     "launches", got, [torch.stack(x) for x in zip(*one)])
            if lanes is None and (h, w) == MAIN_K1:
                times("dilate_pyramid",
                      lambda: hk.dilate_pyramid(ti, tw, LEVELS),
                      lambda: hk.dilate_pyramid_plain(ti, tw, LEVELS),
                      kt.dilate_pyramid_bound(1, h, w, LEVELS))
    for lanes in (None, LANES):
        for (h, w) in K2_SHAPES:
            maps = np.stack([seed_map(h, w, rng)
                             for _ in range(lanes or 1)])
            ts = torch.as_tensor(maps if lanes else maps[0], device=device)
            for iters in K2_ITERS:
                got = hk.distance_transform(ts, iters)
                ref = hk.distance_transform_plain(ts, iters)
                torch.cuda.synchronize()
                hold("distance_transform", f"{tuple(ts.shape)} iters={iters}",
                     [got], [ref])
                if lanes and (h, w) == MAIN_K2:
                    one = torch.stack([hk.distance_transform(ts[j], iters)
                                       for j in range(lanes)])
                    hold("distance_transform", f"{tuple(ts.shape)} "
                         f"iters={iters} lanes against one-lane launches",
                         [got], [one])
            if lanes is None and (h, w) == MAIN_K2:
                times("distance_transform",
                      lambda: hk.distance_transform(ts, 32),
                      lambda: hk.distance_transform_plain(ts, 32),
                      kt.distance_transform_bound(1, h, w, 32))

    # deterministic splat + build_track_ref on the card
    h, w = MAIN_K1
    img = torch.as_tensor(rng.random((h, w)).astype(np.float32) * 255,
                          device=device)
    dI, _ = make_images(img, LEVELS)
    n = 3000
    u = torch.as_tensor(rng.integers(4, w - 4, n), device=device)
    v = torch.as_tensor(rng.integers(4, h - 4, n), device=device)
    idp = torch.as_tensor(rng.uniform(0.01, 0.5, n).astype(np.float32),
                          device=device)
    wgt = torch.as_tensor(rng.uniform(1, 300, n).astype(np.float32),
                          device=device)
    ok = torch.ones(n, dtype=torch.bool, device=device)
    pools = []
    for _ in range(2):
        id0, w0 = splat_idepth(u, v, idp, wgt, ok, w, h)
        pools.append(build_track_ref(dI, id0, w0, LEVELS,
                                     cap=(6144, 4096, 2048, 1024)))
    same = all(torch.equal(a[k], b[k]) for a, b in zip(*pools)
               for k in ("u", "v", "idepth", "color", "valid"))
    print(f"build_track_ref twice: identical={same}", flush=True)
    if not same:
        _fail("build_track_ref is not deterministic on the card")
    return rec


def solver_kernels(device):
    """The CUDA kernels behind the windowed BA's dense solve
    (`torch.linalg.solve_ex` on the (D, D) system, D = 4 + 6 * 8): one
    window, as the lane form calls it lane by lane, and four windows in one
    batched call, which PyTorch may route to another library."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    D = 4 + 6 * 8
    rng = np.random.default_rng(1)
    a = rng.normal(size=(4, D, D)).astype(np.float32)
    A = torch.as_tensor(a @ a.transpose(0, 2, 1) + D * np.eye(D,
                        dtype=np.float32), device=device)
    b = torch.as_tensor(rng.normal(size=(4, D)).astype(np.float32),
                        device=device)
    names = {}
    for what, fn in (("one window", lambda: torch.linalg.solve_ex(A[0],
                                                                  b[0])),
                     ("four windows batched",
                      lambda: torch.linalg.solve_ex(A, b))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        # the library's kernels: not PyTorch's own, not runtime calls
        names[what] = sorted(
            {e.key.split("(")[0].replace("void ", "")
             for e in prof.key_averages()
             if not any(x in e.key for x in ("at::native", "cuda", "Mem",
                                             "Activity"))})
        print(f"BA solve kernels, {what}: {names[what]}", flush=True)
    one = torch.stack([torch.linalg.solve_ex(A[j], b[j])[0]
                       for j in range(4)])
    print("BA solve: lane by lane equals the batched call: "
          f"{torch.equal(one, torch.linalg.solve_ex(A, b)[0])}", flush=True)
    return names


class Rendered:
    """A synthetic sequence with its frames rendered once (a runner reader;
    `write_kitti_fixture` takes it in the sequence's place)."""

    def __init__(self, seq, frames):
        self.seq, self.frames = seq, frames
        self.calib, self.sensor = seq.calib, seq.sensor
        self.poses_wc, self.timestamps = seq.poses_wc, seq.timestamps

    def __len__(self):
        return len(self.frames)

    def get(self, i):
        return self.frames[i]


def run_slice(device):
    """Phase 4: the default-preset slice. Returns (summary, the rendered
    scene)."""
    import torch

    from sdv_loam_tpu_torch.config import Settings
    from sdv_loam_tpu_torch.data.synthetic import make_sequence
    from sdv_loam_tpu_torch.eval.ate import ate_rmse, rpe
    from sdv_loam_tpu_torch.ops import hopper_kernels as hk
    from sdv_loam_tpu_torch.system import full_system, kf_ops
    from sdv_loam_tpu_torch.system.runner import run_sequence

    n_frames = 30
    t0 = time.perf_counter()
    seq = make_sequence(n_frames=n_frames, **SCENE, **FLEET_SCENES["A"])
    scene = Rendered(seq, [seq.get(i) for i in range(n_frames)])
    print(f"slice scene rendered in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # count build_track_ref calls on the main path (one K1 launch each)
    n_build = [0]
    for mod in (full_system, kf_ops):
        orig = mod.build_track_ref

        def counted(*a, _orig=orig, **k):
            n_build[0] += 1
            return _orig(*a, **k)
        mod.build_track_ref = counted

    torch.cuda.reset_peak_memory_stats()
    hk.reset_launch_counts()
    t0 = time.perf_counter()
    fs, summary = run_sequence(scene, Settings(), device=device,
                               prefetch=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(hk.LAUNCHES)
    est = fs.get_trajectory()
    ate = float(ate_rmse(est, seq.poses_wc[:n_frames]))
    t_rpe, r_rpe = rpe(est, seq.poses_wc[:n_frames])
    # host-clock ms per frame of each stage (each stage ends in a device
    # synchronize, so it includes the device work it queued)
    summary["stage_ms_per_frame"] = {
        k: 1000.0 * v / n_frames
        for k, v in sorted(fs.telemetry.stage_time.items())}
    summary.update(ate_m=ate, t_rpe=float(t_rpe), r_rpe=float(r_rpe),
                   wall_s=wall, fps=n_frames / wall,
                   peak_mem_bytes=int(torch.cuda.max_memory_allocated()),
                   launches=launches, build_track_ref_calls=n_build[0],
                   n_keyframes=len(fs.kf_shells), lost=bool(fs.is_lost))
    print("slice: " + json.dumps(summary), flush=True)
    if fs.is_lost:
        _fail("slice lost tracking")
    if len(fs.kf_shells) < 2:
        _fail("slice made fewer than 2 keyframes")
    if not np.isfinite(est).all() or not ate <= ATE_LIMIT_M:
        _fail(f"slice ATE {ate} m over the {ATE_LIMIT_M} m gate")
    if not (launches["dilate_pyramid"] > 0
            and launches["dilate_pyramid"] == n_build[0]):
        _fail(f"dilate_pyramid launches {launches['dilate_pyramid']} != "
              f"{n_build[0]} build_track_ref calls")
    if launches["distance_transform"] < 1:
        _fail("distance_transform never launched on the main path")
    return summary, scene


def _pose_diff(A, B):
    """(translation m, rotation rad) between two poses; the angle is
    atan2(|skew|, (trace - 1) / 2), resolved for float32 rotations."""
    d = np.linalg.inv(A) @ B
    R = d[:3, :3]
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return (float(np.linalg.norm(d[:3, 3])),
            float(np.arctan2(0.5 * np.linalg.norm(w),
                             0.5 * (np.trace(R) - 1.0))))


def run_fleet(device):
    """Phase 5: pipelined references and three B-sequence fleets."""
    import torch

    from sdv_loam_tpu_torch.config import Settings
    from sdv_loam_tpu_torch.data.synthetic import make_sequence
    from sdv_loam_tpu_torch.eval.ate import ate_rmse
    from sdv_loam_tpu_torch.ops import hopper_kernels as hk
    from sdv_loam_tpu_torch.system.full_system import FullSystem
    from sdv_loam_tpu_torch.system.multi import InterleavedFleet, MultiSystem

    n = FLEET_FRAMES
    t0 = time.perf_counter()
    scenes = {}
    for name, kw in FLEET_SCENES.items():
        seq = make_sequence(n_frames=n, **SCENE, **kw)
        scenes[name] = (seq, [seq.get(i) for i in range(n)])
    print(f"fleet scenes rendered in {time.perf_counter() - t0:.1f} s",
          flush=True)

    def system(name, **kw):
        seq = scenes[name][0]
        return FullSystem(seq.calib, seq.sensor, Settings(**kw),
                          device=device)

    def ate(name, traj):
        return float(ate_rmse(traj, scenes[name][0].poses_wc[:n]))

    # references: each scene alone, pipelined (scene A also sequential,
    # for the pipelining's own gain, and with the deferred readback)
    refs = {}
    for name, kw in (("A", {}), ("B", {}),
                     ("A_sequential", dict(pipelined_frames=False)),
                     ("A_deferred", dict(deferred_kf_readback=True))):
        scene = name[0]
        fs = system(scene, **dict(dict(pipelined_frames=True), **kw))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for fr in scenes[scene][1]:
            fs.add_active_frame(*fr)
        traj = fs.get_trajectory()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        refs[name] = dict(traj=traj, n_kf=len(fs.kf_shells),
                          lost=bool(fs.is_lost), ate_m=ate(scene, traj),
                          fps=n / wall)
        print(f"reference {name}: ATE {refs[name]['ate_m']:.5f} m, "
              f"keyframes {refs[name]['n_kf']}, lost {fs.is_lost}, "
              f"{n / wall:.3f} frames/s", flush=True)
        if fs.is_lost or not refs[name]["ate_m"] <= ATE_LIMIT_M:
            _fail(f"reference {name} lost or over the ATE gate")
    d = refs["A_deferred"]
    if d["n_kf"] != refs["A"]["n_kf"] or \
            not d["ate_m"] <= max(2.0 * refs["A"]["ate_m"], 0.02):
        _fail(f"deferred readback: keyframes {d['n_kf']} vs "
              f"{refs['A']['n_kf']}, ATE {d['ate_m']} vs {refs['A']['ate_m']}")
    single_fps = refs["A"]["fps"]
    print("pipelined vs sequential, scene A: largest difference "
          f"{float(np.abs(refs['A']['traj'] - refs['A_sequential']['traj']).max())}",
          flush=True)

    lanes = [("A", "B")[b % 2] for b in range(FLEET_B)]
    comps = (
        ("interleaved_serial",
         lambda: InterleavedFleet([system(x, pipelined_frames=True)
                                   for x in lanes], workers=0)),
        ("interleaved_threads",
         lambda: InterleavedFleet([system(x, pipelined_frames=True)
                                   for x in lanes], workers=FLEET_B)),
        ("lockstep_unbatched",
         lambda: MultiSystem([system(x) for x in lanes], batch_track=False)),
        ("lockstep_batched",
         lambda: MultiSystem([system(x) for x in lanes], batch_track=True)),
        # the same lockstep with its per-sequence host work on one thread
        # per system (the CPU default), to tell the threads' effect from
        # the batching's
        ("lockstep_batched_threads",
         lambda: MultiSystem([system(x) for x in lanes], batch_track=True,
                             host_workers=FLEET_B)),
    )
    results = {}
    for name, make in comps:
        fleet = make()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        hk.reset_launch_counts()
        t0 = time.perf_counter()
        for i in range(n):
            fleet.add_frames([scenes[x][1][i] for x in lanes])
        if hasattr(fleet, "flush"):
            fleet.flush()
        trajs = [fs.get_trajectory() for fs in fleet.systems]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(hk.LAUNCHES)
        kernel_lanes = dict(hk.LANES)
        agg = FLEET_B * n / wall
        # host-clock ms per frame of the keyframe stages, the mean over the
        # fleet's systems (a batched stage's time is entered on each of
        # its lanes)
        stage_ms = {k: 1000.0 * float(np.mean(
            [fs.telemetry.stage_time.get(k, 0.0) for fs in fleet.systems]))
            / n for k in STAGES}
        # windowed-LM iterations: each lane's own, and (batched lockstep)
        # the ones its batched calls ran, the group's largest count
        counters = [fs.telemetry.counters for fs in fleet.systems]
        lm = dict(own=sum(c["ba_lm_iters"] for c in counters),
                  fleet=sum(c["ba_lm_iters_fleet"] for c in counters))
        rec = dict(wall_s=wall, aggregate_fps=agg,
                   scaling_efficiency=agg / (FLEET_B * single_fps),
                   peak_mem_bytes=int(torch.cuda.max_memory_allocated()),
                   launches=launches, kernel_lanes=kernel_lanes,
                   stage_ms_per_frame=stage_ms, lm_iters=lm, lanes=[])
        for x, fs, traj in zip(lanes, fleet.systems, trajs):
            dt = dr = 0.0
            for a, b in zip(traj, refs[x]["traj"]):
                t_, r_ = _pose_diff(b, a)
                dt, dr = max(dt, t_), max(dr, r_)
            rec["lanes"].append(dict(
                scene=x, lost=bool(fs.is_lost), n_kf=len(fs.kf_shells),
                ate_m=ate(x, traj), max_dt_m=dt, max_dr_rad=dr,
                max_abs=float(np.abs(traj - refs[x]["traj"]).max())))
        results[name] = rec
        print(f"fleet {name}: " + json.dumps(rec), flush=True)
        for b, ln in enumerate(rec["lanes"]):
            ref = refs[ln["scene"]]
            if ln["lost"] or not ln["ate_m"] <= ATE_LIMIT_M:
                _fail(f"{name} lane {b} lost or ATE {ln['ate_m']}")
            if ln["n_kf"] != ref["n_kf"]:
                _fail(f"{name} lane {b}: {ln['n_kf']} keyframes, reference "
                      f"{ref['n_kf']}")
            if name.startswith("interleaved") and \
                    not ln["max_abs"] <= FLEET_TRAJ_TOL:
                _fail(f"{name} lane {b}: trajectory {ln['max_abs']} from "
                      f"its reference")
        if launches["dilate_pyramid"] < 1 or \
                launches["distance_transform"] < 1:
            _fail(f"{name}: a kernel was not launched ({launches})")
        if name.startswith("lockstep_batched"):
            n_kf = sum(ln["n_kf"] for ln in rec["lanes"])
            for k in launches:
                if not kernel_lanes[k] > launches[k]:
                    _fail(f"{name}: {k} never took two lanes or more "
                          f"({launches[k]} launches, {kernel_lanes[k]} "
                          "lanes)")
            if not launches["dilate_pyramid"] < n_kf:
                _fail(f"{name}: {launches['dilate_pyramid']} K1 launches "
                      f"for {n_kf} keyframes")
    return dict(single_pipelined_fps=single_fps,
                references={k: {kk: v for kk, v in r.items() if kk != "traj"}
                            for k, r in refs.items()},
                compositions=results)


def _kernels_ran(part, launches):
    if launches["dilate_pyramid"] < 1 or launches["distance_transform"] < 1:
        _fail(f"phase 6 {part}: a kernel was not launched ({launches})")


def _stage_ms(fs, n):
    return {k: 1000.0 * v / n for k, v in sorted(fs.telemetry.stage_time
                                                  .items())}


def _report(part, rec):
    print(f"phase 6 {part}: " + json.dumps(rec), flush=True)


def run_cli(device, scene):
    """Phase 6 (a): the CLI on phase 4's frames written as a KITTI
    directory."""
    import torch

    from sdv_loam_tpu_torch import run as cli
    from sdv_loam_tpu_torch.data.kitti import KittiSequence
    from sdv_loam_tpu_torch.data.kitti_fixture import write_kitti_fixture
    from sdv_loam_tpu_torch.eval.ate import ate_rmse
    from sdv_loam_tpu_torch.io.images import read_image
    from sdv_loam_tpu_torch.ops import hopper_kernels as hk
    from sdv_loam_tpu_torch.config import Settings
    from sdv_loam_tpu_torch.system import checkpoint, runner

    d = os.path.join(OUT_DIR, "cli")
    n = len(scene)
    t0 = time.perf_counter()
    paths = write_kitti_fixture(scene, os.path.join(d, "kitti"))
    t_write = time.perf_counter() - t0
    out = {k: os.path.join(d, k) for k in ("view", "dbg")}
    files = {k: os.path.join(d, f) for k, f in (
        ("result", "traj.txt"), ("record", "events.jsonl"),
        ("log", "log.jsonl"), ("viewer3d", "map.html"),
        ("checkpoint", "window.npz"))}
    argv = ["--seq-dir", paths["seq_dir"], "--calib", paths["calib"],
            "--sensor", paths["sensor"], "--preset", "0",
            "--result", files["result"], "--record", files["record"],
            "--log", files["log"], "--viewer", out["view"],
            "--viewer3d", files["viewer3d"], "--debug-plots", out["dbg"],
            "--checkpoint", files["checkpoint"], "--device", str(device)]
    # the system the CLI ran, for its stage table
    ran = []
    orig = runner.run_sequence

    def keep_system(*a, **kw):
        out = orig(*a, **kw)
        ran.append(out[0])
        return out
    torch.cuda.synchronize()
    hk.reset_launch_counts()
    t0 = time.perf_counter()
    buf = io.StringIO()
    runner.run_sequence = keep_system
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    finally:
        runner.run_sequence = orig
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(hk.LAUNCHES)
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])

    def rows_to_T(rows):
        T = np.tile(np.eye(4), (rows.shape[0], 1, 1))
        T[:, :3, :] = rows.reshape(-1, 3, 4)
        return T
    rows = np.loadtxt(files["result"]).reshape(-1, 12)
    ate = float(ate_rmse(rows_to_T(rows),
                         rows_to_T(np.loadtxt(paths["poses"]))))
    events = [json.loads(x)["event"] for x in open(files["record"])]
    pngs = {k: sorted(os.listdir(v)) for k, v in out.items()}
    shapes = {k: list(read_image(os.path.join(out[k], v[-1])).shape)
              for k, v in pngs.items() if v}
    reader = KittiSequence.open(paths["seq_dir"], paths["calib"],
                                paths["sensor"])
    back = checkpoint.load(files["checkpoint"], reader.calib, reader.sensor,
                           Settings.preset_default(), device=device)
    ck_err = float(np.abs(back.get_trajectory()[:, :3, :].reshape(-1, 12)
                          - rows).max()) if len(back.shells) == n else None
    rec = dict(rc=rc, rows=int(rows.shape[0]), ate_m=ate, wall_s=wall,
               fps=n / wall, png_write_s=t_write, launches=launches,
               events={e: events.count(e) for e in sorted(set(events))},
               pngs={k: len(v) for k, v in pngs.items()}, png_shapes=shapes,
               checkpoint_max_abs=ck_err,
               stage_ms_per_frame=_stage_ms(ran[0], n),
               summary_fps=summary["fps"])
    _report("(a) CLI on a KITTI directory", rec)
    if rc != 0 or rows.shape[0] != n:
        _fail(f"CLI: rc {rc}, {rows.shape[0]} trajectory rows")
    if not ate <= ATE_LIMIT_M:
        _fail(f"CLI: ATE {ate} m over the {ATE_LIMIT_M} m gate")
    if not (rec["events"].get("cam_pose") and rec["events"].get("keyframes")):
        _fail(f"CLI: recording without cam_pose / keyframes ({events[:5]})")
    if not (pngs["view"] and pngs["dbg"]) or \
            any(len(v) != 3 for v in shapes.values()):
        _fail(f"CLI: viewer / debug-plot PNGs missing or bad ({shapes})")
    if ck_err is None or not ck_err <= 1e-6 * max(1.0, np.abs(rows).max()):
        _fail(f"CLI: the checkpoint reads back to another trajectory "
              f"({ck_err})")
    _kernels_ran("(a)", launches)
    # what comes back from the card stays small: the KITTI directory, the
    # window file and all but the last snapshot of each observer go
    shutil.rmtree(os.path.join(d, "kitti"))
    os.remove(files["checkpoint"])
    for k, v in pngs.items():
        for f in v[:-1]:
            os.remove(os.path.join(out[k], f))
    return rec


def run_dropout(device, scene):
    """Phase 6 (b): LiDAR dropout, sequential with the deep logs, then
    pipelined."""
    import torch

    from sdv_loam_tpu_torch.config import Settings
    from sdv_loam_tpu_torch.eval.ate import ate_rmse
    from sdv_loam_tpu_torch.ops import hopper_kernels as hk
    from sdv_loam_tpu_torch.system.runner import run_sequence

    n = len(scene)
    drop = Rendered(scene.seq, [(img, None if dropped(i) else cloud, ts)
                                for i, (img, cloud, ts)
                                in enumerate(scene.frames)])
    recs, trajs = {}, {}
    for mode, kw in (("sequential", dict(pipelined_frames=False,
                                         log_stuff=True)),
                     ("pipelined", dict(pipelined_frames=True))):
        log = os.path.join(OUT_DIR, f"dropout_{mode}.jsonl")
        torch.cuda.synchronize()
        hk.reset_launch_counts()
        t0 = time.perf_counter()
        fs, _ = run_sequence(drop, Settings(**kw), device=device,
                             log_path=log, prefetch=False, allow_reset=False)
        traj = fs.get_trajectory()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(hk.LAUNCHES)
        kinds = [json.loads(x)["kind"] for x in open(log)]
        trajs[mode] = traj
        recs[mode] = rec = dict(
            lost=bool(fs.is_lost), n_keyframes=len(fs.kf_shells),
            ate_m=float(ate_rmse(traj, scene.poses_wc[:n])), wall_s=wall,
            fps=n / wall, launches=launches,
            hessian_lines=kinds.count("hessian"),
            counters=dict(fs.telemetry.counters),
            mono_candidates=int((fs.im_valid & ~fs.im["is_sensor"]).sum()),
            stage_ms_per_frame=_stage_ms(fs, n))
        _report(f"(b) LiDAR dropout, {mode}", rec)
        if rec["lost"] or not rec["ate_m"] <= ATE_LIMIT_M:
            _fail(f"dropout {mode}: lost or ATE {rec['ate_m']}")
        if kw.get("log_stuff") and \
                rec["hessian_lines"] != rec["n_keyframes"] - 1:
            _fail(f"dropout: {rec['hessian_lines']} Hessian lines for "
                  f"{rec['n_keyframes'] - 1} optimized keyframes")
        _kernels_ran(f"(b) {mode}", launches)
    diff = float(np.abs(trajs["pipelined"] - trajs["sequential"]).max())
    print(f"phase 6 (b): pipelined vs sequential, largest difference {diff}",
          flush=True)
    return dict(recs, pipelined_vs_sequential=diff)


def run_mono(device):
    """Phase 6 (c): the monocular bootstrap at full width."""
    import torch

    from sdv_loam_tpu_torch.config import Settings
    from sdv_loam_tpu_torch.data.synthetic import make_sequence
    from sdv_loam_tpu_torch.ops import hopper_kernels as hk
    from sdv_loam_tpu_torch.ops import mono_init
    from sdv_loam_tpu_torch.system.full_system import FullSystem

    n = MONO_FRAMES
    t0 = time.perf_counter()
    seq = make_sequence(n_frames=n, **MONO_SCENE)
    frames = [seq.get(i) for i in range(n)]
    print(f"phase 6 (c): scene rendered in {time.perf_counter() - t0:.1f} s",
          flush=True)
    knn_calls = []
    orig = mono_init.knn

    def timed_knn(points, valid, *a, **kw):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = orig(points, valid, *a, **kw)
        torch.cuda.synchronize()
        knn_calls.append(dict(
            points=int(points.shape[0]), valid=int(valid.sum()),
            ms=1000.0 * (time.perf_counter() - t),
            peak_bytes=int(torch.cuda.max_memory_allocated()),
            peak_above_start_bytes=int(torch.cuda.max_memory_allocated()
                                       - base)))
        return out
    mono_init.knn = timed_knn
    try:
        fs = FullSystem(seq.calib, seq.sensor,
                        Settings(use_struct_pose=False,
                                 pipelined_frames=False), device=device)
        torch.cuda.synchronize()
        hk.reset_launch_counts()
        t0 = time.perf_counter()
        for img, _, ts in frames:
            fs.add_active_frame(img, None, ts)
        est = fs.get_trajectory()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        mono_init.knn = orig
    launches = dict(hk.LAUNCHES)
    rec = dict(initialized=bool(fs.initialized), lost=bool(fs.is_lost),
               n_keyframes=len(fs.kf_shells), wall_s=wall, fps=n / wall,
               launches=launches, knn_level0=knn_calls[0] if knn_calls
               else None, knn_calls=knn_calls,
               sensor_points=int(fs.pt["is_sensor"][fs.pt_valid].sum()),
               stage_ms_per_frame=_stage_ms(fs, n))
    if fs.initialized and len(fs.kf_shells) >= 2:
        k = fs.kf_shells[1]
        e = est[k:, :3, 3] - est[k, :3, 3]
        g = seq.poses_wc[k:n, :3, 3] - seq.poses_wc[k, :3, 3]
        s = float((e * g).sum() / max((e * e).sum(), 1e-12))
        rec.update(ready_frame=k, scale=s,
                   path_m=float(np.linalg.norm(np.diff(g, axis=0),
                                               axis=1).sum()),
                   err_m=float(np.linalg.norm(s * e - g, axis=1).max()))
    _report("(c) monocular bootstrap", rec)
    if not rec["initialized"] or rec["lost"] or rec["n_keyframes"] < 2 \
            or rec["sensor_points"]:
        _fail("mono bootstrap: not initialized, lost, < 2 keyframes or "
              "sensor points")
    if not (rec["scale"] > 0
            and rec["err_m"] < MONO_ERR_FRAC * rec["path_m"]):
        _fail(f"mono bootstrap: scale-aligned error {rec['err_m']} m over "
              f"{MONO_ERR_FRAC} x path {rec['path_m']} m")
    _kernels_ran("(c)", launches)
    return rec


def main():
    import torch

    # 1. device
    if not torch.cuda.is_available():
        _fail("CUDA is not available")
    device = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi unavailable: {smi.stderr.strip()}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # 2. build
    from sdv_loam_tpu_torch.ops import hopper_kernels as hk
    t0 = time.perf_counter()
    path = hk.build_library(verbose=True)
    hk._load()
    print(f"build: {path} in {time.perf_counter() - t0:.2f} s", flush=True)

    # 3. kernels against their plain versions
    rec = check_kernels(device)

    solver_kernels(device)

    # 4. the slice
    summary, scene = run_slice(device)
    print(f"slice ATE {summary['ate_m']:.4f} m, keyframes "
          f"{summary['n_keyframes']}, {summary['fps']:.3f} frames/s, "
          f"stage ms/frame {summary['stage_ms_per_frame']}, peak memory "
          f"{summary['peak_mem_bytes'] / 2**20:.1f} MiB", flush=True)

    # 5. the fleet
    t0 = time.perf_counter()
    fleet = run_fleet(device)
    for name, r in fleet["compositions"].items():
        worst = max(ln["max_dt_m"] for ln in r["lanes"]), \
            max(ln["max_dr_rad"] for ln in r["lanes"])
        print(f"fleet {name}: {r['aggregate_fps']:.3f} frames/s aggregate "
              f"(B={FLEET_B} x {FLEET_FRAMES} frames), single pipelined "
              f"{fleet['single_pipelined_fps']:.3f} frames/s, scaling "
              f"efficiency {r['scaling_efficiency']:.3f}, peak memory "
              f"{r['peak_mem_bytes'] / 2**20:.1f} MiB, launches "
              f"{r['launches']}, lanes {r['kernel_lanes']}, LM iterations "
              f"{r['lm_iters']}, largest "
              f"difference from the references {worst[0]:.3g} m / "
              f"{worst[1]:.3g} rad, stage ms/frame "
              f"{ {k: round(v, 3) for k, v in r['stage_ms_per_frame'].items() if v} }",
              flush=True)
    print(f"fleet phase {time.perf_counter() - t0:.1f} s", flush=True)

    # 6. CLI and camera-only
    t0 = time.perf_counter()
    os.makedirs(OUT_DIR, exist_ok=True)
    phase6 = dict(cli=run_cli(device, scene), dropout=run_dropout(device, scene),
                  mono=run_mono(device))
    print(f"phase 6 {time.perf_counter() - t0:.1f} s", flush=True)
    by_path = {"cli": phase6["cli"]["launches"],
               "dropout_sequential":
                   phase6["dropout"]["sequential"]["launches"],
               "dropout_pipelined": phase6["dropout"]["pipelined"]["launches"],
               "mono": phase6["mono"]["launches"]}

    kernels = [
        dict(name="dilate_pyramid", route="cuda",
             source="sdv_loam_tpu_torch/csrc/dilate_pyramid.cu",
             replaces="sdv_loam_tpu/ops/pallas_kernels.py:122",
             launches=summary["launches"]["dilate_pyramid"],
             launches_phase6={k: v["dilate_pyramid"]
                              for k, v in by_path.items()},
             **rec["dilate_pyramid"]),
        dict(name="distance_transform", route="cuda",
             source="sdv_loam_tpu_torch/csrc/distance_transform.cu",
             replaces="sdv_loam_tpu/ops/pallas_kernels.py:67",
             launches=summary["launches"]["distance_transform"],
             launches_phase6={k: v["distance_transform"]
                              for k, v in by_path.items()},
             **rec["distance_transform"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
