"""Chip smoke test of the PyTorch / CUDA port (sdv_loam_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits nonzero; each prints its results):
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles the Hopper kernels (csrc/*.cu, nvcc sm_90a);
  3. kernels: K1 (dilate_depth) and K2 (distance_transform) against their
     plain PyTorch versions on the card at the main-path shapes (exact
     equality required), determinism of build_track_ref, and CUDA-event
     times of kernel and plain version (median of 25);
  4. slice: the 30-frame default-preset synthetic KITTI scene (1200x360)
     through the port's run_sequence with the default Settings on cuda;
     requires not lost, >= 2 keyframes, ATE <= 0.10 m, and the main path's
     kernel launch counts;
then one JSON line with the kernels, and the device JSON as the last line.
The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# K1 shapes: the four pyramid levels at the default preset (1200x360) and
# one odd shape; K2: the level-1 grid at the default and fast presets and
# one odd shape
K1_SHAPES = ((360, 1200), (180, 600), (90, 300), (45, 150), (45, 70))
K2_SHAPES = ((180, 600), (160, 212), (37, 91))
MAIN_K1 = (360, 1200)
MAIN_K2 = (180, 600)
ATE_LIMIT_M = 0.10


def _fail(msg):
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def sparse_splat(h, w, rng, frac=0.04):
    """Realistic splat maps: ~frac of the cells filled with idepth sums and
    weights, as splat_idepth leaves them."""
    wt = np.zeros((h, w), np.float32)
    idp = np.zeros((h, w), np.float32)
    m = rng.random((h, w)) < frac
    wt[m] = rng.uniform(1.0, 300.0, m.sum()).astype(np.float32)
    idp[m] = wt[m] * rng.uniform(0.01, 0.5, m.sum()).astype(np.float32)
    return idp, wt


def seed_map(h, w, rng, n_seeds=2000):
    seed = np.full((h, w), 1000.0, np.float32)
    seed.reshape(-1)[rng.choice(h * w, min(n_seeds, h * w // 2),
                                replace=False)] = 0.0
    return seed


def time_ms(fn, n=25):
    """Median CUDA-event time of fn() in ms over n runs (after warm-up)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return float(np.median(out))


def check_kernels(device):
    """Phase 3. Returns per-kernel records (max_abs_err, ms, plain_ms)."""
    import torch

    from sdv_loam_tpu_torch.ops import hopper_kernels as hk
    from sdv_loam_tpu_torch.ops.photometric import (build_track_ref,
                                                    splat_idepth)
    from sdv_loam_tpu_torch.ops.pyramid import make_images

    rng = np.random.default_rng(0)
    rec = {"dilate_depth": dict(max_abs_err=0.0),
           "distance_transform": dict(max_abs_err=0.0)}
    for (h, w) in K1_SHAPES:
        idp, wt = sparse_splat(h, w, rng)
        ti = torch.as_tensor(idp, device=device)
        tw = torch.as_tensor(wt, device=device)
        for diag in (True, False):
            ki, kw = hk.dilate_depth(ti, tw, diagonal=diag)
            pi, pw = hk.dilate_depth_plain(ti, tw, diagonal=diag)
            torch.cuda.synchronize()
            err = max(float((ki - pi).abs().max()),
                      float((kw - pw).abs().max()))
            rec["dilate_depth"]["max_abs_err"] = max(
                rec["dilate_depth"]["max_abs_err"], err)
            eq = torch.equal(ki, pi) and torch.equal(kw, pw)
            print(f"K1 dilate_depth {h}x{w} diagonal={diag}: "
                  f"equal={eq} max_abs_err={err}", flush=True)
            if not eq:
                _fail(f"K1 differs from its plain version at {h}x{w}")
        if (h, w) in ((360, 1200), (180, 600), (90, 300), (45, 150)):
            diag = h >= 180
            t_k = time_ms(lambda: hk.dilate_depth(ti, tw, diagonal=diag))
            t_p = time_ms(lambda: hk.dilate_depth_plain(ti, tw,
                                                        diagonal=diag))
            print(f"K1 time {h}x{w} diagonal={diag}: kernel {t_k:.4f} ms, "
                  f"plain {t_p:.4f} ms", flush=True)
            if (h, w) == MAIN_K1:
                rec["dilate_depth"].update(ms=t_k, plain_ms=t_p)
    for (h, w) in K2_SHAPES:
        ts = torch.as_tensor(seed_map(h, w, rng), device=device)
        kd = hk.distance_transform(ts, 32)
        pd = hk.distance_transform_plain(ts, 32)
        torch.cuda.synchronize()
        err = float((kd - pd).abs().max())
        rec["distance_transform"]["max_abs_err"] = max(
            rec["distance_transform"]["max_abs_err"], err)
        eq = torch.equal(kd, pd)
        print(f"K2 distance_transform {h}x{w}: equal={eq} "
              f"max_abs_err={err}", flush=True)
        if not eq:
            _fail(f"K2 differs from its plain version at {h}x{w}")
        if (h, w) != (37, 91):
            t_k = time_ms(lambda: hk.distance_transform(ts, 32))
            t_p = time_ms(lambda: hk.distance_transform_plain(ts, 32))
            print(f"K2 time {h}x{w}: kernel {t_k:.4f} ms, plain "
                  f"{t_p:.4f} ms", flush=True)
            if (h, w) == MAIN_K2:
                rec["distance_transform"].update(ms=t_k, plain_ms=t_p)

    # deterministic splat + build_track_ref on the card
    h, w = MAIN_K1
    img = torch.as_tensor(rng.random((h, w)).astype(np.float32) * 255,
                          device=device)
    dI, _ = make_images(img, 4)
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
        pools.append(build_track_ref(dI, id0, w0, 4,
                                     cap=(6144, 4096, 2048, 1024)))
    same = all(torch.equal(a[k], b[k]) for a, b in zip(*pools)
               for k in ("u", "v", "idepth", "color", "valid"))
    print(f"build_track_ref twice: identical={same}", flush=True)
    if not same:
        _fail("build_track_ref is not deterministic on the card")
    return rec


def run_slice(device):
    """Phase 4: the default-preset slice. Returns (summary, n_build)."""
    import torch

    from sdv_loam_tpu_torch.config import Settings
    from sdv_loam_tpu_torch.data.synthetic import make_sequence
    from sdv_loam_tpu_torch.eval.ate import ate_rmse, rpe
    from sdv_loam_tpu_torch.ops import hopper_kernels as hk
    from sdv_loam_tpu_torch.system import full_system, kf_ops
    from sdv_loam_tpu_torch.system.runner import run_sequence

    n_frames = 30
    t0 = time.perf_counter()
    seq = make_sequence(n_frames=n_frames, w=1200, h=360, fx=718.856,
                        cy_offset=0.0, step=0.7, lidar_stride=2,
                        half_width=16.0, ground_contrast=0.25,
                        follow_path=True, yaw_rate=0.004, seed=7)
    frames = [seq.get(i) for i in range(n_frames)]   # render up front

    class Frames:
        """The pre-rendered sequence as a runner reader."""
        calib, sensor = seq.calib, seq.sensor

        def __len__(self):
            return n_frames

        def get(self, i):
            return frames[i]

    print(f"slice scene rendered in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # count build_track_ref calls on the main path (4 K1 launches each)
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
    fs, summary = run_sequence(Frames(), Settings(), device=device,
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
    if not (launches["dilate_depth"] > 0
            and launches["dilate_depth"] == 4 * n_build[0]):
        _fail(f"dilate_depth launches {launches['dilate_depth']} != 4 x "
              f"{n_build[0]} build_track_ref calls")
    if launches["distance_transform"] < 1:
        _fail("distance_transform never launched on the main path")
    return summary


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

    # 4. the slice
    summary = run_slice(device)
    print(f"slice ATE {summary['ate_m']:.4f} m, keyframes "
          f"{summary['n_keyframes']}, {summary['fps']:.3f} frames/s, "
          f"stage ms/frame {summary['stage_ms_per_frame']}, peak memory "
          f"{summary['peak_mem_bytes'] / 2**20:.1f} MiB", flush=True)

    kernels = [
        dict(name="dilate_depth", route="cuda",
             source="sdv_loam_tpu_torch/csrc/dilate_depth.cu",
             replaces="sdv_loam_tpu/ops/pallas_kernels.py:122",
             launches=summary["launches"]["dilate_depth"],
             **rec["dilate_depth"]),
        dict(name="distance_transform", route="cuda",
             source="sdv_loam_tpu_torch/csrc/distance_transform.cu",
             replaces="sdv_loam_tpu/ops/pallas_kernels.py:67",
             launches=summary["launches"]["distance_transform"],
             **rec["distance_transform"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
