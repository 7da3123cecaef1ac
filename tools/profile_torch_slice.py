"""Profile the PyTorch port's default-preset slice on one GPU.

    python3 tools/profile_torch_slice.py [--frames 30] [--window 10 20]
        [--out profile_out]

Renders the 30-frame 1200x360 synthetic KITTI scene of chip_smoke.py, runs
the port's FullSystem with the default Settings on cuda, and records frames
[window) under torch.profiler (CPU + CUDA). Writes to --out:

  * key_averages.txt: the op/kernel table sorted by device time;
  * summary.json: wall time of the window, summed device kernel time, the
    device busy and idle shares, launches per frame, the top kernels, and
    the per-stage host-clock ms/frame of the port's telemetry.

The device busy share counts each kernel's device time once (overlap
between streams is not subtracted; the port uses one stream).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--window", type=int, nargs=2, default=(10, 20))
    ap.add_argument("--out", default=os.path.join(ROOT, "profile_out"))
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from sdv_loam_tpu_torch.config import Settings
    from sdv_loam_tpu_torch.data.synthetic import make_sequence
    from sdv_loam_tpu_torch.system.full_system import FullSystem

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev = torch.device("cuda:0")
    os.makedirs(args.out, exist_ok=True)
    seq = make_sequence(n_frames=args.frames, w=1200, h=360, fx=718.856,
                        cy_offset=0.0, step=0.7, lidar_stride=2,
                        half_width=16.0, ground_contrast=0.25,
                        follow_path=True, yaw_rate=0.004, seed=7)
    frames = [seq.get(i) for i in range(args.frames)]
    fs = FullSystem(seq.calib, seq.sensor, Settings(), device=dev)
    a, b = args.window
    for i in range(a):
        fs.add_active_frame(*frames[i])
    torch.cuda.synchronize()
    stage0 = dict(fs.telemetry.stage_time)
    n_kf0 = len(fs.kf_shells)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(a, b):
            fs.add_active_frame(*frames[i])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = b - a
    ka = prof.key_averages()

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return float(getattr(e, attr))
        return 0.0

    kernels = [e for e in ka if dev_us(e) > 0 and e.device_type is not None
               and "cuda" in str(e.device_type).lower()]
    if not kernels:     # older attribute layouts: any event with device time
        kernels = [e for e in ka if dev_us(e) > 0]
    dev_total_us = sum(dev_us(e) for e in kernels)
    launches = sum(int(e.count) for e in kernels)
    top = sorted(kernels, key=dev_us, reverse=True)[:15]
    stages = {k: 1000.0 * (v - stage0.get(k, 0.0)) / n
              for k, v in fs.telemetry.stage_time.items()}
    summary = dict(
        device=torch.cuda.get_device_name(0), window=[a, b],
        wall_ms_per_frame=1000.0 * wall / n,
        device_kernel_ms_per_frame=dev_total_us / 1000.0 / n,
        device_busy_share=dev_total_us / 1e6 / wall,
        device_idle_share=1.0 - dev_total_us / 1e6 / wall,
        kernel_launches_per_frame=launches / n,
        keyframes_in_window=len(fs.kf_shells) - n_kf0,
        stage_host_ms_per_frame=stages,
        top_kernels=[dict(name=e.key[:120], device_ms_per_frame=dev_us(e)
                          / 1000.0 / n, calls_per_frame=e.count / n)
                     for e in top])
    with open(os.path.join(args.out, "key_averages.txt"), "w") as f:
        f.write(ka.table(sort_by="self_cuda_time_total", row_limit=60))
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items()
                      if k != "top_kernels"}))
    for t in summary["top_kernels"]:
        print(json.dumps(t))


if __name__ == "__main__":
    main()
