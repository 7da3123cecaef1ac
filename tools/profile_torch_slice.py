"""Profile the PyTorch port's default-preset slice on one GPU.

    python3 tools/profile_torch_slice.py [--frames 30] [--window 10 20]
        [--out profile_out]

Renders the 30-frame 1200x360 synthetic KITTI scene of chip_smoke.py, runs
the port's FullSystem with the default Settings on cuda, and records frames
[window) under torch.profiler (CPU + CUDA). Writes to --out:

  * key_averages.txt: the op/kernel table sorted by device time;
  * summary.json: `sdv_loam_tpu_torch.eval.profile.profile_window`'s
    summary: host launch calls (kernel and graph launches), device kernels,
    device busy share, graph replays (the stage programs' among them),
    flag reads, captures and the ops the programs' captures recorded, and
    the per-stage host-clock ms, each per frame, and the top kernels;
    besides, the run's program captures, capture and instantiate seconds
    and graph pool MiB per stage (`device_loop.counts()`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--window", type=int, nargs=2, default=(10, 20))
    ap.add_argument("--out", default=os.path.join(ROOT, "profile_out"))
    args = ap.parse_args()

    import torch

    from sdv_loam_tpu_torch.config import Settings
    from sdv_loam_tpu_torch.data.synthetic import make_sequence
    from sdv_loam_tpu_torch.eval.profile import profile_window
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
    n_kf0 = len(fs.kf_shells)
    summary, ka = profile_window(
        lambda i: fs.add_active_frame(*frames[a + i]), b - a, [fs])
    from sdv_loam_tpu_torch.utils import device_loop
    counts = device_loop.counts()
    summary.update(device=torch.cuda.get_device_name(0), window=[a, b],
                   keyframes_in_window=len(fs.kf_shells) - n_kf0,
                   programs={k: counts[k] for k in sorted(device_loop.PROGRAMS)
                             if k in counts})
    with open(os.path.join(args.out, "key_averages.txt"), "w") as f:
        try:
            f.write(ka.table(sort_by="self_device_time_total", row_limit=60))
        except Exception:        # the key's older name
            f.write(ka.table(sort_by="self_cuda_time_total", row_limit=60))
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items()
                      if k != "top_kernels"}))
    for t in summary["top_kernels"]:
        print(json.dumps(t))


if __name__ == "__main__":
    main()
