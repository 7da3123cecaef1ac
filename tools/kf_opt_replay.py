"""One keyframe-optimization program replayed on the card: its kernels by
name and its device time.

    python3 tools/kf_opt_replay.py [--lanes 2] [--frames 6] [--replays 20] \
        [--out profile_out/kf_opt_replay.json]

Runs the first `--frames` frames of the 320x96 synthetic scene (the card
tests' scene, tests/test_torch_cuda.py; the default preset's pool of 4096
points and 8 frame slots) in a batched lockstep of `--lanes` sequences,
records the keyframe programs (`device_loop.recording`) and replays the
first recorded "kf_opt" `--replays` times: per replay the kernels the
profiler saw (count and device ms, by name), their summed device time,
the replay's CUDA-event time (input copies and output clones included),
the Hopper kernels' device counts, and the loops' iterations. The first
keyframe's inputs do not depend on the BA, so two checkouts replay the
same program inputs: run it from the root of each (it measures the
program of the checkout it runs from).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lanes", type=int, default=2)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--replays", type=int, default=20)
    ap.add_argument("--out", default="profile_out/kf_opt_replay.json")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())

    import torch
    from torch.profiler import ProfilerActivity, profile

    from sdv_loam_tpu_torch.config import Settings
    from sdv_loam_tpu_torch.data.synthetic import make_sequence
    from sdv_loam_tpu_torch.ops import hopper_kernels as hk
    from sdv_loam_tpu_torch.system.full_system import FullSystem
    from sdv_loam_tpu_torch.system.multi import MultiSystem
    from sdv_loam_tpu_torch.utils import device_loop as dl

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    seqs = [make_sequence(n_frames=args.frames, w=320, h=96, lidar_stride=2,
                          yaw_rate=0.003 * b) for b in range(args.lanes)]
    systems = [FullSystem(s.calib, s.sensor, Settings(), device=dev)
               for s in seqs]
    run = MultiSystem(systems, batch_track=True)
    log = []
    with dl.recording(log, programs=True):
        for i in range(args.frames):
            run.add_frames([s.get(i) for s in seqs])
    recs = [r for r in log if r["stage"] == "kf_opt"]
    if not recs:
        sys.exit("no keyframe program was recorded")
    rec = recs[0]
    leaves = [v.clone() if isinstance(v, torch.Tensor) else v
              for v in rec["leaves"]]

    def replay():
        return dl._graph_program(rec["stage"], rec["fn"], leaves,
                                 rec["spec"], rec["static"], dev)

    out, _ = replay()            # a capture where this key is new
    out, replayed = replay()
    torch.cuda.synchronize()
    hk.reset_launch_counts()
    ms = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(args.replays):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out, replayed = replay()
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
    launched = hk.device_launches()
    kernels = {}
    for e in prof.key_averages():
        if "CUDA" not in str(e.device_type):
            continue
        t = getattr(e, "device_time_total", None) or \
            getattr(e, "cuda_time_total", 0.0)
        kernels[e.key] = dict(count=e.count / args.replays,
                              ms=t / 1e3 / args.replays)
    top = sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])
    res = dict(
        card=torch.cuda.get_device_name(dev), root=os.getcwd(),
        lanes=args.lanes, replayed=bool(replayed),
        key_shapes=[tuple(v.shape) for v in rec["leaves"][:1]],
        lm_iters=np.asarray(out["lm_iters"].cpu()).tolist()
        if "lm_iters" in out else None,
        replay_event_ms=float(np.median(ms)),
        kernels_per_replay=sum(k["count"] for k in kernels.values()),
        device_ms_per_replay=sum(k["ms"] for k in kernels.values()),
        device_launches_per_replay={k: v / args.replays
                                    for k, v in launched.items()},
        top=[dict(name=n[:120], **v) for n, v in top[:25]],
        gemm={n[:120]: v for n, v in kernels.items() if "gemm" in n.lower()})
    print(json.dumps({k: v for k, v in res.items() if k not in ("top",
                                                                "gemm")}))
    for row in res["top"][:15]:
        print(f"  {row['ms']:.4f} ms  x{row['count']:.1f}  {row['name']}")
    print("gemm kernels: " + json.dumps(res["gemm"]))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
