"""Steady-state host ms per stage of the port on one GPU, this checkout
against another, in turns in one process tree.

    python3 tools/ab_slice.py --baseline DIR [--frames 40] [--skip 10] \
        [--preset fast]

Renders the default-preset slice of chip_smoke.py (scene A, 1200x360;
with `--preset fast` its phase 8 scene at 424x320 and
`Settings.preset_fast()`) once, then runs it through `FullSystem`
(sequential, on cuda) in a fresh process per run, in the order baseline,
this tree, this tree in the stage form (`device_loop.stage_form`),
baseline, this tree. Each run prints one JSON line: frames/s over the
frames from `--skip` on (each frame timed on the host clock; a sequential
frame ends in its stages' stream waits), keyframes, a digest of the
trajectory (two runs with the same digest tracked bit for bit alike), the
host ms per frame of each telemetry stage over the same frames, and the
device ms per frame of each stage program's replays over them (a CUDA
event pair around each replay, put around `device_loop._graph_program`'s
graph replay from outside, so a checkout without its own program timing
is measured alike). `--baseline` is an unpacked checkout of another commit
(`git archive <commit> | tar -x -C DIR`).
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scene(root, n, preset):
    sys.path.insert(0, root)
    import chip_smoke
    from sdv_loam_tpu_torch.data.synthetic import make_sequence
    scene = chip_smoke.FAST_SCENE if preset == "fast" else chip_smoke.SCENE
    return chip_smoke, make_sequence(n_frames=n, seed=7, yaw_rate=0.004,
                                     **scene)


def _time_programs(events):
    """Record (stage, start, end) CUDA events around every stage program's
    graph replay into `events` while `events` holds a True first item."""
    import torch

    from sdv_loam_tpu_torch.utils import device_loop

    stage_of = []
    graph_program = device_loop._graph_program
    replay = torch.cuda.CUDAGraph.replay

    def timed_program(stage, *a, **k):
        stage_of.append(stage)
        try:
            return graph_program(stage, *a, **k)
        finally:
            stage_of.pop()

    def timed_replay(self):
        if not (stage_of and events[0]):
            return replay(self)
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = replay(self)
        ev[1].record()
        events.append((stage_of[-1], *ev))
        return out
    device_loop._graph_program = timed_program
    torch.cuda.CUDAGraph.replay = timed_replay


def render(path, n, preset):
    import numpy as np
    chip_smoke, seq = _scene(ROOT, n, preset)
    frames = chip_smoke.render(seq, n)
    np.savez(path, img=np.stack([f[0] for f in frames]),
             ts=np.array([f[2] for f in frames]),
             **{f"cloud{i}": f[1] for i, f in enumerate(frames)})


def run(root, form, path, n, skip, preset):
    """One run of the slice from the rendered frames at `path`, with the
    checkout at `root` on the path; prints its JSON line."""
    import numpy as np
    import torch

    _, seq = _scene(root, n, preset)
    from sdv_loam_tpu_torch.config import Settings
    from sdv_loam_tpu_torch.system.full_system import FullSystem

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    ctx = contextlib.nullcontext()
    if form == "stage":
        from sdv_loam_tpu_torch.utils import device_loop
        ctx = device_loop.stage_form()
    events = [False]
    _time_programs(events)
    # every frame read once, before the timed loop (an NpzFile reads and
    # decodes a whole array at each item access)
    with np.load(path) as z:
        img, ts = z["img"], z["ts"]
        frames = [(img[i], z[f"cloud{i}"], float(ts[i])) for i in range(n)]
    settings = Settings.preset_fast() if preset == "fast" else Settings()
    fs = FullSystem(seq.calib, seq.sensor, settings, device="cuda")
    times, stage0 = [], {}
    with ctx:
        for i in range(n):
            if i == skip:
                stage0 = dict(fs.telemetry.stage_time)
                events[0] = True
            t0 = time.perf_counter()
            fs.add_active_frame(*frames[i])
            times.append(time.perf_counter() - t0)
    ms = {k: 1000.0 * (v - stage0.get(k, 0.0)) / (n - skip)
          for k, v in sorted(fs.telemetry.stage_time.items())}
    torch.cuda.synchronize()
    prog = {}
    for stage, a, b in events[1:]:
        prog[stage] = prog.get(stage, 0.0) + a.elapsed_time(b) / (n - skip)
    traj = np.ascontiguousarray(fs.get_trajectory(), dtype=np.float64)
    print(json.dumps(dict(tree=root, form=form, preset=preset,
                          device=torch.cuda.get_device_name(0),
                          fps=(n - skip) / sum(times[skip:]),
                          n_keyframes=len(fs.kf_shells), stage_ms=ms,
                          program_device_ms=dict(sorted(prog.items())),
                          trajectory_sha256=hashlib.sha256(
                              traj.tobytes()).hexdigest()[:16])),
          flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--skip", type=int, default=10)
    ap.add_argument("--preset", choices=("default", "fast"),
                    default="default")
    ap.add_argument("--run", nargs=3, metavar=("ROOT", "FORM", "PATH"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        run(args.run[0], args.run[1], args.run[2], args.frames, args.skip,
            args.preset)
        return
    base = os.path.abspath(args.baseline)
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        path = os.path.join(tmp, "frames.npz")
        render(path, args.frames, args.preset)
        for root, form in ((base, "default"), (ROOT, "default"),
                           (ROOT, "stage"), (base, "default"),
                           (ROOT, "default")):
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--baseline", base, "--frames",
                            str(args.frames), "--skip", str(args.skip),
                            "--preset", args.preset,
                            "--run", root, form, path], check=True)


if __name__ == "__main__":
    main()
