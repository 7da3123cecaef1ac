"""Steady-state host ms per stage of the port on one GPU, this checkout
against another, in turns in one process tree.

    python3 tools/ab_slice.py --baseline DIR [--frames 40] [--skip 10]

Renders the default-preset slice of chip_smoke.py (scene A, 1200x360)
once, then runs it through `FullSystem` (sequential, default Settings, on
cuda) in a fresh process per run, in the order baseline, this tree, this
tree in the stage form (`device_loop.stage_form`), baseline, this tree.
Each run prints one JSON line: frames/s over the frames from `--skip` on
(each frame timed on the host clock; a sequential frame ends in its
stages' stream waits), keyframes, and the host ms per frame of each
telemetry stage over the same frames. `--baseline` is an unpacked
checkout of another commit (`git archive <commit> | tar -x -C DIR`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scene(root, n):
    sys.path.insert(0, root)
    import chip_smoke
    from sdv_loam_tpu_torch.data.synthetic import make_sequence
    return chip_smoke, make_sequence(n_frames=n, seed=7, yaw_rate=0.004,
                                     **chip_smoke.SCENE)


def render(path, n):
    import numpy as np
    chip_smoke, seq = _scene(ROOT, n)
    frames = chip_smoke.render(seq, n)
    np.savez(path, img=np.stack([f[0] for f in frames]),
             ts=np.array([f[2] for f in frames]),
             **{f"cloud{i}": f[1] for i, f in enumerate(frames)})


def run(root, form, path, n, skip):
    """One run of the slice from the rendered frames at `path`, with the
    checkout at `root` on the path; prints its JSON line."""
    import numpy as np
    import torch

    _, seq = _scene(root, n)
    from sdv_loam_tpu_torch.config import Settings
    from sdv_loam_tpu_torch.system.full_system import FullSystem

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    ctx = contextlib.nullcontext()
    if form == "stage":
        from sdv_loam_tpu_torch.utils import device_loop
        ctx = device_loop.stage_form()
    z = np.load(path)
    fs = FullSystem(seq.calib, seq.sensor, Settings(), device="cuda")
    times, stage0 = [], {}
    with ctx:
        for i in range(n):
            if i == skip:
                stage0 = dict(fs.telemetry.stage_time)
            t0 = time.perf_counter()
            fs.add_active_frame(z["img"][i], z[f"cloud{i}"],
                                float(z["ts"][i]))
            times.append(time.perf_counter() - t0)
    ms = {k: 1000.0 * (v - stage0.get(k, 0.0)) / (n - skip)
          for k, v in sorted(fs.telemetry.stage_time.items())}
    print(json.dumps(dict(tree=root, form=form,
                          device=torch.cuda.get_device_name(0),
                          fps=(n - skip) / sum(times[skip:]),
                          n_keyframes=len(fs.kf_shells), stage_ms=ms)),
          flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--skip", type=int, default=10)
    ap.add_argument("--run", nargs=3, metavar=("ROOT", "FORM", "PATH"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        run(args.run[0], args.run[1], args.run[2], args.frames, args.skip)
        return
    base = os.path.abspath(args.baseline)
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        path = os.path.join(tmp, "frames.npz")
        render(path, args.frames)
        for root, form in ((base, "default"), (ROOT, "default"),
                           (ROOT, "stage"), (base, "default"),
                           (ROOT, "default")):
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--baseline", base, "--frames",
                            str(args.frames), "--skip", str(args.skip),
                            "--run", root, form, path], check=True)


if __name__ == "__main__":
    main()
