"""The tracking LM's kernels (K3, K4) against their plain versions on the
card, on the default-preset slice of chip_smoke.py (scene A, 1200x360,
30 frames, sequential, default Settings).

    python3 tools/track_kernel_ab.py [--frames 30] [--dropout] [--out FILE]
    python3 tools/track_kernel_ab.py --device cpu [--dropout]

Runs the slice twice in one process: with the kernels (the main path,
every track step program recorded), then with `photometric`'s K3 / K4
wrappers replaced by their plain versions (the op-by-op body the card ran
before the kernels). Prints one JSON line per run (ATE, relative pose
errors, keyframes), one per frame where the two trajectories part (pose
difference, LM iterations per level), and, for each recorded track step
of the kernel run, its outputs recomputed on the same inputs in the stage
form with the kernels and with the plain versions (pose difference,
whether the LM iterations, the chosen hypothesis and the residuals
agree). With `--dropout`, every third frame after the first two comes
without its cloud (chip_smoke.py phase 6 (b)). With `--device cpu`, one
run on the CPU (where every wrapper takes its plain version): its ATE
line only. A diagnostic; never the main path.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


@contextlib.contextmanager
def plain_versions():
    """photometric's K3 / K4 entry points replaced by the plain versions."""
    from sdv_loam_tpu_torch.ops import hopper_kernels as hk
    from sdv_loam_tpu_torch.ops import photometric as ph

    names = {"track_res_gs": hk.calc_res_gs_plain,
             "lm_update_step": hk.lm_update_step_plain,
             "lm_update_accept_step": hk.lm_update_accept_step_plain}
    saved = {n: getattr(ph, n) for n in names}
    for n, f in names.items():
        setattr(ph, n, f)
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(ph, n, f)


def _pose_diff(A, B):
    d = np.linalg.inv(A.astype(np.float64)) @ B.astype(np.float64)
    R = d[:3, :3]
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return (float(np.linalg.norm(d[:3, 3])),
            float(np.arctan2(0.5 * np.linalg.norm(w),
                             0.5 * (np.trace(R) - 1.0))))


def main():
    import torch

    import chip_smoke
    from sdv_loam_tpu_torch.config import Settings
    from sdv_loam_tpu_torch.data.synthetic import make_sequence
    from sdv_loam_tpu_torch.eval.ate import ate_rmse, rpe
    from sdv_loam_tpu_torch.system.full_system import FullSystem
    from sdv_loam_tpu_torch.utils import device_loop as dl

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--dropout", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    cpu = args.device == "cpu"
    if not cpu and not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    n = args.frames
    seq = make_sequence(n_frames=n, **chip_smoke.SCENE,
                        **chip_smoke.FLEET_SCENES["A"])
    frames = chip_smoke.render(seq, n)
    if args.dropout:
        frames = [(img, None if chip_smoke.dropped(i) else cloud, ts)
                  for i, (img, cloud, ts) in enumerate(frames)]
    lines = []

    def emit(rec):
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    if not cpu:
        # the plain versions' lazily made constant, made outside any
        # capture (the process's warm-ups ran the kernels)
        from sdv_loam_tpu_torch.ops import hopper_kernels as hk
        hk._step_scale(torch.zeros(1, device="cuda"))
    runs, programs = {}, []
    for form in ("plain",) if cpu else ("kernels", "plain"):
        fs = FullSystem(seq.calib, seq.sensor, Settings(), device=args.device)
        with plain_versions() if form == "plain" else \
                contextlib.nullcontext():
            for fr in frames:
                with dl.recording(programs, programs=True) \
                        if form == "kernels" else contextlib.nullcontext():
                    fs.add_active_frame(*fr)
        est = fs.get_trajectory()
        t_rpe, r_rpe = rpe(est, seq.poses_wc[:n])
        runs[form] = dict(traj=est, iters=[np.asarray(x).tolist()
                                           for x in fs.track_iters_hist])
        emit(dict(run=form, device="cpu" if cpu
                  else torch.cuda.get_device_name(0),
                  dropout=args.dropout,
                  ate_m=float(ate_rmse(est, seq.poses_wc[:n])),
                  t_rpe=float(t_rpe), r_rpe=float(r_rpe),
                  n_keyframes=len(fs.kf_shells), lost=bool(fs.is_lost),
                  counters=dict(fs.telemetry.counters)))
        del fs
    if cpu:
        return
    for i in range(n):
        dt, dr = _pose_diff(runs["kernels"]["traj"][i],
                            runs["plain"]["traj"][i])
        # the first frame is not tracked: frame i's LM iterations are the
        # (i - 1)-th record
        iters = {form: r["iters"][i - 1] if 0 < i <= len(r["iters"])
                 else None for form, r in runs.items()}
        emit(dict(frame=i, dt_m=dt, dr_rad=dr, iters=iters))

    # each recorded track step on its own inputs, kernels against plain
    from torch.utils._pytree import tree_unflatten
    k = 0
    for rec in programs:
        if rec["stage"] != "track":
            continue
        outs = {}
        for form in ("kernels", "plain"):
            inputs = tree_unflatten([v.clone() if isinstance(v, torch.Tensor)
                                     else v for v in rec["leaves"]],
                                    rec["spec"])
            # a cache of its own per form: the loops' graphs are keyed
            # by their body, which both forms share
            with dl.use(dl.LoopCache()), dl.stage_form(), \
                    plain_versions() if form == "plain" \
                    else contextlib.nullcontext():
                outs[form] = {kk: v.cpu().numpy() for kk, v in
                              rec["fn"](inputs, **rec["static"]).items()}
        a, b = outs["kernels"], outs["plain"]
        dt, dr = _pose_diff(a["T_ref_to_fh"][0], b["T_ref_to_fh"][0])
        res = a["res"][0], b["res"][0]
        f = np.isfinite(res[1])
        emit(dict(track_step=k, dt_m=dt, dr_rad=dr,
                  lvl_iters_equal=bool(np.array_equal(a["lvl_iters"],
                                                      b["lvl_iters"])),
                  lvl_iters=[a["lvl_iters"][0].tolist(),
                             b["lvl_iters"][0].tolist()],
                  best_try=[int(a["best_try"][0]), int(b["best_try"][0])],
                  res_rel=float(np.abs(res[0][f] - res[1][f]).max()
                                / max(np.abs(res[1][f]).max(), 1e-30))
                  if f.any() else 0.0,
                  n_matched=[int(a["n_matched"][0]),
                             int(b["n_matched"][0])]))
        k += 1
    if args.out:
        with open(args.out, "w") as fh:
            for rec in lines:
                fh.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
