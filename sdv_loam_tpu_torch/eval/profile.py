"""A profile window of the port on the card: torch.profiler (CPU + CUDA)
around a run of frames, read into per-frame numbers.

    summary = profile_window(step, n, systems)

`step(i)` advances frame (or lockstep round) i of the window; `systems`
are the FullSystems whose telemetry gives the stage times. The summary
holds, per frame (a round of B sequences counts as B frames when
`frames_per_step` is B):

  * host_launch_calls: the runtime's kernel-launch and graph-launch calls
    (`cudaLaunchKernel`, `cudaLaunchKernelExC`, `cuLaunchKernel`,
    `cudaGraphLaunch`), graph_launches the last of them;
  * device_kernels: kernels the device ran (a graph's kernels each count);
  * device_kernel_ms and device_busy_share: their summed device time, and
    its share of the window's wall time (overlap between streams is not
    subtracted);
  * replays, reads, captures: the loop driver's counts
    (`utils/device_loop.STATS`) over the window: every graph replay (the
    stage programs' and, in the stage form, the loops'), host reads of a
    stop flag, captures; program_replays, program_captures and
    program_ops: the stage programs' replays, captures and the ops their
    captures recorded; program_totals: their captures, capture and
    instantiate seconds, graph pool MiB and recorded ops since the counts'
    last reset (the captures happen before a steady window);
  * stage_ms: host-clock ms of each telemetry stage per frame of one
    system, the mean over `systems` (each stage ends in a wait for the
    system's stream; a batched stage is entered on each of its lanes);
  * program_device_ms: per stage program, the device ms of its replays
    per frame (a CUDA event pair around each replay,
    `device_loop.program_timing`, only inside the window), and
    program_device_replays their count per frame.

`count_dispatches(step, n)` counts, on the CPU, the ops a window
dispatches per frame inside and outside the iterated stages' loops: the
kernel launches each loop would cost on the card run eagerly. From the
command line, on phase 4's scene of chip_smoke.py (on the card by
default; `--device cpu` for the eager counts):

    python -m sdv_loam_tpu_torch.eval.profile --device cpu [--window 4 8] \
        [--w 1200 --h 360]

`lm_iteration_ops()` (`--lm-ops`) counts the ops of one tracking LM
iteration, with the K3 / K4 plain versions and with their kernels;
`align_ops()` (`--align-ops`, with `--device cpu` the plain versions')
the ops of one matcher alignment and patch warp.
"""

from __future__ import annotations

import time

import torch

from sdv_loam_tpu_torch.utils import device_loop

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")
GRAPH_CALLS = ("cudaGraphLaunch", "cuGraphLaunch")


def _dev_us(e):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, attr):
            return float(getattr(e, attr))
    return 0.0


def _is_device(e):
    return e.device_type is not None and "cuda" in str(e.device_type).lower()


def profile_window(step, n_steps: int, systems, frames_per_step: int = 1,
                   top: int = 15):
    """Profile `step(0) .. step(n_steps - 1)`; returns (summary dict, the
    profiler's key averages)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    stage0 = [dict(fs.telemetry.stage_time) for fs in systems]
    c0 = device_loop.counts()
    loops0, progs0 = c0.get("all", {}), c0.get("programs", {})
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            device_loop.program_timing() as prog_dev:
        t0 = time.perf_counter()
        for i in range(n_steps):
            step(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    c1 = device_loop.counts()
    loops1, progs1 = c1.get("all", {}), c1.get("programs", {})
    ka = prof.key_averages()
    n = n_steps * frames_per_step
    kernels = [e for e in ka if _dev_us(e) > 0 and _is_device(e)
               and not any(s in e.key for s in ("Memcpy", "Memset"))]
    copies = [e for e in ka if _dev_us(e) > 0 and _is_device(e)
              and any(s in e.key for s in ("Memcpy", "Memset"))]
    calls = {e.key: int(e.count) for e in ka if e.key in LAUNCH_CALLS}
    dev_us = sum(_dev_us(e) for e in kernels)
    stages = {}
    for fs, s0 in zip(systems, stage0):
        for k, v in fs.telemetry.stage_time.items():
            stages[k] = stages.get(k, 0.0) + v - s0.get(k, 0.0)
    # a batched stage's time is entered on each of its lanes: the mean over
    # the systems, per frame of one system
    per_sys = max(1, len(systems))
    summary = dict(
        frames=n, wall_ms_per_frame=1000.0 * wall / n,
        host_launch_calls_per_frame=sum(calls.values()) / n,
        graph_launches_per_frame=sum(calls.get(k, 0)
                                     for k in GRAPH_CALLS) / n,
        launch_calls=calls,
        device_kernels_per_frame=sum(int(e.count) for e in kernels) / n,
        device_kernel_ms_per_frame=dev_us / 1000.0 / n,
        device_copy_ms_per_frame=sum(_dev_us(e) for e in copies) / 1000.0
        / n,
        device_busy_share=dev_us / 1e6 / wall,
        **{f"{k}_per_frame": (loops1.get(k, 0) - loops0.get(k, 0)) / n
           for k in ("replays", "reads", "captures")},
        **{f"program_{k}_per_frame": (progs1.get(k, 0) - progs0.get(k, 0))
           / n for k in ("replays", "captures", "ops")},
        # the programs' captures since the counts' last reset (the frames
        # before the window capture them)
        program_totals={k: progs1.get(k, 0) for k in (
            "captures", "capture_s", "instantiate_s", "pool_mib", "ops")},
        stage_ms_per_frame={k: 1000.0 * v / per_sys / n_steps
                            for k, v in sorted(stages.items())},
        program_device_ms_per_frame={k: v["ms"] / n for k, v in
                                     sorted(prog_dev.items())},
        program_device_replays_per_frame={k: v["replays"] / n for k, v in
                                          sorted(prog_dev.items())},
        top_kernels=[dict(name=e.key[:120],
                          device_ms_per_frame=_dev_us(e) / 1000.0 / n,
                          calls_per_frame=e.count / n)
                     for e in sorted(kernels, key=_dev_us,
                                     reverse=True)[:top]])
    return summary, ka


# ops that make a view or alias and launch no kernel
_VIEW_OPS = frozenset((
    "view", "_unsafe_view", "expand", "select", "slice", "as_strided", "t",
    "transpose", "unsqueeze", "permute", "squeeze", "alias", "detach",
    "unbind", "split", "split_with_sizes", "diagonal", "lift_fresh",
    "reshape", "chunk", "narrow", "view_as_real", "unfold",
    "_reshape_alias"))


def count_dispatches(step, n_steps: int) -> dict:
    """Ops the port dispatches per frame, outside and inside the iterated
    stages' loops (views excluded): what each loop costs in kernel
    launches when it runs eagerly. Run on the CPU, where every loop is the
    eager one; returns dict(all, in_loops, per_stage), each per frame."""
    from torch.utils._python_dispatch import TorchDispatchMode

    counts = {"all": 0, "in_loops": 0}
    stage = []
    eager = device_loop.eager_loop

    def counted_loop(name, *a, **kw):
        stage.append(name)
        try:
            return eager(name, *a, **kw)
        finally:
            stage.pop()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ not in _VIEW_OPS:
                counts["all"] += 1
                if stage:
                    counts["in_loops"] += 1
                    key = "stage:" + stage[0]
                    counts[key] = counts.get(key, 0) + 1
            return func(*args, **(kwargs or {}))

    device_loop.eager_loop = counted_loop
    try:
        with Count():
            for i in range(n_steps):
                step(i)
    finally:
        device_loop.eager_loop = eager
    per = {k: v / n_steps for k, v in counts.items()}
    return dict(all=per.pop("all"), in_loops=per.pop("in_loops"),
                per_stage={k[6:]: v for k, v in sorted(per.items())})


def lm_iteration_ops() -> dict:
    """Ops one tracking LM iteration (`photometric._lm_body`: K3 at the
    carried step, then K4's accept-step) and one first evaluation
    (`photometric._level_res`) dispatch, views excluded, on the
    CPU on `kernel_timing.track_scene`'s 320x96 inputs (two lanes, three
    rows each, 1024 points): `plain` counts every op of the K3 / K4 plain
    versions (the op-by-op body the card ran before the kernels), `kernels`
    counts each K3 / K4 wrapper call as one launch and the ops around them
    (what the card path launches)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from sdv_loam_tpu_torch.eval import kernel_timing as kt
    from sdv_loam_tpu_torch.ops import photometric as ph

    x = kt.track_inputs(kt.track_scene(0, 96, 320, 1024, 2, 3), "cpu")
    B = x["T"].shape[0]
    loop_x = {"pool_" + k: v for k, v in x["pool"].items()}
    loop_x.update(K=x["K"], packed=x["packed"], lane=x["lane"],
                  cutoff=x["cutoff"], ref_aff=torch.zeros(B, 2),
                  exposures=torch.ones(B, 2))
    aff = torch.zeros(B, 2)
    state = {"n": 0, "inside": 0}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not state["inside"] and \
                    func.overloadpacket.__name__ not in _VIEW_OPS:
                state["n"] += 1
            return func(*args, **(kwargs or {}))

    def counted(fn):
        def call(*a, **k):
            state["n"] += 1
            state["inside"] += 1
            try:
                return fn(*a, **k)
            finally:
                state["inside"] -= 1
        return call

    def first():
        return ph._level_res(loop_x, x["T"], aff, x["cutoff"], 96, 320, 9.0,
                             True)
    r = first()
    lam = torch.full((B,), 0.01)
    step = ph.lm_update_step(r["H"], r["b"], lam, x["T"], aff,
                             loop_x["exposures"], loop_x["ref_aff"])
    st = dict({"r_" + k: v for k, v in r.items()}, T=x["T"], aff=aff,
              lam=lam, done=torch.zeros(B, dtype=torch.bool),
              n_it=torch.zeros(B, dtype=torch.int64),
              **dict(zip(ph.STEP_KEYS, step)))
    out = {}
    names = ("track_res_gs", "lm_update_step", "lm_update_accept_step")
    saved = {n: getattr(ph, n) for n in names}
    for mode in ("plain", "kernels"):
        if mode == "kernels":
            for n in names:
                setattr(ph, n, counted(saved[n]))
        try:
            res = {}
            for what, fn in (("lm_iteration", lambda: ph._lm_body(
                    loop_x, st, 96, 320, 9.0, True)),
                             ("first_evaluation", first)):
                state["n"] = 0
                with Count():
                    fn()
                res[what] = state["n"]
            out[mode] = res
        finally:
            for n in names:
                setattr(ph, n, saved[n])
    return out


def align_ops(device="cpu") -> dict:
    """Ops one matcher call (`warp_align`: the patch warp and the
    alignment), one `align_batch` call and one `warp_affine_patches`
    call dispatch, views excluded, at M = 256 candidate rows
    (`kernel_timing.warp_align_scene`, `align_scene`, `warp_scene` at
    96x320, one lane, n_iter 10): on the CPU the plain versions' (the
    batched loop op by op, what the card ran before K5 and K6), with the
    loop's iterations and the ops of one iteration (`align_body`); on CUDA
    the wrappers', each kernel launch counted as one op beside the ops it
    dispatches (the allocations of its outputs among them, listed by
    name)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from sdv_loam_tpu_torch.eval import kernel_timing as kt
    from sdv_loam_tpu_torch.ops import align
    from sdv_loam_tpu_torch.ops import hopper_kernels as hk

    names = []

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ not in _VIEW_OPS:
                names.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    def count(fn):
        names.clear()
        with Count():
            fn()
        if device != "cpu":
            names.append("kernel launch")
        return dict(ops=len(names), by_name={n: names.count(n)
                                             for n in sorted(set(names))})
    args = kt.align_args(kt.align_scene(0, 96, 320, 256, levels=3), device)
    wargs, kw = kt.warp_args(kt.warp_scene(1, 96, 320, 256), device)
    fargs, fkw = kt.warp_align_args(kt.warp_align_scene(2, 96, 320, 256,
                                                        levels=3), device)
    out = dict(device=str(device),
               warp_align=count(lambda: align.warp_align(*fargs, **fkw)))
    device_loop.reset_counts()
    out.update(align_batch=count(lambda: align.align_batch(*args)),
               warp_affine_patches=count(
                   lambda: align.warp_affine_patches(*wargs, **kw)))
    if device == "cpu":
        out["align_batch"]["iterations"] = \
            device_loop.counts()["align"]["iters"]
        x, st = hk.align_setup(*args)
        names.clear()
        with Count():
            hk.align_body(x, st)
        out["align_batch"]["ops_per_iteration"] = len(names)
    return out


def main():
    """Dispatch counts of a frame window of phase 4's scene
    (chip_smoke.py's SCENE, seed 7, default Settings), on the card unless
    `--device cpu` is given; with `--lm-ops`, the ops of one tracking LM
    iteration instead (`lm_iteration_ops`, on the CPU); with
    `--align-ops`, those of one matcher alignment and patch warp
    (`align_ops`)."""
    import argparse
    import json

    from sdv_loam_tpu_torch.config import Settings
    from sdv_loam_tpu_torch.data.synthetic import make_sequence
    from sdv_loam_tpu_torch.system.full_system import FullSystem

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--window", type=int, nargs=2, default=(4, 8))
    ap.add_argument("--w", type=int, default=1200)
    ap.add_argument("--h", type=int, default=360)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lm-ops", action="store_true")
    ap.add_argument("--align-ops", action="store_true")
    args = ap.parse_args()
    if args.lm_ops:
        print(json.dumps(lm_iteration_ops()))
        return
    if args.align_ops:
        print(json.dumps(align_ops(args.device)))
        return
    a, b = args.window
    seq = make_sequence(n_frames=b, w=args.w, h=args.h, fx=718.856,
                        cy_offset=0.0, step=0.7, lidar_stride=2,
                        half_width=16.0, ground_contrast=0.25,
                        follow_path=True, seed=7, yaw_rate=0.004)
    fs = FullSystem(seq.calib, seq.sensor, Settings(), device=args.device)
    for i in range(a):
        fs.add_active_frame(*seq.get(i))
    out = count_dispatches(lambda i: fs.add_active_frame(*seq.get(a + i)),
                           b - a)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
