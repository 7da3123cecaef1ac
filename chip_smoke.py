"""Chip smoke test of the PyTorch / CUDA port (sdv_loam_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits nonzero; each prints its results):
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles the Hopper kernels (csrc/*.cu, nvcc sm_90a; a
     library already built from the same sources is reused with the
     ptxas report kept beside it) and prints ptxas's registers, spills
     and shared memory of K3-K6's kernels (K5 and K6 are one kernel;
     fails on a spill, or when that kernel takes more than
     ALIGN_MAX_REGISTERS registers);
  3. kernels: K1 (dilate_pyramid, build_track_ref's whole 4-level chain)
     and K2 (distance_transform) against their plain PyTorch versions on
     the card (exact equality required) at the main-path shapes, the fast
     preset's, odd shapes and L = 4 lanes, K2 at 32 and 64 sweeps; at the
     main-path shapes each lane of an L = 4 launch against its one-lane
     launch (exact); determinism of build_track_ref; at the main-path
     shapes and the fast preset's each kernel's device time
     (torch.profiler), wrapper and plain CUDA-event times, bound and
     share; K3 (track_res_gs) and K4 (lm_update_step and
     lm_update_accept_step) against their plain versions (the
     accept-step against the plain accept then step) at the main path's
     shapes of both
     presets (the hypothesis ladder, level 0, the struct-pose veto), one
     lane and L = 4, with points out of bounds, saturated, at depth 0 and
     under an image patch of inf (K3's counts exact, its other outputs
     within TRACK_REL of each row's largest magnitude, non-finite outputs
     where the plain version's are; K4's steps within SOLVE_REL of their
     norm, its accept and carries bit for bit), a row alone bit for bit
     as among the others, and their times at the ladder's and level 0's
     shapes and at the ladder's with L = 4 (K4 per LM iteration: one
     accept-step launch; its step entry beside it); the matcher's kernel,
     K5 (align_batch, the whole alignment loop) with K6
     (warp_affine_patches) as its prologue, in one launch (warp_align),
     against its plain version (the two plain versions in turn) at the
     matcher's main-path shapes of both presets (the track step's call,
     the keyframe's two passes), one lane and L = 4, with a NaN start, a
     NaN patch, a NaN and a singular warp, rows that walk far from their
     start, rows at a level's edge and rows on a level the pack cuts
     short; and K5 alone (given patches) and K6 alone (the
     patches written) against theirs (K5's converged flags agreeing on
     ALIGN_FLAG_SHARE of the rows but one, px within ALIGN_PX_TOL, its
     failure counts apart by at most the rows whose flags differ, K6's
     zero and NaN pattern equal and values within PATCH_TOL, all bit for
     bit their CPU emulation tests/k5_align.py; the rows and values that
     differ printed; the plain loop's graphs in a cache of the phase's
     own, freed before phase 4), the fused call's times at every shape
     with one lane and at the default pass 1
     with L = 4, K5's and K6's alone at that pass; the CUDA kernels behind the
     windowed BA's dense solve (one window, and four in one batched
     call);
  4. slice: the 30-frame default-preset synthetic KITTI scene (1200x360)
     through the port's run_sequence with the default Settings on cuda;
     requires not lost, >= 2 keyframes, ATE <= 0.10 m, one K1 launch per
     keyframe optimization and build_track_ref call outside it, at
     least one K2 launch, and K3-K6's device counters equal to the
     evaluations the tracking loops ran and the matcher's calls (one
     fused K5 / K6 launch each, no K5 or K6 launch of its own, and one
     launch of the kernel zeroing its failure counts each)
     (`check_track_evaluations`: the same frames with the eager loops,
     where device_loop counts every LM call and iteration and the
     matcher's calls are counted on the host), and no "align" loop;
  5. fleet: bench.py's two default-preset scenes (16 frames each) alone in
     pipelined mode (scene A also with the deferred keyframe readback),
     then B = 4 sequences (A, B, A, B) on the card as InterleavedFleet
     (serial, and one thread and stream per system) and as the lockstep
     MultiSystem: unbatched (every stage per sequence), and batched
     (pyramid, LiDAR, track, trace, selection, activation and the keyframe
     optimization as lanes of one call per round; host work on one
     thread, the CUDA default, and on a thread per system); requires every
     lane not lost, ATE <= 0.10 m, its scene's keyframe count, (for the
     interleaved fleets) its scene's trajectory to 1e-5, K3 and K4
     launched in every composition (and in the batched lockstep once per
     evaluation its loops ran, against an eager run), and of the
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
         frame (after a 320x96 camera-only warm-up system, which takes the
         process's eager first call of each bootstrap program); requires
         initialized, not lost, >= 2 keyframes, no sensor points, a
         scale-aligned error below 0.15 x path and no flag read on the
         host in a bootstrap frame; prints each knn call's time and peak
         memory (level 0 first), the flag reads per bootstrap frame and
         each level LM's iterations; then the bootstrap again in the
         stage form, which must take the same iterations and reach the
         same pose bit for bit, and its recorded "mono_lm", "select_map"
         and "pyramid" programs held to the stage form;
     each part requires at least one launch of each of K1-K6;
  7. long horizon, sequential through run_sequence, each part with its own
     kernel launch counts: (a) tests/test_drift_gate.py's scene and
     Settings (320x96, 100 frames); (b) phase 4's scene A at the default
     preset and full width (1200x360), 100 frames; each requires not lost,
     ATE under 2 % of the path and at least one launch of each of K1-K6,
     and
     prints ATE, the BA step vetoes (`ba_step_veto`, `ba_step_veto_hard`),
     keyframes and frames/s;
  8. the fast preset (`Settings.preset_fast()`, bench.py's second
     operating point: 424x320, 800 points, 7 frame slots) on bench.py's
     scenes at that resolution (fx 245.6, fy 611.8), each part with its
     kernel launch counts; accuracy gated at the drift gate's share of the
     path (this operating point drifts in the JAX package too):
     (a) 30 frames of scene A through run_sequence in a child process of
         its own (the process's first call of each stage program, its
         eager warm-up, is then the fast preset's); requires not lost,
         >= 2 keyframes, one K1 launch per keyframe program and
         build_track_ref call outside it, a K2 launch and no flag read on
         the host in a frame without a warm-up; then the same frames in
         the stage form (the same decisions and trajectory bit for bit)
         and the stage programs of frames 5-10 against the stage form;
         prints frames/s (whole, frames 10-30), stage ms per frame, each
         program's captures, keys, seconds, pool MiB and graph nodes, peak
         memory, a profile window of frames 10-20, then the same 30
         frames with the eager loops: K3-K6's counters equal to the
         evaluations the loops ran and the matcher's calls, and each
         loop's iteration counts over frames 0-14;
     (b) scene A pipelined: (a)'s trajectory to 1e-5;
     (c) B = 4 (A, B, A, B, 16 frames) as the batched lockstep: each lane
         not lost, with its scene's keyframe count; K1 and K2 launches
         that took two lanes or more; the programs of rounds 5-10 against
         the stage form; aggregate frames/s and peak memory;
     (d) 20 frames of scene A as a KITTI directory through the CLI with
         `--preset 2`: rc 0 and one trajectory row per frame;
  9. capacity and pinned fleets, each number beside the card's name and
     power limit:
     (a) at each preset, one sequence of scene A (16 frames): its
         persistent device bytes (`utils/hbm.system_device_bytes`), the
         process's live bytes, the card's budget (`hbm_budget_bytes`) and
         the fleet size `hbm.pick_fleet_size` picks for B = 8; then the
         batched lockstep at B = 4 and 8 (A, B, A, B, ..., 16 rounds) on
         phases 5's and 8's frames: peak memory (its own beside what the
         process held before its systems were made), aggregate frames/s
         (whole, rounds 5-16) and each lane's ATE; first the memory the
         process holds with no system alive, with and without torch's
         cuBLAS workspaces (then freed); requires no lane lost,
         phase 5's ATE gate (default) or phase 8's (fast), no peak over
         the budget, and no measured working-set ratio (B = 1, 4 and 8:
         a run's own peak over B x one system's persistent bytes) above
         `hbm.TEMPORARIES_FACTOR`;
     (b) `parallel/dryrun.dryrun_pinned_fleet` over
         `parallel/mesh.make_batch_mesh()` (every visible card; one
         pipelined 320x96 system each, its state on its card, its
         trajectory bit for bit its run alone), then a threaded pinned
         fleet of two systems on [cuda:0, cuda:0] at the default preset
         (phase 5's scenes A and B, 16 frames; the worker pool prepares
         each worker on the devices of its fleet), each bit for bit its
         run alone, and `dryrun_production` over the mesh (the
         production lane forms, two lanes a card, finite); the fleets'
         counts are read when they have flushed (before the runs alone)
         and must show all six kernels, the lane forms' (counted without
         the recording run their inputs come from) K1 and K3-K6 (K2 is
         the activation program's, which no lane form runs); prints the
         devices, and that cross-card placement was not run where one
         card is visible;
The pyramid, the track step, the LiDAR preprocessing, the trace, a
selection attempt, the activation, the keyframe optimization (matcher
refresh, windowed BA, marginalization and the K1 launch), and the
bootstrap's status-map selection and level LM run as stage programs, one
captured CUDA graph per shape each, their loops' later chunks and their
conds as conditional nodes decided on the card (utils/device_loop). Each
phase prints the graphs' captures, capture seconds, replays and flag reads
per frame, and the programs' replays, captures, capture and instantiate
seconds, pool MiB and recorded ops, and for the pyramid, the selection
and the bootstrap's programs each one's captures, capture seconds and
keys; phases 4 and 5 print the keyframe program's own (captures
per system) and require that none of its loops and conds read a flag on
the host past the process's first, eager call of the program (phase 4
checks a second system), and the program comparisons count K1's launches
per replay of a keyframe program (one).
Besides:
  * phase 4 again in the stage form (`device_loop.stage_form`: the stages
    called directly, every loop as replayed chunk graphs with host reads):
    the same LM decisions (iteration counts per level and per keyframe
    BA), keyframes and trajectory, bit for bit, are required;
  * program against stage form: the stage programs of that run's frames
    5-10, and of the batched lockstep's rounds 5-10 (four lanes), each
    replayed on the card (captured in a fresh cache first) and run in the
    stage form on the same inputs; every output must be bit for bit equal;
  * graph against eager, per loop: the loops of phase 4's fifth frame in
    the stage form (LiDAR scan, track step) and of its first keyframe
    optimization, and the batched lockstep's windowed-BA loops of its fifth
    round and first batched keyframe optimization (lanes), each replayed
    through graphs and run by the eager early-exit loop on the card;
    every output and iteration count must be bit for bit equal;
  * the results recorded on the card (PERF.md section 5), read again
    (phases 4, 6, 7), printed beside this run's;
  * profile windows (torch.profiler): phase 4's frames 10-20 and five
    rounds of the batched lockstep: host launch calls, device kernels,
    device busy share, replays, reads, captures, program replays, each
    stage program's device ms (CUDA events around its replays) and stage
    ms, per frame;
then one JSON line with the six kernels (K3-K6 with their launches in
every phase), and the device JSON as the last line.
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
# the fast preset's (phase 8): 424x320 input, K2 on the level-1 grid
FAST_K1 = (320, 424)
FAST_K2 = (160, 212)
# K3 and K4, the tracking LM's body: the main path's (h, w, points, rows)
# at each preset are `kernel_timing.TRACK_SHAPES`: the hypothesis ladder
# on the coarsest level (32 rows), the refinement on level 0 (3 rows), the
# struct-pose veto on level 1 (2 rows); the ladder's and level 0's are
# timed, and the ladder's of LANES lanes (the batched lockstep's).
# Tolerances (as in tests/test_torch_cuda.py): K3's counts exact, its
# other outputs within TRACK_REL of the row's largest magnitude (float32
# sums of up to 6144 terms, whose own error K3's float64 sums leave out,
# with cancellation: 1.3e-5 measured at level 0 on an H100); K4's step
# within SOLVE_REL of its norm (its float64 LU against
# torch.linalg.solve_ex's float32 one: the float32 solve's error grows
# with the damped system's condition, 3.2e-5 measured on the fast ladder),
# the pose and affine update of the kernel's own step within UPDATE_TOL of
# max(1, |value|), its accept bit for bit
TRACK_REL = 1e-4
SOLVE_REL = 1e-3
UPDATE_TOL = 1e-5
# K5 and K6 (as in tests/test_torch_align_kernels.py): K5's converged flags
# differ from the plain loop's on at most one row plus 1 - ALIGN_FLAG_SHARE
# of the rows (a row whose last step sits at the 0.03 px threshold
# converges on one side only when its float64 sums round otherwise than
# the plain version's float32 ones; read on an H100: 0 of phase 3's 39,280
# rows, 1 of eval/kernel_timing.py --align's 720 at the default track
# call), px within ALIGN_PX_TOL (a third of a converging step; read: <=
# 0.0038 px) where both converge, the per-lane failure counts apart by at
# most the rows whose flags differ; K6's patches within PATCH_TOL (0-255
# intensities: its float64 inverse against inv_ex's float32 LU moves a
# sample point by ~1e-5 px). Both also bit for bit (NaN payloads aside)
# against their CPU emulation, tests/k5_align.py: that catches a fault
# that moves px by less than ALIGN_PX_TOL (an iteration too few, the
# convergence test before the last update)
ALIGN_FLAG_SHARE = 0.999
ALIGN_PX_TOL = 0.01
PATCH_TOL = 0.02
# the fused call's px gate (as in tests/test_torch_cuda.py): a row that
# converges in both but one iteration later on one side differs by that
# last step, less than the threshold of 0.03 px; such rows share the
# flags' budget (read on an H100 80GB HBM3 at 700 W: 1 of 10,240 rows,
# 0.016 px, in the card tests' four-lane pass 1)
ALIGN_STEP_TOL = 0.03
HUBER = 9.0
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
# the warm-up system before it: tests/test_mono_init.py's scene, frames
# enough for every bootstrap program's first call
MONO_WARM_SCENE = dict(w=320, h=96, step=0.4, lidar_stride=8)
MONO_WARM_FRAMES = 3
# phase 7: tests/test_drift_gate.py's scene and Settings, and scene A at
# full width, 100 frames each; the drift gate's ATE limit (share of path)
DRIFT_SCENE = dict(w=320, h=96, step=0.8, yaw_rate=0.0, lidar_stride=4)
DRIFT_SETTINGS = dict(desired_immature_density=600, desired_point_density=800,
                      n_active_cap=2048, n_immature_cap=2048,
                      closest_view_track=False)
LONG_FRAMES = 100
LONG_ATE_FRAC = 0.02
# what the eager-loop port read on the card (PERF.md section 5): ATE to
# 4 decimals (m), BA step vetoes, keyframes, K1 and K2 launches; the
# bootstrap's ready frame and error
RECORDED = {"phase4": dict(ate_m=0.0176, n_keyframes=16, k1=16, k2=15),
            "phase6_cli": dict(ate_m=0.0164, k2=15),
            "phase6_dropout": dict(ate_m=0.0371, ba_step_veto=4, k1=20,
                                   k2=15),
            "phase6_mono": dict(ready_frame=7, err_m=0.305),
            "phase7_drift_gate": dict(ate_m=0.8673, ba_step_veto=4,
                                      n_keyframes=51, k1=55, k2=50),
            "phase7_scene_a": dict(ate_m=0.6838, ba_step_veto=0, k1=51,
                                   k2=50)}
# the frame (round) whose loops are compared graph against eager, and the
# profile windows: phase 4's frames, the batched lockstep's rounds
COMPARE_FRAME = 4
PROFILE_FRAMES = (10, 20)
# the frames (rounds) whose stage programs are compared with the stage
# form on the same inputs, and the programs every such comparison needs
PROGRAM_FRAMES = range(5, 11)
PROGRAM_STAGES = ("track", "lidar", "trace", "activate", "kf_opt", "select",
                  "pyramid")
# the stage programs whose captures, capture seconds and keys every phase
# prints (the per-frame stages that became programs last, and the
# bootstrap's)
KEYED_PROGRAMS = ("pyramid", "select", "select_map", "mono_lm")
# the key statics that name a program's key beside its largest input's
# shape
KEY_STATICS = ("levels", "pot", "cap", "max_iters")
# the loops and conds inside the keyframe program: no flag of theirs is
# read on the host on the main path (its splat rounds also build the
# first frame's tracking reference, outside any program)
KF_PROGRAM_PARTS = ("ba0", "ba", "match2", "marg")
PROFILE_ROUNDS = (5, 10)
# the six kernels' launch counts (`hopper_kernels.launch_counts`)
KERNEL_NAMES = ("dilate_pyramid", "distance_transform", "track_res_gs",
                "track_lm_update", "align_batch", "warp_patches")
# phase 9: the fleet size bench.py asks for, whose capacity is measured,
# and the batched lockstep fleets run to measure it
CAPACITY_B = 8
CAPACITY_LOCKSTEP = (4, CAPACITY_B)
# phase 8: bench.py's fast operating point (its scene keywords,
# bench.py:104-116 and :122-132): the reference's preset 2/3 on a
# non-proportional resize of the KITTI frame; scene A's frames for one
# sequence and for the CLI; the frames whose loops' iterations are counted
FAST_SCENE = dict(w=424, h=320, fx=245.6, fy=611.8, cy_offset=0.0, step=0.7,
                  lidar_stride=2, half_width=16.0, ground_contrast=0.25,
                  follow_path=True)
FAST_FRAMES = 30
FAST_CLI_FRAMES = 20
FAST_ITER_FRAMES = 15
# The fast preset drifts on this scene in the JAX package too, so its
# accuracy gate is the drift gate's share of the path (LONG_ATE_FRAC), not
# the 0.10 m of a ~10 m path: the JAX package's ATE over scene A's 30
# frames on the CPU is 0.266 m with x64 off and 0.058 m with x64 on (raw
# scans), 0.580 and 0.524 m mid-binned.
FAST_ATE_FRAC = LONG_ATE_FRAC
# the argument that runs phase 8 (a) in this script's child process
FAST_CHILD = "--fast-child"
# the renderer's worker processes run one thread each: eight processes of
# eight BLAS threads each ran at half the speed on an 8-core host
RENDER_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                      "MKL_NUM_THREADS")


def dropped(i):
    """LiDAR dropout: every third frame after the first two has no cloud."""
    return i >= 2 and i % 3 == 2


def render(seq, n):
    """Frames 0..n-1 of a synthetic sequence (host raycasting; each frame
    depends only on its index), rendered by spawned worker processes with
    one BLAS / OpenMP thread each, which exit before this returns."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    workers = max(1, min(8, os.cpu_count() or 1, n))
    saved = {k: os.environ.get(k) for k in RENDER_THREAD_VARS}
    os.environ.update({k: "1" for k in RENDER_THREAD_VARS})
    try:
        with ProcessPoolExecutor(
                workers,
                mp_context=multiprocessing.get_context("spawn")) as ex:
            return list(ex.map(seq.get, range(n)))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _Tee:
    """Standard output also written to a log under chiprun_out/, which
    keeps the whole of a long run's output."""

    def __init__(self, stream, path):
        self.stream, self.log = stream, open(path, "w")

    def write(self, text):
        self.stream.write(text)
        self.log.write(text)

    def flush(self):
        self.stream.flush()
        self.log.flush()


def held_memory():
    """Bytes the process holds on the card once the dead systems of earlier
    runs are collected (a system's reference cycles wait for the cyclic
    collector); read before a fleet's systems are made, it is what a peak
    of that fleet's run holds besides the fleet."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _brief(loops):
    return {k: v for k, v in loops.items() if k != "per_stage"}


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

    def times(name, kernel, plain, bound, shape):
        t_dev = kt.device_ms(kernel)
        t_k = kt.wrapper_ms(kernel)
        t_p = kt.wrapper_ms(plain)
        share = bound[0] / t_dev if t_dev else None
        print(f"{name} time at {shape}: device {t_dev} ms, wrapper "
              f"{t_k:.4f} ms, plain {t_p:.4f} ms, bound {bound[0]:.6f} ms "
              f"({bound[1]}), share of the bound {share}", flush=True)
        t = dict(ms=t_k, plain_ms=t_p, device_ms=t_dev, bound_ms=bound[0],
                 bound_us=1e3 * bound[0], bound_by=bound[1], share=share,
                 library_ms=None, library="none")
        if shape in (MAIN_K1, MAIN_K2):
            rec[name].update(t)
        else:
            # the fast preset's shape, beside the main path's
            rec[name]["fast_preset"] = dict(t, shape=list(shape))

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
            if lanes is None and (h, w) in (MAIN_K1, FAST_K1):
                times("dilate_pyramid",
                      lambda: hk.dilate_pyramid(ti, tw, LEVELS),
                      lambda: hk.dilate_pyramid_plain(ti, tw, LEVELS),
                      kt.dilate_pyramid_bound(1, h, w, LEVELS), (h, w))
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
            if lanes is None and (h, w) in (MAIN_K2, FAST_K2):
                times("distance_transform",
                      lambda: hk.distance_transform(ts, 32),
                      lambda: hk.distance_transform_plain(ts, 32),
                      kt.distance_transform_bound(1, h, w, 32), (h, w))

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


def _res_errors(got, ref):
    """K3's outputs against its plain version's: (whether every count is
    equal, every non-finite output sits where the plain version's does and
    every other is within TRACK_REL of its row's largest magnitude; the
    largest absolute and relative error over the finite outputs)."""
    import torch

    ok = torch.equal(got["n"], ref["n"]) and torch.equal(
        torch.round(got["sat_frac"] * ref["n"].clamp(min=1)),
        torch.round(ref["sat_frac"] * ref["n"].clamp(min=1)))
    worst_abs = worst_rel = 0.0
    for k in ("E", "H", "b", "flow_t", "flow_rt"):
        g = got[k].double().reshape(got[k].shape[0], -1)
        r = ref[k].double().reshape(ref[k].shape[0], -1)
        f = torch.isfinite(r)
        ok = ok and torch.equal(torch.isfinite(g), f)
        d = torch.where(f, (g - r).abs(), torch.zeros_like(r))
        scale = torch.where(f, r.abs(), torch.zeros_like(r)).amax(1)
        rel = d.amax(1) / scale.clamp(min=1e-30)
        worst_abs = max(worst_abs, float(d.max()))
        worst_rel = max(worst_rel, float(rel.max()))
    return ok and worst_rel <= TRACK_REL, worst_abs, worst_rel


def _rel_dev(a, b):
    """Largest |a - b| / max(1, |b|)."""
    return float(((a - b).abs() / b.abs().clamp(min=1.0)).max())


def kernel_times(name, kernel, plain, bound, where):
    """A kernel's device time (torch.profiler), its wrapper's and its plain
    version's CUDA-event times, its bound and share at `where`, printed;
    no library call computes K3-K6's functions."""
    from sdv_loam_tpu_torch.eval import kernel_timing as kt

    t_dev = kt.device_ms(kernel)
    t_k = kt.wrapper_ms(kernel)
    t_p = kt.wrapper_ms(plain)
    share = bound[0] / t_dev if t_dev else None
    print(f"{name} time at {where}: device {t_dev} ms, wrapper "
          f"{t_k:.4f} ms, plain {t_p:.4f} ms, bound {bound[0]:.6f} ms "
          f"({bound[1]}), share of the bound {share}", flush=True)
    return dict(ms=t_k, plain_ms=t_p, device_ms=t_dev, bound_ms=bound[0],
                bound_by=bound[1], share=share, library_ms=None,
                library="none")


def check_track_kernels(device):
    """Phase 3 for K3 (track_res_gs) and K4 (lm_update_step and
    lm_update_accept_step) at the main path's shapes of both presets, one
    lane (no lane index) and LANES, on kernel_timing.track_scene's inputs
    with points out of bounds, saturated points, a point at depth 0 and
    an image patch of inf; device, wrapper and plain times, bound and
    share at the ladder's and level 0's shapes with one lane and at the
    ladder's with LANES. Returns per-kernel records (max_abs_err,
    max_rel_err, and the ladder's times at the default preset with one
    lane, the rest beside them)."""
    import torch

    from sdv_loam_tpu_torch.eval import kernel_timing as kt
    from sdv_loam_tpu_torch.ops import hopper_kernels as hk
    from sdv_loam_tpu_torch.utils import device_loop as dl
    from sdv_loam_tpu_torch.utils import se3

    rec = {"track_res_gs": dict(max_abs_err=0.0, max_rel_err=0.0),
           "track_lm_update": dict(max_abs_err=0.0, max_rel_err=0.0)}
    S = torch.tensor(hk.STEP_SCALE, device=device)

    def note(name, what, ok, err_abs, err_rel):
        r = rec[name]
        r["max_abs_err"] = max(r["max_abs_err"], err_abs)
        r["max_rel_err"] = max(r["max_rel_err"], err_rel)
        print(f"{name} {what}: within tolerance={ok} max_abs_err={err_abs} "
              f"max_rel_err={err_rel}", flush=True)
        if not ok:
            _fail(f"{name} differs from its plain version at {what}")

    for preset, shapes in kt.TRACK_SHAPES.items():
        for i, (h, w, n, rows) in enumerate(shapes):
            for lanes in (1, LANES):
                sc = kt.track_scene(100 + i, h, w, n, lanes, rows,
                                    poison=True)
                x = kt.track_inputs(sc, device)
                single = lanes == 1
                pool = {k: v[0] for k, v in x["pool"].items()} if single \
                    else x["pool"]
                args = (pool, x["dI"][0] if single else x["dI"],
                        x["K"][0] if single else x["K"], x["T"],
                        x["aff_rel"], x["ref_b"], x["cutoff"], HUBER)
                kw = dict(packed=x["packed"], lane=None if single
                          else x["lane"])
                what = f"{preset} {(h, w)} n={n} rows={rows} lanes={lanes}"
                got = hk.track_res_gs(*args, **kw)
                ref = hk.calc_res_gs_plain(*args, **kw)
                torch.cuda.synchronize()
                note("track_res_gs", what, *_res_errors(got, ref))
                if not single and i == 0:
                    # a row alone: the bits it has among the others
                    for b in (0, x["T"].shape[0] - 1):
                        sl = slice(b, b + 1)
                        one = hk.track_res_gs(
                            pool, x["dI"], x["K"], x["T"][sl],
                            x["aff_rel"][sl], x["ref_b"][sl],
                            x["cutoff"][sl], HUBER, packed=x["packed"],
                            lane=x["lane"][sl])
                        same = all(dl.same_bits(one[k][0], got[k][b])
                                   for k in one)
                        print(f"track_res_gs {what}: row {b} alone bit for "
                              f"bit as among the rows: {same}", flush=True)
                        if not same:
                            _fail(f"track_res_gs: row {b} alone differs "
                                  f"from the row among others at {what}")

                # K4 on the plain version's systems
                B = x["T"].shape[0]
                rng = np.random.default_rng(200 + i)

                def t(v, dtype=torch.float32):
                    return torch.as_tensor(np.asarray(v), dtype=dtype,
                                           device=device)
                lam = t(np.array([1e-4, 0.01, 0.3, 1.0])[np.arange(B) % 4])
                aff = t(rng.normal(0, [0.02, 1.0], (B, 2)))
                ex = t(rng.uniform(0.8, 1.2, (B, 2) if lanes > 1 else (2,)))
                ra = t(rng.normal(0, [0.05, 2.0], (B, 2) if lanes > 1
                                  else (2,)))
                done = t(rng.random(B) < 0.3, torch.bool)
                n_it = t(rng.integers(0, 5, B), torch.int64)
                step_in = (ref["H"], ref["b"], lam, x["T"], aff, ex, ra)

                def step_check(step, plain_inc, T, aff):
                    """(step within SOLVE_REL, its largest error, relative
                    error, the pose and affine update's deviation)."""
                    T_new, aff_new, aff_rel, inc = step
                    d_inc = (inc - plain_inc).abs().amax(-1)
                    norm = torch.linalg.vector_norm(plain_inc, dim=-1)
                    upd = max(_rel_dev(a, b) for a, b in (
                        (T_new, se3.se3_exp((inc * S)[:, :6]) @ T),
                        (aff_new, aff + (inc * S)[:, 6:]),
                        (aff_rel, hk.aff_transfer(ex[..., 0], ex[..., 1],
                                                  ra, aff_new))))
                    return (bool((d_inc <= SOLVE_REL * norm + 1e-30).all()),
                            float(d_inc.max()),
                            float((d_inc / norm.clamp(min=1e-30)).max()),
                            upd)
                step = hk.lm_update_step(*step_in)
                ok_s, err_s, rel_s, upd_s = step_check(
                    step, hk.lm_update_step_plain(*step_in)[3], x["T"], aff)
                T_new, aff_new, aff_rel, inc = step
                r_new = hk.calc_res_gs_plain(args[0], args[1], args[2],
                                             T_new, aff_rel, x["ref_b"],
                                             x["cutoff"], HUBER, **kw)
                acc_in = (ref, r_new, x["T"], T_new, aff, aff_new, lam,
                          done, n_it, inc, ex, ra)
                ok_k, ok_p = (hk.lm_update_accept_step(*acc_in),
                              hk.lm_update_accept_step_plain(*acc_in))
                torch.cuda.synchronize()
                same = all(dl.same_bits(ok_k[k], ok_p[k]) for k in
                           ("T", "aff", "lam", "done", "n_it", "active")) \
                    and all(dl.same_bits(ok_k["r"][k], ok_p["r"][k])
                            for k in ok_k["r"])
                ok_n, err_n, rel_n, upd_n = step_check(
                    tuple(ok_k[k] for k in ("T_new", "aff_new", "aff_rel",
                                            "inc")),
                    ok_p["inc"], ok_p["T"], ok_p["aff"])
                upd = max(upd_s, upd_n)
                print(f"track_lm_update {what}: step update {upd} (of "
                      f"max(1, |value|)), accept-step: accept and carries "
                      f"bit for bit {same}, next step within SOLVE_REL "
                      f"{ok_n}", flush=True)
                note("track_lm_update", what, ok_s and ok_n and
                     upd <= UPDATE_TOL and same, max(err_s, err_n),
                     max(rel_s, rel_n))
                if i == 2 or (not single and i != 0):
                    continue

                # times at the ladder's and level 0's shapes with one lane,
                # and at the ladder's with LANES (the batched lockstep's
                # rows)
                def k3():
                    return hk.track_res_gs(*args, **kw)

                def p3():
                    return hk.calc_res_gs_plain(*args, **kw)

                # K4 per LM iteration: one accept-step launch
                def k4():
                    return hk.lm_update_accept_step(*acc_in)

                def p4():
                    return hk.lm_update_accept_step_plain(*acc_in)
                where = f"{preset} {(h, w)} n={n} rows={B} lanes={lanes}"
                t3 = kernel_times("track_res_gs", k3, p3,
                                  kt.track_res_gs_bound(lanes, B, n), where)
                t4 = kernel_times("track_lm_update", k4, p4,
                                  kt.lm_update_bound(B), where)
                # and the step entry, once per LM call
                t4["step_entry"] = kernel_times(
                    "track_lm_update (step entry)",
                    lambda: hk.lm_update_step(*step_in),
                    lambda: hk.lm_update_step_plain(*step_in),
                    kt.lm_update_bound(B, "step"), where)
                for name, tt in (("track_res_gs", t3),
                                 ("track_lm_update", t4)):
                    tt["shape"] = [h, w, n, B]
                    if preset == "default" and i == 0 and single:
                        rec[name].update(tt)
                    else:
                        rec[name][f"{preset}_{('ladder', 'level0')[i]}"
                                  f"{'' if single else f'_lanes{lanes}'}"] \
                            = tt
    return rec


def check_align_kernels(device):
    """Phase 3 for the fused K5 / K6 kernel (csrc/align_batch.cu) at every
    main-path shape of both presets (kernel_timing.ALIGN_SHAPES: the track
    step's matcher and the keyframe's two passes), one lane and
    kernel_timing.ALIGN_LANES, in each of its modes:
      * the matcher's call (`warp_align`, K6's patch warp then K5's
        alignment in one launch) on warp_align_scene's poisoned inputs:
        converged flags agree with the plain loop's on the kernel's own
        patches (the patches-only mode's, held to their plain version's
        zero and NaN pattern and within PATCH_TOL) on at least
        ALIGN_FLAG_SHARE of the rows but one, px within ALIGN_PX_TOL where
        both converge (within ALIGN_STEP_TOL on rows that count in the
        flags' budget), per-lane failure counts apart by at most the rows
        whose flags differ; there and with kernel_timing.edge_cases'
        rows (rows that walk far from their start, at a level's edge, on
        a level the pack cuts short) bit for bit (NaN payloads aside) its
        CPU emulation (tests/k5_align.py);
      * K5 alone (`align_batch`, given patches) on align_scene's poisoned
        inputs, under the same tolerances against `align_batch_plain` and
        bit for bit its emulation;
      * K6 alone (`warp_affine_patches`, the patches written) on
        warp_scene's poisoned inputs: the plain version's zero and NaN
        pattern, values within PATCH_TOL, bit for bit its emulation.
    The rows and values that differ printed apart. Device, wrapper and
    plain times, bound and share of the fused call (on warp_align_scene's
    inputs without the edge cases), at every shape with one lane and at
    pass 1 of the default preset with ALIGN_LANES; K5's and K6's alone at
    that pass with one lane. The plain loop's
    graphs live in a LoopCache of this phase's own, freed when it ends.
    Returns per-kernel records: "align_batch" the fused kernel's (its
    errors over every check, the default preset's pass 1 with one lane
    timed, the rest beside it, K5 alone under "alone"), "warp_patches"
    K6 alone's."""
    from sdv_loam_tpu_torch.utils import device_loop as dl

    with dl.use(dl.LoopCache()):
        return _check_align_kernels(device)


def _hold_align(what, got, ref, emu, lanes, late=False):
    """Flags, px and failure counts of a K5 launch against its plain
    version's (tolerances; none when `ref` is None; with `late`, rows
    whose px differ by more than ALIGN_PX_TOL but at most ALIGN_STEP_TOL
    count in the flags' budget) and emulation's (bits); printed. Returns
    (ok, flags that differ, px error, outputs that differ from the
    emulation)."""
    import torch

    import k5_align
    torch.cuda.synchronize()
    if ref is None:
        emu_diff = (k5_align.bits_differ(got[0], emu[0])
                    + int((got[1].cpu() != emu[1]).sum())
                    + int((got[2].cpu() != emu[2].reshape(lanes, -1, 2)
                           .sum(1)).sum()))
        print(f"{what}: {emu_diff} outputs differ from the emulation "
              f"({int(got[1].sum())} of {got[1].numel()} rows converged)",
              flush=True)
        return emu_diff == 0, 0, 0.0, emu_diff
    agree = got[1] == ref[1]
    both = got[1] & ref[1]
    d = (got[0] - ref[0]).abs().amax(-1)
    err = float(d[both].max())
    n_diff = int((~agree).sum())
    n_late = int((both & (d > ALIGN_PX_TOL)).sum()) if late else 0
    emu_diff = (k5_align.bits_differ(got[0], emu[0])
                + int((got[1].cpu() != emu[1]).sum())
                + int((got[2].cpu() != emu[2].reshape(lanes, -1, 2)
                       .sum(1)).sum()))
    fail_diff = int((got[2] - ref[2]).abs().sum())
    ok = (n_diff + n_late <= 1 + (1 - ALIGN_FLAG_SHARE) * agree.numel()
          and err <= (ALIGN_STEP_TOL if late else ALIGN_PX_TOL)
          and fail_diff <= n_diff and emu_diff == 0)
    print(f"{what}: {n_diff} of {agree.numel()} converged flags differ "
          f"({int(ref[1].sum())} converged), px largest difference {err} px "
          f"over {int(both.sum())} rows ({n_late} beyond {ALIGN_PX_TOL}), "
          f"failure counts {got[2].tolist()} "
          f"against {ref[2].tolist()}; {emu_diff} outputs differ from the "
          f"emulation; within tolerance={ok}", flush=True)
    return ok, n_diff, err, emu_diff


def _check_align_kernels(device):
    import torch

    from sdv_loam_tpu_torch.eval import kernel_timing as kt
    from sdv_loam_tpu_torch.ops import hopper_kernels as hk
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import k5_align

    rec = {"align_batch": dict(max_abs_err=0.0, flags_differ=0, rows=0,
                               emulation_differ=0,
                               alone=dict(max_abs_err=0.0, flags_differ=0,
                                          rows=0, emulation_differ=0)),
           "warp_patches": dict(max_abs_err=0.0, values_differ=0,
                                values=0, emulation_differ=0,
                                fused_into="align_batch")}

    def tally(r, rows, n_diff, err, emu_diff):
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["flags_differ"] += n_diff
        r["rows"] += rows
        r["emulation_differ"] += emu_diff

    for preset, ((h, w), calls) in kt.ALIGN_SHAPES.items():
        for call, rows in calls.items():
            for lanes in (1, kt.ALIGN_LANES):
                where = f"{preset} {call} ({h}, {w}) rows={rows} " \
                    f"lanes={lanes}"
                # the fused call: against the plain loop on the kernel's
                # own patches (the patches-only mode's: the same device
                # code; the K6 check below holds those to their plain
                # version) and against its emulation, then with the edge
                # cases against its emulation
                for cases in (False, True):
                    fs = kt.warp_align_scene(500 + rows, h, w, rows, lanes,
                                             poison=True)
                    if cases:
                        fs = kt.edge_cases(fs, 500 + rows)
                    fargs, fkw = kt.warp_align_args(fs, device)
                    got = hk.warp_align(*fargs, n_lanes=lanes, **fkw)
                    ref = None
                    if not cases:
                        (fwa, fwk), falign = kt.split_warp_align(fargs, fkw)
                        pg = hk.warp_affine_patches(*fwa, **fwk)
                        pr = hk.warp_affine_patches_plain(*fwa, **fwk)
                        nan_r = torch.isnan(pr)
                        if not (torch.equal(torch.isnan(pg), nan_r)
                                and float((pg - pr).abs()[~nan_r].max())
                                <= PATCH_TOL):
                            _fail(f"warp_align's patches differ from their "
                                  f"plain version at {where}")
                        ref = hk.align_batch_plain(*falign(pg), n_lanes=lanes)
                    cpu = [a.cpu() for a in fargs]
                    emu = k5_align.warp_align(fkw["quad_stack"].cpu(),
                                              *cpu[1:5], h, w, *cpu[5:])
                    what = f"warp_align {where}" + \
                        (" edge cases" if cases else "")
                    ok, n_diff, err, emu_diff = _hold_align(
                        what, got, ref, emu, lanes, late=True)
                    tally(rec["align_batch"],
                          got[1].numel() if not cases else 0, n_diff, err,
                          emu_diff)
                    if not ok:
                        _fail(f"warp_align differs from its plain version or "
                              f"its emulation at {where}")
                # K5 alone, given patches
                sc = kt.align_scene(300 + rows, h, w, rows, lanes,
                                    poison=True)
                args = kt.align_args(sc, device)
                got = hk.align_batch(*args, n_lanes=lanes)
                ref = hk.align_batch_plain(*args, n_lanes=lanes)
                emu = k5_align.align_batch(*(a.cpu() for a in args))
                ok, n_diff, err, emu_diff = _hold_align(
                    f"align_batch {where}", got, ref, emu, lanes)
                tally(rec["align_batch"]["alone"], got[1].numel(), n_diff,
                      err, emu_diff)
                if not ok:
                    _fail(f"align_batch differs from its plain version at "
                          f"{where}")
                # K6 alone, the patches written
                ws = kt.warp_scene(400 + rows, h, w, rows, lanes,
                                   poison=True)
                wargs, kw = kt.warp_args(ws, device)
                pg = hk.warp_affine_patches(*wargs, **kw)
                pr = hk.warp_affine_patches_plain(*wargs, **kw)
                torch.cuda.synchronize()
                nan_r = torch.isnan(pr)
                d = (pg - pr).abs()[~nan_r]
                perr = float(d.max())
                emu_diff = k5_align.bits_differ(pg, k5_align.warp_patches(
                    kw["quad_stack"].cpu(), *(a.cpu() for a in wargs[1:]),
                    h, w))
                r = rec["warp_patches"]
                r["max_abs_err"] = max(r["max_abs_err"], perr)
                r["values_differ"] += int((d > 0).sum())
                r["values"] += d.numel()
                r["emulation_differ"] += emu_diff
                ok = (torch.equal(torch.isnan(pg), nan_r)
                      and torch.equal(pg == 0, pr == 0) and perr <= PATCH_TOL
                      and emu_diff == 0)
                print(f"warp_patches {where}: {int((d > 0).sum())} of "
                      f"{d.numel()} values differ, largest {perr}; "
                      f"{emu_diff} differ from the emulation; zero and NaN "
                      f"pattern equal, within tolerance={ok}", flush=True)
                if not ok:
                    _fail(f"warp_patches differs from its plain version at "
                          f"{where}")
                if lanes != 1 and (preset, call) != ("default", "pass1"):
                    continue
                main = (preset, call, lanes) == ("default", "pass1", 1)
                targs, tkw = kt.warp_align_args(kt.warp_align_scene(
                    500 + rows, h, w, rows, lanes, poison=True), device)
                (twa, twk), talign = kt.split_warp_align(targs, tkw)
                it = kt.align_iterations(talign(
                    hk.warp_affine_patches_plain(*twa, **twk)))
                tt = kernel_times(
                    "warp_align",
                    lambda: hk.warp_align(*targs, n_lanes=lanes, **tkw),
                    lambda: hk.warp_align_plain(*targs, n_lanes=lanes,
                                                **tkw),
                    kt.warp_align_bound(
                        rows * lanes, it["valid_rows"],
                        it["sampled_iterations"], it["quad_rows"],
                        kt.warp_quad_rows(twa, twk["quad_stack"])),
                    where)
                tt.update(shape=[h, w, rows, lanes])
                if main:
                    rec["align_batch"].update(tt)
                else:
                    rec["align_batch"][f"{preset}_{call}"
                                       f"{'' if lanes == 1 else f'_lanes{lanes}'}"
                                       ] = tt
                    continue
                t5 = kernel_times("align_batch",
                           lambda: hk.align_batch(*args, n_lanes=lanes),
                           lambda: hk.align_batch_plain(*args,
                                                        n_lanes=lanes),
                           kt.align_batch_bound(rows * lanes, *(
                               kt.align_iterations(args)[k] for k in (
                                   "valid_rows", "sampled_iterations",
                                   "quad_rows"))),
                           where)
                k6_rows = kt.warp_quad_rows(wargs, kw["quad_stack"])
                t6 = kernel_times("warp_patches",
                           lambda: hk.warp_affine_patches(*wargs, **kw),
                           lambda: hk.warp_affine_patches_plain(*wargs,
                                                                **kw),
                           kt.warp_patches_bound(rows * lanes, k6_rows),
                           where)
                rec["align_batch"]["alone"].update(t5, shape=[h, w, rows,
                                                              lanes])
                rec["warp_patches"].update(t6, shape=[h, w, rows, lanes])
    return rec


def check_ba_kernels(device):
    """Phase 3 for K7 (ba_linearize) and K8 (ba_accumulate) at the main
    path's BA shapes of both presets (kernel_timing.BA_SHAPES) with one
    lane and eight (kernel_timing.BA_LANES), on kernel_timing.ba_scene's
    window, against their plain versions on the card: K7's states equal
    away from the thresholds and its floats within
    kernel_timing.BA_LIN_REL of their output's scale
    (`kernel_timing.ba_lin_gaps`), K8's sums within
    kernel_timing.BA_ACC_REL of their terms' magnitudes
    (build_system_lanes' accumulation); then their times
    (kernel_timing.time_ba). (Each kernel against its CPU emulation, bit
    for bit: tests/test_torch_ba_kernels.py on the card.) Returns
    per-kernel records."""
    from sdv_loam_tpu_torch.eval import kernel_timing as kt
    from sdv_loam_tpu_torch.models import backend

    rec = {"ba_linearize": dict(max_rel_err=0.0, states_near=0),
           "ba_accumulate": dict(max_rel_err=0.0)}
    for preset, (n, f, w, h) in kt.BA_SHAPES.items():
        for lanes in kt.BA_LANES:
            what = f"{preset} N={n} F={f} lanes={lanes}"
            x = kt.ba_scene(400 + lanes, lanes, n, f, w, h, device)
            args = kt.ba_lin_args(x, f)
            kw = dict(w=w, h=h, gate=x["gate"])
            got = backend.linearize_residuals_lanes(*args, **kw)
            plain = backend.linearize_residuals_lanes_plain(*args, **kw)
            gc = {k: v.cpu() for k, v in got.items()}
            near = kt.ba_lin_near(gc, x, w, h)
            bad, worst, _ = kt.ba_lin_gaps(gc, {k: v.cpu() for k, v in
                                                plain.items()}, near)
            n_diff = int((gc["new_state"] != plain["new_state"].cpu()).sum())
            print(f"ba_linearize {what}: states differing from the plain "
                  f"version {n_diff} (near a threshold {int(near.sum())}, "
                  f"away from one {bad}), worst float gap {worst:.3g} of "
                  f"its output's scale", flush=True)
            r = rec["ba_linearize"]
            r["max_rel_err"] = max(r["max_rel_err"], worst)
            r["states_near"] = max(r["states_near"], n_diff)
            if bad or worst > kt.BA_LIN_REL:
                _fail(f"ba_linearize differs at {what}")

            acc = kt.ba_acc_args(got, x, f)
            out = backend._accumulate(*acc)
            ref = backend._accumulate_plain(*acc)
            worst = kt.ba_acc_gap(out, ref, kt.ba_acc_magnitudes(acc, f))
            print(f"ba_accumulate {what}: worst gap from the plain version "
                  f"{worst:.3g} of the terms' magnitudes", flush=True)
            r = rec["ba_accumulate"]
            r["max_rel_err"] = max(r["max_rel_err"], worst)
            if worst > kt.BA_ACC_REL:
                _fail(f"ba_accumulate differs at {what}")
    for row in kt.time_ba(device):
        name = row.pop("name")
        key = f"{row['preset']}_lanes{row['lanes']}"
        rec[name][key] = dict(row, library_ms=None, library="none")
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


def count_builds():
    """Count, from now on, the keyframe programs and the build_track_ref
    calls outside them on the main path (one K1 launch each): returns the
    one-element list that holds the count."""
    from sdv_loam_tpu_torch.system import full_system, kf_ops

    n_build = [0]
    for mod, name in ((full_system, "build_track_ref"),
                      (kf_ops, "kf_opt_step_lanes")):
        orig = getattr(mod, name)

        def counted(*a, _orig=orig, **k):
            n_build[0] += 1
            return _orig(*a, **k)
        setattr(mod, name, counted)
    return n_build


# K3-K8's kernel entries (a substring of each mangled name); K5 and K6
# are one kernel, K8 three
KERNEL_ENTRIES = {"track_res_gs": ("track_res_gs_kernel",),
                  "track_lm_update": ("lm_step_kernel",
                                      "lm_accept_step_kernel"),
                  "align_batch": ("warp_align_kernel",),
                  "warp_patches": ("warp_align_kernel",),
                  "ba_linearize": ("ba_linearize_kernel",),
                  "ba_accumulate": ("ba_acc_tiles_kernel",
                                    "ba_acc_sum_kernel",
                                    "ba_acc_stitch_kernel")}
# the fused K5 / K6 kernel's registers a thread (K5 alone used 80)
ALIGN_MAX_REGISTERS = 80


def kernel_usage(usage):
    """Phase 2: the ptxas report (registers, spills, shared memory) of
    each K3-K8 kernel entry, printed; fails when one spills or is missing
    from the report, or when the fused K5 / K6 kernel takes more than
    ALIGN_MAX_REGISTERS registers."""
    out = {}
    for name, entries in KERNEL_ENTRIES.items():
        out[name] = {}
        for entry in entries:
            found = [v for k, v in usage.items() if entry in k]
            if len(found) != 1 or "registers" not in found[0]:
                _fail(f"ptxas reported no usage for {entry}")
            out[name][entry] = found[0]
            print(f"ptxas {name} ({entry}): {json.dumps(found[0])}",
                  flush=True)
            if found[0].get("spill_stores", 1) or \
                    found[0].get("spill_loads", 1):
                _fail(f"{entry} spills registers")
            if entry == "warp_align_kernel" and \
                    found[0]["registers"] > ALIGN_MAX_REGISTERS:
                _fail(f"{entry} takes {found[0]['registers']} registers")
    return out


def _track_launches(what, launched):
    """K3-K6's device counts of a main-path run (`device_launches`): K3,
    both of K4's entry points and the fused K5 / K6 kernel launched, K4's
    accept-step (one per LM iteration) at least as often as its step (one
    per LM call), every K5 and K6 launch a fused one (no standalone
    patch warp or alignment on the main path), and the kernel that zeroes
    the fused kernel's failure counts launched once per fused launch."""
    if not (launched["track_res_gs"] > 0 and launched["lm_step"] > 0
            and launched["lm_accept_step"] >= launched["lm_step"]
            and launched["warp_align"] > 0
            and launched["align_batch"] == launched["warp_align"]
            and launched["warp_patches"] == launched["warp_align"]
            and launched["align_zero"] == launched["warp_align"]):
        _fail(f"{what}: K3, K4 or the fused K5 / K6 not launched, K4's "
              f"accept-step less often than its step, a K5 or K6 launch "
              f"not fused, or zeroing launches not one per fused launch "
              f"({launched})")


# the matcher's kernel wrapper, as models/matcher calls it: the fused K5 /
# K6 call
MATCHER_KERNELS = {"warp_align": "warp_align"}


def match_diags(systems):
    """Each system's last keyframe optimization's matcher diagnostics
    (`last_match_diag`: pass 1's in-bounds, candidate and matched counts
    and the fused kernel's two failure counts; `last_match_diag_p2`, pass
    2's summed over its targets) as int lists, None before a keyframe."""
    return [[None if d is None else np.asarray(d).tolist()
             for d in (getattr(fs, "last_match_diag", None),
                       getattr(fs, "last_match_diag_p2", None))]
            for fs in systems]


def check_track_evaluations(what, launched, drive, main_diags):
    """The main path's K3-K6 launches (`launched`, the device counters of a
    run with stage programs) against the evaluations its loops ran and
    the matcher calls it made: `drive()` runs the same frames again with
    the eager early-exit loops (`device_loop.reference`, the same
    decisions bit for bit; the keyframe program's conds read on the
    host), where device_loop counts every tracking LM call and iteration
    and the cutoff loop's iterations, and the track step's calls and the
    matcher's `warp_align` calls (each of at least 8 rows: one launch)
    are counted on the host. Per track step K3 runs once per LM call (its
    first evaluation), once per LM and cutoff iteration and once for the
    struct-pose veto; K4's step once per LM call and its accept-step once
    per LM iteration; the fused K5 / K6 kernel once per matcher call (so
    K5's and K6's counts are that too), and the kernel zeroing its
    failure counts once per matcher call; K7 once per BA linearization
    and K8 once per BA system build or point marginalization (each
    counted on the host where the eager run calls its wrapper). Both
    runs' counters must equal that. `drive()` returns its systems, whose
    last keyframe's matcher diagnostics (`match_diags`: the failure counts the fused kernel adds
    up after its zeroing kernel, in the main run from a replay of the
    keyframe program, pass 2's inside its IF nodes) must equal the main
    run's `main_diags` bit for bit."""
    from sdv_loam_tpu_torch.models import matcher
    from sdv_loam_tpu_torch.ops import frame_step
    from sdv_loam_tpu_torch.ops import hopper_kernels as hk
    from sdv_loam_tpu_torch.utils import device_loop as dl

    _track_launches(what, launched)
    calls = dict(track=0, warp_align=0, ba_linearize=0, ba_accumulate=0)
    patched = {(frame_step, "_track_program"): "track",
               **{(matcher, fn): k for k, fn in MATCHER_KERNELS.items()},
               (hk, "ba_linearize"): "ba_linearize",
               (hk, "ba_accumulate"): "ba_accumulate"}
    orig = {key: getattr(*key) for key in patched}

    def counted(key):
        def fn(*a, **k):
            calls[patched[key]] += 1
            return orig[key](*a, **k)
        return fn
    hk.reset_launch_counts()
    dl.reset_counts()
    for key in patched:
        setattr(*key, counted(key))
    try:
        with dl.reference():
            eager_diags = match_diags(drive())
    finally:
        for key, fn in orig.items():
            setattr(*key, fn)
    ref = hk.device_launches()
    c = dl.counts()
    lm, cut = c.get("lm", {}), c.get("cutoff", {})
    want = {"track_res_gs": lm.get("calls", 0) + lm.get("iters", 0)
            + cut.get("iters", 0) + calls["track"],
            "track_lm_update": lm.get("calls", 0) + lm.get("iters", 0),
            "lm_step": lm.get("calls", 0),
            "lm_accept_step": lm.get("iters", 0),
            "align_batch": calls["warp_align"],
            "warp_patches": calls["warp_align"],
            "warp_align": calls["warp_align"],
            "align_zero": calls["warp_align"],
            "ba_linearize": calls["ba_linearize"],
            "ba_accumulate": calls["ba_accumulate"]}
    rec = dict(main_path={k: launched[k] for k in want},
               eager_run={k: ref[k] for k in want}, evaluations=want,
               lm_calls=lm.get("calls", 0), lm_iters=lm.get("iters", 0),
               cutoff_iters=cut.get("iters", 0), track_steps=calls["track"],
               matcher_calls=calls["warp_align"],
               ba_linearizations=calls["ba_linearize"],
               ba_accumulations=calls["ba_accumulate"],
               align_loops=c.get("align", {}).get("calls", 0),
               match_diags=dict(main_path=main_diags, eager_run=eager_diags))
    print(f"K3-K8 launches against the loops' evaluations, the matcher "
          f"calls and the BA's linearizations and accumulations, {what}: "
          + json.dumps(rec), flush=True)
    if not rec["main_path"] == rec["eager_run"] == want:
        _fail(f"{what}: K3-K8 launches differ from the evaluations the "
              "loops ran, the matcher calls or the BA's linearizations and "
              "accumulations")
    if rec["align_loops"]:
        _fail(f"{what}: an \"align\" loop ran on the card")
    if main_diags != eager_diags or any(None in d for d in main_diags):
        _fail(f"{what}: the last keyframe's matcher diagnostics differ "
              f"between the programs and the eager run, or are missing "
              f"({main_diags} against {eager_diags})")
    return rec


def program_keys(caches, stages=KEYED_PROGRAMS):
    """Per stage of `stages`: its captures, capture and instantiate
    seconds, graph pool growth (MiB), graph nodes, replays and warm-ups
    since the counts' last reset, and the
    keys the graph caches `caches` hold for it, one per program (its
    largest input's shape and the statics of KEY_STATICS; two programs
    that print alike differ in another input's layout)."""
    from sdv_loam_tpu_torch.utils import device_loop as dl

    def largest(layout):
        return max((lay[0] for lay in layout if lay[0] != "const"),
                   key=lambda shape: int(np.prod(shape)))

    c = dl.counts()
    out = {}
    for stage in stages:
        k = c.get(stage, {})
        keys = sorted(str((list(largest(key[4])),
                           {n: v for n, v in key[6] if n in KEY_STATICS}))
                      for cache in caches
                      for key in getattr(cache, "entries", ())
                      if key[0] == "program" and key[1] == stage)
        out[stage] = dict(captures=k.get("captures", 0),
                          capture_s=k.get("capture_s", 0.0),
                          instantiate_s=k.get("instantiate_s", 0.0),
                          pool_mib=k.get("pool_mib", 0.0),
                          graph_nodes=k.get("ops", 0),
                          replays=k.get("replays", 0),
                          warmups=k.get("warmups", 0), keys=keys)
    return out


def loop_counts(n_frames, caches=()):
    """The loop driver's counts since its last reset: per stage, and per
    frame (graph replays, flag reads, captures), capture seconds, graphs
    held; the stage programs' replays per frame, captures, capture and
    instantiate seconds, graph pool growth (MiB) and recorded ops; the
    captures and keys of KEYED_PROGRAMS."""
    from sdv_loam_tpu_torch.utils import device_loop as dl

    keyed = program_keys(caches)
    c = dl.counts()
    a = c.pop("all", {})
    p = c.pop("programs", {})
    return dict(keyed_programs=keyed,
                replays_per_frame=a.get("replays", 0) / n_frames,
                reads_per_frame=a.get("reads", 0) / n_frames,
                captures=a.get("captures", 0),
                capture_s=a.get("capture_s", 0.0),
                graphs=sum(len(x) for x in caches),
                program_replays_per_frame=p.get("replays", 0) / n_frames,
                program_captures=p.get("captures", 0),
                program_capture_s=p.get("capture_s", 0.0),
                program_instantiate_s=p.get("instantiate_s", 0.0),
                program_pool_mib=p.get("pool_mib", 0.0),
                program_ops=p.get("ops", 0),
                per_stage={k: {kk: v.get(kk, 0) for kk in
                               ("calls", "replays", "reads", "captures")}
                           for k, v in sorted(c.items())})


def kf_program(what, caches, n_systems=1, strict=True):
    """The keyframe program's counts since `device_loop.reset_counts()`
    (captures, capture and instantiate seconds, recorded graph nodes,
    graph pool MiB, replays) of `n_systems` systems, and over their graph
    caches `caches` (a lockstep fleet's own among them): the (lanes,
    p2_cap) of each program they hold; fails where a cache
    holds two programs of one (lanes, p2_cap) (a key that moved with the
    inputs' strides) and, with `strict`, where one of its loops or conds
    read a flag on the host (the process's first call of the program, its
    eager warm-up, reads them)."""
    from sdv_loam_tpu_torch.utils import device_loop as dl

    c = dl.counts()
    k = c.get("kf_opt", {})
    keys = [[(int(key[4][0][0][0]), dict(key[6])["p2_cap"])
             for key in cache.entries
             if key[0] == "program" and key[1] == "kf_opt"]
            for cache in caches]
    rec = dict(systems=n_systems, keys=keys, captures=k.get("captures", 0),
               captures_per_system=k.get("captures", 0) / n_systems,
               capture_s=k.get("capture_s", 0.0),
               instantiate_s=k.get("instantiate_s", 0.0),
               graph_nodes=k.get("ops", 0), pool_mib=k.get("pool_mib", 0.0),
               replays=k.get("replays", 0), calls=k.get("calls", 0),
               warmups=k.get("warmups", 0),
               reads={s: c.get(s, {}).get("reads", 0)
                      for s in KF_PROGRAM_PARTS})
    print(f"kf_opt program, {what}: " + json.dumps(rec), flush=True)
    if any(len(set(ks)) < len(ks) for ks in keys):
        _fail(f"{what}: two keyframe programs of one (lanes, p2_cap) in a "
              f"system's cache: {keys}")
    if strict and any(rec["reads"].values()):
        _fail(f"{what}: the keyframe program's parts read flags on the "
              f"host: {rec['reads']}")
    if not rec["calls"]:
        _fail(f"{what}: no keyframe program ran")
    return rec


def keep_records(log, frame, keep, have_ba, lanes=1):
    """Of one frame's (round's) recorded loops, keep those of the compared
    frame and of the first keyframe optimization with at least `lanes`
    lanes; returns whether that optimization is now kept."""
    if frame == COMPARE_FRAME:
        keep.extend(log)
    ba = [r for r in log if r["stage"] == "ba0"
          and r["st"]["eps"].shape[0] >= lanes]
    if ba and not have_ba:
        ids = {id(r) for r in keep}
        keep.extend(r for r in log if id(r) not in ids)
        return True
    return have_ba


def _lanes(rec):
    """A recorded program's lanes: the track program's inputs hold a list
    of lanes, the bootstrap's programs take one image, the others lead
    with their lane dimension."""
    import torch
    from torch.utils._pytree import tree_unflatten

    if rec["stage"] == "track":
        return len(tree_unflatten(rec["leaves"], rec["spec"])["lanes"])
    if rec["stage"] in ("mono_lm", "select_map"):
        return 1
    return next(v for v in rec["leaves"]
                if isinstance(v, torch.Tensor)).shape[0]


def compare_programs(records, what, need=PROGRAM_STAGES):
    """Each recorded stage program replayed on the card (captured in a
    fresh cache at its key's first record) against the stage form on the
    same inputs: bit for bit, or the run fails. Returns, per stage, the
    programs compared and their lane counts."""
    import torch

    from sdv_loam_tpu_torch.utils import device_loop as dl

    from sdv_loam_tpu_torch.ops import hopper_kernels as hk

    stages = {}
    with dl.use(dl.LoopCache()):
        for rec in records:
            res = dl.compare_program(rec)
            if not (res["equal"] and res["replayed"]):
                _fail(f"{what}: the {res['stage']} program differs from its "
                      f"stage form in outputs {res['differ']} (replayed "
                      f"{res['replayed']})")
            if rec["stage"] == "kf_opt":
                # one more replay: it counts one K1 launch of all its lanes
                n0, l0 = (hk.LAUNCHES["dilate_pyramid"],
                          hk.LANES["dilate_pyramid"])
                leaves = [v.clone() if isinstance(v, torch.Tensor) else v
                          for v in rec["leaves"]]
                dev = next(v.device for v in leaves
                           if isinstance(v, torch.Tensor))
                _, replayed = dl._graph_program(rec["stage"], rec["fn"],
                                                leaves, rec["spec"],
                                                rec["static"], dev)
                k1 = (hk.LAUNCHES["dilate_pyramid"] - n0,
                      hk.LANES["dilate_pyramid"] - l0)
                if not (replayed and k1 == (1, leaves[0].shape[0])):
                    _fail(f"{what}: a kf_opt replay counted {k1} K1 "
                          "(launches, lanes)")
            lanes = _lanes(rec)
            st = stages.setdefault(rec["stage"], dict(programs=0, lanes=set()))
            st["programs"] += 1
            st["lanes"].add(int(lanes))
            if rec["stage"] == "kf_opt":
                st["k1_launches_per_replay"] = 1
    stages = {k: dict(v, lanes=sorted(v["lanes"])) for k, v in
              stages.items()}
    print(f"program against stage form, {what}: every output bit for bit "
          f"equal; per stage {json.dumps(stages)}", flush=True)
    missing = set(need) - set(stages)
    if missing:
        _fail(f"{what}: no {sorted(missing)} program recorded")
    return stages


def compare_stages(records, what, need=("lm", "struct", "ba0", "sweep")):
    """Each recorded loop through graph replays and through the eager
    early-exit loop on the card: bit for bit, or the run fails. The
    graphs of one kind are captured on its first record and replayed on
    the others. The alignment is one K5 launch on the card: a recorded
    "align" loop fails the run."""
    from sdv_loam_tpu_torch.utils import device_loop as dl

    if any(rec["stage"] == "align" for rec in records):
        _fail(f"{what}: an \"align\" loop ran on the card")
    out = []
    with dl.use(dl.LoopCache()):
        for rec in records:
            res = dl.compare(rec)
            res.update(rows=int(next(iter(rec["st"].values())).shape[0]),
                       max_iters=rec["max_iters"])
            out.append(res)
            if not res["equal"]:
                _fail(f"{what}: the {res['stage']} loop's graph replays "
                      f"differ from its eager loop in {res['differ']}")
    stages = {}
    for r in out:
        st = stages.setdefault(r["stage"], dict(loops=0, chunk=set(),
                                                rows=set(), replays=0,
                                                reads=0))
        st["loops"] += 1
        st["chunk"].add(r["chunk"])
        st["rows"].add(r["rows"])
        st["replays"] += r["replays"]
        st["reads"] += r["reads"]
    stages = {k: dict(v, rows=sorted(v["rows"]), chunk=sorted(v["chunk"]))
              for k, v in stages.items()}
    print(f"graph against eager, {what}: {len(out)} loops, every output "
          f"bit for bit equal; per stage {json.dumps(stages)}", flush=True)
    missing = set(need) - set(stages)
    if missing:
        _fail(f"{what}: no {sorted(missing)} loop recorded")
    return stages


def recorded(part, now):
    """This run's numbers beside what `RECORDED` holds for `part`."""
    was = RECORDED[part]
    rows = {}
    for k, v in was.items():
        x = now.get(k)
        if isinstance(v, float):
            d = len(repr(v).split(".")[1])
            held = x is not None and f"{x:.{d}f}" == f"{v:.{d}f}"
        else:
            held = x == v
        rows[k] = dict(recorded=v, now=x, held=held)
    print(f"recorded results, {part}: {json.dumps(rows)}", flush=True)
    return rows


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
    from sdv_loam_tpu_torch.system.full_system import FullSystem
    from sdv_loam_tpu_torch.system.runner import run_sequence
    from sdv_loam_tpu_torch.utils import device_loop as dl

    n_frames = 30
    t0 = time.perf_counter()
    seq = make_sequence(n_frames=n_frames, **SCENE, **FLEET_SCENES["A"])
    scene = Rendered(seq, render(seq, n_frames))
    print(f"slice scene rendered in {time.perf_counter() - t0:.1f} s",
          flush=True)

    n_build = count_builds()

    torch.cuda.reset_peak_memory_stats()
    hk.reset_launch_counts()
    dl.reset_counts()
    t0 = time.perf_counter()
    fs, summary = run_sequence(scene, Settings(), device=device,
                               prefetch=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = hk.launch_counts()
    track_launched = hk.device_launches()
    n_build_main = n_build[0]
    loops = loop_counts(n_frames, [fs.loops])
    kf_prog = kf_program("slice (one system)", [fs.loops], strict=False)
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
                   launches=launches, build_track_ref_calls=n_build_main,
                   n_keyframes=len(fs.kf_shells), lost=bool(fs.is_lost),
                   loops=loops, kf_program=kf_prog)

    # the same frames in the stage form (the stages called directly, loops
    # as chunk replays, host reads): the same LM decisions (per level
    # iterations of every track step, per keyframe BA iterations),
    # keyframes and trajectory, bit for bit; the loops of the compared
    # frame and of the first keyframe optimization are recorded for the
    # per-loop check, the stage programs of PROGRAM_FRAMES for the
    # per-program check
    ref = FullSystem(seq.calib, seq.sensor, Settings(), device=device)
    records, programs, have_ba, frame_s = [], [], False, []
    t0 = time.perf_counter()
    with dl.stage_form():
        for i, fr in enumerate(scene.frames):
            log = []
            if i == PROFILE_FRAMES[0]:
                stage0 = dict(ref.telemetry.stage_time)
            t1 = time.perf_counter()
            with contextlib.ExitStack() as stack:
                if i == COMPARE_FRAME or not have_ba:
                    stack.enter_context(dl.recording(log))
                if i in PROGRAM_FRAMES:
                    stack.enter_context(dl.recording(programs,
                                                     programs=True))
                ref.add_active_frame(*fr)
            frame_s.append(time.perf_counter() - t1)
            have_ba = keep_records(log, i, records, have_ba)
    est_ref = ref.get_trajectory()
    torch.cuda.synchronize()
    staged = dict(wall_s=time.perf_counter() - t0,
                 steady_fps=_steady_fps(frame_s),
                 steady_stage_ms_per_frame=_steady_stage_ms(ref, stage0,
                                                            n_frames),
                 n_keyframes=len(ref.kf_shells),
                 track_iters_equal=_same_iters(fs.track_iters_hist,
                                               ref.track_iters_hist),
                 ba_lm_iters=[fs.telemetry.counters["ba_lm_iters"],
                              ref.telemetry.counters["ba_lm_iters"]],
                 trajectory_equal=bool(np.array_equal(est, est_ref)),
                 trajectory_max_abs=float(np.abs(est - est_ref).max()))
    staged["fps"] = n_frames / staged["wall_s"]
    summary["stage_form"] = staged
    print("slice, stage form against programs: " + json.dumps(staged),
          flush=True)
    if not (staged["track_iters_equal"] and staged["n_keyframes"]
            == summary["n_keyframes"] and staged["ba_lm_iters"][0]
            == staged["ba_lm_iters"][1] and staged["trajectory_equal"]):
        _fail("slice: the programs and the stage form took other decisions")
    summary["program_check"] = compare_programs(programs,
                                                "slice (one lane)")
    # the programs again, each frame timed as the stage form's were (a
    # fresh system: its captures included)
    again = FullSystem(seq.calib, seq.sensor, Settings(), device=device)
    dl.reset_counts()
    frame_s = []
    for i, fr in enumerate(scene.frames):
        if i == PROFILE_FRAMES[0]:
            stage0 = dict(again.telemetry.stage_time)
        t1 = time.perf_counter()
        again.add_active_frame(*fr)
        frame_s.append(time.perf_counter() - t1)
    summary["programs_again"] = dict(
        steady_fps=_steady_fps(frame_s),
        steady_stage_ms_per_frame=_steady_stage_ms(again, stage0, n_frames),
        trajectory_equal=bool(np.array_equal(again.get_trajectory(), est)),
        kf_program=kf_program("slice, a second system (no warm-up)",
                              [again.loops]))
    print("slice, programs again (frames timed): "
          + json.dumps(summary["programs_again"]), flush=True)
    if not summary["programs_again"]["trajectory_equal"]:
        _fail("slice: a second program run took another trajectory")
    summary["stage_check"] = compare_stages(records, "slice (one lane)")

    # the same frames with the eager loops: K3 and K4 launched once per
    # evaluation the loops ran
    eager_traj = []

    def eager_slice():
        eager = FullSystem(seq.calib, seq.sensor, Settings(), device=device)
        for fr in scene.frames:
            eager.add_active_frame(*fr)
        eager_traj.append(eager.get_trajectory())
        return [eager]
    summary["track_check"] = dict(
        check_track_evaluations("slice", track_launched, eager_slice,
                                match_diags([fs])),
        trajectory_equal=bool(np.array_equal(eager_traj[0], est)))
    print("slice: " + json.dumps(summary), flush=True)
    if fs.is_lost:
        _fail("slice lost tracking")
    if len(fs.kf_shells) < 2:
        _fail("slice made fewer than 2 keyframes")
    if not np.isfinite(est).all() or not ate <= ATE_LIMIT_M:
        _fail(f"slice ATE {ate} m over the {ATE_LIMIT_M} m gate")
    if not (launches["dilate_pyramid"] > 0
            and launches["dilate_pyramid"] == n_build_main):
        _fail(f"dilate_pyramid launches {launches['dilate_pyramid']} != "
              f"{n_build_main} keyframe programs and build_track_ref calls")
    if launches["distance_transform"] < 1:
        _fail("distance_transform never launched on the main path")
    return summary, scene


def profile_slice(device, scene, stage_form=False, settings=None,
                  what="slice"):
    """The profile window of a single sequence (phases 4 and 8 (a)):
    frames PROFILE_FRAMES of `scene` (a fresh system with `settings`, by
    default `Settings()`; the frames before the window run unprofiled),
    as stage programs or (`stage_form`) in the stage form."""
    from sdv_loam_tpu_torch.config import Settings
    from sdv_loam_tpu_torch.eval.profile import profile_window
    from sdv_loam_tpu_torch.system.full_system import FullSystem

    from sdv_loam_tpu_torch.utils import device_loop as dl

    dl.reset_counts()
    fs = FullSystem(scene.calib, scene.sensor, settings or Settings(),
                    device=device)
    a, b = PROFILE_FRAMES
    with dl.stage_form() if stage_form else contextlib.nullcontext():
        for fr in scene.frames[:a]:
            fs.add_active_frame(*fr)
        prof, ka = profile_window(lambda i: fs.add_active_frame(
            *scene.frames[a + i]), b - a, [fs])
    form = "stage form" if stage_form else "programs"
    print(f"profile, {what} frames {a}-{b}, {form}: " + json.dumps(prof),
          flush=True)
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    name = f"profile_{what.replace(' ', '_')}" + \
        ("_stage_form.txt" if stage_form else ".txt")
    with open(os.path.join(out, name), "w") as f:
        f.write(key_table(ka))
    return prof


def key_table(ka):
    """The profiler's table sorted by device time (the key's name differs
    between PyTorch versions)."""
    try:
        return ka.table(sort_by="self_device_time_total", row_limit=60)
    except Exception:
        return ka.table(sort_by="self_cuda_time_total", row_limit=60)


def _steady_fps(frame_s):
    """Frames/s over the frames from PROFILE_FRAMES[0] on (each frame's
    host-clock seconds; a sequential frame ends in its stages' waits)."""
    tail = frame_s[PROFILE_FRAMES[0]:]
    return len(tail) / sum(tail)


def _steady_stage_ms(fs, stage0, n_frames):
    """Host-clock ms per frame of each stage over the frames from
    PROFILE_FRAMES[0] on (`stage0`: the stage totals before them)."""
    n = n_frames - PROFILE_FRAMES[0]
    return {k: 1000.0 * (v - stage0.get(k, 0.0)) / n
            for k, v in sorted(fs.telemetry.stage_time.items())}


def _same_iters(a, b):
    """Two systems' per-frame track-step LM iteration records equal."""
    return len(a) == len(b) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))


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
    from sdv_loam_tpu_torch.eval.profile import profile_window
    from sdv_loam_tpu_torch.ops import hopper_kernels as hk
    from sdv_loam_tpu_torch.system.full_system import FullSystem
    from sdv_loam_tpu_torch.system.multi import InterleavedFleet, MultiSystem
    from sdv_loam_tpu_torch.utils import device_loop as dl

    n = FLEET_FRAMES
    t0 = time.perf_counter()
    scenes = {}
    for name, kw in FLEET_SCENES.items():
        seq = make_sequence(n_frames=n, **SCENE, **kw)
        scenes[name] = (seq, render(seq, n))
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
    fleet = None
    for name, make in comps:
        # what the process holds before the fleet's systems are made (the
        # last composition's freed first)
        fleet = None
        mem0 = held_memory()
        fleet = make()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        hk.reset_launch_counts()
        dl.reset_counts()
        t0 = time.perf_counter()
        for i in range(n):
            if i == PROFILE_ROUNDS[0]:
                # the rounds from here on: the steady aggregate, past the
                # first rounds' captures
                torch.cuda.synchronize()
                t_steady = time.perf_counter()
            fleet.add_frames([scenes[x][1][i] for x in lanes])
        if hasattr(fleet, "flush"):
            fleet.flush()
        trajs = [fs.get_trajectory() for fs in fleet.systems]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steady = FLEET_B * (n - PROFILE_ROUNDS[0]) / (time.perf_counter()
                                                       - t_steady)
        launches = dict(hk.LAUNCHES)
        track_launched = hk.device_launches()
        _track_launches(f"fleet {name}", track_launched)
        loops = loop_counts(FLEET_B * n, [fs.loops for fs in fleet.systems]
                            + [getattr(fleet, "loops", ())])
        kf_prog = kf_program(
            f"fleet {name}", [fs.loops for fs in fleet.systems]
            + ([fleet.loops] if hasattr(fleet, "loops") else []), FLEET_B)
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
        rec = dict(wall_s=wall, aggregate_fps=agg, steady_aggregate_fps=steady,
                   scaling_efficiency=agg / (FLEET_B * single_fps),
                   peak_mem_bytes=int(torch.cuda.max_memory_allocated()),
                   mem_at_start_bytes=int(mem0),
                   launches=launches, kernel_lanes=kernel_lanes,
                   track_launches=track_launched,
                   stage_ms_per_frame=stage_ms, lm_iters=lm, loops=loops,
                   kf_program=kf_prog, match_diags=match_diags(fleet.systems),
                   lanes=[])
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
    # the batched lockstep with the eager loops: its K3 and K4 launches
    # once per evaluation the loops ran
    def eager_lockstep():
        eager = MultiSystem([system(x) for x in lanes], batch_track=True)
        for i in range(n):
            eager.add_frames([scenes[x][1][i] for x in lanes])
        return eager.systems
    track_check = check_track_evaluations(
        "batched lockstep", results["lockstep_batched"]["track_launches"],
        eager_lockstep, results["lockstep_batched"]["match_diags"])

    # the batched lockstep once more, apart from the timed compositions
    # (whose peak memory the records' clones would raise), in the stage
    # form: its stage programs of PROGRAM_FRAMES, and the windowed BA's
    # loops of the compared round and of its first batched keyframe
    # optimization (two lanes or more), recorded
    fleet = MultiSystem([system(x) for x in lanes], batch_track=True)
    records, programs, have_ba = [], [], False
    for i in range(n):
        if i > max(PROGRAM_FRAMES) and have_ba:
            break
        log = []
        with contextlib.ExitStack() as stack:
            stack.enter_context(dl.stage_form())
            if i == COMPARE_FRAME or not have_ba:
                stack.enter_context(dl.recording(log))
            if i in PROGRAM_FRAMES:
                stack.enter_context(dl.recording(programs, programs=True))
            fleet.add_frames([scenes[x][1][i] for x in lanes])
        have_ba = keep_records(log, i, records, have_ba, lanes=2)
    del fleet
    stage_check = compare_stages(records, "batched lockstep (lanes)",
                                 need=("ba0",))
    if not any(r["stage"] == "ba0" and r["st"]["eps"].shape[0] >= 2
               for r in records):
        _fail("batched lockstep: no keyframe optimization of two lanes or "
              "more was recorded")
    program_check = compare_programs(programs, "batched lockstep (lanes)",
                                     need=("track", "lidar", "kf_opt",
                                           "pyramid", "select"))
    for stage in ("track", "pyramid"):
        if FLEET_B not in program_check[stage]["lanes"]:
            _fail(f"batched lockstep: no {stage} program of {FLEET_B} "
                  "lanes")
    if max(program_check["kf_opt"]["lanes"]) < 2:
        _fail("batched lockstep: no keyframe program of two lanes or more")
    del records, programs

    # the profile window: five rounds of the batched lockstep
    dl.reset_counts()
    fleet = MultiSystem([system(x) for x in lanes], batch_track=True)
    a, b = PROFILE_ROUNDS
    for i in range(a):
        fleet.add_frames([scenes[x][1][i] for x in lanes])
    prof, _ = profile_window(
        lambda i: fleet.add_frames([scenes[x][1][a + i] for x in lanes]),
        b - a, fleet.systems, frames_per_step=FLEET_B)
    print("profile, batched lockstep rounds "
          f"{a}-{b}: " + json.dumps(prof), flush=True)
    return dict(single_pipelined_fps=single_fps,
                references={k: {kk: v for kk, v in r.items() if kk != "traj"}
                            for k, r in refs.items()},
                compositions=results, stage_check=stage_check,
                program_check=program_check, track_check=track_check,
                profile=prof, scenes=scenes)


def _kernels_ran(part, launches):
    if min(launches.values()) < 1:
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
    from sdv_loam_tpu_torch.utils import device_loop as dl

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
    dl.reset_counts()
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
    launches = hk.launch_counts()
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
               summary_fps=summary["fps"],
               loops=loop_counts(n, [ran[0].loops]))
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
    from sdv_loam_tpu_torch.utils import device_loop as dl

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
        dl.reset_counts()
        t0 = time.perf_counter()
        fs, _ = run_sequence(drop, Settings(**kw), device=device,
                             log_path=log, prefetch=False, allow_reset=False)
        traj = fs.get_trajectory()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = hk.launch_counts()
        kinds = [json.loads(x)["kind"] for x in open(log)]
        trajs[mode] = traj
        recs[mode] = rec = dict(
            lost=bool(fs.is_lost), n_keyframes=len(fs.kf_shells),
            ate_m=float(ate_rmse(traj, scene.poses_wc[:n])), wall_s=wall,
            fps=n / wall, launches=launches,
            hessian_lines=kinds.count("hessian"),
            counters=dict(fs.telemetry.counters),
            mono_candidates=int((fs.im_valid & ~fs.im["is_sensor"]).sum()),
            stage_ms_per_frame=_stage_ms(fs, n),
            loops=loop_counts(n, [fs.loops]))
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
    """Phase 6 (c): the monocular bootstrap at full width, after a small
    camera-only warm-up system; then its bootstrap frames again in the
    stage form."""
    import torch

    from sdv_loam_tpu_torch.config import Settings
    from sdv_loam_tpu_torch.data.synthetic import make_sequence
    from sdv_loam_tpu_torch.ops import hopper_kernels as hk
    from sdv_loam_tpu_torch.ops import mono_init
    from sdv_loam_tpu_torch.system.full_system import FullSystem
    from sdv_loam_tpu_torch.utils import device_loop as dl

    kw = dict(use_struct_pose=False, pipelined_frames=False)
    # the process's first call of each bootstrap program is its eager
    # warm-up (early-exit loops, host reads): a small system takes it
    t0 = time.perf_counter()
    dl.reset_counts()
    warm = make_sequence(n_frames=MONO_WARM_FRAMES, **MONO_WARM_SCENE)
    fs = FullSystem(warm.calib, warm.sensor, Settings(**kw), device=device)
    for i in range(MONO_WARM_FRAMES):
        img, _, ts = warm.get(i)
        fs.add_active_frame(img, None, ts)
    torch.cuda.synchronize()
    print(f"phase 6 (c): warm-up system ({MONO_WARM_FRAMES} frames at "
          f"{MONO_WARM_SCENE['w']}x{MONO_WARM_SCENE['h']}) in "
          f"{time.perf_counter() - t0:.1f} s: "
          + json.dumps(program_keys([fs.loops])), flush=True)
    del fs

    n = MONO_FRAMES
    t0 = time.perf_counter()
    seq = make_sequence(n_frames=n, **MONO_SCENE)
    frames = render(seq, n)
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
    # per bootstrap frame (the frames that leave the system not yet
    # initialized): host-clock seconds and flag reads
    boot_s, boot_reads, ini, at_ready = [], [], None, None
    try:
        fs = FullSystem(seq.calib, seq.sensor, Settings(**kw), device=device)
        torch.cuda.synchronize()
        hk.reset_launch_counts()
        dl.reset_counts()
        t0 = time.perf_counter()
        for img, _, ts in frames:
            was = fs.initialized
            r0 = dl.counts()["all"].get("reads", 0)
            t1 = time.perf_counter()
            fs.add_active_frame(img, None, ts)
            if not fs.initialized:
                boot_s.append(time.perf_counter() - t1)
                boot_reads.append(dl.counts()["all"].get("reads", 0) - r0)
            elif not was:
                # the trajectory as the ready frame leaves it (a later
                # windowed BA moves its keyframes)
                at_ready = fs.get_trajectory()
            ini = ini or fs._mono
        est = fs.get_trajectory()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        mono_init.knn = orig
    launches = hk.launch_counts()
    rec = dict(initialized=bool(fs.initialized), lost=bool(fs.is_lost),
               n_keyframes=len(fs.kf_shells), wall_s=wall, fps=n / wall,
               launches=launches, knn_level0=knn_calls[0] if knn_calls
               else None, knn_calls=knn_calls,
               sensor_points=int(fs.pt["is_sensor"][fs.pt_valid].sum()),
               stage_ms_per_frame=_stage_ms(fs, n),
               bootstrap=dict(frames=len(boot_s),
                              fps=len(boot_s) / max(sum(boot_s), 1e-9),
                              frame_s=boot_s, reads_per_frame=boot_reads,
                              lm_iters=ini.lm_iters if ini else None),
               loops=loop_counts(n, [fs.loops]))
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
    print(f"phase 6 (c): bootstrap frames {len(boot_s)}, flag reads per "
          f"bootstrap frame {boot_reads}, level LM iterations per frame "
          f"(coarse to fine) {rec['bootstrap']['lm_iters']}", flush=True)
    if not rec["initialized"] or rec["lost"] or rec["n_keyframes"] < 2 \
            or rec["sensor_points"]:
        _fail("mono bootstrap: not initialized, lost, < 2 keyframes or "
              "sensor points")
    if not (rec["scale"] > 0
            and rec["err_m"] < MONO_ERR_FRAC * rec["path_m"]):
        _fail(f"mono bootstrap: scale-aligned error {rec['err_m']} m over "
              f"{MONO_ERR_FRAC} x path {rec['path_m']} m")
    if any(boot_reads):
        _fail(f"mono bootstrap: flags read on the host in bootstrap frames "
              f"({boot_reads})")
    _kernels_ran("(c)", launches)

    # the bootstrap frames again in the stage form (the level LM's loop as
    # chunk replays with host reads): the same iterations, pose and
    # trajectory, bit for bit; its bootstrap programs recorded and each
    # held to the stage form on the same inputs
    ref = FullSystem(seq.calib, seq.sensor, Settings(**kw), device=device)
    programs, ref_ini = [], None
    t0 = time.perf_counter()
    with dl.stage_form():
        for img, _, ts in frames:
            if ref.initialized:
                break
            log = []
            with dl.recording(log, programs=True):
                ref.add_active_frame(img, None, ts)
            programs.extend(r for r in log if r["stage"] in KEYED_PROGRAMS)
            ref_ini = ref_ini or ref._mono
    torch.cuda.synchronize()
    m = len(ref.shells)
    staged = dict(frames=m, wall_s=time.perf_counter() - t0,
                  lm_iters_equal=ref_ini.lm_iters == ini.lm_iters,
                  pose_equal=bool(np.array_equal(ref_ini.T, ini.T)
                                  and np.array_equal(ref_ini.aff, ini.aff)),
                  trajectory_equal=bool(np.array_equal(
                      ref.get_trajectory(), at_ready)))
    print("phase 6 (c), stage form against programs: " + json.dumps(staged),
          flush=True)
    if not (staged["lm_iters_equal"] and staged["pose_equal"]
            and staged["trajectory_equal"]):
        _fail("mono bootstrap: the programs and the stage form took other "
              "iterations or reached another pose")
    rec["stage_form"] = staged
    rec["program_check"] = compare_programs(
        programs, "camera-only bootstrap",
        need=("mono_lm", "select_map", "pyramid"))
    return rec


def run_long(device):
    """Phase 7: the two long-horizon parts, sequential through
    run_sequence (no reset: a lost run fails)."""
    import torch

    from sdv_loam_tpu_torch.config import Settings
    from sdv_loam_tpu_torch.data.synthetic import make_sequence
    from sdv_loam_tpu_torch.eval.ate import ate_rmse
    from sdv_loam_tpu_torch.ops import hopper_kernels as hk
    from sdv_loam_tpu_torch.system.runner import run_sequence
    from sdv_loam_tpu_torch.utils import device_loop as dl

    n_frames = LONG_FRAMES
    parts = {}
    for name, scene, settings in (
            ("drift_gate", DRIFT_SCENE, Settings(**DRIFT_SETTINGS)),
            ("scene_a", dict(SCENE, **FLEET_SCENES["A"]), Settings())):
        t0 = time.perf_counter()
        seq = make_sequence(n_frames=n_frames, **scene)
        run = Rendered(seq, render(seq, n_frames))
        t_render = time.perf_counter() - t0
        torch.cuda.synchronize(device)
        hk.reset_launch_counts()
        dl.reset_counts()
        t0 = time.perf_counter()
        fs, _ = run_sequence(run, settings, device=device, prefetch=False,
                             allow_reset=False)
        est = fs.get_trajectory()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        launches = hk.launch_counts()
        gt = seq.poses_wc[:n_frames]
        path = _path_m(gt)
        ate = float(ate_rmse(est, gt))
        c = fs.telemetry.counters
        parts[name] = rec = dict(
            frames=n_frames, lost=bool(fs.is_lost), ate_m=ate, path_m=path,
            ate_share_of_path=ate / path,
            ba_step_veto=int(c["ba_step_veto"]),
            ba_step_veto_hard=int(c["ba_step_veto_hard"]),
            n_keyframes=len(fs.kf_shells), wall_s=wall, fps=n_frames / wall,
            render_s=t_render, launches=launches,
            stage_ms_per_frame=_stage_ms(fs, n_frames),
            loops=loop_counts(n_frames, [fs.loops]))
        print(f"phase 7 {name}: " + json.dumps(rec), flush=True)
        if rec["lost"] or not np.isfinite(est).all() \
                or not ate < LONG_ATE_FRAC * path:
            _fail(f"phase 7 {name}: lost or ATE {ate} m over "
                  f"{LONG_ATE_FRAC} x path {path} m")
        if min(launches.values()) < 1:
            _fail(f"phase 7 {name}: a kernel was not launched ({launches})")
    return parts


class _CountedReader(Rendered):
    """A runner reader that notes, as each frame is read (just before the
    runner hands it on), the host clock, the loop driver's flag reads and
    warm-ups, and the running system's stage totals."""

    def __init__(self, seq, frames, systems):
        super().__init__(seq, frames)
        self.systems, self.marks = systems, []

    def mark(self):
        from sdv_loam_tpu_torch.utils import device_loop as dl

        a = dl.counts()
        self.marks.append(dict(
            t=time.perf_counter(), reads=a["all"].get("reads", 0),
            splat_reads=a.get("splat", {}).get("reads", 0),
            warmups=a["all"].get("warmups", 0),
            stage_time=dict(self.systems[-1].telemetry.stage_time)
            if self.systems else {}))

    def get(self, i):
        self.mark()
        return self.frames[i]


def _path_m(poses):
    """The length (m) of a trajectory's path."""
    return float(np.linalg.norm(np.diff(poses[:, :3, 3], axis=0),
                                axis=1).sum())


def fast_child(device, frames_path):
    """Phase 8 (a), in a process of its own (so that each stage program's
    first call in the process, its eager warm-up, is the fast preset's):
    30 frames of the fast scene A through run_sequence, then in the stage
    form, the recorded programs against the stage form, a profile window
    and the loops' iteration counts. Writes its trajectory next to
    `frames_path` and prints its record last, on a line that starts with
    FAST_CHILD."""
    import pickle

    import torch

    from sdv_loam_tpu_torch.config import Settings
    from sdv_loam_tpu_torch.data.synthetic import make_sequence
    from sdv_loam_tpu_torch.eval.ate import ate_rmse
    from sdv_loam_tpu_torch.ops import hopper_kernels as hk
    from sdv_loam_tpu_torch.system import runner
    from sdv_loam_tpu_torch.system.full_system import FullSystem
    from sdv_loam_tpu_torch.utils import device_loop as dl

    with open(frames_path, "rb") as f:
        frames = pickle.load(f)
    n = len(frames)
    seq = make_sequence(n_frames=n, **FAST_SCENE, **FLEET_SCENES["A"])
    settings = Settings.preset_fast()
    systems = []
    scene = _CountedReader(seq, frames, systems)
    n_build = count_builds()
    orig_fs = runner.FullSystem

    def keep(*a, **k):
        systems.append(orig_fs(*a, **k))
        return systems[-1]
    runner.FullSystem = keep
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    hk.reset_launch_counts()
    dl.reset_counts()
    t0 = time.perf_counter()
    try:
        fs, _ = runner.run_sequence(scene, settings, device=device,
                                    prefetch=False, allow_reset=False)
    finally:
        runner.FullSystem = orig_fs
    torch.cuda.synchronize()
    scene.mark()
    wall = time.perf_counter() - t0
    launches = hk.launch_counts()
    track_launched = hk.device_launches()
    marks = scene.marks
    per = [dict(reads=b["reads"] - a["reads"],
                splat_reads=b["splat_reads"] - a["splat_reads"],
                warmups=b["warmups"] - a["warmups"])
           for a, b in zip(marks, marks[1:])]
    a = PROFILE_FRAMES[0]
    steady_s = marks[-1]["t"] - marks[a]["t"]
    est = fs.get_trajectory()
    rec = dict(
        frames=n, lost=bool(fs.is_lost), n_keyframes=len(fs.kf_shells),
        ate_m=float(ate_rmse(est, seq.poses_wc[:n])), wall_s=wall,
        fps=n / wall, steady_fps=(n - a) / steady_s,
        stage_ms_per_frame=_stage_ms(fs, n),
        steady_stage_ms_per_frame={
            k: 1000.0 * (v - marks[a]["stage_time"].get(k, 0.0)) / (n - a)
            for k, v in sorted(fs.telemetry.stage_time.items())},
        peak_mem_bytes=int(torch.cuda.max_memory_allocated()),
        mem_at_start_bytes=int(mem0),
        launches=launches, build_track_ref_calls=n_build[0],
        reads_per_frame=[p["reads"] for p in per],
        warmups_per_frame=[p["warmups"] for p in per],
        programs=program_keys([fs.loops], sorted(dl.PROGRAMS)),
        loops=loop_counts(n, [fs.loops]),
        kf_program=kf_program("fast preset, one system (its process's "
                              "first calls)", [fs.loops], strict=False))
    print("phase 8 (a) fast preset, programs: " + json.dumps(rec), flush=True)
    rec["path_m"] = _path_m(seq.poses_wc[:n])
    if rec["lost"] or rec["n_keyframes"] < 2 or not np.isfinite(est).all() \
            or not rec["ate_m"] <= FAST_ATE_FRAC * rec["path_m"]:
        _fail(f"fast preset: lost, < 2 keyframes or ATE {rec['ate_m']} m "
              f"over {FAST_ATE_FRAC} x path {rec['path_m']} m")
    if not (launches["dilate_pyramid"] > 0
            and launches["dilate_pyramid"] == n_build[0]):
        _fail(f"fast preset: {launches['dilate_pyramid']} K1 launches for "
              f"{n_build[0]} keyframe programs and build_track_ref calls")
    if launches["distance_transform"] < 1:
        _fail("fast preset: distance_transform never launched")
    # past each program's first call (its warm-up) no flag is read: a
    # frame without a warm-up reads none (the first frame's tracking
    # reference, outside the programs, reads its splat rounds' flags)
    late = [(i, p["reads"]) for i, p in enumerate(per)
            if not p["warmups"] and p["reads"] - (p["splat_reads"] if i == 0
                                                  else 0)]
    if late:
        _fail(f"fast preset: flags read on the host past the programs' "
              f"first calls (frame, reads): {late}")

    # the same frames in the stage form: the same decisions and trajectory
    # bit for bit; the programs of PROGRAM_FRAMES recorded
    ref = FullSystem(seq.calib, seq.sensor, settings, device=device)
    programs = []
    t0 = time.perf_counter()
    with dl.stage_form():
        for i, fr in enumerate(frames):
            with dl.recording(programs, programs=True) \
                    if i in PROGRAM_FRAMES else contextlib.nullcontext():
                ref.add_active_frame(*fr)
    est_ref = ref.get_trajectory()
    torch.cuda.synchronize()
    staged = dict(wall_s=time.perf_counter() - t0,
                  n_keyframes=len(ref.kf_shells),
                  track_iters_equal=_same_iters(fs.track_iters_hist,
                                                ref.track_iters_hist),
                  ba_lm_iters=[fs.telemetry.counters["ba_lm_iters"],
                               ref.telemetry.counters["ba_lm_iters"]],
                  trajectory_equal=bool(np.array_equal(est, est_ref)))
    staged["fps"] = n / staged["wall_s"]
    rec["stage_form"] = staged
    print("phase 8 (a), stage form against programs: " + json.dumps(staged),
          flush=True)
    if not (staged["track_iters_equal"] and staged["n_keyframes"]
            == rec["n_keyframes"] and staged["ba_lm_iters"][0]
            == staged["ba_lm_iters"][1] and staged["trajectory_equal"]):
        _fail("fast preset: the programs and the stage form took other "
              "decisions")
    del ref
    rec["program_check"] = compare_programs(programs,
                                            "fast preset (one lane)")
    del programs

    rec["profile"] = profile_slice(device, Rendered(seq, frames),
                                   settings=settings, what="fast preset")

    # the same frames with the early-exit loops (eager, on the card): K3
    # and K4 launched once per evaluation the loops ran, and each loop's
    # iterations over the first FAST_ITER_FRAMES frames (how many calls
    # ran n iterations)
    hist = {}

    def eager_fast():
        it_fs = FullSystem(seq.calib, seq.sensor, settings, device=device)
        for i, fr in enumerate(frames):
            if i == FAST_ITER_FRAMES:
                hist.update({k: dict(sorted(v.items()))
                             for k, v in sorted(dl.HIST.items())})
            it_fs.add_active_frame(*fr)
        return [it_fs]
    rec["track_check"] = check_track_evaluations(
        "fast preset", track_launched, eager_fast, match_diags([fs]))
    rec["loop_iterations"] = hist
    print(f"phase 8 (a): loop iterations over frames 0-"
          f"{FAST_ITER_FRAMES - 1} (calls per count), CHUNK {dl.CHUNK}: "
          + json.dumps(rec["loop_iterations"]), flush=True)
    np.save(frames_path + ".traj.npy", est)
    print("FAST_CHILD " + json.dumps(rec), flush=True)


def run_fast(device):
    """Phase 8: the fast preset (bench.py's second operating point) on the
    card: (a) one sequence in a child process, (b) pipelined, (c) the B = 4
    batched lockstep, (d) the CLI with --preset 2."""
    import pickle
    import tempfile

    import torch

    from sdv_loam_tpu_torch import run as cli
    from sdv_loam_tpu_torch.config import Settings
    from sdv_loam_tpu_torch.data.kitti_fixture import write_kitti_fixture
    from sdv_loam_tpu_torch.data.synthetic import make_sequence
    from sdv_loam_tpu_torch.eval.ate import ate_rmse
    from sdv_loam_tpu_torch.ops import hopper_kernels as hk
    from sdv_loam_tpu_torch.system.full_system import FullSystem
    from sdv_loam_tpu_torch.system.multi import MultiSystem
    from sdv_loam_tpu_torch.utils import device_loop as dl

    t0 = time.perf_counter()
    seqs, frames = {}, {}
    for name, n in (("A", FAST_FRAMES), ("B", FLEET_FRAMES)):
        seqs[name] = make_sequence(n_frames=n, **FAST_SCENE,
                                   **FLEET_SCENES[name])
        frames[name] = render(seqs[name], n)
    print(f"phase 8: fast scenes rendered in {time.perf_counter() - t0:.1f} s",
          flush=True)
    out = {}

    # (a) one sequence, sequential, in a child process
    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, "fast_a.pkl")
    with open(path, "wb") as f:
        pickle.dump(frames["A"], f)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           FAST_CHILD, path], stdout=subprocess.PIPE,
                          text=True)
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        _fail(f"phase 8 (a): the child process exited {proc.returncode}")
    line = [x for x in proc.stdout.splitlines()
            if x.startswith("FAST_CHILD ")]
    out["sequential"] = json.loads(line[-1][len("FAST_CHILD "):])
    out["sequential"]["process_s"] = time.perf_counter() - t0
    seq_traj = np.load(path + ".traj.npy")
    shutil.rmtree(tmp)

    def ate(name, traj):
        return float(ate_rmse(traj, seqs[name].poses_wc[:len(traj)]))

    def lanes_of(launches, lanes):
        return dict(launches=dict(launches), lanes=dict(lanes))

    # (b) scene A pipelined against (a)'s sequential trajectory
    fs = FullSystem(seqs["A"].calib, seqs["A"].sensor,
                    Settings.preset_fast(pipelined_frames=True),
                    device=device)
    torch.cuda.synchronize()
    hk.reset_launch_counts()
    dl.reset_counts()
    t0 = time.perf_counter()
    for fr in frames["A"]:
        fs.add_active_frame(*fr)
    traj = fs.get_trajectory()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["pipelined"] = rec = dict(
        lost=bool(fs.is_lost), n_keyframes=len(fs.kf_shells),
        ate_m=ate("A", traj), fps=FAST_FRAMES / wall,
        launches=hk.launch_counts(),
        max_abs_vs_sequential=float(np.abs(traj - seq_traj).max()),
        loops=loop_counts(FAST_FRAMES, [fs.loops]))
    print("phase 8 (b) fast preset, pipelined: " + json.dumps(rec),
          flush=True)
    if rec["lost"] or not rec["max_abs_vs_sequential"] <= FLEET_TRAJ_TOL:
        _fail(f"phase 8 (b): lost, or the pipelined trajectory "
              f"{rec['max_abs_vs_sequential']} from the sequential one")
    del fs

    # (c) the B = 4 batched lockstep: each scene alone first, for its
    # keyframe count and trajectory
    n = FLEET_FRAMES
    refs = {}
    for name in ("A", "B"):
        fs = FullSystem(seqs[name].calib, seqs[name].sensor,
                        Settings.preset_fast(), device=device)
        for fr in frames[name][:n]:
            fs.add_active_frame(*fr)
        refs[name] = dict(traj=fs.get_trajectory(), n_kf=len(fs.kf_shells))
    del fs
    lanes = [("A", "B")[b % 2] for b in range(FLEET_B)]

    def fleet():
        return MultiSystem([FullSystem(seqs[x].calib, seqs[x].sensor,
                                       Settings.preset_fast(), device=device)
                            for x in lanes], batch_track=True)
    # what the process holds before the fleet's systems are made (the
    # earlier phases' live memory counts in the peak)
    mem0 = held_memory()
    m = fleet()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hk.reset_launch_counts()
    dl.reset_counts()
    t0 = time.perf_counter()
    for i in range(n):
        if i == PROFILE_ROUNDS[0]:
            torch.cuda.synchronize()
            t_steady = time.perf_counter()
        m.add_frames([frames[x][i] for x in lanes])
    trajs = [fs.get_trajectory() for fs in m.systems]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches, kernel_lanes = dict(hk.LAUNCHES), dict(hk.LANES)
    track_launched = hk.device_launches()
    _track_launches("phase 8 (c)", track_launched)
    rec = dict(aggregate_fps=FLEET_B * n / (t1 - t0),
               steady_aggregate_fps=FLEET_B * (n - PROFILE_ROUNDS[0])
               / (t1 - t_steady),
               peak_mem_bytes=int(torch.cuda.max_memory_allocated()),
               mem_at_start_bytes=int(mem0),
               launches=launches, kernel_lanes=kernel_lanes,
               track_launches=track_launched,
               programs=program_keys([fs.loops for fs in m.systems]
                                     + [m.loops], sorted(dl.PROGRAMS)),
               kf_program=kf_program("fast preset, batched lockstep",
                                     [fs.loops for fs in m.systems]
                                     + [m.loops], FLEET_B),
               lanes=[dict(scene=x, lost=bool(fs.is_lost),
                           n_kf=len(fs.kf_shells), ate_m=ate(x, t),
                           max_abs_vs_alone=float(np.abs(
                               t - refs[x]["traj"]).max()))
                      for x, fs, t in zip(lanes, m.systems, trajs)])
    del m
    print("phase 8 (c) fast preset, batched lockstep: " + json.dumps(rec),
          flush=True)
    for b, ln in enumerate(rec["lanes"]):
        limit = FAST_ATE_FRAC * _path_m(seqs[ln["scene"]].poses_wc[:n])
        if ln["lost"] or not ln["ate_m"] <= limit or \
                ln["n_kf"] != refs[ln["scene"]]["n_kf"]:
            _fail(f"phase 8 (c) lane {b}: lost, ATE {ln['ate_m']} or "
                  f"{ln['n_kf']} keyframes against "
                  f"{refs[ln['scene']]['n_kf']}")
    for k in launches:
        if not kernel_lanes[k] > launches[k] >= 1:
            _fail(f"phase 8 (c): {k} never took two lanes or more "
                  f"({launches[k]} launches, {kernel_lanes[k]} lanes)")
    # the lockstep's programs of PROGRAM_FRAMES in the stage form, recorded
    # and held to it
    m = fleet()
    programs = []
    for i in range(max(PROGRAM_FRAMES) + 1):
        with contextlib.ExitStack() as stack:
            stack.enter_context(dl.stage_form())
            if i in PROGRAM_FRAMES:
                stack.enter_context(dl.recording(programs, programs=True))
            m.add_frames([frames[x][i] for x in lanes])
    del m
    rec["program_check"] = check = compare_programs(
        programs, "fast preset, batched lockstep (lanes)",
        need=("track", "lidar", "kf_opt", "pyramid", "select"))
    del programs
    for stage in ("track", "pyramid"):
        if FLEET_B not in check[stage]["lanes"]:
            _fail(f"phase 8 (c): no {stage} program of {FLEET_B} lanes")
    if max(check["kf_opt"]["lanes"]) < 2:
        _fail("phase 8 (c): no keyframe program of two lanes or more")
    out["lockstep"] = rec

    # (d) the CLI, --preset 2, on FAST_CLI_FRAMES frames of scene A
    d = os.path.join(os.path.dirname(OUT_DIR), "phase8")
    n = FAST_CLI_FRAMES
    paths = write_kitti_fixture(Rendered(seqs["A"], frames["A"][:n]),
                                os.path.join(d, "kitti"))
    result = os.path.join(d, "traj.txt")
    torch.cuda.synchronize()
    hk.reset_launch_counts()
    dl.reset_counts()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--seq-dir", paths["seq_dir"], "--calib",
                       paths["calib"], "--sensor", paths["sensor"],
                       "--preset", "2", "--result", result,
                       "--device", str(device)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = np.loadtxt(result).reshape(-1, 12)
    T = np.tile(np.eye(4), (rows.shape[0], 1, 1))
    T[:, :3, :] = rows.reshape(-1, 3, 4)
    out["cli"] = rec = dict(rc=rc, rows=int(rows.shape[0]),
                            ate_m=ate("A", T), fps=n / wall,
                            launches=hk.launch_counts())
    shutil.rmtree(os.path.join(d, "kitti"))
    print("phase 8 (d) CLI --preset 2: " + json.dumps(rec), flush=True)
    if rc != 0 or rows.shape[0] != n or \
            not rec["ate_m"] <= FAST_ATE_FRAC * _path_m(seqs["A"].poses_wc[:n]):
        _fail(f"phase 8 (d): rc {rc}, {rows.shape[0]} rows, ATE "
              f"{rec['ate_m']}")
    if not min(rec["launches"].values()) >= 1:
        _fail(f"phase 8 (d): a kernel was not launched ({rec['launches']})")
    out["scenes"] = {x: (seqs[x], frames[x]) for x in seqs}
    return out


def _lockstep_run(device, scenes, lanes, settings, n):
    """The batched lockstep MultiSystem of `lanes` (scene names) on
    `scenes` ({name: (seq, frames)}), n rounds; its systems made after the
    process's held memory is read. Returns its record."""
    import torch

    from sdv_loam_tpu_torch.eval.ate import ate_rmse
    from sdv_loam_tpu_torch.ops import hopper_kernels as hk
    from sdv_loam_tpu_torch.system.full_system import FullSystem
    from sdv_loam_tpu_torch.system.multi import MultiSystem
    from sdv_loam_tpu_torch.utils import device_loop as dl

    mem0 = held_memory()
    m = MultiSystem([FullSystem(scenes[x][0].calib, scenes[x][0].sensor,
                                settings(), device=device) for x in lanes],
                    batch_track=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hk.reset_launch_counts()
    dl.reset_counts()
    t0 = time.perf_counter()
    for i in range(n):
        if i == PROFILE_ROUNDS[0]:
            torch.cuda.synchronize()
            t_steady = time.perf_counter()
        m.add_frames([scenes[x][1][i] for x in lanes])
    trajs = [fs.get_trajectory() for fs in m.systems]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    B = len(lanes)
    rec = dict(B=B, aggregate_fps=B * n / (t1 - t0),
               steady_aggregate_fps=B * (n - PROFILE_ROUNDS[0])
               / (t1 - t_steady),
               peak_bytes=int(torch.cuda.max_memory_allocated()),
               mem_at_start_bytes=int(mem0),
               launches=hk.launch_counts(),
               lanes=[dict(scene=x, lost=bool(fs.is_lost),
                           n_kf=len(fs.kf_shells),
                           ate_m=float(ate_rmse(t, scenes[x][0].poses_wc[
                               :len(t)])))
                      for x, fs, t in zip(lanes, m.systems, trajs)])
    rec["peak_own_bytes"] = rec["peak_bytes"] - rec["mem_at_start_bytes"]
    return rec


def run_capacity(device, scenes, card):
    """Phase 9 (a): how many sequences one card holds, at each preset:
    one sequence's persistent bytes after FLEET_FRAMES frames
    (`hbm.system_device_bytes`), the process's live bytes, the card's
    budget and the fleet size `pick_fleet_size` gives for CAPACITY_B; then
    the batched lockstep at each of CAPACITY_LOCKSTEP (scenes A and B
    alternating, FLEET_FRAMES rounds): peak (reset before the run; the
    memory the process held before its systems were made is printed
    beside it), aggregate frames/s over the run and over rounds
    PROFILE_ROUNDS[0]-end, each lane's ATE. First the process's held
    memory is read, with and without torch's cuBLAS workspaces (freed
    here, so each run makes its own as a process of its own would). The
    working-set ratio of each run, (peak - held) / (B x one system's
    persistent bytes), B = 1 and CAPACITY_LOCKSTEP, must not exceed
    `hbm.TEMPORARIES_FACTOR`, no peak may exceed the budget, and no lane
    may be lost or over its preset's ATE gate (phase 5's, phase 8's)."""
    import torch

    from sdv_loam_tpu_torch.config import Settings
    from sdv_loam_tpu_torch.eval.ate import ate_rmse
    from sdv_loam_tpu_torch.system.full_system import FullSystem
    from sdv_loam_tpu_torch.utils import hbm

    n = FLEET_FRAMES
    budget = hbm.hbm_budget_bytes(device)
    held = held_memory()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    out = dict(card=card, budget_bytes=budget,
               temporaries_factor=hbm.TEMPORARIES_FACTOR,
               held_bytes=held, held_without_cublas_workspaces_bytes=(
                   held_memory() if clear is not None else None),
               presets={})
    print(f"phase 9 (a) ({card}): the process holds "
          f"{held / 2**20:.1f} MiB with no system alive; once torch's "
          "cuBLAS workspaces are freed: "
          f"{out['held_without_cublas_workspaces_bytes']} bytes",
          flush=True)
    for preset, settings in (("default", Settings),
                             ("fast", Settings.preset_fast)):
        sc = scenes[preset]
        seq, frames = sc["A"]
        mem0 = held_memory()
        fs = FullSystem(seq.calib, seq.sensor, settings(), device=device)
        torch.cuda.reset_peak_memory_stats()
        for fr in frames[:n]:
            fs.add_active_frame(*fr)
        traj = fs.get_trajectory()
        torch.cuda.synchronize()
        per_system = hbm.system_device_bytes(fs)
        one = dict(system_device_bytes=per_system,
                   live_device_bytes=hbm.live_device_bytes(device),
                   peak_bytes=int(torch.cuda.max_memory_allocated()),
                   mem_at_start_bytes=int(mem0), lost=bool(fs.is_lost),
                   ate_m=float(ate_rmse(traj, seq.poses_wc[:n])))
        one["peak_own_bytes"] = one["peak_bytes"] - one["mem_at_start_bytes"]
        del fs
        pick = hbm.pick_fleet_size(per_system, CAPACITY_B, budget=budget)
        runs = {B: _lockstep_run(device, sc,
                                 [("A", "B")[b % 2] for b in range(B)],
                                 settings, n)
                for B in CAPACITY_LOCKSTEP}
        ratios = {1: one["peak_own_bytes"] / per_system,
                  **{B: r["peak_own_bytes"] / (B * per_system)
                     for B, r in runs.items()}}
        rec = dict(one_sequence=one, picked_B=pick, lockstep=runs,
                   working_set_ratio=ratios)
        out["presets"][preset] = rec
        print(f"phase 9 (a) {preset} preset ({card}): " + json.dumps(rec),
              flush=True)
        print(f"phase 9 (a) {preset} preset ({card}): one sequence "
              f"{per_system / 2**20:.1f} MiB persistent, "
              f"{one['live_device_bytes'] / 2**20:.1f} MiB live, budget "
              f"{budget / 2**20:.1f} MiB, picked B = {pick} of "
              f"{CAPACITY_B}; working-set ratios {ratios} against the "
              f"factor {hbm.TEMPORARIES_FACTOR}", flush=True)
        path = {x: _path_m(sc[x][0].poses_wc[:n]) for x in sc}
        limit = {x: ATE_LIMIT_M if preset == "default"
                 else FAST_ATE_FRAC * path[x] for x in sc}
        for B, r in runs.items():
            print(f"phase 9 (a) {preset} preset ({card}): B = {B} batched "
                  f"lockstep: peak {r['peak_bytes'] / 2**20:.1f} MiB "
                  f"({r['mem_at_start_bytes'] / 2**20:.1f} MiB held before "
                  f"it), {r['aggregate_fps']:.3f} frames/s aggregate "
                  f"(rounds {PROFILE_ROUNDS[0]}-{n}: "
                  f"{r['steady_aggregate_fps']:.3f}), lane ATE "
                  f"{[round(ln['ate_m'], 4) for ln in r['lanes']]} m",
                  flush=True)
            for b, ln in enumerate(r["lanes"]):
                if ln["lost"] or not ln["ate_m"] <= limit[ln["scene"]]:
                    _fail(f"phase 9 (a) {preset}, B = {B}, lane {b}: lost, "
                          f"or ATE {ln['ate_m']} m over "
                          f"{limit[ln['scene']]} m")
        if one["lost"] or not one["ate_m"] <= limit["A"]:
            _fail(f"phase 9 (a) {preset}: the single sequence was lost or "
                  f"over the ATE gate ({one['ate_m']} m)")
        peaks = [one["peak_bytes"]] + [r["peak_bytes"] for r in runs.values()]
        if max(peaks) > budget:
            _fail(f"phase 9 (a) {preset}: a peak of {peaks} exceeds the "
                  f"budget {budget}")
        if max(ratios.values()) > hbm.TEMPORARIES_FACTOR:
            _fail(f"phase 9 (a) {preset}: a working-set ratio {ratios} "
                  f"exceeds the factor {hbm.TEMPORARIES_FACTOR}: "
                  "pick_fleet_size would admit more than the card holds")
    return out


def run_pinned(device, scenes, card):
    """Phase 9 (b): `parallel.dryrun`'s pinned fleet (one pipelined 320x96
    FullSystem per device of `make_batch_mesh()`, its state on its device,
    its trajectory bit for bit its run alone there), a threaded pinned
    fleet of two systems on `device` at the default preset (`scenes`:
    phase 5's A and B, FLEET_FRAMES frames), and the production lane forms
    over the mesh (`dryrun.LANES_PER_DEVICE` lanes a device). Each fleet's
    counts are its own (read when it has flushed, before its systems'
    runs alone) and must show all six kernels; the lane forms' are counted
    after their inputs were recorded and must show K1 and K3-K6 (no lane
    form runs K2, the activation program's)."""
    import torch

    from sdv_loam_tpu_torch.ops import hopper_kernels as hk
    from sdv_loam_tpu_torch.parallel import dryrun
    from sdv_loam_tpu_torch.parallel.mesh import make_batch_mesh

    mesh = make_batch_mesh()
    out = dict(card=card, mesh=[str(d) for d in mesh],
               names=[torch.cuda.get_device_name(d) for d in mesh])
    print(f"phase 9 (b): devices {out['mesh']} ({out['names']})",
          flush=True)
    if len(mesh) == 1:
        print("phase 9 (b): one card visible: cross-card placement was not "
              "run", flush=True)
    hk.reset_launch_counts()
    pinned = dryrun.dryrun_pinned_fleet(mesh)
    out["placement"] = pinned["placement"]
    out["launches_pinned"] = pinned["launches"]
    two = [str(device)] * 2
    print(f"phase 9 (b): a threaded pinned fleet at the default preset on "
          f"{two}", flush=True)
    t0 = time.perf_counter()
    hk.reset_launch_counts()
    pinned = dryrun.dryrun_pinned_fleet(two, [scenes["A"], scenes["B"]],
                                        n_frames=FLEET_FRAMES)
    out["placement_default_threads"] = pinned["placement"]
    out["launches_pinned_default_threads"] = pinned["launches"]
    out["default_threads_s"] = time.perf_counter() - t0
    rec = dryrun.record_production_calls(device=mesh[0])
    hk.reset_launch_counts()
    energies = dryrun.dryrun_production(mesh, rec)
    out["launches_production"] = hk.launch_counts()
    out["kf_energies"] = np.asarray(energies).tolist()
    print(f"phase 9 (b) ({card}): " + json.dumps(out), flush=True)
    need = {"launches_pinned": KERNEL_NAMES,
            "launches_pinned_default_threads": KERNEL_NAMES,
            "launches_production": tuple(
                k for k in KERNEL_NAMES if k != "distance_transform")}
    for part, names in need.items():
        missing = [k for k in names if not out[part][k] >= 1]
        if missing:
            _fail(f"phase 9 (b): {part}: {missing} not launched "
                  f"({out[part]})")
    return out


def main():
    import torch

    # 1. device
    if not torch.cuda.is_available():
        _fail("CUDA is not available")
    device = torch.device("cuda:0")
    if len(sys.argv) == 3 and sys.argv[1] == FAST_CHILD:
        fast_child(device, sys.argv[2])
        return
    os.makedirs(os.path.dirname(OUT_DIR), exist_ok=True)
    sys.stdout = _Tee(sys.stdout, os.path.join(os.path.dirname(OUT_DIR),
                                               "chip_smoke.log"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"nvidia-smi unavailable: {smi.stderr.strip()}"
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # 2. build
    from sdv_loam_tpu_torch.ops import hopper_kernels as hk
    t0 = time.perf_counter()
    path = hk.build_library(verbose=True)
    hk._load()
    print(f"build: {path} in {time.perf_counter() - t0:.2f} s", flush=True)
    usage = kernel_usage(hk.ptxas_usage(hk.build_report(path)))

    # 3. kernels against their plain versions
    rec = check_kernels(device)
    rec.update(check_track_kernels(device))
    rec.update(check_align_kernels(device))
    rec.update(check_ba_kernels(device))
    for name, entries in usage.items():
        rec[name]["ptxas"] = entries

    solver_kernels(device)

    # 4. the slice
    summary, scene = run_slice(device)
    print(f"slice ATE {summary['ate_m']:.4f} m, keyframes "
          f"{summary['n_keyframes']}, {summary['fps']:.3f} frames/s "
          f"(stage form {summary['stage_form']['fps']:.3f}), "
          f"stage ms/frame {summary['stage_ms_per_frame']}, peak memory "
          f"{summary['peak_mem_bytes'] / 2**20:.1f} MiB, graphs "
          f"{json.dumps(_brief(summary['loops']))}", flush=True)
    recorded("phase4", dict(ate_m=summary["ate_m"],
                            n_keyframes=summary["n_keyframes"],
                            k1=summary["launches"]["dilate_pyramid"],
                            k2=summary["launches"]["distance_transform"]))
    profile_slice(device, scene)
    profile_slice(device, scene, stage_form=True)

    # 5. the fleet
    t0 = time.perf_counter()
    fleet = run_fleet(device)
    scenes = {"default": fleet.pop("scenes")}
    for name, r in fleet["compositions"].items():
        worst = max(ln["max_dt_m"] for ln in r["lanes"]), \
            max(ln["max_dr_rad"] for ln in r["lanes"])
        print(f"fleet {name}: {r['aggregate_fps']:.3f} frames/s aggregate "
              f"(B={FLEET_B} x {FLEET_FRAMES} frames; rounds "
              f"{PROFILE_ROUNDS[0]}-{FLEET_FRAMES}: "
              f"{r['steady_aggregate_fps']:.3f}), single pipelined "
              f"{fleet['single_pipelined_fps']:.3f} frames/s, scaling "
              f"efficiency {r['scaling_efficiency']:.3f}, peak memory "
              f"{r['peak_mem_bytes'] / 2**20:.1f} MiB, launches "
              f"{r['launches']}, lanes {r['kernel_lanes']}, LM iterations "
              f"{r['lm_iters']}, largest "
              f"difference from the references {worst[0]:.3g} m / "
              f"{worst[1]:.3g} rad, stage ms/frame "
              f"{ {k: round(v, 3) for k, v in r['stage_ms_per_frame'].items() if v} }"
              f", loop graphs {json.dumps(_brief(r['loops']))}", flush=True)
    print(f"fleet phase {time.perf_counter() - t0:.1f} s", flush=True)

    # 6. CLI and camera-only
    t0 = time.perf_counter()
    os.makedirs(OUT_DIR, exist_ok=True)
    phase6 = dict(cli=run_cli(device, scene), dropout=run_dropout(device, scene),
                  mono=run_mono(device))
    print(f"phase 6 {time.perf_counter() - t0:.1f} s", flush=True)
    recorded("phase6_cli", dict(
        ate_m=phase6["cli"]["ate_m"],
        k2=phase6["cli"]["launches"]["distance_transform"]))
    d = phase6["dropout"]["sequential"]
    recorded("phase6_dropout", dict(
        ate_m=d["ate_m"], ba_step_veto=d["counters"].get("ba_step_veto", 0),
        k1=d["launches"]["dilate_pyramid"],
        k2=d["launches"]["distance_transform"]))
    recorded("phase6_mono", dict(ready_frame=phase6["mono"].get(
        "ready_frame"), err_m=phase6["mono"].get("err_m")))

    # 7. long horizon
    t0 = time.perf_counter()
    phase7 = run_long(device)
    print(f"phase 7 {time.perf_counter() - t0:.1f} s", flush=True)
    for name, r in phase7.items():
        print(f"phase 7 {name}: ATE {r['ate_m']:.4f} m "
              f"({100 * r['ate_share_of_path']:.3f} % of {r['path_m']:.1f} m),"
              f" ba_step_veto {r['ba_step_veto']}, ba_step_veto_hard "
              f"{r['ba_step_veto_hard']}, keyframes {r['n_keyframes']}, "
              f"{r['fps']:.3f} frames/s, K1 launches "
              f"{r['launches']['dilate_pyramid']}, K2 launches "
              f"{r['launches']['distance_transform']}, loop graphs "
              f"{json.dumps(_brief(r['loops']))}", flush=True)
        recorded(f"phase7_{name}", dict(
            ate_m=r["ate_m"], ba_step_veto=r["ba_step_veto"],
            n_keyframes=r["n_keyframes"], k1=r["launches"]["dilate_pyramid"],
            k2=r["launches"]["distance_transform"]))

    # 8. the fast preset
    t0 = time.perf_counter()
    phase8 = run_fast(device)
    scenes["fast"] = phase8.pop("scenes")
    print(f"phase 8 {time.perf_counter() - t0:.1f} s", flush=True)
    a, c = phase8["sequential"], phase8["lockstep"]
    print(f"phase 8 (a): ATE {a['ate_m']:.4f} m, keyframes "
          f"{a['n_keyframes']}, {a['fps']:.3f} frames/s (frames "
          f"{PROFILE_FRAMES[0]}-{FAST_FRAMES}: {a['steady_fps']:.3f}; stage "
          f"form {a['stage_form']['fps']:.3f}), peak memory "
          f"{a['peak_mem_bytes'] / 2**20:.1f} MiB; (c): "
          f"{c['aggregate_fps']:.3f} frames/s aggregate (rounds "
          f"{PROFILE_ROUNDS[0]}-{FLEET_FRAMES}: "
          f"{c['steady_aggregate_fps']:.3f}), peak memory "
          f"{c['peak_mem_bytes'] / 2**20:.1f} MiB ("
          f"{c['mem_at_start_bytes'] / 2**20:.1f} MiB held at its start)",
          flush=True)
    by_phase8 = {k: phase8[k]["launches"]
                 for k in ("sequential", "pipelined", "lockstep", "cli")}

    # 9. capacity, and fleets pinned one system per card
    t0 = time.perf_counter()
    capacity = run_capacity(device, scenes, card)
    pinned = run_pinned(device, scenes["default"], card)
    del scenes
    print(f"phase 9 {time.perf_counter() - t0:.1f} s", flush=True)
    for preset, r in capacity["presets"].items():
        print(f"phase 9 (a) {preset} ({card}): "
              f"{r['one_sequence']['system_device_bytes'] / 2**20:.1f} MiB "
              f"a system, budget {capacity['budget_bytes'] / 2**20:.1f} MiB,"
              f" picked B = {r['picked_B']}; " + "; ".join(
                  f"B = {B}: peak {big['peak_bytes'] / 2**20:.1f} MiB, "
                  f"{big['aggregate_fps']:.3f} frames/s aggregate (rounds "
                  f"{PROFILE_ROUNDS[0]}-{FLEET_FRAMES}: "
                  f"{big['steady_aggregate_fps']:.3f})"
                  for B, big in r["lockstep"].items()), flush=True)
    print(f"phase 9 (b) ({card}): pinned fleet and production lane forms "
          f"on {pinned['mesh']}", flush=True)
    by_phase9 = dict(
        {f"lockstep_{p}_B{B}": big["launches"]
         for p, r in capacity["presets"].items()
         for B, big in r["lockstep"].items()},
        pinned=pinned["launches_pinned"],
        pinned_default_threads=pinned["launches_pinned_default_threads"],
        production=pinned["launches_production"])

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
             launches_phase7={k: v["launches"]["dilate_pyramid"]
                              for k, v in phase7.items()},
             launches_phase8={k: v["dilate_pyramid"]
                              for k, v in by_phase8.items()},
             launches_phase9={k: v["dilate_pyramid"]
                              for k, v in by_phase9.items()},
             **rec["dilate_pyramid"]),
        dict(name="distance_transform", route="cuda",
             source="sdv_loam_tpu_torch/csrc/distance_transform.cu",
             replaces="sdv_loam_tpu/ops/pallas_kernels.py:67",
             launches=summary["launches"]["distance_transform"],
             launches_phase6={k: v["distance_transform"]
                              for k, v in by_path.items()},
             launches_phase7={k: v["launches"]["distance_transform"]
                              for k, v in phase7.items()},
             launches_phase8={k: v["distance_transform"]
                              for k, v in by_phase8.items()},
             launches_phase9={k: v["distance_transform"]
                              for k, v in by_phase9.items()},
             **rec["distance_transform"]),
    ]
    # K3-K8: no Pallas kernel of the JAX package; they stand for its
    # XLA-fused calc_res_gs and LM body, the windowed BA's linearization
    # and accumulation, and its matcher's align_batch (a
    # while_loop) and warp_affine_patches, which are one kernel here (K6
    # the prologue of K5's launch: each main-path launch runs both, and
    # K6's numbers are its patches-only mode's)
    for name, source, replaces in (
            ("track_res_gs", "track_res_gs",
             "sdv_loam_tpu/ops/photometric.py:162"),
            ("track_lm_update", "track_lm_update",
             "sdv_loam_tpu/ops/photometric.py:310"),
            ("align_batch", "align_batch", "sdv_loam_tpu/ops/align.py:319"),
            ("warp_patches", "align_batch",
             "sdv_loam_tpu/ops/align.py:147"),
            ("ba_linearize", "ba_linearize",
             "sdv_loam_tpu/models/backend.py:linearize_residuals"),
            ("ba_accumulate", "ba_accumulate",
             "sdv_loam_tpu/models/backend.py:_accumulate")):
        kernels.append(dict(
            name=name, route="cuda",
            source=f"sdv_loam_tpu_torch/csrc/{source}.cu", replaces=replaces,
            launches=summary["launches"][name],
            launches_phase5={k: r["track_launches"][name]
                             for k, r in fleet["compositions"].items()},
            launches_phase6={k: v[name] for k, v in by_path.items()},
            launches_phase7={k: v["launches"][name]
                             for k, v in phase7.items()},
            launches_phase8=dict(
                {k: v[name] for k, v in by_phase8.items() if k != "lockstep"},
                lockstep=phase8["lockstep"]["track_launches"][name]),
            launches_phase9={k: v[name] for k, v in by_phase9.items()},
            **rec[name]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
