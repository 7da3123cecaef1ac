"""Timing of the Hopper kernels on the card, and their bounds.

Used by chip_smoke.py (phase 3) and, run as a script, to compare the
kernels with those of an earlier checkout in one process on one card:

    python3 -m sdv_loam_tpu_torch.eval.kernel_timing --baseline DIR \
        [--track] [--out kernel_timing.json]

DIR is the root of another checkout of this repository (for example
`git archive` of the parent commit unpacked into an ignored directory).
Its `sdv_loam_tpu_torch/ops/hopper_kernels.py` is loaded under another
module name and builds its own kernels into DIR. The baseline is taken to
be the single-pass K1 (`dilate_depth`, called once per level with the 2x2
sum-pool between, as its `build_track_ref` did) and the single-map K2
(`distance_transform`, at most 32 sweeps). With `--track`, K3 and K4
instead (`compare_track`, against the baseline's `track_res_gs`,
`lm_update_step` and one LM iteration's K4 launches: its
`lm_update_accept_step`, or, in a checkout without it, its
`lm_update_accept` then `lm_update_step`). With `--align`, the fused
K5 / K6 call (`compare_align`, against the baseline's
`warp_affine_patches` then `align_batch`: its own K6 and K5 where it has
them, else its tensor operations and batched loop from its
`ops/align.py`, each run as a stage program), then the baseline's eager
`align_batch` calls over chip_smoke.py phase 4's frames, with the loop's
iterations where it has the loop (`baseline_align_counts`). Each
measurement runs in the order baseline, current, current, baseline.

With `--ba` (no baseline), K7 and K8 against their plain versions at the
main path's shapes (`time_ba`): the plain versions are the torch chain
that ran before the kernels.

Times:
  * device_ms: the sum of the device time of every kernel and copy that
    the call put on the card, from torch.profiler's records, over n calls,
    divided by n;
  * ms: the median CUDA-event time around one call of the Python wrapper
    (host enqueue included, which dominates a call of a few microseconds).
Bounds (the least time the card could take for the same work): the bytes
that the function must move (each input read once, each output written
once) over 3.35 TB/s, or its operations over 67 TFLOP/s (float32 outside
the tensor cores), whichever is larger (the peak rates of the H100 SXM
at 700 W).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


# ---------------------------------------------------------------------------
# bounds
# ---------------------------------------------------------------------------

def _level_shapes(h, w, levels):
    shapes = [(h, w)]
    for _ in range(levels - 1):
        shapes.append((shapes[-1][0] // 2, shapes[-1][1] // 2))
    return shapes


def dilate_pyramid_bound(lanes, h, w, levels):
    """(bound_ms, bound_by) of K1's chain: two level-0 maps read, two maps
    written per level; ~14 operations per output cell (12 sums, 2
    divisions) and 6 per pooled cell."""
    shapes = _level_shapes(h, w, levels)
    cells = sum(hl * wl for hl, wl in shapes) * lanes
    pooled = sum(hl * wl for hl, wl in shapes[1:]) * lanes
    nbytes = 4 * (2 * h * w * lanes + 2 * cells)
    ops = 14 * cells + 6 * pooled
    return _bound(nbytes, ops)


def distance_transform_bound(lanes, h, w, iters):
    """(bound_ms, bound_by) of K2: the map read and written once; 6
    operations per cell and sweep (the separable form: 4 mins, an add and
    a min)."""
    cells = lanes * h * w
    return _bound(4 * 2 * cells, 6 * cells * iters)


def track_res_gs_bound(lanes, rows, n):
    """(bound_ms, bound_by) of K3 over `rows` rows of `n` points (pools of
    `lanes` lanes): the pools read once (17 bytes a point), one 48-byte
    bilinear support per point and row, the per-row inputs and outputs;
    ~230 operations per point and row (the projection and the sample ~50,
    the residual, weight and Jacobian ~35, J^T W J and J^T W r 144)."""
    nbytes = 17 * lanes * n + 48 * rows * n + rows * (4 * 20 + 8 + 4 * 76)
    return _bound(nbytes, 230 * rows * n)


# K4 per row. The step reads H, b, lambda, T, the affine state, the
# exposures and the reference affine (380 bytes), of which the exposures
# and the reference affine are 16, and writes T_new, aff_new, aff_rel and
# the step (112 bytes); ~650 operations (the 8x8 LU and substitutions
# ~400, se3_exp and the 4x4 product ~250). The accept needs E and n of
# both residual carries to decide (24 bytes), then the chosen side's other
# carries (sat_frac, H, b and the flows, 300 bytes) with one of T / T_new
# and one of aff / aff_new (72 bytes), and lambda, done, n_it and the step
# (45 bytes); it writes one carry set, T, aff, lambda, done and n_it (397
# bytes); ~30 operations
LM_STEP = (380 + 112, 650)
LM_STEP_OWN_BYTES = 16 + 112
LM_ACCEPT = (24 + 300 + 72 + 45 + 397, 30)


def lm_update_bound(rows, launch="accept_step"):
    """(bound_ms, bound_by) of one K4 launch over `rows` rows. `launch`:
    "accept_step" (the fused entry, one per LM iteration): per row the
    accept's bytes and operations (LM_ACCEPT) and the step's operations,
    with only the step's own bytes (the exposures and reference affine it
    reads, the 112 it writes: the rest of its inputs are the carries the
    accept selected); "step" (one per LM call): the step's alone. The
    LU's operations are float64, counted against the float32 peak: a
    smaller bound than float64's rate would give, and moot here, where
    bytes bind."""
    if launch == "step":
        return _bound(rows * LM_STEP[0], rows * LM_STEP[1])
    return _bound(rows * (LM_ACCEPT[0] + LM_STEP_OWN_BYTES),
                  rows * (LM_ACCEPT[1] + LM_STEP[1]))


# K5 (align_batch) per row: its inputs (the 10x10 border patch 400 bytes,
# the start pixel, direction and affine transfer 24, the level and its
# three table entries 32, the two flags 2) and outputs (px 8, three flags
# 3); ~1,300 operations of setup for a valid row (the gradients, J, H's
# six 64-term sums, the 3x3 inverse); per sampled iteration (a running row
# in bounds) ~2,300 operations (per pixel the sample point, floor, weights
# and bilinear sum, the residual and its three products and sums; the 3x3
# product). The quad pack's rows (16 bytes each) are counted apart: each
# distinct row that the launch samples, once
ALIGN_ROW_BYTES = 400 + 24 + 32 + 2 + 8 + 3
ALIGN_SETUP_OPS = 1300
ALIGN_ITER_OPS = 2300
QUAD_ROW_BYTES = 16
# K6 (warp_affine_patches) per row: the warp, pixel, host slot and level
# (40 bytes) read, the 10x10 patch written (the quad rows counted apart,
# as for K5); ~30 operations a pixel (the point through the inverse, the
# tests and clamps, floor, the weights and the bilinear sum) and ~20 for
# the inverse
WARP_ROW = (40 + 400, 100 * 30 + 20)


def align_batch_bound(rows, valid_rows, sampled_iters, quad_rows):
    """(bound_ms, bound_by) of one K5 launch over `rows` rows, of which
    `valid_rows` run the setup, with `sampled_iters` iterations sampled in
    all and `quad_rows` distinct quad rows read (`align_iterations`: the
    run's data decides both). Bytes: each row's inputs and outputs once
    (ALIGN_ROW_BYTES) and each quad row that some sampled iteration reads
    once for the whole launch. A running row moves less than a pixel a
    step, so its later iterations re-read nearly the rows of its first,
    and neighbouring candidates' patches overlap: those re-reads come from
    cache and are not counted."""
    return _bound(rows * ALIGN_ROW_BYTES + QUAD_ROW_BYTES * quad_rows,
                  ALIGN_SETUP_OPS * valid_rows
                  + ALIGN_ITER_OPS * sampled_iters)


def warp_align_bound(rows, valid_rows, sampled_iters, quad_rows,
                     warp_quad_rows):
    """(bound_ms, bound_by) of one fused K5 / K6 launch (`warp_align`):
    K5's and K6's work on the same rows (`align_batch_bound`,
    `warp_patches_bound`: each distinct quad row of the target pyramids
    and of the host frames once) without the border patch's 400 bytes a
    row, which the fused kernel keeps on chip (K6 wrote them, K5 read
    them)."""
    return _bound(rows * (ALIGN_ROW_BYTES + WARP_ROW[0] - 2 * 400)
                  + QUAD_ROW_BYTES * (quad_rows + warp_quad_rows),
                  ALIGN_SETUP_OPS * valid_rows
                  + ALIGN_ITER_OPS * sampled_iters + rows * WARP_ROW[1])


def warp_patches_bound(rows, quad_rows):
    """(bound_ms, bound_by) of one K6 launch over `rows` rows that read
    `quad_rows` distinct quad rows (`warp_quad_rows`), each once."""
    return _bound(rows * WARP_ROW[0] + QUAD_ROW_BYTES * quad_rows,
                  rows * WARP_ROW[1])


def _bound(nbytes, ops):
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / FP32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# timers
# ---------------------------------------------------------------------------

def wrapper_ms(fn, n=25):
    """Median CUDA-event time in ms of one call of fn (after warm-up)."""
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


def device_ms(fn, n=50):
    """Device time in ms of one call of fn: the kernels' and copies' own
    durations from torch.profiler, summed over n calls, divided by n.
    None when the profiler records no device activity."""
    by_kernel = device_kernels(fn, n)
    return sum(by_kernel.values()) if by_kernel else None


def device_kernels(fn, n=50):
    """Device ms per call of fn by kernel or copy (torch.profiler, after
    warm-up, summed over n calls), each name cut to its function's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("::")[-1]
            out[name] = out.get(name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / n
    return out


# ---------------------------------------------------------------------------
# current against a baseline checkout
# ---------------------------------------------------------------------------

def _load_ops(root, name):
    """A checkout's `sdv_loam_tpu_torch/ops/<name>.py` under the module name
    `baseline_<name>` (what it imports of the package is this tree's)."""
    path = os.path.join(root, "sdv_loam_tpu_torch", "ops", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"baseline_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_baseline(root):
    """A checkout's `hopper_kernels`, its library built."""
    mod = _load_ops(root, "hopper_kernels")
    mod.build_library()
    return mod


def baseline_chain(old, idepth0, weight0, levels):
    """The baseline's build_track_ref chain: one single-pass launch per
    level, with the 2x2 sum-pool between them."""
    from sdv_loam_tpu_torch.ops.hopper_kernels import sum_pool2
    out = []
    idl, wl = idepth0, weight0
    for lvl in range(levels):
        if lvl > 0:
            idl, wl = sum_pool2(idl), sum_pool2(wl)
        idl, wl = old.dilate_depth(idl.contiguous(), wl.contiguous(),
                                   diagonal=(lvl < 2))
        out.append((idl, wl))
    return out


def track_scene(seed, h, w, n, lanes, rows, poison=False):
    """Seeded numpy inputs of K3 and K4: `lanes` images (lanes, h, w, 3)
    (an intensity pattern with noise, and its central differences), pools
    of `n` points per lane (90 % valid), intrinsics, and `rows` pose rows
    per lane (lane-major) near the identity with per-row affine transfer,
    reference b and cutoff, so that some points leave the image and some
    saturate. With `poison`, row 0's pose puts its lane's point 5 at depth
    0 (a NaN Jacobian), and with several lanes the last lane's image holds
    a patch of inf under some of its points (which reach every row of that
    lane: one lane keeps finite systems beside row 0)."""
    from sdv_loam_tpu_torch.utils.se3 import se3_exp_np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    imgs, pools, Ks = [], [], []
    for ln in range(lanes):
        i0 = (128 + 60 * np.sin(xx / (5.0 + ln)) * np.cos(yy / 7.0)
              + 4 * rng.standard_normal((h, w))).astype(np.float32)
        gy, gx = np.gradient(i0)
        imgs.append(np.stack([i0, gx, gy], -1).astype(np.float32))
        u = rng.integers(3, w - 3, n)
        v = rng.integers(3, h - 3, n)
        pools.append(dict(
            u=u.astype(np.float32), v=v.astype(np.float32),
            idepth=rng.uniform(0.05, 0.5, n).astype(np.float32),
            color=(i0[v, u] + 6 * rng.standard_normal(n)).astype(np.float32),
            valid=rng.random(n) < 0.9))
        Ks.append(np.array([0.78 * w + 10 * ln, 0.77 * w, w / 2, h / 2],
                           np.float32))
    B = lanes * rows
    T = np.stack([se3_exp_np(np.concatenate([
        rng.normal(0, 0.03, 3), rng.normal(0, 0.01, 3)]))
        for _ in range(B)]).astype(np.float32)
    sc = dict(imgs=np.stack(imgs), pools=pools, Ks=np.stack(Ks),
              lane=np.repeat(np.arange(lanes), rows), T=T,
              aff_rel=np.stack([1.0 + 0.05 * rng.standard_normal(B),
                                2.0 * rng.standard_normal(B)],
                               -1).astype(np.float32),
              ref_b=rng.normal(0, 3, B).astype(np.float32),
              cutoff=rng.uniform(12.0, 30.0, B).astype(np.float32))
    if poison:
        sc["T"][0] = np.eye(4, dtype=np.float32)
        sc["T"][0, :3, 3] = (0.01, 0.0, -0.5)
        sc["pools"][0]["idepth"][5] = 2.0
    if poison and lanes > 1:
        p = sc["pools"][-1]
        u, v = int(p["u"][7]), int(p["v"][7])
        sc["imgs"][-1, max(v - 8, 0):v + 8, max(u - 8, 0):u + 8] = np.inf
    return sc


def track_inputs(sc, device):
    """`track_scene`'s arrays as the port's K3 arguments on `device`:
    dict(pool (L, N) fields, dI, packed, K, lane, T, aff_rel, ref_b,
    cutoff)."""
    from sdv_loam_tpu_torch.ops.warp import pack_bilinear

    def t(x):
        return torch.as_tensor(x, device=device)
    dI = t(sc["imgs"])
    return dict(pool={k: t(np.stack([p[k] for p in sc["pools"]]))
                      for k in sc["pools"][0]},
                dI=dI, packed=pack_bilinear(dI), K=t(sc["Ks"]),
                lane=t(sc["lane"]).long(), T=t(sc["T"]),
                aff_rel=t(sc["aff_rel"]), ref_b=t(sc["ref_b"]),
                cutoff=t(sc["cutoff"]))


# ---------------------------------------------------------------------------
# K7 (ba_linearize) and K8 (ba_accumulate): the windowed BA
# ---------------------------------------------------------------------------

# the main path's BA shapes per preset: (N, F, w, h) (the active pool's
# cap, the window's slots, the image), and the lanes timed (one system,
# the benchmark's lockstep of eight)
BA_SHAPES = {"default": (4096, 8, 1200, 360), "fast": (2048, 7, 424, 320)}
BA_LANES = (1, 8)


def ba_linearize_bound(lanes, n, f):
    """(bound_ms, bound_by) of K7: per residual 19 bytes read (the
    matcher's position, its flags and state, the gate's two values) and
    114 written (resF, Jxi, Jc, Jd, the energy, the centre, the state,
    proj_ok), per point 20 read, per lane its pairs, thresholds and
    intrinsics; ~120 float32 operations a residual."""
    res = lanes * n * f
    nbytes = 133 * res + 20 * lanes * n + lanes * (96 * f * f + 4 * f + 16)
    return _bound(nbytes, 120 * res)


def ba_accumulate_bound(lanes, n, f):
    """(bound_ms, bound_by) of K8: per residual its terms read once (97
    bytes: Jc, Jxi, Jd, resF, the active flag), per point 14 read and
    20 + 4 D written (Hdd, bd, HdiF, n_act, Vpt), per lane the adjoints
    read and the two (D, D) systems and their b written (the tiles'
    scratch is not counted); float32 operations: per residual its pair
    block and b (65 terms of 2 products and 2 sums), JpJd and the point
    sums (42), its Vpt columns (144), per point the Schur entries (3
    each)."""
    D = 4 + 6 * f
    res, pts = lanes * n * f, lanes * n
    nbytes = 97 * res + pts * (34 + 4 * D) + lanes * (
        288 * f * f + 8 * D * D + 8 * D)
    ops = res * (4 * 65 + 42 + 144) + pts * 3 * (D * (D + 1) // 2 + D)
    return _bound(nbytes, ops)


def ba_scene(seed, L, N, F, w, h, device="cpu"):
    """A BA window's linearization and accumulation inputs for L lanes
    (numpy, seeded): frames along a drive with a slot left invalid in
    every second lane, points inside and outside the image and a few
    behind the camera, inactive residuals (the host's own, invalid
    frames, 20 % more), OOB and outlier states, invalid matches, the
    matcher's position near the projection (a tenth far, in the Huber
    branch), gate energies above the thresholds and gradients below 2,
    sensor points with their depth prior, a marginalization mask and
    small deltas. The pairs are made on `device` (strided views, as the
    BA passes them)."""
    from sdv_loam_tpu_torch.models import backend
    from sdv_loam_tpu_torch.utils import se3

    rng = np.random.default_rng(seed)
    f32 = np.float32
    K = np.tile(np.array([0.6 * w, 0.6 * w, (w - 1) / 2, (h - 1) / 2], f32),
                (L, 1))
    K[:, :2] *= rng.uniform(0.98, 1.02, (L, 1)).astype(f32)
    Tf = np.tile(np.eye(4, dtype=f32), (L, F, 1, 1))
    for ln in range(L):
        for k in range(F):
            a = 0.01 * k + rng.normal(0, 0.002)
            c, s = np.cos(a), np.sin(a)
            Tf[ln, k, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
            Tf[ln, k, :3, 3] = [rng.normal(0, 0.05), rng.normal(0, 0.02),
                                -0.7 * k]
    eps = rng.normal(0, 2e-3, (L, F, 6)).astype(f32)
    aff = rng.normal(0, [0.05, 2.0], (L, F, 2)).astype(f32)
    expo = np.ones((L, F), f32)
    fvalid = np.ones((L, F), bool)
    fvalid[1::2, F - 1] = False
    host = np.stack([rng.choice(np.flatnonzero(fvalid[ln]), N)
                     for ln in range(L)])
    u = rng.uniform(-30, w + 30, (L, N)).astype(f32)
    v = rng.uniform(-20, h + 20, (L, N)).astype(f32)
    idp = rng.uniform(0.02, 0.4, (L, N)).astype(f32)
    idp[rng.random((L, N)) < 0.01] *= -1
    act = (rng.random((L, N, F)) < 0.8) & fvalid[:, None, :] & \
        (host[..., None] != np.arange(F))
    state = rng.choice([0, 1, 2], (L, N, F), p=[0.8, 0.1, 0.1]).astype(
        np.int8)
    sensor = rng.random((L, N)) < 0.4

    def t(x, dtype=None, dev=device):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    def pairs_on(dev):
        T = t(Tf, dev=dev)
        return backend.make_pairs_lanes(
            se3.se3_exp(t(eps, dev=dev)) @ T, T, t(aff, dev=dev),
            t(expo, dev=dev), t(K, dev=dev))

    x = dict(pt_u=t(u), pt_v=t(v), pt_idepth=t(idp),
             pt_host=t(host, torch.int64), res_active=t(act),
             res_state=t(state),
             matcher_valid=t(rng.random((L, N, F)) < 0.92),
             frame_energy_th=t(rng.uniform(300, 3000, (L, F)).astype(f32)),
             K=t(K), gate=(t(rng.gamma(2.0, 400.0, (L, N, F)).astype(f32)),
                           t(rng.uniform(0, 60, (L, N, F)).astype(f32))))
    cpu = dict({k: v.cpu() for k, v in x.items() if k != "gate"},
               gate=tuple(g.cpu() for g in x["gate"]),
               matcher_px=torch.zeros((L, N, F, 2)), pairs=pairs_on("cpu"))
    centre = backend.linearize_residuals_lanes_plain(
        *ba_lin_args(cpu, F), w=w, h=h, gate=cpu["gate"])["center"]
    noise = rng.normal(0, 0.5, (L, N, F, 2)) * np.where(
        rng.random((L, N, F, 1)) < 0.1, 40.0, 1.0)
    x["matcher_px"] = t((centre[..., :2].numpy() + noise).astype(f32))
    x["pairs"] = pairs_on(device)
    x["pt_is_sensor"] = t(sensor)
    x["pt_prior"] = t(np.where(sensor, 2500.0, 0.0).astype(f32))
    x["marg_mask"] = t(rng.random((L, N)) < 0.3)
    x["frame_delta"] = t(rng.normal(0, 1e-3, (L, F, 6)).astype(f32))
    x["c_delta"] = t(rng.normal(0, 1e-2, (L, 4)).astype(f32))
    return x


def ba_lin_args(x, F):
    """`ba_scene`'s arrays as `backend.linearize_residuals_lanes`'s
    positional arguments (no colors, weights or images: the gate is
    given)."""
    L = x["pt_u"].shape[0]
    dev = x["pt_u"].device
    return (x["pt_u"], x["pt_v"], x["pt_idepth"], x["pt_host"], None, None,
            x["res_active"], x["res_state"], x["matcher_px"],
            x["matcher_valid"], x["pairs"],
            torch.zeros((), device=dev).expand(L, F, 1, 1, 3),
            x["frame_energy_th"], x["K"])


def ba_acc_args(lin, x, F):
    """`backend._accumulate`'s arguments as build_system_lanes forms them
    from a linearization `lin` of `ba_scene`'s window."""
    from sdv_loam_tpu_torch.models import backend

    active = lin["new_state"] == backend.RES_IN
    resF = torch.where(active[..., None], lin["resF"],
                       torch.zeros((), device=lin["resF"].device))
    return (lin["Jc"], lin["Jxi"], lin["Jd"], resF, active, x["pt_host"],
            x["pt_is_sensor"], x["pt_prior"],
            torch.ones_like(x["pt_is_sensor"]), x["pairs"], F)


# K7 against its plain version (chip_smoke.py phase 3,
# tests/test_torch_ba_kernels.py): a residual within BA_LIN_NEAR_PX of a
# bounds threshold, or whose point lies within BA_LIN_NEAR_Z of the
# target's camera plane (its projection's rounding grows as 1 / rho: at
# rho = 0.02 one float32 ulp of rho is 6e-6 of the position), may take
# either state and is not compared (the plain version's library products
# round otherwise); elsewhere the states agree and each float lies within
# BA_LIN_REL of its output's scale in the lane (`ba_lin_gaps`).
# BA_LIN_REL: the library rounds a pixel position a few ulps apart (4 ulps
# of 1300 px: 5e-4 px), which moves the Huber weight's square root by half
# that over the residual (at least the threshold, 6 px): 4e-5 of every
# Jacobian and weighted residual. Readings on an H100 at L = 8 (`ba_scene`,
# seeds 500-505 at both presets' BA shapes, and the card tests' windows):
# the kernel against the plain version 0 in the FEJ branch and at most
# 2.2e-5 in the current-projection branch (3.2e-5 in the card tests'
# windows, the fast preset's centre); planted faults: a focal length off
# by 1e-4 of itself reads 1.0e-4 to 2.3e-3 (states differ too), a Huber
# threshold one float32 ulp above 6 reads no more than the clean
# comparison (it moves a weight by an ulp), TF32 products nothing (the
# plain version's products are elementwise, no library GEMM). The limit
# lies between the clean reading and the smallest planted fault.
BA_LIN_NEAR_PX = 1e-3
BA_LIN_NEAR_Z = 0.02
BA_LIN_REL = 5e-5
# K8 against its plain version (the same callers): every float output
# within BA_ACC_REL of its terms' magnitudes (`ba_acc_gap`), n_act equal.
# Readings on an H100 at L = 8 (the same windows): 9.7e-7 to 2.2e-6; the
# plain version's GEMMs in TF32, a planted fault, 3.6e-4 to 7.1e-4
BA_ACC_REL = 1e-5
BA_ACC_NAMES = ("H_top", "b_top", "H_sc", "b_sc", "Hdd", "bd", "HdiF",
                "Vpt", "n_act")


def ba_lin_near(lin, x, w, h):
    """Residuals whose projection lies within BA_LIN_NEAR_PX of a bounds
    threshold (from `lin`'s centre), or whose point lies within
    BA_LIN_NEAR_Z of the target's camera plane in the FEJ or the current
    projection (the depth ratio rho = z_target / z_host, the projection's
    third coordinate, from `ba_scene`'s inputs `x` in float64: where rho
    is near 0 the sign test flips, and the projection divides by a
    difference of terms of size ~1, so its rounding grows as 1 / rho)."""
    Ku, Kv, _ = lin["center"].unbind(-1)
    out = torch.zeros_like(Ku, dtype=torch.bool)
    for v, lo, hi in ((Ku, 1.1, w - 3), (Kv, 1.1, h - 3)):
        out |= ((v - lo).abs() <= BA_LIN_NEAR_PX) | \
            ((v - hi).abs() <= BA_LIN_NEAR_PX)
    f64 = torch.float64
    L, N, F = Ku.shape
    K = x["K"].cpu().to(f64)
    u, v, idp = (x[k].cpu().to(f64)[..., None]
                 for k in ("pt_u", "pt_v", "pt_idepth"))
    k0 = (u - K[:, 2, None, None]) / K[:, 0, None, None]
    k1 = (v - K[:, 3, None, None]) / K[:, 1, None, None]
    pidx = x["pt_host"].cpu().long().clamp(0, F - 1)[..., None] * F + \
        torch.arange(F)
    lane = torch.arange(L)[:, None, None]
    for rk, tk in (("R0", "t0"), ("Rc", "tc")):
        R = x["pairs"][rk].cpu().to(f64)[lane, pidx]
        t = x["pairs"][tk].cpu().to(f64)[lane, pidx]
        rho = R[..., 2, 0] * k0 + R[..., 2, 1] * k1 + R[..., 2, 2] + \
            t[..., 2] * idp
        out |= rho.abs() <= BA_LIN_NEAR_Z
    return out


def ba_lin_gaps(got, ref, near_mask):
    """(states or proj_ok flags that differ away from the thresholds, the
    largest float gap over its output's scale at residuals away from the
    thresholds whose states and proj_ok agree, that gap per output) of
    two `linearize_residuals_lanes` results (on the CPU). An output's
    scale is its largest magnitude in the lane, plus for resF the lane's
    largest pixel position (r = K u - px rounds at its scale) and for the
    energy (about r^2) that position times 1 + sqrt of the largest
    energy: a residual's own magnitude is no scale where its terms cancel
    (the depth Jacobian drescale (t0 - t0_z u) f at points near the
    epipole, where one ulp of u moves it by many of its own ulps)."""
    same = (got["new_state"] == ref["new_state"]) & \
        (got["proj_ok"] == ref["proj_ok"])
    bad_states = int((~same & ~near_mask).sum())
    same = same & ~near_mask
    L = same.shape[0]
    pix = got["center"][..., :2].abs().reshape(L, -1).amax(-1).double()
    per = {}
    for k in ("resF", "Jxi", "Jc", "Jd", "energy", "center"):
        a, b = got[k].double(), ref[k].double()
        lane = b.abs().nan_to_num(0.0).reshape(L, -1).amax(-1)
        if k == "resF":
            lane = lane + pix
        elif k == "energy":
            lane = lane + pix * (1.0 + lane.sqrt())
        gap = (a - b).abs()
        gap = torch.where(torch.isnan(a) & torch.isnan(b),
                          torch.zeros_like(gap), gap)
        gap = gap.reshape(gap.shape[:3] + (-1,)).amax(-1)
        rel = gap / lane.clamp(min=1e-30).reshape(L, 1, 1)
        rel = torch.nan_to_num(rel, nan=float("inf"))
        per[k] = float(torch.where(same, rel, torch.zeros_like(rel)).max())
    return bad_states, max(per.values()), per


def ba_acc_magnitudes(args, F):
    """`backend._accumulate`'s arguments' outputs composed by the plain
    version in float64 on the terms' absolute values: each output's sum
    of its terms' magnitudes."""
    from sdv_loam_tpu_torch.models import backend

    def a(t):
        return t.abs().to(torch.float64) if isinstance(t, torch.Tensor) \
            and t.is_floating_point() else t
    (Jc, Jxi, Jd, resF, active, host, sensor, prior, sc, pairs, _) = args
    return backend._accumulate_plain(
        a(Jc), a(Jxi), a(Jd), a(resF), active, host, sensor, a(prior), sc,
        {k: a(v) for k, v in pairs.items()}, F)


def ba_acc_gap(got, ref, mag):
    """The largest |got - ref| over the terms' magnitudes over the float
    outputs of two `_accumulate` results (NaN against a number reads
    inf); raises where n_act differs."""
    f64 = torch.float64
    worst = 0.0
    for name, g, r, m in zip(BA_ACC_NAMES, got, ref, mag):
        if not g.is_floating_point():
            if not torch.equal(g.cpu(), r.cpu()):
                raise AssertionError(f"{name} differs")
            continue
        d = (g.to(f64).cpu() - r.to(f64).cpu()).abs()
        rel = torch.where(d == 0, torch.zeros_like(d),
                          d / m.to(f64).cpu().clamp(min=1e-30))
        worst = max(worst, float(torch.nan_to_num(rel, nan=float("inf"))
                                 .max()))
    return worst


def time_ba(device, seed=300):
    """K7 and K8 at the main path's shapes (BA_SHAPES, BA_LANES), each
    against its plain version on `ba_scene`'s inputs: the kernel's device
    time (torch.profiler; by kernel, K8's three launches apart), its
    wrapper's and the plain version's CUDA-event times, the plain
    version's device time, the bound and the share.
    Returns one row per kernel and shape."""
    from sdv_loam_tpu_torch.models import backend

    rows = []
    for preset, (n, f, w, h) in BA_SHAPES.items():
        for lanes in BA_LANES:
            x = ba_scene(seed + lanes, lanes, n, f, w, h, device)
            args = ba_lin_args(x, f)
            kw = dict(w=w, h=h, gate=x["gate"])
            lin = backend.linearize_residuals_lanes(*args, **kw)
            acc = ba_acc_args(lin, x, f)
            for name, kern, plain, bound in (
                    ("ba_linearize",
                     lambda: backend.linearize_residuals_lanes(*args, **kw),
                     lambda: backend.linearize_residuals_lanes_plain(
                         *args, **kw),
                     ba_linearize_bound(lanes, n, f)),
                    ("ba_accumulate", lambda: backend._accumulate(*acc),
                     lambda: backend._accumulate_plain(*acc),
                     ba_accumulate_bound(lanes, n, f))):
                by_kernel = device_kernels(kern)
                t_dev = sum(by_kernel.values()) if by_kernel else None
                r = dict(name=name, preset=preset, lanes=lanes, n=n, f=f,
                         device_ms=t_dev, kernels=by_kernel,
                         ms=wrapper_ms(kern),
                         plain_ms=wrapper_ms(plain),
                         plain_device_ms=device_ms(plain),
                         bound_ms=bound[0], bound_by=bound[1],
                         share=bound[0] / t_dev if t_dev else None)
                print(f"{name} {preset} N={n} F={f} lanes={lanes}: device "
                      f"{t_dev} ms, wrapper {r['ms']:.4f} ms, plain "
                      f"{r['plain_ms']:.4f} ms (device "
                      f"{r['plain_device_ms']}), bound {bound[0]:.6f} ms "
                      f"({bound[1]}), share {r['share']}; by kernel "
                      f"{ {k: round(v, 5) for k, v in r['kernels'].items()} }",
                      flush=True)
                rows.append(r)
    return rows


# K5's and K6's main-path shapes per preset: (h, w) of level 0, and the
# rows per lane of the track step's matcher (one per 25-px cell, rounded up
# to 8), of the keyframe's first matcher pass (0.625 of the active pool)
# and of its second pass (0.5 of it); chip_smoke.py phase 3 checks and
# times both kernels at each, with one lane and ALIGN_LANES
ALIGN_SHAPES = {"default": ((360, 1200), dict(track=720, pass1=2560,
                                               pass2=2048)),
                "fast": ((320, 424), dict(track=224, pass1=1280,
                                          pass2=1024))}
ALIGN_LANES = 4
ALIGN_LEVELS = 4


def _texture(rng, h, w, k):
    """A smooth intensity pattern (0-255 scale) with noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return (128 + 50 * np.sin(xx / (6.0 + k)) * np.cos(yy / 5.0)
            + 30 * np.sin((xx + yy) / 11.0) + 4 * rng.standard_normal((h, w))
            ).astype(np.float32)


def _quad_np(img):
    """numpy `quad_from_image`: (H*W, 4) rows of each pixel's 2x2 support,
    edge rows and columns replicated."""
    p = np.pad(img, ((0, 1), (0, 1)), mode="edge")
    h, w = img.shape
    return np.stack([p[:h, :w], p[:h, 1:], p[1:, :w], p[1:, 1:]],
                    -1).reshape(h * w, 4)


def _bilinear_np(img, x, y):
    x0, y0 = np.floor(x).astype(np.int64), np.floor(y).astype(np.int64)
    ax, ay = x - x0, y - y0
    h, w = img.shape
    x0c, y0c = np.clip(x0, 0, w - 2), np.clip(y0, 0, h - 2)
    return ((1 - ax) * (1 - ay) * img[y0c, x0c] + ax * (1 - ay)
            * img[y0c, x0c + 1] + (1 - ax) * ay * img[y0c + 1, x0c]
            + ax * ay * img[y0c + 1, x0c + 1])


def align_scene(seed, h, w, rows, lanes=1, levels=ALIGN_LEVELS,
                poison=False):
    """Seeded numpy inputs of K5 (`align_batch`) over `lanes` lanes of
    `rows` candidate rows each, laid out as the matcher lays out its lanes:
    each lane's target pyramid (a textured image and its 2x2-mean levels)
    quad-packed level after level, lane after lane; the level tables per
    lane and each row's `search_level` indexing its lane's entries. A row's
    border patch is its level's image around a true point (in the
    reference's brightness, with noise), its start that point moved by
    ~0.8 px; a quarter are edgelets; some rows are invalid and some start
    at the level's edge (they walk out). With `poison`, row 0 starts at
    NaN and row 1's patch holds a NaN. Returns a dict of arrays (the
    arguments of `align_batch`, in order, under their names, and each
    row's true point on its level, `px_true`)."""
    rng = np.random.default_rng(seed)
    quads, offs, wids, heis, levs = [], [], [], [], []
    base = 0
    for ln in range(lanes):
        lev = [_texture(rng, h, w, ln)]
        for _ in range(levels - 1):
            p = lev[-1]
            lev.append((0.25 * (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2]
                                + p[1::2, 1::2])).astype(np.float32))
        levs.append(lev)
        o = base
        for p in lev:
            quads.append(_quad_np(p))
            offs.append(o)
            wids.append(p.shape[1])
            heis.append(p.shape[0])
            o += p.size
        base = o
    M = lanes * rows
    share = np.array([0.55, 0.25, 0.12, 0.08][:levels])
    lvl = rng.choice(levels, M, p=share / share.sum())
    border = np.zeros((M, 10, 10), np.float32)
    px0 = np.zeros((M, 2), np.float32)
    aff_a = rng.uniform(0.9, 1.1, M).astype(np.float32)
    aff_b = rng.normal(0, 3, M).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, M)
    direction = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    by, bx = np.mgrid[0:10, 0:10].astype(np.float64) - 5
    true = np.zeros((M, 2))
    for r in range(M):
        ln, lv = r // rows, int(lvl[r])
        img = levs[ln][lv]
        hl, wl = img.shape
        edge = rng.random() < 0.03
        x = rng.uniform(0, 6) if edge else rng.uniform(7, wl - 8)
        y = rng.uniform(7, hl - 8)
        patch = _bilinear_np(img, np.clip(x + bx, 0, wl - 1.001),
                             np.clip(y + by, 0, hl - 1.001))
        border[r] = ((patch - aff_b[r]) / aff_a[r]
                     + 0.5 * rng.standard_normal((10, 10)))
        px0[r] = (x + rng.normal(0, 0.8), y + rng.normal(0, 0.8))
        true[r] = (x, y)
    sc = dict(quad_pyr=np.concatenate(quads).astype(np.float32),
              offsets=np.array(offs, np.int64),
              widths=np.array(wids, np.int64),
              heights=np.array(heis, np.int64),
              search_level=(np.repeat(np.arange(lanes), rows) * levels
                            + lvl).astype(np.int64),
              border_patch=border, px_init_scaled=px0, direction=direction,
              is_edge=rng.random(M) < 0.25, aff_a=aff_a, aff_b=aff_b,
              valid=rng.random(M) < 0.92, px_true=true)
    if poison:
        sc["px_init_scaled"][0] = np.nan
        sc["valid"][:2] = True
        sc["border_patch"][1, 4, 5] = np.nan
    return sc


ALIGN_ARGS = ("quad_pyr", "offsets", "widths", "heights", "search_level",
              "border_patch", "px_init_scaled", "direction", "is_edge",
              "aff_a", "aff_b", "valid")


def align_args(sc, device):
    """`align_scene`'s arrays as `align_batch`'s positional arguments on
    `device`."""
    return tuple(torch.as_tensor(sc[k], device=device) for k in ALIGN_ARGS)


def warp_scene(seed, h, w, rows, lanes=1, slots=3, poison=False):
    """Seeded numpy inputs of K6 (`warp_affine_patches`) over `lanes` lanes
    of `rows` rows each, as the matcher passes them: a stack of
    `lanes * slots` host frames (h, w, 3) (a texture and its central
    differences), each row's host slot in its lane's frames, reference
    pixel, affine warp (a scaled rotation with shear; some scaled 2-6x) and
    the search level `best_search_level` gives it. With `poison`, row 0's
    warp is NaN, row 1's singular and row 2's host slot lies past the
    stack. Returns dict(stack, host_idx, px_ref, A_cur_ref, search_level)."""
    rng = np.random.default_rng(seed)
    frames = []
    for k in range(lanes * slots):
        i0 = _texture(rng, h, w, k)
        gy, gx = np.gradient(i0)
        frames.append(np.stack([i0, gx, gy], -1).astype(np.float32))
    M = lanes * rows
    host = (np.repeat(np.arange(lanes), rows) * slots
            + rng.integers(0, slots, M)).astype(np.int64)
    px = np.stack([rng.uniform(6, w - 7, M), rng.uniform(6, h - 7, M)],
                  -1).astype(np.float32)
    th = rng.normal(0, 0.1, M)
    s = rng.uniform(0.8, 1.25, M) * np.where(rng.random(M) < 0.2,
                                             rng.uniform(2, 6, M), 1.0)
    shear = rng.normal(0, 0.05, M)
    A = np.stack([np.stack([s * np.cos(th), -s * np.sin(th) + shear], -1),
                  np.stack([s * np.sin(th), s * np.cos(th)], -1)],
                 1).astype(np.float32)
    det = np.abs(np.linalg.det(A.astype(np.float64)))
    lvl = np.zeros(M, np.int64)
    for _ in range(ALIGN_LEVELS - 1):
        step = det > 3.0
        lvl += step
        det = np.where(step, det * 0.25, det)
    if poison:
        A[0] = np.nan
        A[1] = [[1.0, 2.0], [2.0, 4.0]]
        host[2] = lanes * slots
    return dict(stack=np.stack(frames), host_idx=host, px_ref=px,
                A_cur_ref=A, search_level=lvl)


def warp_args(sc, device, quad=True):
    """`warp_scene`'s arrays as `warp_affine_patches`'s arguments on
    `device`, with the stack's quad pack (`quad_stack`) unless `quad` is
    false."""
    t = {k: torch.as_tensor(v, device=device) for k, v in sc.items()}
    kw = {}
    if quad:
        from sdv_loam_tpu_torch.ops.hopper_kernels import _stack_quads
        kw["quad_stack"] = _stack_quads(t["stack"])
    return (t["stack"], t["host_idx"], t["px_ref"], t["A_cur_ref"],
            t["search_level"]), kw


def warp_align_scene(seed, h, w, rows, lanes=1, levels=ALIGN_LEVELS,
                     slots=3, poison=False):
    """Seeded numpy inputs of the fused call (`warp_align`): `align_scene`
    (the target pyramids, level tables and alignment inputs; its border
    patches are not read) and, for the patch warp, a stack of
    `lanes * slots` host frames (h, w, 3), each its lane's level-0 image
    with noise and its central differences; each row's host slot in its
    lane's frames, its true point mapped to level 0 as `px_ref` (the
    matcher's level scaling undone), a warp near the identity (a small
    rotation with shear) and its search level as the warp's level, so
    that the warped patch resembles the target around the true point.
    With `poison`, row 0 starts at NaN, row 1's host slot lies past the
    stack (a NaN patch), row 2's warp is NaN and row 3's singular, all
    four valid. Returns align_scene's dict with `stack`, `host_idx`,
    `px_ref`, `A_cur_ref` and `warp_level` added."""
    sc = align_scene(seed, h, w, rows, lanes, levels=levels)
    rng = np.random.default_rng(seed + 1)
    quad = sc["quad_pyr"]
    frames = []
    for ln in range(lanes):
        o = int(sc["offsets"][ln * levels])
        i0 = quad[o:o + h * w, 0].reshape(h, w)
        for _ in range(slots):
            im = (i0 + 2 * rng.standard_normal((h, w))).astype(np.float32)
            gy, gx = np.gradient(im)
            frames.append(np.stack([im, gx, gy], -1).astype(np.float32))
    M = lanes * rows
    lvl = sc["search_level"] - np.repeat(np.arange(lanes), rows) * levels
    scale = 2.0 ** lvl
    px_ref = (sc["px_true"] * scale[:, None]
              + 0.5 * (scale[:, None] - 1)).astype(np.float32)
    th = rng.normal(0, 0.05, M)
    shear = rng.normal(0, 0.03, M)
    A = np.stack([np.stack([np.cos(th), -np.sin(th) + shear], -1),
                  np.stack([np.sin(th), np.cos(th)], -1)],
                 1).astype(np.float32)
    host = (np.repeat(np.arange(lanes), rows) * slots
            + rng.integers(0, slots, M)).astype(np.int64)
    if poison:
        sc["px_init_scaled"][0] = np.nan
        host[1] = lanes * slots
        A[2] = np.nan
        A[3] = [[1.0, 2.0], [2.0, 4.0]]
        sc["valid"][:4] = True
    sc.update(stack=np.stack(frames), host_idx=host, px_ref=px_ref,
              A_cur_ref=A, warp_level=lvl.astype(np.int64))
    return sc


def edge_cases(sc, seed, levels=ALIGN_LEVELS):
    """Rows at the edges of K5's sampling, set in an `align_scene` or
    `warp_align_scene` dict (in place; at least 30 rows a lane): lane 0's
    rows 10-19 start 5.5-6.5 px from their level's right and bottom edges
    (their samples clamp there or they walk out of the level), rows 20-29
    start 5-7 px from their true point (they walk far from their start),
    the last lane's last six rows start 4.5-6 px above the bottom of its
    last level, and the pack ends three pixel rows before that level does
    (samples there read NaN). Returns the dict."""
    rng = np.random.default_rng(seed)
    lvl, px0 = sc["search_level"], sc["px_init_scaled"]
    wid, hei = sc["widths"], sc["heights"]
    rows = sc["valid"].size // (sc["offsets"].size // levels)
    for r in range(10, 20):
        px0[r] = (wid[lvl[r]] - 6.5 + rng.uniform(0, 1),
                  hei[lvl[r]] - 6.5 + rng.uniform(0, 1))
    ang = rng.uniform(0, 2 * np.pi, 10)
    dist = rng.uniform(5, 7, 10)
    px0[20:30] = sc["px_true"][20:30] + np.stack(
        [dist * np.cos(ang), dist * np.sin(ang)], -1)
    last = sc["offsets"].size - 1
    wl, hl = int(wid[last]), int(hei[last])
    for r in range(sc["valid"].size - 6, sc["valid"].size):
        lvl[r] = last
        px0[r] = (rng.uniform(10, wl - 10), hl - 6 + rng.uniform(0, 1.5))
    sc["valid"][10:30] = True
    sc["valid"][-6:] = True
    assert rows >= 30
    sc["quad_pyr"] = sc["quad_pyr"][:int(sc["offsets"][last]) + (hl - 3) * wl]
    if "warp_level" in sc:
        sc["warp_level"][-6:] = last % levels
    return sc


WARP_ALIGN_ARGS = ("stack", "host_idx", "px_ref", "A_cur_ref", "warp_level",
                   "quad_pyr", "offsets", "widths", "heights",
                   "search_level", "px_init_scaled", "direction", "is_edge",
                   "aff_a", "aff_b", "valid")


def warp_align_args(sc, device):
    """`warp_align_scene`'s arrays as `warp_align`'s positional arguments
    on `device`, and its keywords (`quad_stack`, the stack's quad
    pack)."""
    from sdv_loam_tpu_torch.ops.hopper_kernels import _stack_quads
    args = tuple(torch.as_tensor(sc[k], device=device)
                 for k in WARP_ALIGN_ARGS)
    return args, dict(quad_stack=_stack_quads(args[0]))


def split_warp_align(args, kw):
    """`warp_align`'s arguments as (`warp_affine_patches`'s arguments and
    keywords, a function of the patches giving `align_batch`'s positional
    arguments)."""
    return (args[:5], kw), lambda patches: (*args[5:10], patches,
                                            *args[10:])


def align_iterations(args, n_iter=10):
    """K5's work on `args` (`align_batch`'s positional arguments), from the
    plain loop, as a dict: `valid_rows`; `sampled_iterations`, the
    iterations in which a row ran and was in bounds, summed over rows;
    `quad_rows`, how many distinct rows of the quad pack those iterations
    sample (a row outside the pack reads no memory)."""
    from sdv_loam_tpu_torch.ops import hopper_kernels as hk
    x, st = hk.align_setup(*args)
    T = x["quad_pyr"].shape[0]
    n, idx = 0, []
    for _ in range(n_iter):
        running = st["alive"] & x["valid"] & ~st["conv"]
        if not bool(running.any()):
            break
        inb, xx, yy = hk.align_samples(x, st["u"], st["v"])
        act = running & inb
        q = (x["base"] + torch.floor(yy).to(torch.int64) * x["wv"]
             + torch.floor(xx).to(torch.int64))[act]
        idx.append(q[(q >= 0) & (q < T)])
        st, _ = hk.align_body(x, st)
        n += int(act.sum())
    quad_rows = int(torch.unique(torch.cat(idx)).numel()) if idx else 0
    return dict(valid_rows=int(x["valid"].sum()), sampled_iterations=n,
                quad_rows=quad_rows)


def warp_quad_rows(wargs, quad_stack):
    """How many distinct rows of the quad pack K6 reads on `wargs`
    (`warp_affine_patches`'s positional arguments): those of the patch
    pixels inside the image, as `warp_affine_patches_plain` computes them,
    inside the pack."""
    from sdv_loam_tpu_torch.ops import hopper_kernels as hk
    stack, host_idx, px_ref, A, level = wargs
    h, w = stack.shape[1:3]
    ok, xc, yc = hk.warp_samples(h, w, px_ref, A, level)
    q = (host_idx.to(torch.int64)[:, None] * (h * w)
         + torch.floor(yc).to(torch.int64) * w
         + torch.floor(xc).to(torch.int64))[ok]
    return int(torch.unique(q[(q >= 0) & (q < quad_stack.shape[0])]).numel())


def _splat(lanes, h, w, rng, frac=0.04):
    wt = np.zeros((lanes, h, w), np.float32)
    idp = np.zeros((lanes, h, w), np.float32)
    m = rng.random((lanes, h, w)) < frac
    wt[m] = rng.uniform(1.0, 300.0, m.sum()).astype(np.float32)
    idp[m] = wt[m] * rng.uniform(0.01, 0.5, m.sum()).astype(np.float32)
    return idp, wt


def _seed_map(lanes, h, w, rng, n_seeds=2000):
    seed = np.full((lanes, h * w), 1000.0, np.float32)
    for b in range(lanes):
        seed[b, rng.choice(h * w, min(n_seeds, h * w // 2),
                           replace=False)] = 0.0
    return seed.reshape(lanes, h, w)


def _k2_forced_tile(hk, seed, iters, tile):
    """The current K2 with its tile size forced (32 or 64) instead of
    chosen from the work, through the C entry point."""
    lanes, h, w = (1, *seed.shape) if seed.dim() == 2 else seed.shape
    buf = torch.empty((2, *seed.shape), dtype=seed.dtype, device=seed.device)
    stream = torch.cuda.current_stream(seed.device).cuda_stream
    rc = hk._load().sdv_distance_transform(
        seed.data_ptr(), buf[0].data_ptr(), buf[1].data_ptr(), lanes, h, w,
        iters, tile, stream)
    hk._check_rc(rc, "distance_transform")
    return buf[0]


def compare(baseline_root, dev):
    from sdv_loam_tpu_torch.ops import hopper_kernels as hk
    old = load_baseline(baseline_root)
    hk.build_library()
    rng = np.random.default_rng(0)
    rows = []

    def both(name, shape, fn_old, fn_new, plain, bound):
        eq = [torch.equal(a, b) for a, b in zip(plain(fn_old()),
                                                plain(fn_new()))]
        rec = dict(name=name, shape=shape, equal=all(eq),
                   bound_ms=bound[0], bound_by=bound[1])
        for tag, fn in (("baseline", fn_old), ("current", fn_new),
                        ("current", fn_new), ("baseline", fn_old)):
            rec.setdefault(f"{tag}_device_ms", []).append(device_ms(fn))
            rec.setdefault(f"{tag}_ms", []).append(wrapper_ms(fn))
        print(json.dumps(rec), flush=True)
        rows.append(rec)

    def flat_pyr(p):
        return [t for lv in p for t in lv]

    for lanes, (h, w) in ((1, (360, 1200)), (1, (320, 424)),
                          (4, (360, 1200))):
        idp, wt = _splat(lanes, h, w, rng)
        ti = torch.as_tensor(idp, device=dev)
        tw = torch.as_tensor(wt, device=dev)
        if lanes == 1:
            ti, tw = ti[0], tw[0]

        def fn_old(ti=ti, tw=tw, lanes=lanes):
            if lanes == 1:
                return baseline_chain(old, ti, tw, 4)
            return [baseline_chain(old, ti[b], tw[b], 4)
                    for b in range(lanes)]

        def fn_new(ti=ti, tw=tw):
            return hk.dilate_pyramid(ti, tw, 4)

        def plain(p, lanes=lanes):
            if lanes == 1:
                return flat_pyr(p)
            if isinstance(p, list):   # the baseline's per-lane chains
                return [torch.stack([p[b][lv][k] for b in range(lanes)])
                        for lv in range(4) for k in range(2)]
            return flat_pyr(p)
        both("dilate_pyramid", [lanes, h, w], fn_old, fn_new, plain,
             dilate_pyramid_bound(lanes, h, w, 4))

    for lanes, (h, w) in ((1, (180, 600)), (1, (160, 212)), (4, (180, 600))):
        ts = torch.as_tensor(_seed_map(lanes, h, w, rng), device=dev)
        if lanes == 1:
            ts = ts[0]

        def fn_old(ts=ts, lanes=lanes):
            if lanes == 1:
                return old.distance_transform(ts, 32)
            return torch.stack([old.distance_transform(ts[b], 32)
                                for b in range(lanes)])

        def fn_new(ts=ts):
            return hk.distance_transform(ts, 32)
        both("distance_transform", [lanes, h, w], fn_old, fn_new,
             lambda x: [x], distance_transform_bound(lanes, h, w, 32))
        for tile in (32, 64):
            rec = dict(name=f"distance_transform_tile{tile}",
                       shape=[lanes, h, w],
                       equal=torch.equal(_k2_forced_tile(hk, ts, 32, tile),
                                         fn_new()),
                       current_device_ms=device_ms(
                           lambda: _k2_forced_tile(hk, ts, 32, tile)))
            print(json.dumps(rec), flush=True)
            rows.append(rec)

    # where K1's and K2's device time goes: K1's chain cut after 1..3
    # levels, K2 with one chunk of sweeps
    idp, wt = _splat(1, 360, 1200, rng)
    ti = torch.as_tensor(idp[0], device=dev)
    tw = torch.as_tensor(wt[0], device=dev)
    for levels in (1, 2, 3):
        rec = dict(name=f"dilate_pyramid_levels{levels}", shape=[1, 360, 1200],
                   equal=_pyr_equal(hk.dilate_pyramid(ti, tw, levels),
                                    hk.dilate_pyramid_plain(ti, tw, levels)),
                   current_device_ms=device_ms(
                       lambda: hk.dilate_pyramid(ti, tw, levels)))
        print(json.dumps(rec), flush=True)
        rows.append(rec)
    ts = torch.as_tensor(_seed_map(1, 180, 600, rng)[0], device=dev)
    for iters in (1, 16):
        rec = dict(name=f"distance_transform_iters{iters}",
                   shape=[1, 180, 600],
                   equal=torch.equal(hk.distance_transform(ts, iters),
                                     hk.distance_transform_plain(ts, iters)),
                   current_device_ms=device_ms(
                       lambda: hk.distance_transform(ts, iters)))
        print(json.dumps(rec), flush=True)
        rows.append(rec)
    return rows


# K3's and K4's main-path shapes (h, w, points, rows) per preset: the
# hypothesis ladder on the coarsest level, the refinement on level 0, the
# struct-pose veto on level 1 (chip_smoke.py phase 3 checks and times K3
# and K4 at them)
TRACK_SHAPES = {"default": ((45, 150, 1024, 32), (360, 1200, 6144, 3),
                            (180, 600, 4096, 2)),
                "fast": ((40, 53, 512, 32), (320, 424, 3072, 3),
                         (160, 212, 2048, 2))}


def _ulps(a, b):
    """Per element, the float32 ulps between a and b (0 where both are the
    same NaN-ness and bits, inf where one is NaN and the other not)."""
    ai = a.float().contiguous().view(torch.int32).long()
    bi = b.float().contiguous().view(torch.int32).long()
    # the float32 bit patterns on one monotone integer line
    ai = torch.where(ai < 0, -(ai & 0x7FFFFFFF), ai)
    bi = torch.where(bi < 0, -(bi & 0x7FFFFFFF), bi)
    d = (ai - bi).abs().double()
    na, nb = torch.isnan(a), torch.isnan(b)
    d = torch.where(na & nb, torch.zeros_like(d), d)
    return torch.where(na ^ nb, torch.full_like(d, float("inf")), d)


def compare_track(baseline_root, dev):
    """K3 and K4 of this tree against a baseline checkout's on
    track_scene's inputs at TRACK_SHAPES, one lane and four: K3's outputs
    (how many differ, the largest float32 ulps, counts equal), K4's step
    (bit for bit) and one LM iteration's accept and next step (bit for
    bit; a baseline without the fused `lm_update_accept_step` runs its
    `lm_update_accept` then `lm_update_step`); device and wrapper times of
    K3 and of one LM iteration's K4 launches, in the order baseline,
    current, current, baseline, at the ladder and level 0 with one lane
    and at the ladder with four (the batched lockstep's rows)."""
    from sdv_loam_tpu_torch.ops import hopper_kernels as hk
    from sdv_loam_tpu_torch.utils.device_loop import same_bits
    old = load_baseline(baseline_root)
    hk.build_library()
    rows_out = []
    for preset, shapes in TRACK_SHAPES.items():
        for i, (h, w, n, rows) in enumerate(shapes):
            for lanes in (1, 4):
                sc = track_scene(100 + i, h, w, n, lanes, rows, poison=True)
                x = track_inputs(sc, dev)
                single = lanes == 1
                pool = {k: v[0] for k, v in x["pool"].items()} if single \
                    else x["pool"]
                args = (pool, x["dI"][0] if single else x["dI"],
                        x["K"][0] if single else x["K"], x["T"],
                        x["aff_rel"], x["ref_b"], x["cutoff"], 9.0)
                kw = dict(packed=x["packed"], lane=None if single
                          else x["lane"])
                got, ref = hk.track_res_gs(*args, **kw), \
                    old.track_res_gs(*args, **kw)
                u = torch.cat([_ulps(got[k], ref[k]).reshape(-1)
                               for k in got if k != "n"])
                B = x["T"].shape[0]
                rng = np.random.default_rng(200 + i)

                def t(v, dtype=torch.float32):
                    return torch.as_tensor(np.asarray(v), dtype=dtype,
                                           device=dev)
                lam = t(np.array([1e-4, 0.01, 0.3, 1.0])[np.arange(B) % 4])
                aff = t(rng.normal(0, [0.02, 1.0], (B, 2)))
                ex = t(rng.uniform(0.8, 1.2, (B, 2) if lanes > 1 else (2,)))
                ra = t(rng.normal(0, [0.05, 2.0], (B, 2) if lanes > 1
                                  else (2,)))
                done = t(rng.random(B) < 0.3, torch.bool)
                n_it = t(rng.integers(0, 5, B), torch.int64)
                step_in = (ref["H"], ref["b"], lam, x["T"], aff, ex, ra)
                s_new = hk.lm_update_step(*step_in)
                s_old = old.lm_update_step(*step_in)
                step_same = all(same_bits(a, b)
                                for a, b in zip(s_new, s_old))
                r_new = hk.calc_res_gs_plain(args[0], args[1], args[2],
                                             s_new[0], s_new[2], x["ref_b"],
                                             x["cutoff"], 9.0, **kw)
                acc_in = (ref, r_new, x["T"], s_new[0], aff, s_new[1], lam,
                          done, n_it, s_new[3])

                def k4_new():
                    return hk.lm_update_accept_step(*acc_in, ex, ra)

                def k4_old():
                    if hasattr(old, "lm_update_accept_step"):
                        return old.lm_update_accept_step(*acc_in, ex, ra)
                    o = old.lm_update_accept(*acc_in)
                    st = old.lm_update_step(o["r"]["H"], o["r"]["b"],
                                            o["lam"], o["T"], o["aff"], ex,
                                            ra)
                    return dict(o, **dict(zip(hk.STEP_KEYS, st)))
                a_new, a_old = k4_new(), k4_old()
                flat_new = [a_new[k] for k in a_new if k != "r"] + \
                    list(a_new["r"].values())
                flat_old = [a_old[k] for k in a_new if k != "r"] + \
                    [a_old["r"][k] for k in a_new["r"]]
                iter_same = all(same_bits(a, b)
                                for a, b in zip(flat_new, flat_old))
                rec = dict(preset=preset, shape=[h, w, n, rows],
                           lanes=lanes,
                           k3_outputs=int(u.numel()),
                           k3_outputs_differing=int((u != 0).sum()),
                           k3_max_ulps=float(u.max()),
                           k3_counts_equal=torch.equal(got["n"], ref["n"]),
                           k4_step_bit_for_bit=step_same,
                           k4_iteration_bit_for_bit=iter_same)
                if (single and i < 2) or (not single and i == 0):
                    for tag, fn in (
                            ("baseline", lambda: old.track_res_gs(*args,
                                                                  **kw)),
                            ("current", lambda: hk.track_res_gs(*args,
                                                                **kw)),
                            ("current", lambda: hk.track_res_gs(*args,
                                                                **kw)),
                            ("baseline", lambda: old.track_res_gs(*args,
                                                                  **kw))):
                        rec.setdefault(f"k3_{tag}_device_ms", []).append(
                            device_ms(fn))
                        rec.setdefault(f"k3_{tag}_ms", []).append(
                            wrapper_ms(fn))
                    for tag, fn in (("baseline", k4_old),
                                    ("current", k4_new),
                                    ("current", k4_new),
                                    ("baseline", k4_old)):
                        rec.setdefault(f"k4_{tag}_device_ms", []).append(
                            device_ms(fn))
                        rec.setdefault(f"k4_{tag}_ms", []).append(
                            wrapper_ms(fn))
                    rec["k3_bound_ms"] = track_res_gs_bound(lanes, B, n)[0]
                    rec["k4_bound_ms"] = lm_update_bound(B)[0]
                print(json.dumps(rec), flush=True)
                rows_out.append(rec)
    return rows_out


def _replay_ms(stage, fn, inputs, static, n=20):
    """Mean device ms of one replay of `fn(inputs, **static)` as a stage
    program (a CUDA event pair around each graph replay,
    `device_loop.program_timing`), after its warm-up and capture; and its
    outputs."""
    from sdv_loam_tpu_torch.utils import device_loop as dl
    for _ in range(3):
        out = dl.program(stage, fn, inputs, static)
    with dl.program_timing() as timed:
        for _ in range(n):
            out = dl.program(stage, fn, inputs, static)
    t = timed[stage]
    return t["ms"] / t["replays"], out


def _fused_old(x, n_lanes, mod):
    """The baseline's matcher call: its fused call where it has one, else
    its patch warp, then its alignment."""
    if hasattr(mod, "warp_align"):
        return mod.warp_align(*x["a"], n_lanes=n_lanes, quad_stack=x["quad"])
    (wargs, wkw), align = split_warp_align(x["a"], dict(quad_stack=x["quad"]))
    patches = mod.warp_affine_patches(*wargs, **wkw)
    return mod.align_batch(*align(patches), n_lanes=n_lanes)


def _fused_new(x, n_lanes):
    from sdv_loam_tpu_torch.ops import hopper_kernels as hk
    return hk.warp_align(*x["a"], n_lanes=n_lanes, quad_stack=x["quad"])


def _baseline_align(root):
    """The baseline's `align_batch` and `warp_affine_patches`: its own
    kernels' wrappers (its `hopper_kernels`, its library built) where it
    has K5, else its `ops/align.py` (the batched loop and tensor
    operations, run through this tree's device_loop). Returns (module,
    kind): kind "kernels" or "loop"."""
    old = load_baseline(root)
    if "align_batch" in getattr(old, "DEVICE_COUNTED", ()):
        return old, "kernels"
    return _load_ops(root, "align"), "loop"


def _bits_differ(a, b):
    """Elements of two float32 tensors whose bits differ, NaN against NaN
    counted equal (the card makes NaN payloads of its own)."""
    same = (a.view(torch.int32) == b.view(torch.int32)) | \
        (torch.isnan(a) & torch.isnan(b))
    return int((~same).sum())


# the iteration caps of `compare_align`'s sweep at the default preset's
# pass 1: device time against n_iter gives an iteration's cost and the
# setup's
ALIGN_ITER_SWEEP = (0, 1, 2, 5, 10)


def compare_align(baseline_root, dev):
    """The fused K5 / K6 call (`warp_align`) against a baseline
    checkout's `warp_affine_patches` then `align_batch` (`_baseline_align`:
    its own K6 and K5 where it has them, else its tensor operations and
    batched loop) at ALIGN_SHAPES (one lane; the default preset's pass 1
    also with ALIGN_LANES), on warp_align_scene's inputs: outputs whose
    bits differ (px, NaN against NaN equal; flags; failure counts),
    converged rows; then each as a stage program (`device_loop.program`,
    as the track and keyframe programs run them), the replay's device ms,
    and each call's device time (`device_ms`: the baseline's two kernels
    together), in the order baseline, current, current, baseline; the
    fused call's bound; at the default preset's pass
    1 with one lane both calls' device time at each iteration cap of
    ALIGN_ITER_SWEEP."""
    from functools import partial

    from sdv_loam_tpu_torch.ops import hopper_kernels as hk
    from sdv_loam_tpu_torch.utils import device_loop as dl
    old, kind = _baseline_align(baseline_root)
    print(f"baseline warp_affine_patches + align_batch: {kind}", flush=True)
    hk.build_library()
    out = []
    with dl.use(dl.LoopCache()):
        for preset, ((h, w), calls) in ALIGN_SHAPES.items():
            for call, rows in calls.items():
                for lanes in (1, ALIGN_LANES):
                    if lanes != 1 and (preset, call) != ("default", "pass1"):
                        continue
                    args, kw = warp_align_args(warp_align_scene(
                        500 + rows, h, w, rows, lanes), dev)
                    x = dict(a=args, quad=kw["quad_stack"])
                    f_old = partial(_fused_old, mod=old)
                    a_old = f_old(x, lanes)
                    a_new = _fused_new(x, lanes)
                    (wargs, wkw), align = split_warp_align(args, kw)
                    it = align_iterations(align(
                        hk.warp_affine_patches_plain(*wargs, **wkw)))
                    rec = dict(
                        preset=preset, call=call, rows=rows, lanes=lanes,
                        baseline=kind,
                        px_differ=_bits_differ(a_old[0], a_new[0]),
                        flags_differ=int((a_old[1] != a_new[1]).sum()),
                        fails_differ=int((a_old[2] != a_new[2]).sum()),
                        converged=int(a_new[1].sum()),
                        fails=[a_old[2].tolist(), a_new[2].tolist()],
                        sampled_iterations=it["sampled_iterations"],
                        bound_ms=warp_align_bound(
                            rows * lanes, it["valid_rows"],
                            it["sampled_iterations"], it["quad_rows"],
                            warp_quad_rows(wargs, kw["quad_stack"]))[0])
                    tag = f"{preset}_{call}_{lanes}"
                    for side, fn in (("baseline", f_old),
                                     ("current", _fused_new),
                                     ("current", _fused_new),
                                     ("baseline", f_old)):
                        rec.setdefault(f"{side}_replay_ms", []).append(
                            _replay_ms(f"wa_{side}_{tag}", fn, x,
                                       dict(n_lanes=lanes))[0])
                        rec.setdefault(f"{side}_device_ms", []).append(
                            device_ms(lambda: fn(x, lanes)))
                    if (preset, call, lanes) == ("default", "pass1", 1):
                        sweep = {}
                        for n in ALIGN_ITER_SWEEP:
                            for side, fn in (("baseline", f_old),
                                             ("current", _fused_new)):
                                def run(fn=fn, n=n):
                                    if fn is _fused_new:
                                        return hk.warp_align(
                                            *args, n_iter=n, **kw)
                                    patches = old.warp_affine_patches(
                                        *wargs, **wkw)
                                    return old.align_batch(
                                        *align(patches), n_iter=n)
                                sweep.setdefault(str(n), {})[side] = \
                                    device_ms(run)
                        rec["n_iter_device_ms"] = sweep
                    print(json.dumps(rec), flush=True)
                    out.append(rec)
    return out


# The baseline's eager slice: chip_smoke.py phase 4's 30 frames of scene A
# (1200x360, the default Settings) under `device_loop.reference()`, run in
# the baseline checkout's own process (its package on the path), which
# prints its "align" loop's calls and iterations and how many calls ran
# each count of iterations; in a checkout whose card runs K5 (no loop),
# K5's launches as the calls and no iterations
_ALIGN_COUNTS = """
import json, sys
sys.path.insert(0, {root!r})
import chip_smoke
from sdv_loam_tpu_torch.config import Settings
from sdv_loam_tpu_torch.data.synthetic import make_sequence
from sdv_loam_tpu_torch.ops import hopper_kernels as hk
from sdv_loam_tpu_torch.system.full_system import FullSystem
from sdv_loam_tpu_torch.utils import device_loop as dl
n = {frames}
k5 = "align_batch" in getattr(hk, "DEVICE_COUNTED", ())
seq = make_sequence(n_frames=n, **chip_smoke.SCENE,
                    **chip_smoke.FLEET_SCENES["A"])
frames = chip_smoke.render(seq, n)
fs = FullSystem(seq.calib, seq.sensor, Settings(), device="cuda")
dl.reset_counts()
if k5:
    hk.reset_launch_counts()
with dl.reference():
    for fr in frames:
        fs.add_active_frame(*fr)
c = dl.counts().get("align", {{}})
if k5:
    calls = hk.device_launches()["align_batch"]
    out = dict(frames=n, loop=False, calls=calls, iterations=None,
               calls_per_frame=calls / n, iterations_per_frame=None,
               align_loop_calls=c.get("calls", 0))
else:
    out = dict(frames=n, loop=True, calls=c.get("calls", 0),
               iterations=c.get("iters", 0),
               calls_per_frame=c.get("calls", 0) / n,
               iterations_per_frame=c.get("iters", 0) / n,
               iterations_hist=dict(sorted(dl.HIST.get("align", {{}})
                                           .items())))
print("ALIGN_COUNTS " + json.dumps(out))
"""


def baseline_align_counts(root, frames=30):
    """The baseline checkout's eager `align_batch` over phase 4's frames:
    with its "align" loop (`loop` true), calls and iterations in all and
    per frame and the calls per count of iterations; where its card runs
    K5 (`loop` false), K5's launches as the calls, iterations None, and
    the loop calls it recorded (`align_loop_calls`, 0 unless it still ran
    a loop on the card). A child process in `root`."""
    proc = subprocess.run(
        [sys.executable, "-c", _ALIGN_COUNTS.format(root=root,
                                                    frames=frames)],
        cwd=root, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the baseline's eager slice failed:\n"
                           f"{proc.stderr[-4000:]}")
    line = [x for x in proc.stdout.splitlines()
            if x.startswith("ALIGN_COUNTS ")][-1]
    return json.loads(line[len("ALIGN_COUNTS "):])


def _pyr_equal(a, b):
    return all(torch.equal(x, y) for (ai, aw), (bi, bw) in zip(a, b)
               for x, y in ((ai, bi), (aw, bw)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline",
                    help="root of the checkout to compare with")
    ap.add_argument("--out", default=None)
    ap.add_argument("--track", action="store_true",
                    help="K3 and K4 instead of K1 and K2")
    ap.add_argument("--align", action="store_true",
                    help="K5 and K6 instead of K1 and K2, and the "
                    "baseline's align loop counts over phase 4's frames")
    ap.add_argument("--ba", action="store_true",
                    help="K7 and K8 against their plain versions (no "
                    "baseline)")
    args = ap.parse_args()
    if args.baseline is None and not args.ba:
        ap.error("--baseline is required")
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    # the current device, by ordinal (the timers synchronize and profile
    # it; CUDA_VISIBLE_DEVICES picks another card)
    device = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        torch.cuda.get_device_name(device)
    print(f"{card}; timing on {device}, {torch.cuda.get_device_name(device)}",
          flush=True)
    if args.ba:
        rows = time_ba(device)
    elif args.align:
        rows = compare_align(os.path.abspath(args.baseline), device)
        counts = baseline_align_counts(os.path.abspath(args.baseline))
        print("baseline align loop, phase 4's frames: " + json.dumps(counts),
              flush=True)
        rows.append(dict(name="baseline_align_counts", **counts))
    elif args.track:
        rows = compare_track(os.path.abspath(args.baseline), device)
        if not all(r["k3_counts_equal"] for r in rows):
            sys.exit("K3's counts disagree with the baseline's")
    else:
        rows = compare(os.path.abspath(args.baseline), device)
        if not all(r["equal"] for r in rows):
            sys.exit("a kernel disagrees with the baseline")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, rows=rows), f, indent=1)


if __name__ == "__main__":
    main()
