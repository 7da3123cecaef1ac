"""Hand-written Hopper kernels and their plain PyTorch versions.

Counterpart of `sdv_loam_tpu/ops/pallas_kernels.py`, whose two Pallas TPU
kernels are both on the odometry main path, and of the tracking LM's body,
which the JAX package leaves to XLA to fuse:

  * `dilate_pyramid` (K1, csrc/dilate_pyramid.cu) replaces the chain of
    `dilate_depth_pallas` calls in `build_track_ref`: the hole-filling
    pass of every pyramid level and the 2x2 sum-pools between them, in one
    launch per `build_track_ref`;
  * `distance_transform` (K2, csrc/distance_transform.cu) replaces
    `distance_transform_pallas`: the chamfer distance map behind the
    activation spread test, one launch per keyframe.

  * `track_res_gs` (K3, csrc/track_res_gs.cu) computes
    `photometric.calc_res_gs` (the JAX package's `calc_res_gs`,
    sdv_loam_tpu/ops/photometric.py:162): the residual and the scaled 8x8
    system of B pose rows, each row reading its lane's pool directly;
  * `lm_update_step` and `lm_update_accept_step` (K4, two entry points
    of csrc/track_lm_update.cu) compute the rest of the tracking LM
    (`photometric._lm_body`; the JAX package's LM body,
    sdv_loam_tpu/ops/photometric.py:310): the damped solve and the pose
    step of an LM call's first iteration, then per iteration after K3 the
    accept test and the per-row selects with the next iteration's step,
    in one launch;
  * `warp_align` (K5 with K6 as its prologue, csrc/align_batch.cu)
    computes the matcher's patch warp and patch alignment in one kernel,
    a warp per candidate (a call is two launches: a one-block kernel
    zeroing the failure counts, then the fused kernel): K6, the JAX
    package's `warp_affine_patches` (sdv_loam_tpu/ops/align.py:147),
    samples each candidate's 10x10 border patch from its host image
    through the inverse affine warp into shared memory; K5, its `align_batch` (sdv_loam_tpu/ops/align.py:319, a
    `lax.while_loop`), runs the candidate's whole inverse-compositional
    Gauss-Newton loop on it. `warp_affine_patches` (the patches alone)
    and `align_batch` (given patches) reach the same kernel in a mode of
    their own.
  * `ba_linearize` (K7, csrc/ba_linearize.cu) computes the windowed BA's
    residual linearization given its photometric gate (the JAX package's
    XLA-fused `linearize_residuals`, sdv_loam_tpu/models/backend.py), a
    thread per (lane, point, target) residual, the lane's pairs staged in
    shared memory; `ba_accumulate` (K8, csrc/ba_accumulate.cu) the BA's
    accumulation (the same file's `_accumulate` and `_stitch`): per-tile
    pair and Schur sums, their sum in tile order, and the transport to
    the absolute system, three launches a call. Their plain versions are
    `models/backend.linearize_residuals_lanes_plain` and
    `backend._accumulate_plain`, and `backend` dispatches by device.

K1 and K2 take one map (H, W) or a stack of lanes (L, H, W) and compute
each lane as the single-map call would. K3 and K4 take B rows; a row's
result does not depend on the other rows (each row's sums run in a fixed
order, csrc/track_res_gs.cu; K4 solves each row in its own warp). K5 and
K6 take M candidate rows, each computed on its own (K5 runs each row's
loop to that row's own stop, which is what the plain version's batched
loop gives the row: a row that has stopped keeps its carries). K7 and K8
take L windows; a window's outputs do not depend on the other windows
(K8's sums run in an order fixed by N and F alone).

Dispatch: a CPU tensor goes to the plain version beside each kernel; a CUDA
tensor goes to the kernel, and a failed build or launch raises. There is no
fallback from the kernel to the plain version.

The kernels are compiled with nvcc for sm_90a into a shared library with a
plain C interface (bound with ctypes) under `sdv_loam_tpu_torch/build/`, at
the first CUDA call, from the sources in `csrc/` only; a change of any
source's hash builds a new library. Importing this module never needs nvcc.

`LAUNCHES` counts K1's and K2's launches the card ran (plain-version calls
do not count), so a run can show that the main path went through the
kernels; `LANES` counts the lanes (maps) those launches took, so a fleet
run can show its launches took several sequences at once. A wrapper called
while a stage program is being captured (utils/device_loop.program)
launches nothing then: the capture records the launch, and every replay of
the program counts it. K3 and K4 run inside the programs' IF and WHILE
nodes, where a replay decides on the card how often they run, so they
count themselves on the card: one thread of each launch adds one to the
kernel's device counter; so does the K5 / K6 kernel, which runs inside
the keyframe program's IF nodes (the second matcher pass), one counter
per mode, and so do K7 and K8, which run inside the keyframe program's
WHILE nodes (the windowed LM), one count per call. `device_launches()`
reads those counters (a device synchronize: only for a caller that asks, never
on the frame path), `launch_counts()` gives every kernel's counts, and
`reset_launch_counts()` zeroes both kinds.

The same library holds csrc/graph_cond.cu, the conditional (IF and WHILE)
nodes of the captured stage programs (`sdv_cond_begin`, `sdv_cond_set`,
`sdv_cond_end`, `sdv_capture_nodes`, used by utils/device_loop).

Threads: each launch goes to the calling thread's current stream (a fleet
system's own stream), the counts are updated under a lock, and the first
build and load happen once, under another.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

import torch

from sdv_loam_tpu_torch.ops.warp import (bilinear_sample_packed,
                                         pack_bilinear, quad_bilinear,
                                         quad_from_image)
from sdv_loam_tpu_torch.utils import device_loop, se3

LAUNCHES = {"dilate_pyramid": 0, "distance_transform": 0}
LANES = {"dilate_pyramid": 0, "distance_transform": 0}
# the kernels that count their launches on the card
DEVICE_COUNTED = ("track_res_gs", "track_lm_update", "align_batch",
                  "warp_patches", "ba_linearize", "ba_accumulate")

STEP_SCALE = (1.0, 1.0, 1.0, 0.5, 0.5, 0.5, 10.0, 1000.0)
LAMBDA_EXTRAPOLATION_LIMIT = 0.001
# a residual evaluation's outputs, the LM's `r_*` carries
RES_KEYS = ("E", "n", "sat_frac", "H", "b", "flow_t", "flow_rt")
# K4's step outputs, the LM's proposed step (carried into the next
# iteration)
STEP_KEYS = ("T_new", "aff_new", "aff_rel", "inc")

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
SOURCES = ("dilate_pyramid.cu", "distance_transform.cu", "graph_cond.cu",
           "track_res_gs.cu", "track_lm_update.cu", "align_batch.cu",
           "ba_linearize.cu", "ba_accumulate.cu")
# -Xptxas=-v: ptxas's report (registers, spills, shared memory per kernel),
# kept beside the library (`build_report`)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
DILATE_MAX_LEVELS = 8   # levels one K1 launch takes (csrc/dilate_pyramid.cu)
# the matcher's patches (Reprojector.cpp align2D): the 8x8 patch, its
# 10x10 border patch, and the alignment's convergence threshold (px^2)
HALF_PATCH = 4
PATCH = 8
BORDER_PATCH = PATCH + 2
MIN_UPDATE_SQ = 0.03 * 0.03
# the windowed BA's frame slots K7 and K8 take (csrc/ba_*.cu, kMaxF)
BA_MAX_FRAMES = 8

_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()
# the CUDA devices K3-K8 launched on (whose counters a read visits)
_counted_devices: set = set()
# the device counters: (the library's reader, how many counters it reads)
_COUNTERS = (("sdv_track_res_gs_counts", 1),
             ("sdv_track_lm_update_counts", 2),
             ("sdv_warp_align_counts", 4),
             ("sdv_ba_linearize_counts", 1),
             ("sdv_ba_accumulate_counts", 1))


def reset_launch_counts() -> None:
    """Zero `LAUNCHES`, `LANES` and the device counters of K3-K8 (after a
    device synchronize)."""
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
            LANES[k] = 0
    _device_counts(reset=True)


def _device_counts(reset: bool = False):
    """(K3 launches, K4 step launches, K4 accept-step launches, the fused
    K5 / K6 kernel's launches in MODE_FUSED, MODE_ALIGN and MODE_PATCHES,
    the launches of the kernel zeroing its failure counts, K7's launches,
    K8's calls) summed over the devices that launched them,
    read from their counters after a device synchronize; zeroed after the
    read with `reset`."""
    tot = [0] * sum(n for _, n in _COUNTERS)
    if _lib is None:
        return tot
    for d in sorted(_counted_devices):
        with torch.cuda.device(d):
            torch.cuda.synchronize()
            got = []
            for fn, n in _COUNTERS:
                c = (ctypes.c_ulonglong * n)()
                _check_rc(getattr(_lib, fn)(c, int(reset)), f"reading {fn}")
                got.extend(c)
        tot = [a + b for a, b in zip(tot, got)]
    return tot


def device_launches() -> dict:
    """The launches K3-K8 counted on the card since the last reset: per
    kernel (K4's two entry points together), and K4's `lm_step` (one per
    LM call) and `lm_accept_step` (one per LM iteration) apart. K5 and K6
    are one kernel (csrc/align_batch.cu): `align_batch` counts its
    launches that aligned (the fused call and the given-patch mode),
    `warp_patches` those that warped patches (the fused call and the
    patches-only mode), and `warp_align` the fused calls alone, so a
    fused launch counts in all three; `align_zero` the one-block kernel
    that zeroes the failure counts before every aligning launch (as many
    as `align_batch`'s); `ba_linearize` K7's launches (one per BA
    linearization) and `ba_accumulate` K8's calls (one per BA system
    build or point marginalization; each call is three launches).
    Synchronizes."""
    (k3, step, accept_step, fused, align, patches, zero, k7,
     k8) = _device_counts()
    return {"track_res_gs": k3, "track_lm_update": step + accept_step,
            "lm_step": step, "lm_accept_step": accept_step,
            "align_batch": fused + align, "warp_patches": fused + patches,
            "warp_align": fused, "align_zero": zero, "ba_linearize": k7,
            "ba_accumulate": k8}


def launch_counts() -> dict:
    """Every kernel's launches: `LAUNCHES` (K1, K2) and the device
    counters (K3-K8; a fused K5 / K6 launch counts for both, a K8 call
    once). Synchronizes."""
    dev = device_launches()
    with _count_lock:
        out = dict(LAUNCHES)
    out.update({k: dev[k] for k in DEVICE_COUNTED})
    return out


def _count_launch(name: str, lanes: int = 1) -> None:
    log = device_loop.launch_log()
    if log is not None:         # captured: each replay counts it
        log.append((name, lanes))
        return
    count_launches([(name, lanes)])


def count_launches(launches) -> None:
    """Count launches given as (name, lanes) pairs (a replayed program's
    recorded launches)."""
    if not launches:
        return
    with _count_lock:
        for name, lanes in launches:
            LAUNCHES[name] += 1
            LANES[name] += lanes


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the reference the kernels are
# compared with on the card)
# ---------------------------------------------------------------------------

def _shift(x, dy, dx, fill):
    """out[..., y, x] = x[..., y + dy, x + dx], `fill` outside the image."""
    h, w = x.shape[-2:]
    out = torch.full_like(x, fill)
    ys = slice(max(0, -dy), min(h, h - dy))
    xs = slice(max(0, -dx), min(w, w - dx))
    yd = slice(max(0, dy), min(h, h + dy))
    xd = slice(max(0, dx), min(w, w + dx))
    out[..., ys, xs] = x[..., yd, xd]
    return out


# neighbour offsets (dy, dx) in the TPU kernel's summation order
_DIAG_ORDER = ((1, 1), (-1, -1), (1, -1), (-1, 1))     # ul, dr, ur, dl
_CROSS_ORDER = ((0, -1), (0, 1), (-1, 0), (1, 0))      # r, l, d, u


def dilate_depth_plain(idepth: torch.Tensor, weight: torch.Tensor,
                       diagonal: bool):
    """One hole-filling pass over (..., H, W) maps, zero fill outside the
    image, summed in the TPU kernel's order (`_dilate_kernel`)."""
    ssum = torch.zeros_like(idepth)
    nsum = torch.zeros_like(idepth)
    cnt = torch.zeros_like(idepth)
    zero = torch.zeros((), dtype=idepth.dtype, device=idepth.device)
    for dy, dx in (_DIAG_ORDER if diagonal else _CROSS_ORDER):
        si = _shift(idepth, dy, dx, 0.0)
        sw = _shift(weight, dy, dx, 0.0)
        filled = sw > 0
        ssum = ssum + torch.where(filled, si, zero)
        nsum = nsum + torch.where(filled, sw, zero)
        cnt = cnt + filled.to(idepth.dtype)
    fill_ok = (weight <= 0) & (cnt > 0)
    denom = torch.clamp(cnt, min=1.0)
    return (torch.where(fill_ok, ssum / denom, idepth),
            torch.where(fill_ok, nsum / denom, weight))


def sum_pool2(x):
    """2x2 sum-pool of (..., H, W) maps, the odd row and column cropped."""
    h, w = x.shape[-2:]
    x = x[..., : (h // 2) * 2, : (w // 2) * 2]
    # (row-0 pair) + (row-1 pair): the order XLA sums this 2x2 window in
    # the JAX package's build_track_ref (make_images' pooling sums left to
    # right instead), so the pools agree bit for bit
    return ((x[..., 0::2, 0::2] + x[..., 0::2, 1::2])
            + (x[..., 1::2, 0::2] + x[..., 1::2, 1::2]))


def dilate_pyramid_plain(idepth0: torch.Tensor, weight0: torch.Tensor,
                         levels: int):
    """The hole-filling chain of `build_track_ref`: level 0 dilated, then
    per coarser level the 2x2 sum-pool of the level above and its pass
    (diagonal on levels 0-1, the cross on coarser ones). Returns a tuple
    over levels of (idepth, weight), each (..., H_l, W_l)."""
    out = []
    idl, wl = idepth0, weight0
    for lvl in range(levels):
        if lvl > 0:
            idl, wl = sum_pool2(idl), sum_pool2(wl)
        idl, wl = dilate_depth_plain(idl, wl, diagonal=(lvl < 2))
        out.append((idl, wl))
    return tuple(out)


def distance_transform_plain(seed: torch.Tensor, iters: int = 32):
    """`iters` sweeps of 8-neighbour min-plus (+1) relaxation over (..., H,
    W) maps, 1000 outside the image (`_distmap_kernel` /
    `distmap._relax_jnp`)."""
    h, w = seed.shape[-2:]
    d = seed
    for _ in range(iters):
        p = torch.nn.functional.pad(d, (1, 1, 1, 1), value=1000.0)
        m = d
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                m = torch.minimum(m, p[..., 1 + dy:1 + dy + h,
                                       1 + dx:1 + dx + w] + 1.0)
        d = torch.minimum(d, m)
    return d


def _step_scale(like):
    """STEP_SCALE on `like`'s device and dtype (made once)."""
    return device_loop.constant(STEP_SCALE, like.device, like.dtype)


def aff_transfer(exposure_ref, exposure_new, aff_ref, aff_new):
    """AffLight::fromToVecExposure: (a, b) with I_new ~ a * I_ref + b.
    `aff_new` may carry leading batch dimensions (..., 2); `aff_ref` and
    the exposures are one frame's or carry the same leading dimensions."""
    zero = (exposure_ref == 0) | (exposure_new == 0)
    one = torch.ones_like(exposure_ref)
    er = torch.where(zero, one, exposure_ref)
    en = torch.where(zero, one, exposure_new)
    a = torch.exp(aff_new[..., 0] - aff_ref[..., 0]) * en / er
    b = aff_new[..., 1] - a * aff_ref[..., 1]
    return torch.stack([a, b], dim=-1)


def select_rows(mask, new, old):
    """Per-lane select over a dict or tensor with leading batch dim."""
    if isinstance(new, dict):
        return {k: select_rows(mask, new[k], old[k]) for k in new}
    m = mask.reshape(mask.shape + (1,) * (new.dim() - 1))
    return torch.where(m, new, old)


def _lane_inputs(pool, K, B, lane, device):
    """(pool fields (B, N), K (B, 4), lane) for B rows: each row reads its
    lane's pool; one lane's (N,) pool runs as lane 0."""
    if lane is None:
        pool = {k: pool[k][None] for k in ("u", "v", "idepth", "color",
                                           "valid")}
        K = K[None]
        lane = torch.zeros(B, dtype=torch.int64, device=device)
    rows = {k: pool[k].index_select(0, lane)
            for k in ("u", "v", "idepth", "color", "valid")}
    return rows, K.index_select(0, lane), lane


def calc_res_gs_plain(pool, dI_new, K, T_ref_to_new, aff_rel, ref_aff_b,
                      cutoff, huber_th, packed=None, lane=None, hw=None):
    """K3's plain version: `photometric.calc_res_gs` in tensor operations
    (see there for the arguments)."""
    h, w = hw if hw is not None else (dI_new.shape[-3], dI_new.shape[-2])
    if packed is None:
        packed = pack_bilinear(dI_new)
    B = T_ref_to_new.shape[0]
    dev = T_ref_to_new.device
    rows, Kb, lane = _lane_inputs(pool, K, B, lane, dev)
    u0, v0 = rows["u"], rows["v"]                                    # (B,N)
    idp, color, valid = rows["idepth"], rows["color"], rows["valid"]
    fx, fy, cx, cy = (Kb[:, i:i + 1] for i in range(4))              # (B,1)
    cutoff = torch.as_tensor(cutoff, dtype=torch.float32,
                             device=dev).expand(B)[:, None]
    ref_aff_b = torch.as_tensor(ref_aff_b, dtype=torch.float32,
                                device=dev).expand(B)[:, None]

    xn = (u0 - cx) / fx
    yn = (v0 - cy) / fy
    R = T_ref_to_new[:, :3, :3]
    t = T_ref_to_new[:, :3, 3]
    p = torch.stack([xn, yn, torch.ones_like(xn)], dim=-1)         # (B,N,3)
    pr = torch.einsum("bnj,bij->bni", p, R)                          # p @ R^T
    pt = pr + t[:, None, :] * idp[:, :, None]                        # (B,N,3)
    u = pt[..., 0] / pt[..., 2]
    v = pt[..., 1] / pt[..., 2]
    Ku = fx * u + cx
    Kv = fy * v + cy
    new_idepth = idp / pt[..., 2]

    inb = valid & (Ku > 2) & (Kv > 2) & (Ku < w - 3) & (Kv < h - 3) \
        & (new_idepth > 0)
    hit, hit_ok = bilinear_sample_packed(packed, h, w, Ku, Kv,
                                         base=lane[:, None] * (h * w))
    inb = inb & hit_ok & torch.isfinite(hit[..., 0])

    r = hit[..., 0] - (aff_rel[:, 0:1] * color + aff_rel[:, 1:2])
    absr = torch.abs(r)
    one = torch.ones_like(absr)
    hw = torch.where(absr < huber_th, one,
                     huber_th / torch.clamp(absr, min=1e-12))
    saturated = inb & (absr > cutoff)
    inlier = inb & (absr <= cutoff)
    zero = torch.zeros_like(absr)

    max_energy = 2.0 * huber_th * cutoff - huber_th * huber_th       # (B,1)
    E = torch.where(inlier, hw * r * r * (2.0 - hw), zero).sum(-1) + \
        torch.where(saturated, max_energy.expand_as(absr), zero).sum(-1)
    n_terms = inb.sum(-1)
    sat_frac = saturated.sum(-1) / torch.clamp(n_terms, min=1)

    dxf = hit[..., 1] * fx
    dyf = hit[..., 2] * fy
    idn = new_idepth
    J = torch.stack([
        idn * dxf,
        idn * dyf,
        -idn * (u * dxf + v * dyf),
        -(u * v * dxf + (1.0 + v * v) * dyf),
        u * v * dyf + (1.0 + u * u) * dxf,
        u * dyf - v * dxf,
        aff_rel[:, 0:1] * (ref_aff_b - color),
        -torch.ones_like(u),
    ], dim=-1)                                                        # (B,N,8)
    wgt = torch.where(inlier, hw, zero)
    n_in = torch.clamp(inlier.sum(-1), min=1).to(J.dtype)
    Jw = J * wgt[..., None]
    Hm = (J.transpose(1, 2) @ Jw) / n_in[:, None, None]
    bv = (Jw.transpose(1, 2) @ r[..., None])[..., 0] / n_in[:, None]
    S = _step_scale(J)
    Hm = Hm * S[:, None] * S[None, :]
    bv = bv * S

    # flow indicators (calcRes:538-565): every 32nd pool slot
    m = valid & (torch.arange(u0.shape[1], device=dev) % 32 == 0)
    ti = t[:, None, :] * idp[:, :, None]
    ptT = p + ti
    ptT2 = p - ti
    pt3 = pr - ti

    def pix_shift(q):
        uu = fx * (q[..., 0] / q[..., 2]) + cx
        vv = fy * (q[..., 1] / q[..., 2]) + cy
        return (uu - u0) ** 2 + (vv - v0) ** 2

    num = m.sum(-1) * 2.0
    zf = torch.zeros((), dtype=u.dtype, device=dev)
    flow_t = torch.where(m, pix_shift(ptT) + pix_shift(ptT2), zf).sum(-1) \
        / (num + 0.1)
    flow_rt = torch.where(m, pix_shift(pt) + pix_shift(pt3), zf).sum(-1) \
        / (num + 0.1)
    return dict(E=E, n=n_terms, sat_frac=sat_frac, H=Hm, b=bv,
                flow_t=flow_t, flow_rt=flow_rt)


def _solve_scaled(H, b, lam):
    """LM-damped solve of the scaled (B, 8, 8) systems; lam (B,)."""
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    Hl = H + torch.diag_embed(diag) * lam[:, None, None] + eye * 1e-12
    inc = torch.linalg.solve_ex(Hl, -b)[0]
    extrap = torch.where(
        lam < LAMBDA_EXTRAPOLATION_LIMIT,
        torch.sqrt(torch.sqrt(LAMBDA_EXTRAPOLATION_LIMIT
                              / torch.clamp(lam, min=1e-12))),
        torch.ones_like(lam))
    inc = inc * extrap[:, None]
    return torch.where(torch.isfinite(inc), inc, torch.zeros_like(inc))


def lm_update_step_plain(H, b, lam, T, aff, exposures, ref_aff):
    """K4's first half in tensor operations: the damped solve of each row's
    scaled system (H (B, 8, 8), b (B, 8), lam (B,)), the pose and affine
    step from T (B, 4, 4) and aff (B, 2), and the brightness transfer of
    the new affine from `ref_aff` and `exposures` ((2,), or (B, 2) per
    row). Returns (T_new, aff_new, aff_rel, inc): the step `inc` (B, 8)
    before STEP_SCALE."""
    inc = _solve_scaled(H, b, lam)
    inc_scaled = inc * _step_scale(inc)
    T_new = se3.se3_exp(inc_scaled[:, :6]) @ T
    aff_new = aff + inc_scaled[:, 6:]
    aff_rel = aff_transfer(exposures[..., 0], exposures[..., 1], ref_aff,
                           aff_new)
    return T_new, aff_new, aff_rel, inc


def lm_update_accept_plain(r, r_new, T, T_new, aff, aff_new, lam, done,
                           n_it, inc):
    """K4's second half in tensor operations: rows not `done` take the new
    state where its energy per term is lower; lambda halves on an accept
    and grows fourfold (at least to the limit) on a reject; a row is done
    once its step's norm is not above 1e-3. `r`, `r_new`: residual dicts
    (RES_KEYS). Returns dict(r, T, aff, lam, done, n_it, active), `active`
    a () bool: whether any row still runs."""
    act = ~done
    accept = (r_new["E"] / torch.clamp(r_new["n"], min=1)) < \
        (r["E"] / torch.clamp(r["n"], min=1))
    acc = accept & act
    T = select_rows(acc, T_new, T)
    aff = select_rows(acc, aff_new, aff)
    lam_n = torch.where(accept, lam * 0.5,
                        torch.clamp(lam * 4.0,
                                    min=LAMBDA_EXTRAPOLATION_LIMIT))
    lam = torch.where(act, lam_n, lam)
    r = select_rows(acc, r_new, r)
    done = done | (act & ~(torch.linalg.vector_norm(inc, dim=-1) > 1e-3))
    n_it = n_it + act.to(torch.int64)
    return dict(r=r, T=T, aff=aff, lam=lam, done=done, n_it=n_it,
                active=(~done).any())


def lm_update_accept_step_plain(r, r_new, T, T_new, aff, aff_new, lam, done,
                                n_it, inc, exposures, ref_aff):
    """K4's fused entry in tensor operations: `lm_update_accept_plain`,
    then `lm_update_step_plain` from the carries it selected (every row,
    done or not). Returns the accept's dict with the next step's T_new,
    aff_new, aff_rel and inc."""
    o = lm_update_accept_plain(r, r_new, T, T_new, aff, aff_new, lam, done,
                               n_it, inc)
    step = lm_update_step_plain(o["r"]["H"], o["r"]["b"], o["lam"], o["T"],
                                o["aff"], exposures, ref_aff)
    return dict(o, **dict(zip(STEP_KEYS, step)))


def _patch_offsets(n, device, dtype=torch.float32):
    ar = torch.arange(n, device=device)
    ys = ar[:, None].expand(n, n).reshape(-1)
    xs = ar[None, :].expand(n, n).reshape(-1)
    return xs.to(dtype), ys.to(dtype)


def warp_samples(h, w, px_ref, A_cur_ref, search_level):
    """The 10x10 border patch's points in an (h, w) host image: inside
    the image (M, 100), and the clamped sample points xc, yc (M, 100)."""
    Ainv = torch.linalg.inv_ex(A_cur_ref)[0]
    Ainv = torch.where(torch.isfinite(Ainv), Ainv, torch.zeros_like(Ainv))
    xs, ys = _patch_offsets(BORDER_PATCH, px_ref.device)
    offs = torch.stack([xs, ys], dim=-1) - (HALF_PATCH + 1)
    scale = torch.pow(2.0, search_level.to(torch.float32))
    px_patch = offs[None, :, :] * scale[:, None, None]
    src = torch.einsum("mij,mpj->mpi", Ainv, px_patch) + px_ref[:, None, :]
    x = src[..., 0]
    y = src[..., 1]
    ok = (x >= 0) & (y >= 0) & (x < w - 1) & (y < h - 1)
    return ok, torch.clamp(x, 0.0, w - 1.001), torch.clamp(y, 0.0, h - 1.001)


def warp_affine_patches_plain(dI_ref0_stack, host_idx, px_ref, A_cur_ref,
                              search_level, quad_stack=None):
    """K6's plain version: `align.warp_affine_patches` in tensor
    operations (see there for the arguments)."""
    h, w = dI_ref0_stack.shape[1:3]
    ok, xc, yc = warp_samples(h, w, px_ref, A_cur_ref, search_level)
    if quad_stack is None:
        quad_stack = _stack_quads(dI_ref0_stack)
    base = (host_idx.to(torch.int64) * (h * w))[:, None]
    inten = quad_bilinear(quad_stack, base, w, xc, yc)
    inten = torch.where(ok, inten, torch.zeros_like(inten))
    return inten.reshape(-1, BORDER_PATCH, BORDER_PATCH)


def _stack_quads(dI_ref0_stack):
    """The (F*H*W, 4) quad pack of an (F, H, W, 3) stack's intensities."""
    return torch.cat([quad_from_image(im[..., 0]) for im in dI_ref0_stack],
                     dim=0)


def _patch_grads(border_patch):
    """Reference-patch gradients from the 10x10 border patch (align2D)."""
    inner = border_patch[:, 1:-1, 1:-1]
    dx = 0.5 * (border_patch[:, 1:-1, 2:] - border_patch[:, 1:-1, :-2])
    dy = 0.5 * (border_patch[:, 2:, 1:-1] - border_patch[:, :-2, 1:-1])
    m = border_patch.shape[0]
    return inner.reshape(m, -1), dx.reshape(m, -1), dy.reshape(m, -1)


def align_samples(x, u, v):
    """Each row's in-bounds test of floor(u), floor(v) against its level
    (M,) and its 8x8 patch's sample points xx, yy (M, 64)."""
    wv, hv = x["wv"], x["hv"]
    po_x, po_y = _patch_offsets(PATCH, u.device)
    po_x = po_x - HALF_PATCH
    po_y = po_y - HALF_PATCH
    ur = torch.floor(u)
    vr = torch.floor(v)
    inb = ((ur >= HALF_PATCH) & (vr >= HALF_PATCH)
           & (ur < wv[:, 0] - HALF_PATCH) & (vr < hv - HALF_PATCH))
    xx = torch.minimum(torch.clamp(u[:, None], min=HALF_PATCH),
                       (wv - HALF_PATCH).to(u.dtype)) + po_x[None, :]
    yy = torch.minimum(torch.clamp(v[:, None], min=HALF_PATCH),
                       (hv[:, None] - HALF_PATCH).to(v.dtype)) + po_y[None, :]
    return inb, xx, yy


def align_body(x, st):
    """One Gauss-Newton step of every candidate still running (alive,
    valid, not converged); the others keep every carry."""
    u, v, conv, alive = st["u"], st["v"], st["conv"], st["alive"]
    valid, is_edge, direction = x["valid"], x["is_edge"], x["direction"]
    running = alive & valid & (~conv)
    inb, xx, yy = align_samples(x, u, v)
    act = running & inb
    cur = quad_bilinear(x["quad_pyr"], x["base"], x["wv"], xx, yy)
    res = cur - x["target"] + st["mean_diff"][:, None]
    Jres = -torch.einsum("mp,mpi->mi", res, x["J"])
    upd = torch.einsum("mij,mj->mi", x["Hinv"], Jres)
    upd = torch.where(act[:, None], upd, torch.zeros_like(upd))
    du = torch.where(is_edge, upd[:, 0] * direction[:, 0], upd[:, 0])
    dv = torch.where(is_edge, upd[:, 0] * direction[:, 1], upd[:, 1])
    dmd = torch.where(is_edge, upd[:, 1], upd[:, 2])
    step_sq = upd[:, 0] ** 2 + upd[:, 1] ** 2
    conv = conv | (act & (step_sq < MIN_UPDATE_SQ))
    # a candidate leaves when it walks out of bounds; one that has stopped
    # keeps its state (the reference's per-candidate loop has ended)
    alive = torch.where(running, inb, alive)
    st = dict(u=u + du, v=v + dv, mean_diff=st["mean_diff"] + dmd,
              conv=conv, alive=alive)
    return st, (alive & valid & (~conv)).any()


def align_setup(quad_pyr, offsets, widths, heights, search_level,
                border_patch, px_init_scaled, direction, is_edge, aff_a,
                aff_b, valid):
    """The plain alignment's loop inputs and first carries (x, st) for
    `align_body`: the reference patch, its Jacobian J (M, 64, 3), the
    inverse of H = J^T J + 1e-9 I, each row's level table entries."""
    border_patch = border_patch.to(torch.float32)
    px_init_scaled = px_init_scaled.to(torch.float32)
    aff_a = aff_a.to(torch.float32)
    aff_b = aff_b.to(torch.float32)
    direction = direction.to(torch.float32)
    ref, dx, dy = _patch_grads(border_patch)
    dgrad = direction[:, 0:1] * dx + direction[:, 1:2] * dy
    e = is_edge[:, None]
    one = torch.ones_like(dx)
    J = torch.stack([torch.where(e, dgrad, dx), torch.where(e, one, dy),
                     torch.where(e, torch.zeros_like(dx), one)], dim=-1)
    H = torch.einsum("mpi,mpj->mij", J, J)
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    Hinv = torch.linalg.inv_ex(H + eye * 1e-9)[0]
    Hinv = torch.where(torch.isfinite(Hinv), Hinv, torch.zeros_like(Hinv))

    x = dict(quad_pyr=quad_pyr, base=offsets[search_level][:, None],
             wv=widths[search_level][:, None], hv=heights[search_level],
             target=aff_a[:, None] * ref + aff_b[:, None], J=J, Hinv=Hinv,
             is_edge=is_edge, direction=direction, valid=valid)
    u = px_init_scaled[:, 0]
    st = dict(u=u, v=px_init_scaled[:, 1], mean_diff=torch.zeros_like(u),
              conv=torch.zeros_like(valid), alive=valid.clone())
    return x, st


def _lane_fails(masks, n_lanes):
    """(M, 2) failure masks -> (2,) counts, or (n_lanes, 2) per lane."""
    if n_lanes:
        return masks.reshape(n_lanes, -1, 2).sum(1)
    return masks.sum(0)


def align_batch_plain(quad_pyr, offsets, widths, heights, search_level,
                      border_patch, px_init_scaled, direction, is_edge,
                      aff_a, aff_b, valid, n_iter: int = 10,
                      n_lanes: int = 0):
    """K5's plain version: `align.align_batch` as one batched loop
    (`device_loop.run`, "align") of `align_body`, which stops once no
    candidate is still running (see `align.align_batch` for the
    arguments)."""
    x, st = align_setup(quad_pyr, offsets, widths, heights, search_level,
                        border_patch, px_init_scaled, direction, is_edge,
                        aff_a, aff_b, valid)
    st = device_loop.run("align", align_body, x, st, n_iter)
    u, v, conv, alive = st["u"], st["v"], st["conv"], st["alive"]
    fail_oob = valid & ~conv & ~alive
    fail_iters = valid & ~conv & alive
    return (torch.stack([u, v], dim=-1), conv & valid,
            _lane_fails(torch.stack([fail_oob, fail_iters], -1), n_lanes))


def warp_align_plain(dI_ref0_stack, host_idx, px_ref, A_cur_ref, warp_level,
                     quad_pyr, offsets, widths, heights, search_level,
                     px_init_scaled, direction, is_edge, aff_a, aff_b, valid,
                     n_iter: int = 10, n_lanes: int = 0, quad_stack=None):
    """The fused kernel's plain version: `warp_affine_patches_plain`, then
    `align_batch_plain` on the patches it warps."""
    patches = warp_affine_patches_plain(dI_ref0_stack, host_idx, px_ref,
                                        A_cur_ref, warp_level,
                                        quad_stack=quad_stack)
    return align_batch_plain(quad_pyr, offsets, widths, heights,
                             search_level, patches, px_init_scaled,
                             direction, is_edge, aff_a, aff_b, valid,
                             n_iter=n_iter, n_lanes=n_lanes)



# ---------------------------------------------------------------------------
# build + bind
# ---------------------------------------------------------------------------

def _source_hash() -> str:
    hsh = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            hsh.update(name.encode() + b"\0" + f.read())
    hsh.update(" ".join(NVCC_FLAGS).encode())
    return hsh.hexdigest()[:16]


def _nvcc() -> str:
    cands = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append(shutil.which("nvcc") or "")
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the Hopper kernels are built with the "
                       "CUDA toolkit's nvcc (set CUDA_HOME)")


def build_library(verbose: bool = False) -> str:
    """Compile csrc/*.cu into build/libsdv_hopper_<hash>.so, with the
    compiler's report (`build_report`) beside it (no-op when the library
    for the current sources exists). With `verbose`, print the report.
    Returns the library's path."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"libsdv_hopper_{_source_hash()}.so")
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *(os.path.join(CSRC_DIR, s) for s in SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        # the report first: a library that exists has its report
        with open(f"{tmp}.txt", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(f"{tmp}.txt", _report_path(path))
        os.replace(tmp, path)
    if verbose:
        print(build_report(path))
    return path


def _report_path(library: str) -> str:
    return library[:-len(".so")] + ".ptxas.txt"


def build_report(library: str | None = None) -> str:
    """The compiler's output (ptxas -v) of the build of `library` (by
    default the current sources', built if it is not yet), whether this
    process built it or found it built."""
    with open(_report_path(library or build_library())) as f:
        return f.read()


def ptxas_usage(log: str) -> dict:
    """Per kernel entry of a `ptxas -v` report (`build_report`): registers,
    spill stores and loads (bytes), stack frame and shared memory (bytes),
    keyed by the entry's mangled name."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["smem"] = int(sm.group(1)) if sm else 0
    return out


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind_library(build_library())
    return _lib


def bind_library(path: str):
    """The kernels' library at `path`, loaded with its entry points'
    argument types set."""
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sdv_dilate_pyramid.argtypes = [vp, vp, vp, ci, ci, ci, ci,
                                       vp]
    lib.sdv_dilate_pyramid.restype = ci
    lib.sdv_distance_transform.argtypes = [vp, vp, vp, ci, ci, ci,
                                           ci, ci, vp]
    lib.sdv_distance_transform.restype = ci
    ull = ctypes.c_ulonglong
    lib.sdv_cond_begin.argtypes = [vp, vp, vp, ci,
                                   ctypes.POINTER(ull)]
    lib.sdv_cond_begin.restype = ci
    lib.sdv_cond_set.argtypes = [vp, ull, vp]
    lib.sdv_cond_set.restype = ci
    lib.sdv_cond_end.argtypes = [vp, ctypes.POINTER(ull)]
    lib.sdv_cond_end.restype = ci
    lib.sdv_capture_nodes.argtypes = [vp, ctypes.POINTER(ull)]
    lib.sdv_capture_nodes.restype = ci
    vpp, ll, cf = ctypes.POINTER(vp), ctypes.c_longlong, \
        ctypes.c_float
    lib.sdv_track_res_gs.argtypes = [vpp, ll, ci, ci, ci, ci, ll, cf,
                                     ll, cf, cf, vp]
    lib.sdv_track_res_gs.restype = ci
    lib.sdv_lm_step.argtypes = [vpp, ci, ll, ll, vp]
    lib.sdv_lm_step.restype = ci
    lib.sdv_lm_accept_step.argtypes = [vpp, ci, ll, ll, vp]
    lib.sdv_lm_accept_step.restype = ci
    lib.sdv_warp_align.argtypes = [vpp, ll, ll, ll, ci, ci, ci, ci, ci,
                                   vp]
    lib.sdv_warp_align.restype = ci
    lib.sdv_ba_linearize.argtypes = [vpp, ctypes.POINTER(ll), ci, ci, ci,
                                     ci, ci, cf, ci, vp]
    lib.sdv_ba_linearize.restype = ci
    lib.sdv_ba_accumulate.argtypes = [vpp, ctypes.POINTER(ll), ci, ci, ci,
                                      vp]
    lib.sdv_ba_accumulate.restype = ci
    for name in ("sdv_ba_accumulate_tiles", "sdv_ba_accumulate_part"):
        getattr(lib, name).argtypes = [ci]
        getattr(lib, name).restype = ci
    for name, _ in _COUNTERS:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(ull), ci]
        fn.restype = ci
    return lib


def _check_map(x: torch.Tensor, name: str):
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: float32 required, got {x.dtype}")
    if x.dim() not in (2, 3):
        raise ValueError(f"{name}: (H, W) or (L, H, W) required, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: contiguous tensor required")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def _check_rc(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def _lanes_hw(x: torch.Tensor):
    return (1, *x.shape) if x.dim() == 2 else tuple(x.shape)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def dilate_pyramid(idepth0: torch.Tensor, weight0: torch.Tensor,
                   levels: int):
    """K1: the hole-filling chain of `build_track_ref` over (H, W) or
    (L, H, W) level-0 splat maps; a tuple over levels of (idepth, weight)
    with the input's leading dimensions. CPU -> plain version; CUDA -> one
    launch, all levels in one buffer."""
    _check_map(idepth0, "idepth0")
    _check_map(weight0, "weight0")
    if weight0.shape != idepth0.shape or weight0.device != idepth0.device:
        raise ValueError("idepth0 and weight0 must share shape and device")
    if not 1 <= levels <= DILATE_MAX_LEVELS:
        raise ValueError(f"levels must be in [1, {DILATE_MAX_LEVELS}]")
    if idepth0.device.type == "cpu":
        return dilate_pyramid_plain(idepth0, weight0, levels)
    lib = _load()
    lanes, h, w = _lanes_hw(idepth0)
    lead = idepth0.shape[:-2]
    shapes = [(h, w)]
    for _ in range(levels - 1):
        shapes.append((shapes[-1][0] // 2, shapes[-1][1] // 2))
    sizes = [lanes * hl * wl for hl, wl in shapes]
    # D_0..D_{levels-1}, then the kernel's scratch: at most the pooled
    # maps of the coarser levels, and a counter
    buf = torch.empty(2 * sum(sizes) + 2 * sum(sizes[1:]) + 1,
                      dtype=torch.float32, device=idepth0.device)
    with torch.cuda.device(idepth0.device):
        stream = torch.cuda.current_stream(idepth0.device).cuda_stream
        rc = lib.sdv_dilate_pyramid(idepth0.data_ptr(), weight0.data_ptr(),
                                    buf.data_ptr(), lanes, h, w, levels,
                                    stream)
    _check_rc(rc, "dilate_pyramid")
    if idepth0.numel():
        _count_launch("dilate_pyramid", lanes)
    out, off = [], 0
    for (hl, wl), n in zip(shapes, sizes):
        out.append((buf[off:off + n].view(*lead, hl, wl),
                    buf[off + n:off + 2 * n].view(*lead, hl, wl)))
        off += 2 * n
    return tuple(out)


def distance_transform(seed: torch.Tensor, iters: int = 32):
    """K2: chamfer distance transform of (H, W) or (L, H, W) seed maps,
    any `iters` >= 0. CPU -> plain version; CUDA -> kernel (one launch per
    16 sweeps)."""
    _check_map(seed, "seed")
    if iters < 0:
        raise ValueError("iters must be >= 0")
    if seed.device.type == "cpu":
        return distance_transform_plain(seed, iters)
    lib = _load()
    lanes, h, w = _lanes_hw(seed)
    # the output, and a scratch map that chunks of sweeps ping-pong through
    buf = torch.empty((2, *seed.shape), dtype=torch.float32,
                      device=seed.device)
    out = buf[0]
    with torch.cuda.device(seed.device):
        stream = torch.cuda.current_stream(seed.device).cuda_stream
        rc = lib.sdv_distance_transform(
            seed.data_ptr(), out.data_ptr(), buf[1].data_ptr(), lanes, h, w,
            int(iters), 0, stream)
    _check_rc(rc, "distance_transform")
    if iters and seed.numel():   # 0 sweeps are a copy, not a launch
        _count_launch("distance_transform", lanes)
    return out


def _on_card(what, *tensors):
    """The one CUDA device of `tensors`; raises when they lie on several."""
    devs = {t.device for t in tensors if isinstance(t, torch.Tensor)}
    if len(devs) != 1:
        raise ValueError(f"{what}: inputs on several devices {devs}")
    dev = devs.pop()
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    _counted_devices.add(dev.index)
    return dev


def _f32(x, name):
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: float32 required, got {x.dtype}")
    return x.contiguous()


def _per_row(x, B, name):
    """A float, a () tensor or a (B,) tensor as the kernels take it:
    (pointer or None, row stride, value)."""
    if not isinstance(x, torch.Tensor):
        return None, 0, float(x)
    if x.dtype != torch.float32 or x.dim() > 1 or \
            (x.dim() == 1 and x.shape[0] not in (1, B)):
        raise ValueError(f"{name}: a float, or a float32 () or ({B},) "
                         f"tensor required, got {x.dtype} "
                         f"{tuple(x.shape)}")
    stride = x.stride(0) if x.dim() == 1 and x.shape[0] == B else 0
    return x.data_ptr(), stride, 0.0


def _ptrs(*tensors):
    return (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t if isinstance(t, int) else t.data_ptr()
          for t in tensors))


def track_res_gs(pool, dI_new, K, T_ref_to_new, aff_rel, ref_aff_b, cutoff,
                 huber_th, packed=None, lane=None, hw=None):
    """K3: `photometric.calc_res_gs` (same arguments and results). CPU ->
    plain version; CUDA -> one launch for the B rows, each reading its
    lane's pool fields (L, N) and `packed` rows directly."""
    if T_ref_to_new.device.type == "cpu":
        return calc_res_gs_plain(pool, dI_new, K, T_ref_to_new, aff_rel,
                                 ref_aff_b, cutoff, huber_th, packed=packed,
                                 lane=lane, hw=hw)
    if isinstance(huber_th, torch.Tensor):
        raise TypeError("huber_th: a float required (a device tensor would "
                        "need a host read)")
    h, w = hw if hw is not None else (dI_new.shape[-3], dI_new.shape[-2])
    if packed is None:
        packed = pack_bilinear(dI_new)
    B = T_ref_to_new.shape[0]
    f = {k: _f32(pool[k], k) for k in ("u", "v", "idepth", "color")}
    valid = pool["valid"].contiguous()
    if valid.dtype != torch.bool:
        raise TypeError("valid: bool required")
    N = f["u"].shape[-1]
    if any(x.shape != f["u"].shape for x in (*f.values(), valid)) or \
            f["u"].dim() != (1 if lane is None else 2):
        raise ValueError("pool fields: (N,) each, or (L, N) with `lane`")
    packed = _f32(packed, "packed")
    if packed.dim() != 2 or packed.shape[1] != 12 or packed.data_ptr() % 16:
        raise ValueError("packed: (L * h * w, 12), 16-byte aligned, "
                         "required (pack_bilinear of a 3-channel level)")
    K = _f32(K, "K")
    T = _f32(T_ref_to_new, "T_ref_to_new")
    aff_rel = _f32(aff_rel, "aff_rel")
    if T.shape != (B, 4, 4) or aff_rel.shape != (B, 2):
        raise ValueError("T_ref_to_new (B, 4, 4) and aff_rel (B, 2) "
                         "required")
    if lane is not None:
        if lane.dtype != torch.int64 or lane.shape != (B,):
            raise ValueError("lane: int64 (B,) required")
        lane = lane.contiguous()
    dev = _on_card("track_res_gs", T, aff_rel, K, packed, valid, lane,
                   *f.values(), *(x for x in (ref_aff_b, cutoff)
                                  if isinstance(x, torch.Tensor)))
    rb_ptr, rb_stride, rb_val = _per_row(ref_aff_b, B, "ref_aff_b")
    co_ptr, co_stride, co_val = _per_row(cutoff, B, "cutoff")
    lib = _load()
    out = dict(E=torch.empty(B, device=dev),
               n=torch.empty(B, dtype=torch.int64, device=dev),
               sat_frac=torch.empty(B, device=dev),
               H=torch.empty((B, 8, 8), device=dev),
               b=torch.empty((B, 8), device=dev),
               flow_t=torch.empty(B, device=dev),
               flow_rt=torch.empty(B, device=dev))
    ptrs = _ptrs(f["u"], f["v"], f["idepth"], f["color"], valid, packed, K,
                 lane, T, aff_rel, rb_ptr, co_ptr,
                 *(out[k] for k in RES_KEYS))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sdv_track_res_gs(
            ptrs, N if f["u"].dim() == 2 else 0, N, int(h), int(w), B,
            rb_stride, rb_val, co_stride, co_val, float(huber_th), stream)
    _check_rc(rc, "track_res_gs")
    return out


def _row_pairs(x, B, name):
    """(2,) or (B, 2) float32 -> (tensor with unit last stride, row
    stride)."""
    if x.dtype != torch.float32 or x.shape not in ((2,), (B, 2)):
        raise ValueError(f"{name}: float32 (2,) or ({B}, 2) required")
    if x.stride(-1) != 1:
        x = x.contiguous()
    return x, (x.stride(0) if x.dim() == 2 else 0)


def _step_outputs(B, dev):
    """K4's step outputs (STEP_KEYS)."""
    return tuple(torch.empty(shape, device=dev)
                 for shape in ((B, 4, 4), (B, 2), (B, 2), (B, 8)))


def lm_update_step(H, b, lam, T, aff, exposures, ref_aff):
    """K4's step entry point: `lm_update_step_plain` (same arguments and
    results). CPU -> plain version; CUDA -> one launch, a warp per row."""
    if H.device.type == "cpu":
        return lm_update_step_plain(H, b, lam, T, aff, exposures, ref_aff)
    B = H.shape[0]
    H, b, lam, T, aff = (_f32(x, n) for x, n in (
        (H, "H"), (b, "b"), (lam, "lam"), (T, "T"), (aff, "aff")))
    if (H.shape, b.shape, lam.shape, T.shape, aff.shape) != \
            ((B, 8, 8), (B, 8), (B,), (B, 4, 4), (B, 2)):
        raise ValueError("H (B, 8, 8), b (B, 8), lam (B,), T (B, 4, 4) and "
                         "aff (B, 2) required")
    exposures, ex_stride = _row_pairs(exposures, B, "exposures")
    ref_aff, ra_stride = _row_pairs(ref_aff, B, "ref_aff")
    dev = _on_card("lm_update_step", H, b, lam, T, aff, exposures, ref_aff)
    lib = _load()
    out = _step_outputs(B, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sdv_lm_step(_ptrs(H, b, lam, T, aff, exposures, ref_aff,
                                   *out), B, ex_stride, ra_stride, stream)
    _check_rc(rc, "lm_update_step")
    return out


def lm_update_accept_step(r, r_new, T, T_new, aff, aff_new, lam, done, n_it,
                          inc, exposures, ref_aff):
    """K4's fused entry point: `lm_update_accept_step_plain` (same
    arguments and results): one LM iteration's accept and the next
    iteration's step. CPU -> plain version; CUDA -> one launch of a
    cluster of 8 blocks (a warp per row; the loop's flag reduced over each
    block, then over the cluster)."""
    if T.device.type == "cpu":
        return lm_update_accept_step_plain(r, r_new, T, T_new, aff, aff_new,
                                           lam, done, n_it, inc, exposures,
                                           ref_aff)
    B = T.shape[0]
    shapes = dict(E=(B,), n=(B,), sat_frac=(B,), H=(B, 8, 8), b=(B, 8),
                  flow_t=(B,), flow_rt=(B,))

    def res(d, what):
        out = []
        for k in RES_KEYS:
            x = d[k].contiguous()
            if x.shape != shapes[k] or x.dtype != (
                    torch.int64 if k == "n" else torch.float32):
                raise ValueError(f"{what}[{k}]: {shapes[k]} "
                                 f"{'int64' if k == 'n' else 'float32'} "
                                 "required")
            out.append(x)
        return out
    ins = res(r, "r") + res(r_new, "r_new")
    T, T_new, aff, aff_new, lam, inc = (_f32(x, n) for x, n in (
        (T, "T"), (T_new, "T_new"), (aff, "aff"), (aff_new, "aff_new"),
        (lam, "lam"), (inc, "inc")))
    done, n_it = done.contiguous(), n_it.contiguous()
    if (T.shape, T_new.shape, aff.shape, aff_new.shape, lam.shape,
            inc.shape, done.shape, n_it.shape) != (
            (B, 4, 4), (B, 4, 4), (B, 2), (B, 2), (B,), (B, 8), (B,),
            (B,)) or done.dtype != torch.bool or n_it.dtype != torch.int64:
        raise ValueError("lm_update_accept_step: row shapes or dtypes "
                         "differ from lm_update_accept_step_plain's")
    exposures, ex_stride = _row_pairs(exposures, B, "exposures")
    ref_aff, ra_stride = _row_pairs(ref_aff, B, "ref_aff")
    dev = _on_card("lm_update_accept_step", T, T_new, aff, aff_new, lam,
                   done, n_it, inc, exposures, ref_aff, *ins)
    lib = _load()
    r_out = {k: torch.empty(shapes[k], device=dev,
                            dtype=torch.int64 if k == "n" else torch.float32)
             for k in RES_KEYS}
    out = dict(r=r_out, T=torch.empty((B, 4, 4), device=dev),
               aff=torch.empty((B, 2), device=dev),
               lam=torch.empty(B, device=dev),
               done=torch.empty(B, dtype=torch.bool, device=dev),
               n_it=torch.empty(B, dtype=torch.int64, device=dev),
               active=torch.empty((), dtype=torch.bool, device=dev))
    step = _step_outputs(B, dev)
    ptrs = _ptrs(*ins, T, T_new, aff, aff_new, lam, done, n_it, inc,
                 *(r_out[k] for k in RES_KEYS), out["T"], out["aff"],
                 out["lam"], out["done"], out["n_it"], out["active"],
                 exposures, ref_aff, *step)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sdv_lm_accept_step(ptrs, B, ex_stride, ra_stride, stream)
    _check_rc(rc, "lm_update_accept_step")
    out.update(zip(STEP_KEYS, step))
    return out


def _quad_rows(quad, name):
    """A quad pack (T, 4) float32 as the kernels read it: contiguous, each
    row one 16-byte load."""
    quad = _f32(quad, name)
    if quad.dim() != 2 or quad.shape[1] != 4 or quad.data_ptr() % 16:
        raise ValueError(f"{name}: (T, 4), 16-byte aligned, required")
    return quad


def _rows(x, shape, dtype, name):
    """`x` converted to `dtype` (as the plain version converts it),
    contiguous, of `shape`."""
    x = x.to(dtype).contiguous()
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: {shape} required, got {tuple(x.shape)}")
    return x


# the fused kernel's modes (csrc/align_batch.cu, Mode): the patch warp and
# the alignment (the matcher's call), the alignment of given patches (K5
# alone), the patch warp alone (K6 alone); one device counter each
MODE_FUSED, MODE_ALIGN, MODE_PATCHES = 0, 1, 2


def _warp_inputs(dI_ref0_stack, host_idx, px_ref, A_cur_ref, level,
                 quad_stack, M):
    """K6's inputs as the kernel reads them: (host quad pack, host_idx,
    px_ref, A_cur_ref, level, h, w)."""
    h, w = dI_ref0_stack.shape[1:3]
    if quad_stack is None:
        quad_stack = _stack_quads(dI_ref0_stack)
    if level.dtype != torch.int64:
        raise TypeError("the warp's search_level: int64 required")
    px, A = _f32(px_ref, "px_ref"), _f32(A_cur_ref, "A_cur_ref")
    if px.shape != (M, 2) or A.shape != (M, 2, 2):
        raise ValueError("px_ref (M, 2) and A_cur_ref (M, 2, 2) required")
    return (_quad_rows(quad_stack, "quad_stack"),
            _rows(host_idx, (M,), torch.int64, "host_idx"), px, A,
            _rows(level, (M,), torch.int64, "search_level"), int(h), int(w))


def _align_inputs(quad_pyr, offsets, widths, heights, search_level,
                  px_init_scaled, direction, is_edge, aff_a, aff_b, valid,
                  n_lanes):
    """K5's inputs but the patch, as the kernel reads them: (quad pack,
    offsets, widths, heights, search_level, px_init_scaled, direction,
    is_edge, valid, aff_a, aff_b)."""
    M = valid.shape[0]
    if search_level.dtype != torch.int64 or is_edge.dtype != torch.bool \
            or valid.dtype != torch.bool:
        raise TypeError("search_level int64, is_edge and valid bool "
                        "required")
    if n_lanes and M % n_lanes:
        raise ValueError(f"{M} rows do not split into {n_lanes} lanes")
    return (_quad_rows(quad_pyr, "quad_pyr"),
            *(_level_table(t, n) for t, n in ((offsets, "offsets"),
                                              (widths, "widths"),
                                              (heights, "heights"))),
            _rows(search_level, (M,), torch.int64, "search_level"),
            _rows(px_init_scaled, (M, 2), torch.float32, "px_init_scaled"),
            _rows(direction, (M, 2), torch.float32, "direction"),
            _rows(is_edge, (M,), torch.bool, "is_edge"),
            _rows(valid, (M,), torch.bool, "valid"),
            _rows(aff_a, (M,), torch.float32, "aff_a"),
            _rows(aff_b, (M,), torch.float32, "aff_b"))


def _launch_warp_align(mode, M, warp=None, align=None, border=None,
                       n_iter=0, n_lanes=0):
    """The kernel of csrc/align_batch.cu in `mode` over M rows: `warp`
    (`_warp_inputs`) for MODE_FUSED and MODE_PATCHES, `align`
    (`_align_inputs`) for MODE_FUSED and MODE_ALIGN, `border` (M, 10, 10)
    for MODE_ALIGN. Returns the (M, 10, 10) patches (MODE_PATCHES) or
    align_batch's results (px, conv, failure counts, per lane with
    `n_lanes`: the kernel counts them, after a small kernel of the same
    call zeroed them)."""
    hq, host, px_ref, A, wlvl, h, w = warp or (None,) * 5 + (0, 0)
    (quad, offs, wids, heis, lvl, px0, direc, edge, valid, fa,
     fb) = align or (None,) * 11
    dev = _on_card("warp_align", *(t for t in (hq, host, px_ref, A, wlvl,
                                               border) if t is not None),
                   *(align or ()))
    px = conv = fails = patches = None
    if mode == MODE_PATCHES:
        patches = torch.empty((M, BORDER_PATCH, BORDER_PATCH), device=dev)
    else:
        px = torch.empty((M, 2), device=dev)
        conv = torch.empty(M, dtype=torch.bool, device=dev)
        # the failure counts per lane, which the kernel adds up itself
        fails = torch.empty((max(n_lanes, 1), 2), dtype=torch.int64,
                            device=dev)
    if M:
        lib = _load()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.sdv_warp_align(
                _ptrs(quad, offs, wids, heis, lvl, hq, host, px_ref, A, wlvl,
                      border, px0, direc, edge, valid, fa, fb, px, conv,
                      fails, patches),
                0 if quad is None else quad.shape[0],
                0 if hq is None else hq.shape[0], M, h, w,
                max(int(n_iter), 0), int(n_lanes), mode, stream)
        _check_rc(rc, "warp_align")
    if mode == MODE_PATCHES:
        return patches
    if not M:
        fails.zero_()
    return px, conv, fails if n_lanes else fails[0]


def warp_affine_patches(dI_ref0_stack, host_idx, px_ref, A_cur_ref,
                        search_level, quad_stack=None):
    """K6: `align.warp_affine_patches` (same arguments and results). CPU ->
    plain version; CUDA -> one launch of the fused kernel that warps the
    patches and aligns nothing (MODE_PATCHES), a warp per row."""
    if px_ref.device.type == "cpu":
        return warp_affine_patches_plain(dI_ref0_stack, host_idx, px_ref,
                                         A_cur_ref, search_level,
                                         quad_stack=quad_stack)
    M = px_ref.shape[0]
    return _launch_warp_align(MODE_PATCHES, M, warp=_warp_inputs(
        dI_ref0_stack, host_idx, px_ref, A_cur_ref, search_level, quad_stack,
        M))


def align_batch(quad_pyr, offsets, widths, heights, search_level,
                border_patch, px_init_scaled, direction, is_edge, aff_a,
                aff_b, valid, n_iter: int = 10, n_lanes: int = 0):
    """K5: `align.align_batch` (same arguments and results). CPU -> plain
    version; CUDA -> the fused kernel reading the given patches
    (MODE_ALIGN), a warp per candidate row running the row's whole loop;
    the failure counts (per lane with `n_lanes`) the kernel adds up, after
    a one-block kernel zeroed them (two launches)."""
    if quad_pyr.device.type == "cpu":
        return align_batch_plain(quad_pyr, offsets, widths, heights,
                                 search_level, border_patch, px_init_scaled,
                                 direction, is_edge, aff_a, aff_b, valid,
                                 n_iter=n_iter, n_lanes=n_lanes)
    M = valid.shape[0]
    return _launch_warp_align(
        MODE_ALIGN, M, align=_align_inputs(
            quad_pyr, offsets, widths, heights, search_level,
            px_init_scaled, direction, is_edge, aff_a, aff_b, valid,
            n_lanes),
        border=_rows(border_patch, (M, BORDER_PATCH, BORDER_PATCH),
                     torch.float32, "border_patch"),
        n_iter=n_iter, n_lanes=n_lanes)


def warp_align(dI_ref0_stack, host_idx, px_ref, A_cur_ref, warp_level,
               quad_pyr, offsets, widths, heights, search_level,
               px_init_scaled, direction, is_edge, aff_a, aff_b, valid,
               n_iter: int = 10, n_lanes: int = 0, quad_stack=None):
    """K5 with K6 as its prologue: `align.warp_align` (same arguments and
    results: `warp_affine_patches`, then `align_batch` on its patches).
    CPU -> plain version (`warp_align_plain`); CUDA -> two launches, a
    one-block kernel zeroing the failure counts, then the fused kernel
    (MODE_FUSED): each row's warp samples its patch into shared memory
    and aligns it; no patch leaves the chip."""
    if quad_pyr.device.type == "cpu":
        return warp_align_plain(
            dI_ref0_stack, host_idx, px_ref, A_cur_ref, warp_level,
            quad_pyr, offsets, widths, heights, search_level,
            px_init_scaled, direction, is_edge, aff_a, aff_b, valid,
            n_iter=n_iter, n_lanes=n_lanes, quad_stack=quad_stack)
    M = valid.shape[0]
    return _launch_warp_align(
        MODE_FUSED, M,
        warp=_warp_inputs(dI_ref0_stack, host_idx, px_ref, A_cur_ref,
                          warp_level, quad_stack, M),
        align=_align_inputs(quad_pyr, offsets, widths, heights,
                            search_level, px_init_scaled, direction,
                            is_edge, aff_a, aff_b, valid, n_lanes),
        n_iter=n_iter, n_lanes=n_lanes)


def _level_table(t, name):
    """A level table (offsets, widths or heights) as int64, contiguous."""
    if t.dtype != torch.int64 or t.dim() != 1:
        raise TypeError(f"{name}: an int64 (levels,) table required")
    return t.contiguous()


def _view_strides(x, shape, name):
    """A float32 view's element strides as the BA kernels read it: (lane,
    pair, row, col), 0 for a dimension it lacks (a translation's col)."""
    if x.dtype != torch.float32 or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: float32 {tuple(shape)} required, got "
                         f"{x.dtype} {tuple(x.shape)}")
    st = list(x.stride())
    return st + [0] * (4 - len(st))


def ba_linearize(pt_u, pt_v, pt_idepth, pt_host, res_active, res_state,
                 matcher_px, matcher_valid, pairs, frame_energy_th, K, gate,
                 w: int, h: int, huber_th: float = 6.0,
                 resf_at_fej: bool = True):
    """K7: `backend.linearize_residuals_lanes` of L windows given its gate
    `(energy_phot, wJI2)` (same arguments and results: points (L, N),
    residual grids (L, N, F), `pairs` with R0, t0, Rc, tc (L, F F, 3, 3)
    and (L, F F, 3), any strides). CUDA only (the dispatch is the
    caller's): one launch, a thread per residual. The gate's tensors are
    returned as given."""
    L, N = pt_u.shape
    F = frame_energy_th.shape[-1]
    if not 1 <= F <= BA_MAX_FRAMES:
        raise ValueError(f"ba_linearize: 1 to {BA_MAX_FRAMES} frame slots, "
                         f"got {F}")
    if isinstance(huber_th, torch.Tensor):
        raise TypeError("huber_th: a float required")
    pts = [_rows(x, (L, N), torch.float32, n) for x, n in (
        (pt_u, "pt_u"), (pt_v, "pt_v"), (pt_idepth, "pt_idepth"))]
    host = _rows(pt_host, (L, N), torch.int64, "pt_host")
    act = _rows(res_active, (L, N, F), torch.bool, "res_active")
    state = _rows(res_state, (L, N, F), torch.int8, "res_state")
    mpx = _rows(matcher_px, (L, N, F, 2), torch.float32, "matcher_px")
    mval = _rows(matcher_valid, (L, N, F), torch.bool, "matcher_valid")
    e_ph = _rows(gate[0], (L, N, F), torch.float32, "energy_phot")
    wj = _rows(gate[1], (L, N, F), torch.float32, "wJI2")
    feth = _rows(frame_energy_th, (L, F), torch.float32, "frame_energy_th")
    Kc = _rows(K, (L, 4), torch.float32, "K")
    views = [pairs[k] for k in ("R0", "t0", "Rc", "tc")]
    strides = []
    for v, k in zip(views, ("R0", "t0", "Rc", "tc")):
        strides += _view_strides(v, (L, F * F, 3, 3) if k[0] == "R"
                                 else (L, F * F, 3), k)
    dev = _on_card("ba_linearize", *pts, host, act, state, mpx, mval, e_ph,
                   wj, feth, Kc, *views)

    def out(*tail, dtype=torch.float32):
        return torch.empty((L, N, F) + tail, dtype=dtype, device=dev)
    res = dict(resF=out(2), Jxi=out(2, 6), Jc=out(2, 4), Jd=out(2),
               new_state=out(dtype=torch.int8), energy=out())
    center, proj_ok = out(3), out(dtype=torch.bool)
    if L * N:
        lib = _load()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.sdv_ba_linearize(
                _ptrs(*pts, host, act, state, mpx, mval, e_ph, wj, *views,
                      feth, Kc, *res.values(), center, proj_ok),
                (ctypes.c_longlong * 16)(*strides), L, N, F, int(w), int(h),
                float(huber_th), int(bool(resf_at_fej)), stream)
        _check_rc(rc, "ba_linearize")
    return dict(res, energy_phot=gate[0], wJI2=gate[1], center=center,
                proj_ok=proj_ok)


def ba_accumulate(Jc, Jxi, Jd, resF, active, pt_host, pt_is_sensor,
                  pt_prior, sc_mask, adH, adT, F: int):
    """K8: `backend._accumulate` of L windows (same arguments, with the
    pairs' adjoints adH, adT (L, F F, 6, 6) of any strides, and results:
    H_top, b_top, H_sc, b_sc, Hdd, bd, HdiF, Vpt, n_act). CUDA only (the dispatch is the caller's): three
    launches, the tiles' sums, their sum in tile order, the transport."""
    if not 1 <= F <= BA_MAX_FRAMES:
        raise ValueError(f"ba_accumulate: 1 to {BA_MAX_FRAMES} frame slots, "
                         f"got {F}")
    L, N = resF.shape[:2]
    D = 4 + 6 * F
    Jc = _rows(Jc, (L, N, F, 2, 4), torch.float32, "Jc")
    Jxi = _rows(Jxi, (L, N, F, 2, 6), torch.float32, "Jxi")
    Jd = _rows(Jd, (L, N, F, 2), torch.float32, "Jd")
    res = _rows(resF, (L, N, F, 2), torch.float32, "resF")
    act = _rows(active, (L, N, F), torch.bool, "active")
    host = _rows(pt_host, (L, N), torch.int64, "pt_host")
    sens = _rows(pt_is_sensor, (L, N), torch.bool, "pt_is_sensor")
    prior = _rows(pt_prior, (L, N), torch.float32, "pt_prior")
    sc = _rows(sc_mask, (L, N), torch.bool, "sc_mask")
    strides = _view_strides(adH, (L, F * F, 6, 6), "adH") + \
        _view_strides(adT, (L, F * F, 6, 6), "adT")
    dev = _on_card("ba_accumulate", Jc, Jxi, Jd, res, act, host, sens,
                   prior, sc, adH, adT)
    lib = _load()
    tiles = lib.sdv_ba_accumulate_tiles(N)
    P = lib.sdv_ba_accumulate_part(F)
    part = torch.empty(max(L * tiles * P, 1), device=dev)
    tot = torch.empty(max(L * P, 1), device=dev)
    out = (torch.empty((L, D, D), device=dev), torch.empty((L, D), device=dev),
           torch.empty((L, D, D), device=dev), torch.empty((L, D), device=dev),
           torch.empty((L, N), device=dev), torch.empty((L, N), device=dev),
           torch.empty((L, N), device=dev), torch.empty((L, N, D), device=dev),
           torch.empty((L, N), dtype=torch.int64, device=dev))
    if L:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.sdv_ba_accumulate(
                _ptrs(Jc, Jxi, Jd, res, act, host, sens, prior, sc, adH, adT,
                      part, tot, *out),
                (ctypes.c_longlong * 8)(*strides), L, N, F, stream)
        _check_rc(rc, "ba_accumulate")
    return out
