"""Fused per-frame tracking step.

Counterpart of `sdv_loam_tpu/ops/frame_step.py` (reference
FullSystem::trackNewCoarse, FullSystem.cpp:283-517):

  1. LM of all pose hypotheses on the coarsest pyramid level at once;
  2. winner selection (constant motion preferred when within 5%);
  3. full coarse-to-fine refinement of the top candidates, keeping the
     lowest level-0 residual;
  4. Reprojector matching of the window map into the new frame;
  5. struct (reprojection) pose LM, adopted only under the photometric veto
     and the translation bound.

`track_frame_step_batch` is the fleet form (the JAX package's vmap over
sequences): L sequences' frames run as lanes of one launch stream. The
hypothesis ladder and the refinement candidates of every lane are rows of
the same LM loops, each row gathering from its own lane's pool and image,
and every loop stops each row on its own condition. `track_frame_step` is
lane 0 of the same code.
"""

from __future__ import annotations

import torch

from sdv_loam_tpu_torch.models.matcher import reproject_and_match_lanes
from sdv_loam_tpu_torch.ops.photometric import (aff_transfer, calc_res_gs,
                                                track_coarsest_batch,
                                                track_pyramid)
from sdv_loam_tpu_torch.ops.struct_pose import struct_pose_estimate
from sdv_loam_tpu_torch.ops.warp import pack_bilinear
from sdv_loam_tpu_torch.utils import device_loop, se3

# positional arguments of track_frame_step, in order; every one but the
# shared level tables (offsets, widths, heights) and the two thresholds is
# per sequence
ARG_NAMES = ("pools", "dI_new_pyr", "flat_new", "offsets", "widths",
             "heights", "Ks", "T_tries", "try_exclude", "aff_last", "ref_aff",
             "exposures", "min_res_for_abort", "ref_T_wc", "pt_u", "pt_v",
             "pt_idepth", "pt_host", "pt_type", "pt_valid", "pt_quality",
             "pt_is_sensor", "T_wc_stack", "aff_stack", "exposure_stack",
             "dI0_stack", "ref_idx_per_point", "frame_valid", "K0",
             "cutoff_th", "huber_th")
_SHARED = ("offsets", "widths", "heights", "cutoff_th", "huber_th")
_POOL_FIELDS = ("u", "v", "idepth", "color", "valid")


def track_frame_step(pools, dI_new_pyr, flat_new, offsets, widths, heights,
                     Ks, T_tries, try_exclude, aff_last, ref_aff, exposures,
                     min_res_for_abort, ref_T_wc,
                     pt_u, pt_v, pt_idepth, pt_host, pt_type, pt_valid,
                     pt_quality, pt_is_sensor,
                     T_wc_stack, aff_stack, exposure_stack,
                     dI0_stack, ref_idx_per_point, frame_valid, K0,
                     cutoff_th, huber_th,
                     coarsest_lvl: int, w: int, h: int, max_level: int,
                     n_refine: int = 3, use_struct_pose: bool = True,
                     struct_pose_mad: bool = False,
                     struct_pose_e_tol: float = 1.5,
                     struct_pose_max_dt: float = 0.0,
                     closest_view: bool = False, closest_view_margin=0.0,
                     closest_view_sensor_only=False,
                     align_max_iters: int = 10, quad_stack=None):
    """`_track_frame_step_impl` of the JAX package. Returns dict(T_ref_to_fh, T_wc, aff, res, flow, ok, n_matched,
    best_try, matched, match_px, lvl_iters). `try_exclude` (B,) masks
    hypotheses already consumed by a host retry."""
    args = dict(zip(ARG_NAMES, (
        pools, dI_new_pyr, flat_new, offsets, widths, heights, Ks, T_tries,
        try_exclude, aff_last, ref_aff, exposures, min_res_for_abort,
        ref_T_wc, pt_u, pt_v, pt_idepth, pt_host, pt_type, pt_valid,
        pt_quality, pt_is_sensor, T_wc_stack, aff_stack, exposure_stack,
        dI0_stack, ref_idx_per_point, frame_valid, K0, cutoff_th,
        huber_th)))
    out = track_frame_step_batch(
        [args], [struct_pose_e_tol], [struct_pose_max_dt],
        coarsest_lvl=coarsest_lvl, w=w, h=h, max_level=max_level,
        n_refine=n_refine, use_struct_pose=use_struct_pose,
        struct_pose_mad=struct_pose_mad, closest_view=closest_view,
        closest_view_margin=closest_view_margin,
        closest_view_sensor_only=closest_view_sensor_only,
        align_max_iters=align_max_iters,
        quad_stacks=None if quad_stack is None else [quad_stack])
    return {k: v[0] for k, v in out.items()}


def _stack(args_b, name):
    xs = [a[name] for a in args_b]
    if name == "pools":
        return tuple({k: torch.stack([p[lvl][k] for p in xs])
                      for k in _POOL_FIELDS} for lvl in range(len(xs[0])))
    if name in ("dI_new_pyr", "Ks"):
        return tuple(torch.stack([x[lvl] for x in xs])
                     for lvl in range(len(xs[0])))
    return torch.stack(xs)


def track_frame_step_batch(args_b, etol_b, mdt_b,
                           coarsest_lvl: int, w: int, h: int, max_level: int,
                           n_refine: int = 3, use_struct_pose: bool = True,
                           struct_pose_mad: bool = False,
                           closest_view: bool = False,
                           closest_view_margin=0.0,
                           closest_view_sensor_only=False,
                           align_max_iters: int = 10, quad_stacks=None):
    """L-sequence fleet tracking (the JAX package's `track_frame_step_batch`).

    `args_b`: one dict per sequence of track_frame_step's positional
    arguments (`ARG_NAMES`), all of equal shapes; the level tables and the
    two thresholds must be equal too (the first lane's are used).
    `etol_b` / `mdt_b`: per-sequence struct-pose thresholds (floats).
    `quad_stacks`: per-sequence `stack_quads(dI0_stack)` or None. Returns
    track_frame_step's dict with a leading L.

    One stage program (`device_loop.program`, "track"): its inputs are the
    lanes' tensors, the level tables and the thresholds as device tensors
    (`cutoff_th`, the squared struct-pose tolerance and max step per lane,
    float32 as the single-sequence program's python floats round); the
    Huber threshold and every keyword are static."""
    a0 = args_b[0]
    dev = a0["T_tries"].device
    lanes = [{n: tuple({k: p[k] for k in _POOL_FIELDS} for p in a[n])
              if n == "pools" else a[n]
              for n in ARG_NAMES if n not in _SHARED} for a in args_b]
    cut = a0["cutoff_th"]
    inputs = dict(
        lanes=lanes,
        shared=dict(offsets=a0["offsets"], widths=a0["widths"],
                    heights=a0["heights"],
                    cutoff_th=cut if isinstance(cut, torch.Tensor)
                    else device_loop.constant(float(cut), dev)),
        # squared in float64 on the host, as the single-sequence program's
        # python float would be, then one float32 per lane
        etol_sq=device_loop.constant([float(e) * float(e) for e in etol_b],
                                     dev),
        mdt=device_loop.constant([float(m) for m in mdt_b], dev),
        quad_stacks=None if quad_stacks is None else list(quad_stacks))
    static = dict(
        coarsest_lvl=int(coarsest_lvl), w=int(w), h=int(h),
        max_level=int(max_level), n_refine=int(n_refine),
        use_struct_pose=bool(use_struct_pose),
        struct_pose_mad=bool(struct_pose_mad),
        closest_view=bool(closest_view),
        closest_view_margin=float(closest_view_margin),
        closest_view_sensor_only=bool(closest_view_sensor_only),
        align_max_iters=int(align_max_iters),
        huber_th=float(a0["huber_th"]))
    return device_loop.program("track", _track_program, inputs, static)


def _track_program(inputs, coarsest_lvl, w, h, max_level, n_refine,
                   use_struct_pose, struct_pose_mad, closest_view,
                   closest_view_margin, closest_view_sensor_only,
                   align_max_iters, huber_th):
    args_b, quad_stacks = inputs["lanes"], inputs["quad_stacks"]
    etol_sq, mdt = inputs["etol_sq"], inputs["mdt"]
    L = len(args_b)
    dev = args_b[0]["T_tries"].device
    s = dict(inputs["shared"])
    s.update({n: _stack(args_b, n) for n in args_b[0]})
    pools, dI_pyr, Ks = s["pools"], s["dI_new_pyr"], s["Ks"]
    cutoff_th = s["cutoff_th"]
    exposures, ref_aff = s["exposures"], s["ref_aff"]
    ar = torch.arange(L, device=dev)
    packed = [pack_bilinear(d) for d in dI_pyr]

    # 1. all hypotheses of every lane on the coarsest level: L*B rows
    T_tries, excl = s["T_tries"], s["try_exclude"]
    B = T_tries.shape[1]
    rows1 = ar[:, None].expand(L, B).reshape(-1)
    cl = coarsest_lvl
    cb = track_coarsest_batch(pools[cl], dI_pyr[cl], Ks[cl],
                              T_tries.reshape(L * B, 4, 4),
                              s["aff_last"][rows1], ref_aff[rows1],
                              exposures[rows1], cutoff_th, huber_th,
                              packed=packed[cl], lane=rows1)
    E, n = cb["E"].reshape(L, B), cb["n"].reshape(L, B)
    inf = torch.full_like(E, float("inf"))
    e = torch.where(n > 20, E / torch.clamp(n, min=1), inf)
    e = torch.where(torch.isfinite(e) & (~excl), e, inf)
    first = torch.argmin(e, dim=1)
    e_first = e.gather(1, first[:, None])[:, 0]
    first = torch.where((e[:, 0] <= e_first * 1.05) & (~excl[:, 0]),
                        torch.zeros_like(first), first)

    # 2. full-pyramid refinement of each lane's top candidates: L*k rows
    k = max(n_refine, 1)
    e_top = e.clone()
    e_top.scatter_(1, first[:, None], float("-inf"))
    # stable descending sort = lax.top_k's tie order (lower index first)
    top = torch.sort(-e_top, dim=1, descending=True, stable=True).indices[:, :k]
    cand_idx = torch.cat([first[:, None], top[:, 1:]], 1) if n_refine > 1 \
        else first[:, None]
    T_cand = cb["T"].reshape(L, B, 4, 4)[ar[:, None], cand_idx]
    rows2 = ar[:, None].expand(L, k).reshape(-1)
    trs = track_pyramid(pools, dI_pyr, Ks, T_cand.reshape(L * k, 4, 4),
                        s["aff_last"][rows2], ref_aff[rows2],
                        exposures[rows2], s["min_res_for_abort"][rows2],
                        cutoff_th, huber_th, coarsest_lvl=cl, finest_lvl=0,
                        packed_pyr=packed, lane=rows2)
    res0 = trs["res"][:, 0].reshape(L, k)
    score = torch.where(trs["ok"].reshape(L, k) & torch.isfinite(res0), res0,
                        torch.full_like(res0, float("inf")))
    bias = torch.full((k,), 1.02, dtype=score.dtype, device=dev)
    bias[0].fill_(1.0)
    score = score * bias
    kbest = torch.argmin(score, dim=1)
    tr = {kk: v[ar * k + kbest] for kk, v in trs.items()}
    best = cand_idx.gather(1, kbest[:, None])[:, 0]
    T_ref2fh = tr["T"]
    T_wc_fh = s["ref_T_wc"] @ se3.inverse(T_ref2fh)

    # 3. semi-direct matching of each lane's window map into its new frame
    K0 = s["K0"]
    match = reproject_and_match_lanes(
        s["pt_u"], s["pt_v"], s["pt_idepth"], s["pt_host"], s["pt_type"],
        s["pt_valid"], s["pt_quality"], s["pt_is_sensor"], s["T_wc_stack"],
        s["aff_stack"], s["exposure_stack"], s["dI0_stack"], s["flat_new"],
        s["offsets"], s["widths"], s["heights"], T_wc_fh, tr["aff"],
        exposures[:, 1], K0, s["ref_idx_per_point"],
        w=w, h=h, max_level=max_level, closest_view=closest_view,
        frame_valid=s["frame_valid"], closest_view_margin=closest_view_margin,
        closest_view_sensor_only=closest_view_sensor_only,
        n_iter=align_max_iters,
        quad_stack=None if quad_stacks is None else torch.cat(quad_stacks))
    n_matched = match["matched"].sum(-1)

    # 4. struct pose refinement against the matched pixels, per lane
    fx, fy, cx, cy = (K0[:, i:i + 1] for i in range(4))
    xn = (s["pt_u"] - cx) / fx
    yn = (s["pt_v"] - cy) / fy
    pr = torch.stack([xn, yn, torch.ones_like(xn)], -1) / \
        torch.clamp(s["pt_idepth"], min=1e-9)[..., None]
    T_wc_stack = s["T_wc_stack"]
    host = torch.clamp(s["pt_host"].long(), 0, T_wc_stack.shape[1] - 1)
    T_wc_h = T_wc_stack[ar[:, None], host]
    pw = torch.einsum("lnij,lnj->lni", T_wc_h[..., :3, :3], pr) + \
        T_wc_h[..., :3, 3]
    sp = struct_pose_estimate(T_wc_fh, pw, match["px"], match["matched"],
                              K0, w, h, standardize=struct_pose_mad)
    # photometric veto of the struct pose on level 1
    T_sp = sp["T_cur_to_world"]
    aff_rel = aff_transfer(exposures[:, 0], exposures[:, 1], ref_aff,
                           tr["aff"])
    g = 1
    T_pair = torch.stack([se3.inverse(T_wc_fh) @ s["ref_T_wc"],
                          se3.inverse(T_sp) @ s["ref_T_wc"]], 1)
    rows3 = ar[:, None].expand(L, 2).reshape(-1)
    r = calc_res_gs(pools[g], dI_pyr[g], Ks[g], T_pair.reshape(L * 2, 4, 4),
                    aff_rel[rows3], ref_aff[rows3, 1], cutoff_th, huber_th,
                    packed=packed[g], lane=rows3)
    rE, rn = r["E"].reshape(L, 2), r["n"].reshape(L, 2)
    e_fh = rE[:, 0] / torch.clamp(rn[:, 0], min=1)
    e_sp = rE[:, 1] / torch.clamp(rn[:, 1], min=1)
    sp_ok = (e_sp <= e_fh * etol_sq) & (rn[:, 1] > 0.5 * rn[:, 0])
    sp_dt = torch.linalg.vector_norm(T_sp[:, :3, 3] - T_wc_fh[:, :3, 3],
                                     dim=-1)
    sp_ok = sp_ok & ((mdt <= 0.0) | (sp_dt <= mdt))
    use_sp = sp_ok & (n_matched >= 10) & use_struct_pose
    T_wc_out = torch.where(use_sp[:, None, None], T_sp, T_wc_fh)
    finite = torch.isfinite(T_wc_out).all(dim=-1).all(dim=-1)
    T_wc_out = torch.where(finite[:, None, None], T_wc_out, T_wc_fh)

    return dict(T_ref_to_fh=T_ref2fh, T_wc=T_wc_out, aff=tr["aff"],
                res=tr["res"], flow=tr["flow"], ok=tr["ok"],
                n_matched=n_matched, best_try=best,
                matched=match["matched"], match_px=match["px"],
                lvl_iters=trs["lvl_iters"].reshape(L, k, -1).amax(dim=1))
