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
"""

from __future__ import annotations

import torch

from sdv_loam_tpu_torch.models.matcher import reproject_and_match
from sdv_loam_tpu_torch.ops.photometric import (aff_transfer, calc_res_gs,
                                                track_coarsest_batch,
                                                track_pyramid)
from sdv_loam_tpu_torch.ops.struct_pose import struct_pose_estimate
from sdv_loam_tpu_torch.ops.warp import pack_bilinear
from sdv_loam_tpu_torch.utils import se3


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
    packed = [pack_bilinear(d) for d in dI_new_pyr]

    # 1. all hypotheses on the coarsest level
    cb = track_coarsest_batch(pools[coarsest_lvl], dI_new_pyr[coarsest_lvl],
                              Ks[coarsest_lvl], T_tries, aff_last, ref_aff,
                              exposures, cutoff_th, huber_th,
                              packed=packed[coarsest_lvl])
    inf = torch.full_like(cb["E"], float("inf"))
    e = torch.where(cb["n"] > 20, cb["E"] / torch.clamp(cb["n"], min=1), inf)
    e = torch.where(torch.isfinite(e) & (~try_exclude), e, inf)
    first = torch.argmin(e)
    first = torch.where((e[0] <= e[first] * 1.05) & (~try_exclude[0]),
                        torch.zeros_like(first), first)

    # 2. full-pyramid refinement of the top candidates
    k = max(n_refine, 1)
    e_top = e.clone()
    e_top[first] = float("-inf")
    # stable descending sort = lax.top_k's tie order (lower index first)
    top = torch.sort(-e_top, descending=True, stable=True).indices[:k]
    cand_idx = torch.cat([first[None], top[1:]]) if n_refine > 1 \
        else first[None]
    trs = track_pyramid(pools, dI_new_pyr, Ks, cb["T"][cand_idx], aff_last,
                        ref_aff, exposures, min_res_for_abort, cutoff_th,
                        huber_th, coarsest_lvl=coarsest_lvl, finest_lvl=0,
                        packed_pyr=packed)
    score = torch.where(trs["ok"] & torch.isfinite(trs["res"][:, 0]),
                        trs["res"][:, 0],
                        torch.full_like(trs["res"][:, 0], float("inf")))
    bias = torch.full((k,), 1.02, dtype=score.dtype, device=score.device)
    bias[0] = 1.0
    score = score * bias
    kbest = torch.argmin(score)
    tr = {kk: v[kbest] for kk, v in trs.items()}
    best = cand_idx[kbest]
    T_ref2fh = tr["T"]
    T_wc_fh = ref_T_wc @ se3.inverse(T_ref2fh)

    # 3. semi-direct matching of the window map into the new frame
    match = reproject_and_match(
        pt_u, pt_v, pt_idepth, pt_host, pt_type, pt_valid, pt_quality,
        pt_is_sensor, T_wc_stack, aff_stack, exposure_stack, dI0_stack,
        flat_new, offsets, widths, heights,
        T_wc_fh, tr["aff"], exposures[1], K0, ref_idx_per_point,
        w=w, h=h, max_level=max_level, closest_view=closest_view,
        frame_valid=frame_valid, closest_view_margin=closest_view_margin,
        closest_view_sensor_only=closest_view_sensor_only,
        n_iter=align_max_iters, quad_stack=quad_stack)
    n_matched = match["matched"].sum()

    # 4. struct pose refinement against the matched pixels
    fx, fy, cx, cy = K0[0], K0[1], K0[2], K0[3]
    xn = (pt_u - cx) / fx
    yn = (pt_v - cy) / fy
    pr = torch.stack([xn, yn, torch.ones_like(xn)], -1) / \
        torch.clamp(pt_idepth, min=1e-9)[:, None]
    T_wc_h = T_wc_stack[torch.clamp(pt_host.long(), 0,
                                    T_wc_stack.shape[0] - 1)]
    pw = torch.einsum("nij,nj->ni", T_wc_h[:, :3, :3], pr) + T_wc_h[:, :3, 3]
    sp = struct_pose_estimate(T_wc_fh, pw, match["px"], match["matched"],
                              K0, w, h, standardize=struct_pose_mad)
    # photometric veto of the struct pose on level 1
    T_sp = sp["T_cur_to_world"]
    aff_rel = aff_transfer(exposures[0], exposures[1], ref_aff,
                           tr["aff"])[None]
    g = 1
    T_pair = torch.stack([se3.inverse(T_wc_fh) @ ref_T_wc,
                          se3.inverse(T_sp) @ ref_T_wc])
    r = calc_res_gs(pools[g], dI_new_pyr[g], Ks[g], T_pair,
                    aff_rel.expand(2, 2), ref_aff[1], cutoff_th, huber_th,
                    packed=packed[g])
    e_fh = r["E"][0] / torch.clamp(r["n"][0], min=1)
    e_sp = r["E"][1] / torch.clamp(r["n"][1], min=1)
    sp_ok = (e_sp <= e_fh * (struct_pose_e_tol * struct_pose_e_tol)) \
        & (r["n"][1] > 0.5 * r["n"][0])
    sp_dt = torch.linalg.vector_norm(T_sp[:3, 3] - T_wc_fh[:3, 3])
    if struct_pose_max_dt > 0.0:
        sp_ok = sp_ok & (sp_dt <= struct_pose_max_dt)
    use_sp = sp_ok & (n_matched >= 10) & bool(use_struct_pose)
    T_wc_out = torch.where(use_sp, T_sp, T_wc_fh)
    T_wc_out = torch.where(torch.isfinite(T_wc_out).all(), T_wc_out, T_wc_fh)

    return dict(T_ref_to_fh=T_ref2fh, T_wc=T_wc_out, aff=tr["aff"],
                res=tr["res"], flow=tr["flow"], ok=tr["ok"],
                n_matched=n_matched, best_try=best,
                matched=match["matched"], match_px=match["px"],
                lvl_iters=trs["lvl_iters"].amax(dim=0))

