"""Keyframe device stages.

Counterpart of `sdv_loam_tpu/system/kf_ops.py`:

  * `activate_full` — activatePointsMT (FullSystem.cpp:569-723): level-1
    distance map of the projected active points (K2 kernel), eligibility
    and delete flags, the spread test, and the batched activation depth-GN;
  * `kf_opt_step` — the post-activation keyframe tail: matcher refresh,
    windowed LM, removeOutliers, the tracking-reference rebuild (K1 kernel),
    point marginalization and frame marginalization of flagged slots;
  * the device-pool commits that mirror the host bookkeeping.

The activation and the keyframe optimization each run as one stage
program (`utils/device_loop.program`): one captured CUDA graph per shape
on the card, with their host values made device inputs before the call.
"""

from __future__ import annotations

import torch

from sdv_loam_tpu_torch.models import backend
from sdv_loam_tpu_torch.models.matcher import (
    reproject_and_match_lanes, reproject_and_match_multi_lanes, stack_quads)
from sdv_loam_tpu_torch.ops import trace as trace_ops
from sdv_loam_tpu_torch.ops.distmap import distance_map_lanes
from sdv_loam_tpu_torch.ops.photometric import (build_track_ref,
                                                nonzero_fixed, splat_idepth)
from sdv_loam_tpu_torch.utils import device_loop, se3

# Lanes: `activate_full_lanes` and `kf_opt_step_lanes` run L sequences'
# keyframe stages at once (the JAX package's `activate_full_batch` and
# `kf_opt_step_batch`): every tensor carries a leading L, per-sequence
# host values come as per-lane lists, and each lane computes what the
# sequence computes alone. The single-sequence functions are lane 0.

def activate_full(
        im, pt_u, pt_v, pt_idepth, pt_host, pt_valid,
        newest_slot, slot_used, slot_flagged,
        KRKi1, Kt1, R_pair, t_pair, aff_pair, dI0_stack, K,
        min_act_dist, min_trace_quality, min_idepth_h_act,
        w: int, h: int, w1: int, h1: int, n_frames: int, a_cap: int,
        gn_iters: int = 3):
    """activatePointsMT (`_activate_full_impl` of the JAX package). `im` is
    the device immature pool (IM_FIELDS + im_valid). Lane 0 of
    `activate_full_lanes`. Returns dict(dead, kill, drop_oob, keep,
    cand_idx, lane_valid, success, idepth, inlier_targets, im_valid,
    im_status)."""
    out = activate_full_lanes(
        {k: v[None] for k, v in im.items()},
        *(x[None] for x in (pt_u, pt_v, pt_idepth, pt_host, pt_valid)),
        [newest_slot],
        *(x[None] for x in (slot_used, slot_flagged, KRKi1, Kt1, R_pair,
                            t_pair, aff_pair, dI0_stack, K)),
        [min_act_dist], [min_trace_quality], [min_idepth_h_act],
        w=w, h=h, w1=w1, h1=h1, n_frames=n_frames, a_cap=a_cap,
        gn_iters=gn_iters)
    return {k: v[0] for k, v in out.items()}


def activate_full_lanes(
        im, pt_u, pt_v, pt_idepth, pt_host, pt_valid,
        newest_slot, slot_used, slot_flagged,
        KRKi1, Kt1, R_pair, t_pair, aff_pair, dI0_stack, K,
        min_act_dist, min_trace_quality, min_idepth_h_act,
        w: int, h: int, w1: int, h1: int, n_frames: int, a_cap: int,
        gn_iters: int = 3):
    """`activate_full` of L sequences: the pools (L, M) / (L, N), window
    stacks (L, F, ...); `newest_slot` and the three thresholds per-lane
    host lists. One K2 call takes every lane's level-1 distance map. A
    larger `a_cap` than a lane needs (the fleet's widest) only adds
    invalid compaction rows, so each lane's result is unchanged. One stage
    program (`device_loop.program`, "activate"): the newest slots and the
    thresholds are its device inputs."""
    x = dict(im=dict(im), pt_u=pt_u, pt_v=pt_v, pt_idepth=pt_idepth,
             pt_host=pt_host, pt_valid=pt_valid,
             newest=torch.as_tensor([int(s) for s in newest_slot],
                                    device=pt_u.device)[:, None],
             slot_used=slot_used, slot_flagged=slot_flagged, KRKi1=KRKi1,
             Kt1=Kt1, R_pair=R_pair, t_pair=t_pair, aff_pair=aff_pair,
             dI0_stack=dI0_stack, K=K,
             min_act_dist=trace_ops._lane_floats(min_act_dist, pt_u, 2),
             min_trace_quality=trace_ops._lane_floats(min_trace_quality,
                                                      pt_u, 2),
             min_idepth_h_act=trace_ops._lane_floats(min_idepth_h_act,
                                                     pt_u, 2))
    return device_loop.program(
        "activate", _activate_program, x,
        dict(w=int(w), h=int(h), w1=int(w1), h1=int(h1),
             n_frames=int(n_frames), a_cap=int(a_cap),
             gn_iters=int(gn_iters)))


def _activate_program(x, w, h, w1, h1, n_frames, a_cap, gn_iters):
    im = x["im"]
    (pt_u, pt_v, pt_idepth, pt_host, pt_valid, newest, slot_used,
     slot_flagged, KRKi1, Kt1, R_pair, t_pair, aff_pair, dI0_stack,
     K) = (x[k] for k in (
         "pt_u", "pt_v", "pt_idepth", "pt_host", "pt_valid", "newest",
         "slot_used", "slot_flagged", "KRKi1", "Kt1", "R_pair", "t_pair",
         "aff_pair", "dI0_stack", "K"))
    F = n_frames
    dev = pt_u.device
    L, M = im["u"].shape
    ar = torch.arange(L, device=dev)[:, None]
    im_u, im_v = im["u"], im["v"]
    im_idepth_min, im_idepth_max = im["idepth_min"], im["idepth_max"]
    im_status, im_quality = im["status"], im["quality"]
    im_host = im["host"].long()
    im_is_sensor, im_valid = im["is_sensor"], im["im_valid"]
    pt_host = pt_host.long()

    # level-1 distance map from projected active points (excl. newest)
    pm = pt_valid & (pt_host != newest)
    p = torch.stack([pt_u, pt_v, torch.ones_like(pt_u)], -1)
    hcl = torch.clamp(pt_host, 0, F - 1)
    ptp = torch.einsum("lnij,lnj->lni", KRKi1[ar, hcl], p) + \
        Kt1[ar, hcl] * pt_idepth[..., None]
    uu = (ptp[..., 0] / ptp[..., 2] + 0.5).to(torch.int64)
    vv = (ptp[..., 1] / ptp[..., 2] + 0.5).to(torch.int64)
    dmap = distance_map_lanes(uu, vv, pm & (uu > 0) & (vv > 0) & (uu < w1)
                              & (vv < h1), w1, h1)

    # eligibility (activatePointsMT:605-660)
    eligible = im_valid & ~((~im_is_sensor) & (im_host == newest))
    dead = eligible & ((~torch.isfinite(im_idepth_max))
                       | (im_status == trace_ops.IPS_OUTLIER))
    eligible = eligible & ~dead
    can = ((im_status == trace_ops.IPS_GOOD)
           | (im_status == trace_ops.IPS_SKIPPED)
           | (im_status == trace_ops.IPS_BADCONDITION)
           | (im_status == trace_ops.IPS_OOB))
    can = can & (im["pixel_interval"] < 8) & \
        (im_quality > x["min_trace_quality"]) & \
        ((im_idepth_max + im_idepth_min) > 0)
    cannot = eligible & ~can
    ihcl = torch.clamp(im_host, 0, F - 1)
    kill = cannot & (slot_flagged[ar, ihcl] | (im_status == trace_ops.IPS_OOB))
    cand = eligible & can

    # spread test on the level-1 distance map (:684-719)
    mid = 0.5 * (torch.clamp(im_idepth_max, 0, 1e6) + im_idepth_min)
    pim = torch.stack([im_u, im_v, torch.ones_like(im_u)], -1)
    ptpi = torch.einsum("lnij,lnj->lni", KRKi1[ar, ihcl], pim) + \
        Kt1[ar, ihcl] * mid[..., None]
    ui = ptpi[..., 0] / ptpi[..., 2]
    vi = ptpi[..., 1] / ptpi[..., 2]
    uii = (ui + 0.5).to(torch.int64)
    vii = (vi + 0.5).to(torch.int64)
    inb = (uii > 0) & (vii > 0) & (uii < w1) & (vii < h1)
    dist = dmap[ar, torch.clamp(vii, 0, h1 - 1),
                torch.clamp(uii, 0, w1 - 1)] + (ui - torch.floor(ui))
    mad = x["min_act_dist"]
    keep = cand & inb & (dist >= mad * im["my_type"])
    drop_oob = cand & ~inb

    cidx = nonzero_fixed(keep, a_cap, M - 1)
    lane_valid = torch.arange(a_cap, device=dev) < keep.sum(-1)[:, None]
    out = trace_ops.activate_points_lanes(
        im_u[ar, cidx], im_v[ar, cidx], mid[ar, cidx], im["color"][ar, cidx],
        im["weights"][ar, cidx], im_host[ar, cidx], im_is_sensor[ar, cidx],
        lane_valid, slot_used, R_pair, t_pair, aff_pair, dI0_stack, K,
        im["energy_th"][ar, cidx], w=w, h=h, n_frames=F,
        min_idepth_h_act=x["min_idepth_h_act"], min_obs=1,
        gn_iters=gn_iters)

    lanes = torch.zeros(L * (M + 1), dtype=torch.bool, device=dev)
    lanes.index_fill_(0, (ar * (M + 1) + torch.where(
        lane_valid, cidx, torch.full_like(cidx, M))).reshape(-1), True)
    lanes = lanes.reshape(L, M + 1)[:, :M]
    im_valid_new = im_valid & ~(dead | kill | drop_oob) & ~lanes
    im_status_new = torch.where(im_valid & ~im_valid_new,
                                torch.full_like(im_status, trace_ops.IPS_OOB),
                                im_status)
    return dict(dead=dead, kill=kill, drop_oob=drop_oob, keep=keep,
                cand_idx=cidx, lane_valid=lane_valid,
                success=out["success"] & lane_valid, idepth=out["idepth"],
                inlier_targets=out["inlier_targets"],
                im_valid=im_valid_new, im_status=im_status_new)


# kf_opt_step's per-sequence tensor arguments
KF_TENSOR_ARGS = (
    "T_cw_fej", "eps", "calib", "calib_zero", "frame_valid", "frame_prior",
    "c_prior", "aff", "exposure", "HM", "bM", "frame_energy_th",
    "slot_flagged", "pt_u", "pt_v", "pt_idepth", "pt_host", "pt_color",
    "pt_weights", "pt_is_sensor", "pt_prior", "pt_valid", "pt_type",
    "pt_quality", "pt_idepth_hessian", "num_good_res", "res_active",
    "res_state", "res_is_new", "matcher_px", "matcher_valid", "dI0_stack",
    "flat_newest", "flat_slots_stack", "ref_idx_newest", "ref_idx_multi",
    "multi_target_mask", "prior_marg")
# ... its per-sequence host values (one list entry per lane), made device
# inputs of the program before it runs
KF_HOST_ARGS = ("newest", "max_iters", "min_opt_iterations",
                "th_opt_iterations", "force_accept")
# ... and the level tables, shared by the lanes
KF_SHARED_ARGS = ("offs", "widths", "heights")
# The windowed LM's static iteration bound in the program: the largest
# budget FullSystem gives (100 while the window holds fewer than three
# keyframes, then 75, then `max_opt_iterations`). Each lane stops at its
# own budget on the device, so every budget and the veto's re-runs replay
# one program; a larger budget raises the bound.
KF_ITERS_CAP = 100


def kf_opt_step(
        T_cw_fej, eps, calib, calib_zero, frame_valid, frame_prior, c_prior,
        aff, exposure, HM, bM, newest, frame_energy_th, slot_flagged,
        pt_u, pt_v, pt_idepth, pt_host, pt_color, pt_weights, pt_is_sensor,
        pt_prior, pt_valid, pt_type, pt_quality, pt_idepth_hessian,
        num_good_res, res_active, res_state, res_is_new,
        matcher_px, matcher_valid, dI0_stack,
        flat_newest, offs, widths, heights, flat_slots_stack,
        ref_idx_newest, ref_idx_multi, multi_target_mask,
        dI_newest_pyr,
        max_iters, min_opt_iterations, th_opt_iterations, force_accept,
        lm_diag_floor,
        prior_marg, marg_weight_fac, min_good_active_res_for_marg,
        min_good_res_for_marg, min_idepth_h_marg,
        n_frames: int, w: int, h: int, max_level: int, levels: int,
        **statics):
    """The post-activation keyframe tail (`_kf_opt_step_impl` of the JAX
    package; see the module docstring), lane 0 of `kf_opt_step_lanes`.
    `newest`, `max_iters`, `min_opt_iterations`, `th_opt_iterations`,
    `force_accept` and `lm_diag_floor` are host values;
    `flat_slots_stack` the (F, T, 3) stack of the window's flat pyramids
    (zeros at free slots) and `multi_target_mask` an (F,) bool tensor of
    the second matcher pass's targets."""
    kw = dict(locals())          # every argument above, by name
    kw.pop("statics")
    lanes = {k: kw[k][None] for k in KF_TENSOR_ARGS}
    lanes.update({k: [kw[k]] for k in KF_HOST_ARGS})
    lanes.update({k: kw[k] for k in KF_SHARED_ARGS})
    lanes["dI_newest_pyr"] = tuple(x[None] for x in dI_newest_pyr)
    out = kf_opt_step_lanes(
        **lanes, lm_diag_floor=lm_diag_floor,
        marg_weight_fac=marg_weight_fac,
        min_good_active_res_for_marg=min_good_active_res_for_marg,
        min_good_res_for_marg=min_good_res_for_marg,
        min_idepth_h_marg=min_idepth_h_marg, n_frames=n_frames, w=w, h=h,
        max_level=max_level, levels=levels, **statics)
    return lane_of(out, 0)


def lane_of(out, j):
    """Lane j of a lane-form result dict (the tracking reference is a
    tuple over levels of dicts)."""
    res = {k: v[j] for k, v in out.items() if k != "track_ref"}
    if "track_ref" in out:
        res["track_ref"] = tuple({k: v[j] for k, v in lvl.items()}
                                 for lvl in out["track_ref"])
    return res


def kf_opt_step_lanes(
        T_cw_fej, eps, calib, calib_zero, frame_valid, frame_prior, c_prior,
        aff, exposure, HM, bM, newest, frame_energy_th, slot_flagged,
        pt_u, pt_v, pt_idepth, pt_host, pt_color, pt_weights, pt_is_sensor,
        pt_prior, pt_valid, pt_type, pt_quality, pt_idepth_hessian,
        num_good_res, res_active, res_state, res_is_new,
        matcher_px, matcher_valid, dI0_stack,
        flat_newest, offs, widths, heights, flat_slots_stack,
        ref_idx_newest, ref_idx_multi, multi_target_mask,
        dI_newest_pyr,
        max_iters, min_opt_iterations, th_opt_iterations, force_accept,
        lm_diag_floor,
        prior_marg, marg_weight_fac, min_good_active_res_for_marg,
        min_good_res_for_marg, min_idepth_h_marg,
        n_frames: int, w: int, h: int, max_level: int, levels: int,
        track_ref_cap=16384, gate_refresh: bool = False,
        resf_at_fej: bool = True, p1_cap: int = 0, p2_cap: int = 0,
        closest_view: bool = False, closest_view_margin=0.0,
        closest_view_sensor_only=False, align_max_iters: int = 10,
        solve_dtype=None):
    """`kf_opt_step` of L sequences: tensors (KF_TENSOR_ARGS) carry a
    leading L, `dI_newest_pyr` is a tuple over levels of (L, ...) stacks,
    and the KF_HOST_ARGS are per-lane host lists (`lm_diag_floor` one host
    float). Larger `p1_cap` / `p2_cap` than a lane needs (the fleet's
    widest) only add invalid compaction rows. The matcher passes run every
    target index once for all lanes, the windowed LM runs the lanes to the
    fleet's largest iteration count with stopped lanes frozen, one K1
    launch builds every lane's tracking reference, and frame
    marginalization runs per flagged (lane, slot) pair. One stage program
    (`device_loop.program`, "kf_opt"): the host values are its device
    inputs (`backend.ba_controls`), so a program's key is the lane count
    and the caps. Returns kf_opt_step's dict with a leading L."""
    L = pt_u.shape[0]
    x = dict(
        T_cw_fej=T_cw_fej, eps=eps, calib=calib, calib_zero=calib_zero,
        frame_valid=frame_valid, frame_prior=frame_prior, c_prior=c_prior,
        aff=aff, exposure=exposure, HM=HM, bM=bM,
        frame_energy_th=frame_energy_th, slot_flagged=slot_flagged,
        pt_u=pt_u, pt_v=pt_v, pt_idepth=pt_idepth, pt_host=pt_host,
        pt_color=pt_color, pt_weights=pt_weights, pt_is_sensor=pt_is_sensor,
        pt_prior=pt_prior, pt_valid=pt_valid, pt_type=pt_type,
        pt_quality=pt_quality, num_good_res=num_good_res,
        res_active=res_active, res_state=res_state, res_is_new=res_is_new,
        matcher_px=matcher_px, matcher_valid=matcher_valid,
        dI0_stack=dI0_stack, flat_newest=flat_newest, offs=offs,
        widths=widths, heights=heights, flat_slots_stack=flat_slots_stack,
        ref_idx_newest=ref_idx_newest, ref_idx_multi=ref_idx_multi,
        multi_target_mask=multi_target_mask,
        dI_newest_pyr=tuple(dI_newest_pyr), prior_marg=prior_marg,
        ctl=backend.ba_controls(newest, max_iters, min_opt_iterations,
                                th_opt_iterations, force_accept,
                                [lm_diag_floor] * L, pt_u.device))
    static = dict(
        marg_weight_fac=float(marg_weight_fac),
        min_good_active_res_for_marg=min_good_active_res_for_marg,
        min_good_res_for_marg=min_good_res_for_marg,
        min_idepth_h_marg=min_idepth_h_marg, n_frames=int(n_frames),
        w=int(w), h=int(h), max_level=int(max_level), levels=int(levels),
        iter_cap=max([KF_ITERS_CAP] + [int(v) for v in max_iters]),
        track_ref_cap=track_ref_cap, gate_refresh=bool(gate_refresh),
        resf_at_fej=bool(resf_at_fej), p1_cap=int(p1_cap),
        p2_cap=int(p2_cap), closest_view=bool(closest_view),
        closest_view_margin=float(closest_view_margin),
        closest_view_sensor_only=bool(closest_view_sensor_only),
        align_max_iters=int(align_max_iters), solve_dtype=solve_dtype)
    return device_loop.program("kf_opt", _kf_opt_program, x, static)


def _kf_opt_program(
        x, marg_weight_fac, min_good_active_res_for_marg,
        min_good_res_for_marg, min_idepth_h_marg, n_frames, w, h, max_level,
        levels, iter_cap, track_ref_cap, gate_refresh, resf_at_fej, p1_cap,
        p2_cap, closest_view, closest_view_margin, closest_view_sensor_only,
        align_max_iters, solve_dtype):
    (T_cw_fej, eps, calib, calib_zero, frame_valid, frame_prior, c_prior,
     aff, exposure, HM, bM, frame_energy_th, slot_flagged, pt_u, pt_v,
     pt_idepth, pt_host, pt_color, pt_weights, pt_is_sensor, pt_prior,
     pt_valid, pt_type, pt_quality, num_good_res, res_active, res_state,
     res_is_new, matcher_px, matcher_valid, dI0_stack, flat_newest, offs,
     widths, heights, flat_slots_stack, ref_idx_newest, ref_idx_multi,
     multi_target_mask, dI_newest_pyr, prior_marg, ctl) = (x[k] for k in (
         "T_cw_fej", "eps", "calib", "calib_zero", "frame_valid",
         "frame_prior", "c_prior", "aff", "exposure", "HM", "bM",
         "frame_energy_th", "slot_flagged", "pt_u", "pt_v", "pt_idepth",
         "pt_host", "pt_color", "pt_weights", "pt_is_sensor", "pt_prior",
         "pt_valid", "pt_type", "pt_quality", "num_good_res", "res_active",
         "res_state", "res_is_new", "matcher_px", "matcher_valid",
         "dI0_stack", "flat_newest", "offs", "widths", "heights",
         "flat_slots_stack", "ref_idx_newest", "ref_idx_multi",
         "multi_target_mask", "dI_newest_pyr", "prior_marg", "ctl"))
    F = n_frames
    dev = pt_u.device
    L = pt_u.shape[0]
    ar = torch.arange(L, device=dev)
    newest_t = ctl["newest"]
    newest_c = newest_t[:, None]
    fvalid_f = frame_valid.to(T_cw_fej.dtype)
    frame_valid_b = frame_valid.to(torch.bool)
    pt_host = pt_host.long()
    quad_stack = stack_quads(dI0_stack)
    ar_f = torch.arange(F, device=dev)

    T_cw = se3.se3_exp(eps) @ T_cw_fej
    T_wc = se3.inverse(T_cw)

    # matcher pass 1: ALL old-host points -> newest frame
    hf = pt_valid & (pt_host != newest_c)
    fresh = reproject_and_match_lanes(
        pt_u, pt_v, pt_idepth, pt_host, pt_type, hf, pt_quality,
        pt_is_sensor, T_wc, aff, exposure, dI0_stack, flat_newest, offs,
        widths, heights, T_wc[ar, newest_t], aff[ar, newest_t],
        exposure[ar, newest_t], calib, ref_idx_newest, w=w, h=h,
        max_level=max_level, per_cell=False, lane_cap_frac=0.625,
        lane_cap=p1_cap, closest_view=closest_view,
        frame_valid=frame_valid_b, exclude_slot=newest_t,
        closest_view_margin=closest_view_margin,
        closest_view_sensor_only=closest_view_sensor_only,
        n_iter=align_max_iters, quad_stack=quad_stack)
    upd_fresh = fresh["matched"] & hf
    col_new = ar_f == newest_c                                      # (L,F)
    matcher_px = torch.where(upd_fresh[..., None, None]
                             & col_new[:, None, :, None],
                             fresh["px"][:, :, None, :], matcher_px)
    matcher_valid = matcher_valid | (upd_fresh[..., None]
                                     & col_new[:, None, :])

    # matcher pass 2: newest-host points -> each older frame; a target no
    # lane runs costs no device work, and a lane that skips a target
    # another lane runs gets its rows masked
    nf = pt_valid & (pt_host == newest_c)
    mtm = multi_target_mask
    multi = reproject_and_match_multi_lanes(
        pt_u, pt_v, pt_idepth, pt_host, pt_type, nf, pt_quality,
        pt_is_sensor, T_wc, aff, exposure, dI0_stack, flat_slots_stack, offs,
        widths, heights, T_wc, aff, exposure, calib, ref_idx_multi,
        w=w, h=h, max_level=max_level, per_cell=False,
        closest_view=closest_view, frame_valid=frame_valid_b,
        exclude_slots=list(range(F)),
        closest_view_margin=closest_view_margin,
        closest_view_sensor_only=closest_view_sensor_only,
        lane_cap_frac=0.5, lane_cap=p2_cap, n_iter=align_max_iters,
        target_mask=mtm, quad_stack=quad_stack)
    mm = multi["matched"].transpose(1, 2) & nf[..., None] & mtm[:, None, :]
    mpx = multi["px"].transpose(1, 2)
    matcher_px = torch.where(mm[..., None], mpx, matcher_px)
    matcher_valid = matcher_valid | mm
    res_active = res_active | mm
    res_is_new = res_is_new | mm

    # windowed LM
    res_active_v = res_active & pt_valid[..., None]
    out, lin_f, pairs_f = backend.ba_core_ctl(
        T_cw_fej, eps, calib, calib_zero, frame_valid_b, frame_prior,
        c_prior, aff, exposure, HM, bM, frame_energy_th,
        pt_u, pt_v, pt_idepth, pt_host, pt_color, pt_weights, pt_is_sensor,
        pt_prior, res_active_v, res_state, matcher_px, matcher_valid,
        dI0_stack, ctl, n_frames=F, w=w, h=h, iter_cap=iter_cap,
        gate_refresh=gate_refresh, resf_at_fej=resf_at_fej,
        solve_dtype=solve_dtype)
    new_state = out["new_state"]
    idepth_f = out["idepth"]
    Hdd_f = out["Hdd"]
    centers = out["center"]

    good_new = (new_state == backend.RES_IN) & res_is_new
    num_good_res = num_good_res + good_new.sum(dim=2)

    st_in = new_state == backend.RES_IN
    st_oob = new_state == backend.RES_OOB
    st_out = new_state == backend.RES_OUTLIER

    def _fates(sel):
        a = res_active_v & sel
        return torch.stack([
            (a & st_in).sum(dim=(1, 2)),
            (a & st_oob & matcher_valid).sum(dim=(1, 2)),
            (a & st_oob & ~matcher_valid).sum(dim=(1, 2)),
            (a & st_out).sum(dim=(1, 2))], -1)

    res_diag = torch.stack([_fates(res_is_new), _fates(~res_is_new)], 1)

    # removeOutliers: drop non-IN residuals, then point-less points
    keep_res = res_active_v & st_in
    matcher_valid = matcher_valid & ~(res_active_v & ~st_in)
    res_active2 = keep_res
    pt_dead_outlier = pt_valid & ~res_active2.any(dim=2)
    pt_valid2 = pt_valid & ~pt_dead_outlier

    # tracking reference (makeCoarseDepthL0) from the post-BA state: one
    # K1 launch for every lane
    hdif = 1.0 / torch.clamp(Hdd_f, min=1e-10)
    wgt_splat = torch.sqrt(1e-3 / (hdif + 1e-12))
    newest_col = res_active2[ar, :, newest_t]
    m_new = pt_valid2 & pt_is_sensor & (pt_host == newest_c)
    m_oth = pt_valid2 & pt_is_sensor & (pt_host != newest_c) & newest_col
    c_new = centers[ar, :, newest_t]
    su = torch.where(m_new, pt_u.to(torch.int64),
                     (c_new[..., 0] + 0.5).to(torch.int64))
    sv = torch.where(m_new, pt_v.to(torch.int64),
                     (c_new[..., 1] + 0.5).to(torch.int64))
    sid = torch.where(m_new, idepth_f, c_new[..., 2])
    sok = (m_new | m_oth) & (su >= 0) & (su < w) & (sv >= 0) & (sv < h) \
        & (sid > 0)
    id0, w0 = splat_idepth(su, sv, sid, wgt_splat, sok, w, h)
    track_ref = build_track_ref(dI_newest_pyr, id0, w0, levels,
                                cap=track_ref_cap)

    # flagPointsForRemoval
    n_res = res_active2.sum(dim=2)
    hcl = torch.clamp(pt_host, 0, F - 1)
    host_old = pt_valid2 & (pt_host != newest_c) & \
        frame_valid_b.gather(1, hcl)
    bad = host_old & ((idepth_f < 0) | (n_res == 0))
    rest = host_old & ~bad
    flag_exit = slot_flagged.gather(1, hcl)
    oob = rest & (flag_exit
                  | ((n_res >= min_good_active_res_for_marg)
                     & (num_good_res > min_good_res_for_marg + 10)
                     & (~newest_col)))
    inlier = (n_res >= min_good_active_res_for_marg) \
        & (num_good_res >= min_good_res_for_marg)
    strong = inlier & (Hdd_f > min_idepth_h_marg)
    marg = oob & strong
    drop = bad | (oob & ~strong)

    dHM, dbM = backend.marginalize_points_lanes(
        lin_f, pt_host, pt_is_sensor, prior_marg, marg,
        out["eps"] * fvalid_f[..., None],
        torch.zeros((L, 4), dtype=calib.dtype, device=dev), pairs_f,
        n_frames=F, marg_weight_fac=marg_weight_fac)
    HM2 = HM + dHM
    bM2 = bM + dbM

    pt_dead_marg = drop | marg
    pt_valid3 = pt_valid2 & ~pt_dead_marg
    res_active3 = res_active2 & pt_valid3[..., None]

    # frame marginalization: every (lane, slot) pair under a cond on its
    # flag, in slot order (the JAX package's fori_loop of lax.conds)
    res_active3 = res_active3 & ~slot_flagged[:, None, :]
    matcher_valid = matcher_valid & ~slot_flagged[:, None, :]
    pt_dead_frame = pt_valid3 & flag_exit
    pt_valid4 = pt_valid3 & ~pt_dead_frame
    death_diag = torch.stack([
        pt_dead_outlier.sum(-1), bad.sum(-1),
        ((drop | marg) & flag_exit).sum(-1),
        ((drop | marg) & ~flag_exit & ~bad).sum(-1),
        pt_dead_frame.sum(-1)], -1)

    HM3, bM3 = [], []
    for j in range(L):
        c = dict(HM=HM2[j], bM=bM2[j])
        for slot in range(F):
            c = device_loop.cond(
                "marg", slot_flagged[j, slot],
                lambda cc, j=j, slot=slot: dict(zip(
                    ("HM", "bM"), backend.marginalize_frame(
                        cc["HM"], cc["bM"], frame_prior[j, slot],
                        out["eps"][j, slot], slot, n_frames=F))), c)
        HM3.append(c["HM"])
        bM3.append(c["bM"])
    HM3, bM3 = torch.stack(HM3), torch.stack(bM3)

    host_oh = (hcl[..., None] == ar_f).to(torch.int64)
    stats_out = ((pt_dead_outlier | pt_dead_marg)[..., None]
                 * host_oh).sum(1)

    res = dict(
        eps=out["eps"], calib=out["calib"], T_cw_fej=out["T_cw_fej"],
        feth=out["feth"], energy=out["energy"], rmse=out["rmse"],
        lm_iters=out["lm_iters"], HM=HM3, bM=bM3, stats_out=stats_out,
        match_overflow=torch.stack([fresh["overflow"],
                                    multi["overflow"].amax(dim=1)], -1),
        match_diag=fresh["diag"], match_diag_p2=multi["diag"].sum(dim=1),
        res_diag=res_diag, death_diag=death_diag,
        idepth=idepth_f, new_state=new_state, pt_valid=pt_valid4,
        center=centers, num_good_res=num_good_res, idepth_hessian=Hdd_f,
        res_active=res_active3, matcher_px=matcher_px,
        matcher_valid=matcher_valid, track_ref=track_ref,
        # deep-log exports (read back only with Settings.log_stuff)
        H_final=out["H_final"], b_final=out["b_final"],
        nullspaces=out["nullspaces"])
    # every output dense in its shape's order, so the next keyframe's
    # inputs chained from them keep the program's key
    return {k: (tuple({f: t.contiguous() for f, t in lvl.items()}
                      for lvl in v) if k == "track_ref" else v.contiguous())
            for k, v in res.items()}


POOL_FIELDS = ("u", "v", "idepth", "host", "color", "weights", "is_sensor",
               "prior", "type", "quality")


def commit_pool_kf(pool, slot, act_rows, act_vals, act_res):
    """Apply the between-keyframe host mutations to the device active pool:
    residual insertion toward the new `slot` for every existing valid point,
    then the activation-row inserts at `act_rows` (R,) with field values
    `act_vals` and per-target residual rows `act_res` (R, F)."""
    ins = pool["pt_valid"] & (pool["host"] != slot)
    out = dict(pool)
    res_active = pool["res_active"].clone()
    res_active[:, slot] = ins
    res_state = pool["res_state"].clone()
    res_state[:, slot] = 0
    res_is_new = torch.zeros_like(pool["res_is_new"])
    res_is_new[:, slot] = ins
    matcher_valid = pool["matcher_valid"].clone()
    matcher_valid[:, slot] = False
    if act_rows.numel():
        for f, v in act_vals.items():
            t = pool[f].clone()
            t[act_rows] = v
            out[f] = t
        out["num_good_res"] = pool["num_good_res"].clone()
        out["num_good_res"][act_rows] = 0
        out["pt_valid"] = pool["pt_valid"].clone()
        out["pt_valid"][act_rows] = True
        res_active[act_rows] = act_res
        res_is_new[act_rows] = act_res
        res_state[act_rows] = 0
        matcher_valid[act_rows] = False
    out.update(res_active=res_active, res_state=res_state,
               res_is_new=res_is_new, matcher_valid=matcher_valid)
    return out


IM_FIELDS = ("u", "v", "idepth_min", "idepth_max", "host", "status",
             "quality", "color", "weights", "gradH", "energy_th",
             "is_sensor", "pixel_interval", "my_type")


def commit_im_rows(pool, rows, vals):
    """Insert new immature points into the device immature pool."""
    out = dict(pool)
    for f, v in vals.items():
        t = pool[f].clone()
        t[rows] = v
        out[f] = t
    out["im_valid"] = pool["im_valid"].clone()
    out["im_valid"][rows] = True
    return out


def im_clear_slots(pool, slot_mask):
    """Invalidate immature points hosted at marginalized slots (status
    forced OOB so later traces skip the freed rows)."""
    F = slot_mask.shape[0]
    dead = slot_mask[torch.clamp(pool["host"].long(), 0, F - 1)] & \
        pool["im_valid"]
    return dict(pool, im_valid=pool["im_valid"] & ~dead,
                status=torch.where(dead,
                                   torch.full_like(pool["status"],
                                                   trace_ops.IPS_OOB),
                                   pool["status"]))
