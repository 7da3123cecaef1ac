"""Reprojector — map-point reprojection + direct feature alignment.

Counterpart of `sdv_loam_tpu/models/matcher.py` (reference
Reprojector.{h,cpp}: reprojectPoint :601-616, reprojectCell :198-236,
findMatchDirect :238-293). All points are processed as one batch: grid
binning with a deterministic per-cell winner (min quality, then min index),
compaction to the aligned lanes, one batched alignment over the flattened
target pyramid, and the optional closest-viewing-direction patch reference
(getCloseViewObs, Reprojector.cpp:295-330).
"""

from __future__ import annotations

import torch

from sdv_loam_tpu_torch.ops.align import (best_search_level, quad_from_flat,
                                          quad_from_image, warp_align,
                                          warp_matrix_affine)
from sdv_loam_tpu_torch.ops.photometric import nonzero_fixed
from sdv_loam_tpu_torch.utils import device_loop, se3

CELL_SIZE = 25          # Reprojector::initializeGrid (:100)
PROJ_BOUNDARY = 8       # reprojectPoint (:609)
REF_BOUNDARY = 6        # findMatchDirect (:263): halfpatch+2


def _project(T_wc_inv, pts_world, K):
    """Project (L, N, 3) world points with per-lane (L, 4, 4) worldToCam
    and (L, 4) intrinsics: (L, N, 2) pixels and (L, N) depths."""
    fx, fy, cx, cy = (K[:, i:i + 1] for i in range(4))
    pf = torch.matmul(pts_world, T_wc_inv[:, :3, :3].transpose(1, 2)) + \
        T_wc_inv[:, None, :3, 3]
    z = pf[..., 2]
    zs = torch.where(z == 0, torch.full_like(z, 1e-9), z)
    return torch.stack([fx * pf[..., 0] / zs + cx, fy * pf[..., 1] / zs + cy],
                       dim=-1), z


def stack_quads(dI0_stack):
    """(F*H*W, 4) quad pack of a window stack's level-0 intensities (shared
    by every matcher call on the same stack); a lane stack (L, F, H, W, 3)
    packs lane after lane."""
    return torch.cat([quad_from_image(im[..., 0])
                      for im in dI0_stack.reshape((-1,) + dI0_stack.shape[-3:])],
                     0)


def reproject_and_match(pts_u, pts_v, pts_idepth, pts_host, pts_type,
                        pts_valid, pts_quality, pts_is_sensor,
                        T_wc_stack, aff_stack, exposure_stack,
                        dI0_stack, flat_pyr, offsets, widths, heights,
                        T_wc_target, aff_target, exposure_target,
                        K, ref_idx_per_point,
                        w: int, h: int, max_level: int,
                        per_cell: bool = True,
                        lane_cap_frac: float = 1.0,
                        lane_cap: int = 0,
                        closest_view: bool = False,
                        frame_valid=None,
                        exclude_slot=-1,
                        closest_view_margin=0.0,
                        closest_view_sensor_only=False,
                        n_iter: int = 10, quad_stack=None, quad_pyr=None):
    """Match window map points into a target frame.

    `per_cell=True` keeps one match attempt per 25-px cell (tracking pass);
    `per_cell=False` aligns every in-bounds point, compacted to a lane cap
    (keyframe matcher refresh). `quad_stack` / `quad_pyr` are the quad
    packs of `dI0_stack` and of the target pyramid when the caller hoists
    them. Returns dict(matched (N,), px (N, 2) level-0 target pixel,
    overflow, diag (5,)). `reproject_and_match_lanes` matches L sequences'
    maps at once."""
    def one(x):
        return None if x is None else x[None]
    out = reproject_and_match_lanes(
        *(x[None] for x in (pts_u, pts_v, pts_idepth, pts_host, pts_type,
                            pts_valid, pts_quality, pts_is_sensor,
                            T_wc_stack, aff_stack, exposure_stack, dI0_stack,
                            flat_pyr)),
        offsets, widths, heights,
        *(torch.as_tensor(x, device=pts_u.device)[None]
          for x in (T_wc_target, aff_target, exposure_target, K)),
        ref_idx_per_point[None], w=w, h=h, max_level=max_level,
        per_cell=per_cell, lane_cap_frac=lane_cap_frac, lane_cap=lane_cap,
        closest_view=closest_view, frame_valid=one(frame_valid),
        exclude_slot=exclude_slot, closest_view_margin=closest_view_margin,
        closest_view_sensor_only=closest_view_sensor_only, n_iter=n_iter,
        quad_stack=quad_stack, quad_pyr=quad_pyr)
    return {k: v[0] for k, v in out.items()}


def reproject_and_match_lanes(pts_u, pts_v, pts_idepth, pts_host, pts_type,
                              pts_valid, pts_quality, pts_is_sensor,
                              T_wc_stack, aff_stack, exposure_stack,
                              dI0_stack, flat_pyr, offsets, widths, heights,
                              T_wc_target, aff_target, exposure_target,
                              K, ref_idx_per_point,
                              w: int, h: int, max_level: int,
                              per_cell: bool = True,
                              lane_cap_frac: float = 1.0,
                              lane_cap: int = 0,
                              closest_view: bool = False,
                              frame_valid=None,
                              exclude_slot=-1,
                              closest_view_margin=0.0,
                              closest_view_sensor_only=False,
                              n_iter: int = 10, quad_stack=None,
                              quad_pyr=None):
    """`reproject_and_match` for L lanes (sequences) at once: every
    argument of the single version carries a leading L (points (L, N),
    window stacks (L, F, ...), dI0_stack (L, F, H, W, 3), flat_pyr
    (L, T, 3), targets (L, 4, 4) / (L, 2) / (L,), K (L, 4)); the level
    tables offsets / widths / heights are shared. Cells, compaction and
    scatters never mix lanes, and the alignment runs all lanes' candidates
    in one loop. Returns the single version's dict with a leading L."""
    L, N = pts_u.shape
    dev = pts_u.device
    F = T_wc_stack.shape[1]
    hh, ww = dI0_stack.shape[-3], dI0_stack.shape[-2]
    levels = max_level + 1
    ar = torch.arange(L, device=dev)
    fx, fy, cx, cy = (K[:, i:i + 1] for i in range(4))               # (L,1)

    host = torch.clamp(pts_host.to(torch.int64), 0, F - 1)
    T_wc_h = T_wc_stack[ar[:, None], host]                        # (L,N,4,4)
    xn = (pts_u - cx) / fx
    yn = (pts_v - cy) / fy
    p_ref = torch.stack([xn, yn, torch.ones_like(xn)], dim=-1) / \
        torch.clamp(pts_idepth, min=1e-9)[..., None]
    pw = torch.einsum("lnij,lnj->lni", T_wc_h[..., :3, :3], p_ref) + \
        T_wc_h[..., :3, 3]

    T_tw = se3.inverse(T_wc_target)
    px_t, z_t = _project(T_tw, pw, K)
    pxi = px_t.to(torch.int64)
    inb = (pts_valid & (z_t > 0)
           & (pxi[..., 0] >= PROJ_BOUNDARY) & (pxi[..., 0] < w - PROJ_BOUNDARY)
           & (pxi[..., 1] >= PROJ_BOUNDARY) & (pxi[..., 1] < h - PROJ_BOUNDARY))

    n_cols = -(-w // CELL_SIZE)
    n_rows = -(-h // CELL_SIZE)
    n_cells = n_cols * n_rows
    cell = torch.where(inb, (pxi[..., 1] // CELL_SIZE) * n_cols
                       + (pxi[..., 0] // CELL_SIZE),
                       torch.full_like(pxi[..., 0], n_cells))
    cell_g = cell + (ar * (n_cells + 1))[:, None]     # lanes never share cells

    idxs = torch.arange(N, device=dev).expand(L, N)
    if per_cell:
        BIGQ = 1e30
        q = torch.where(inb, pts_quality, torch.full_like(pts_quality, BIGQ))
        cell_minq = torch.full((L * (n_cells + 1),), BIGQ, dtype=q.dtype,
                               device=dev)
        cell_minq.scatter_reduce_(0, cell_g.reshape(-1), q.reshape(-1),
                                  reduce="amin")
        tie = inb & (q == cell_minq[cell_g])
        spare = (ar * (n_cells + 1) + n_cells)[:, None].expand(L, N)
        cell_mini = torch.full((L * (n_cells + 1),), N, dtype=torch.int64,
                               device=dev)
        cell_mini.scatter_reduce_(
            0, torch.where(tie, cell_g, spare).reshape(-1),
            torch.where(tie, idxs, torch.full_like(idxs, N)).reshape(-1),
            reduce="amin")
        winner = tie & (cell_mini[cell_g] == idxs)
        M = -(-n_cells // 8) * 8
        cidx = nonzero_fixed(winner, M, 0)
        lane_valid = torch.arange(M, device=dev)[None] < \
            winner.sum(-1)[:, None]
        overflow = torch.zeros(L, dtype=torch.int64, device=dev)
    else:
        cap = lane_cap if lane_cap > 0 else max(1, int(lane_cap_frac * N))
        cap = min(-(-cap // 8) * 8, N)
        M = cap
        cidx = nonzero_fixed(inb, cap, 0)
        lane_valid = torch.arange(cap, device=dev)[None] < \
            inb.sum(-1)[:, None]
        overflow = torch.clamp(inb.sum(-1) - cap, min=0)

    rl = ar[:, None]                                                # (L,1)
    pw_c = pw[rl, cidx]                                             # (L,M,3)
    px_t_c = px_t[rl, cidx]
    type_c = pts_type[rl, cidx]

    ref_idx = torch.clamp(ref_idx_per_point.to(torch.int64), 0,
                          F - 1)[rl, cidx]                          # (L,M)
    if closest_view:
        fx3, fy3, cx3, cy3 = (K[:, i, None, None] for i in range(4))
        T_fw = se3.inverse(T_wc_stack)                            # (L,F,4,4)
        pf_all = torch.einsum("lfij,lmj->lfmi", T_fw[..., :3, :3], pw_c) + \
            T_fw[:, :, None, :3, 3]
        z_all = pf_all[..., 2]
        zs_all = torch.where(z_all == 0, torch.full_like(z_all, 1e-9), z_all)
        u_all = fx3 * pf_all[..., 0] / zs_all + cx3
        v_all = fy3 * pf_all[..., 1] / zs_all + cy3
        vis = ((z_all > 0)
               & (u_all >= REF_BOUNDARY) & (u_all < w - REF_BOUNDARY)
               & (v_all >= REF_BOUNDARY) & (v_all < h - REF_BOUNDARY))
        if frame_valid is not None:
            vis = vis & frame_valid[:, :, None]
        # an int, or a per-lane tensor (no host data made into a tensor:
        # the track program runs this)
        excl = exclude_slot.reshape(-1, 1, 1) \
            if isinstance(exclude_slot, torch.Tensor) else int(exclude_slot)
        vis = vis & (torch.arange(F, device=dev)[None, :, None] != excl)
        c_f = T_wc_stack[..., :3, 3]                                 # (L,F,3)
        d_f = c_f[:, :, None, :] - pw_c[:, None, :, :]
        d_f = d_f / torch.clamp(torch.linalg.vector_norm(d_f, dim=-1,
                                                         keepdim=True),
                                min=1e-9)
        d_t = T_wc_target[:, None, :3, 3] - pw_c
        d_t = d_t / torch.clamp(torch.linalg.vector_norm(d_t, dim=-1,
                                                         keepdim=True),
                                min=1e-9)
        score = torch.where(vis, torch.einsum("lfmi,lmi->lfm", d_f, d_t),
                            torch.full_like(z_all, float("-inf")))
        # argmax keeps the FIRST maximum: far points' view-ray cosines tie
        # in float32, and they all re-reference to the lowest slot
        best = torch.argmax(score, dim=1)
        smax = torch.amax(score, dim=1)
        any_vis = smax > float("-inf")
        host_score = torch.gather(score, 1, ref_idx[:, None, :])[:, 0]
        better = smax > host_score + closest_view_margin
        if closest_view_sensor_only:
            better = better & pts_is_sensor[rl, cidx]
        ref_idx = torch.where(any_vis & better, best, ref_idx)
    T_wc_r = T_wc_stack[rl, ref_idx]                              # (L,M,4,4)
    T_rw = se3.inverse(T_wc_r)
    pf_r = torch.einsum("lmij,lmj->lmi", T_rw[..., :3, :3], pw_c) + \
        T_rw[..., :3, 3]
    z_r = pf_r[..., 2]
    zs = torch.where(z_r == 0, torch.full_like(z_r, 1e-9), z_r)
    px_r = torch.stack([fx * pf_r[..., 0] / zs + cx,
                        fy * pf_r[..., 1] / zs + cy], dim=-1)
    pxi_r = px_r.to(torch.int64)
    ref_ok = ((z_r > 0)
              & (pxi_r[..., 0] >= REF_BOUNDARY)
              & (pxi_r[..., 0] < w - REF_BOUNDARY)
              & (pxi_r[..., 1] >= REF_BOUNDARY)
              & (pxi_r[..., 1] < h - REF_BOUNDARY))
    cand = lane_valid & ref_ok

    # the per-candidate stages run on all lanes' candidates as L*M rows
    T_cur_ref = torch.einsum("lij,lmjk->lmik", T_tw, T_wc_r)
    K_rows = K[:, None, :].expand(L, M, 4).reshape(L * M, 4)
    A = warp_matrix_affine(px_r.reshape(-1, 2), z_r.reshape(-1), K_rows,
                           T_cur_ref.reshape(-1, 4, 4))
    lvl = best_search_level(A, max_level)
    if quad_stack is None:
        quad_stack = stack_quads(dI0_stack)
    slot_g = (rl * F + ref_idx).reshape(-1)          # row of the lane stack

    exp_r = exposure_stack[rl, ref_idx]
    exp_t = exposure_target[:, None]
    a_rel = torch.exp(aff_target[:, 0:1] - aff_stack[rl, ref_idx, 0]) * \
        torch.where((exp_r == 0) | (exp_t == 0), torch.ones_like(exp_r),
                    exp_t / exp_r)
    b_rel = aff_target[:, 1:2] - a_rel * aff_stack[rl, ref_idx, 1]
    lvl = lvl.reshape(L, M)

    scale = torch.pow(2.0, lvl.to(torch.float32))
    center_off = 0.5 * (scale - 1.0)
    px_scaled = (px_t_c - center_off[..., None]) / scale[..., None]

    flat0 = dI0_stack.reshape(-1, 3)
    gidx = torch.clamp(ref_idx * (hh * ww) + pxi_r[..., 1] * ww
                       + pxi_r[..., 0], 0, F * hh * ww - 1) + rl * (F * hh * ww)
    g = flat0[gidx][..., 1:]
    gn = g / torch.clamp(torch.linalg.vector_norm(g, dim=-1, keepdim=True),
                         min=1e-9)
    dir_cur = torch.einsum("nij,nj->ni", A, gn.reshape(-1, 2))
    dir_cur = dir_cur / torch.clamp(torch.linalg.vector_norm(
        dir_cur, dim=-1, keepdim=True), min=1e-9)

    is_edge = type_c == 1
    if quad_pyr is None:
        quad_pyr = torch.cat([quad_from_flat(fp, w, h, levels)
                              for fp in flat_pyr], 0)
    T_flat = flat_pyr.shape[1]
    # lane l's levels are rows l*levels .. l*levels+levels-1 of the tables
    offs_g = (offsets[None, :] + (ar * T_flat)[:, None]).reshape(-1)
    # the patch warp and the alignment in one call (on the card one fused
    # kernel, after a one-block kernel zeroing its failure counts)
    px_a, m_c, afail = warp_align(
        dI0_stack.reshape((L * F,) + dI0_stack.shape[-3:]), slot_g,
        px_r.reshape(-1, 2), A, lvl.reshape(-1), quad_pyr, offs_g,
        widths.repeat(L), heights.repeat(L), (rl * levels + lvl).reshape(-1),
        px_scaled.reshape(-1, 2), dir_cur, is_edge.reshape(-1),
        a_rel.reshape(-1), b_rel.reshape(-1), cand.reshape(-1),
        n_iter=n_iter, n_lanes=L, quad_stack=quad_stack)
    px_a = px_a.reshape(L, M, 2)
    m_c = m_c.reshape(L, M)
    px_c = px_a * scale[..., None] + center_off[..., None]
    m_c = m_c & cand & torch.isfinite(px_c).all(dim=-1)

    base = rl * (N + 1)
    tgt = torch.where(m_c, base + cidx, base + N).reshape(-1)
    matched = torch.zeros(L * (N + 1), dtype=torch.bool, device=dev)
    matched[tgt] = m_c.reshape(-1)
    px_out = torch.zeros((L * (N + 1), 2), dtype=px_c.dtype, device=dev)
    px_out[tgt] = px_c.reshape(-1, 2)
    diag = torch.cat([torch.stack([inb.sum(-1), cand.sum(-1), m_c.sum(-1)],
                                  -1), afail], -1)
    return dict(matched=matched.reshape(L, N + 1)[:, :N],
                px=px_out.reshape(L, N + 1, 2)[:, :N], overflow=overflow,
                diag=diag)


def reproject_and_match_multi(pts_u, pts_v, pts_idepth, pts_host, pts_type,
                              pts_valid, pts_quality, pts_is_sensor,
                              T_wc_stack, aff_stack, exposure_stack,
                              dI0_stack, flat_pyr_stack, offsets, widths,
                              heights, T_wc_targets, aff_targets,
                              exposure_targets, K, ref_idx_stack,
                              target_mask=None, **kw):
    """Match the point pool into several target frames (the keyframe
    matcher refresh's pass 2). flat_pyr_stack: the (S, T, 3) stack of the
    targets' flat pyramids; `target_mask` (S,) bool (a tensor or host
    list) of the targets to run — skipped targets return unmatched rows,
    which is what the caller's mask makes of them anyway. Lane 0 of
    `reproject_and_match_multi_lanes`. Returns dict(matched (S, N),
    px (S, N, 2), overflow (S,), diag (S, 5))."""
    S = T_wc_targets.shape[0]
    dev = pts_u.device
    mask = torch.ones(S, dtype=torch.bool, device=dev) \
        if target_mask is None else torch.as_tensor(target_mask, device=dev)
    out = reproject_and_match_multi_lanes(
        *(x[None] for x in (pts_u, pts_v, pts_idepth, pts_host, pts_type,
                            pts_valid, pts_quality, pts_is_sensor,
                            T_wc_stack, aff_stack, exposure_stack,
                            dI0_stack, flat_pyr_stack)),
        offsets, widths, heights,
        *(torch.as_tensor(x, device=dev)[None]
          for x in (T_wc_targets, aff_targets, exposure_targets, K)),
        ref_idx_stack[None], target_mask=mask[None], **kw)
    return {k: v[0] for k, v in out.items()}


def reproject_and_match_multi_lanes(pts_u, pts_v, pts_idepth, pts_host,
                                    pts_type, pts_valid, pts_quality,
                                    pts_is_sensor, T_wc_stack, aff_stack,
                                    exposure_stack, dI0_stack, flat_pyr_lanes,
                                    offsets, widths, heights, T_wc_targets,
                                    aff_targets, exposure_targets, K,
                                    ref_idx_stack, w: int, h: int,
                                    max_level: int, per_cell: bool = True,
                                    lane_cap_frac: float = 1.0,
                                    lane_cap: int = 0,
                                    closest_view: bool = False,
                                    frame_valid=None, exclude_slots=None,
                                    closest_view_margin=0.0,
                                    closest_view_sensor_only=False,
                                    n_iter: int = 10, target_mask=None,
                                    quad_stack=None):
    """`reproject_and_match_multi` of L lanes: every argument carries a
    leading L (targets (L, S, ...), ref_idx_stack (L, S, N), the targets'
    flat pyramids `flat_pyr_lanes` (L, S, T, 3)). `target_mask` is an
    (L, S) device bool (None: every target). Each target index runs once
    for all lanes through `reproject_and_match_lanes`, under
    `device_loop.cond` on whether any lane runs it (a host read in the
    stage form, an IF node in a program), so only the kept targets cost
    device work; a lane that skips the target (its slot of the stack may
    hold anything) gets unmatched rows, zero overflow and zero
    diagnostics."""
    L, N = pts_u.shape
    S = T_wc_targets.shape[1]
    dev = pts_u.device
    if target_mask is None:
        target_mask = torch.ones((L, S), dtype=torch.bool, device=dev)
    if quad_stack is None:
        quad_stack = stack_quads(dI0_stack)
    outs = []
    for s in range(S):
        on = target_mask[:, s]
        excl = -1 if exclude_slots is None else int(exclude_slots[s])

        def match(carry, s=s, on=on, excl=excl):
            out = reproject_and_match_lanes(
                pts_u, pts_v, pts_idepth, pts_host, pts_type, pts_valid,
                pts_quality, pts_is_sensor, T_wc_stack, aff_stack,
                exposure_stack, dI0_stack, flat_pyr_lanes[:, s], offsets,
                widths, heights, T_wc_targets[:, s], aff_targets[:, s],
                exposure_targets[:, s], K, ref_idx_stack[:, s], w=w, h=h,
                max_level=max_level, per_cell=per_cell,
                lane_cap_frac=lane_cap_frac, lane_cap=lane_cap,
                closest_view=closest_view, frame_valid=frame_valid,
                exclude_slot=excl, closest_view_margin=closest_view_margin,
                closest_view_sensor_only=closest_view_sensor_only,
                n_iter=n_iter, quad_stack=quad_stack)
            return dict(
                matched=out["matched"] & on[:, None],
                px=torch.where(on[:, None, None], out["px"], carry["px"]),
                overflow=torch.where(on, out["overflow"], carry["overflow"]),
                diag=torch.where(on[:, None], out["diag"], carry["diag"]))
        outs.append(device_loop.cond("match2", on.any(), match, dict(
            matched=torch.zeros((L, N), dtype=torch.bool, device=dev),
            px=torch.zeros((L, N, 2), dtype=torch.float32, device=dev),
            overflow=torch.zeros(L, dtype=torch.int64, device=dev),
            diag=torch.zeros((L, 5), dtype=torch.int64, device=dev))))
    return {k: torch.stack([o[k] for o in outs], 1)
            for k in ("matched", "px", "overflow", "diag")}
