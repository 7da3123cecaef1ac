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

from sdv_loam_tpu_torch.ops.align import (align_batch, best_search_level,
                                          quad_from_flat, quad_from_image,
                                          warp_affine_patches,
                                          warp_matrix_affine)
from sdv_loam_tpu_torch.ops.photometric import nonzero_fixed
from sdv_loam_tpu_torch.utils import se3

CELL_SIZE = 25          # Reprojector::initializeGrid (:100)
PROJ_BOUNDARY = 8       # reprojectPoint (:609)
REF_BOUNDARY = 6        # findMatchDirect (:263): halfpatch+2


def _project(T_wc_inv, pts_world, K):
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    pf = pts_world @ T_wc_inv[:3, :3].T + T_wc_inv[:3, 3]
    z = pf[:, 2]
    zs = torch.where(z == 0, torch.full_like(z, 1e-9), z)
    return torch.stack([fx * pf[:, 0] / zs + cx, fy * pf[:, 1] / zs + cy],
                       dim=-1), z


def stack_quads(dI0_stack):
    """(F*H*W, 4) quad pack of a window stack's level-0 intensities (shared
    by every matcher call on the same stack)."""
    return torch.cat([quad_from_image(im[..., 0]) for im in dI0_stack], 0)


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
    overflow, diag (5,))."""
    N = pts_u.shape[0]
    dev = pts_u.device
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    F = T_wc_stack.shape[0]

    host = torch.clamp(pts_host.to(torch.int64), 0, F - 1)
    T_wc_h = T_wc_stack[host]
    xn = (pts_u - cx) / fx
    yn = (pts_v - cy) / fy
    p_ref = torch.stack([xn, yn, torch.ones_like(xn)], dim=-1) / \
        torch.clamp(pts_idepth, min=1e-9)[:, None]
    pw = torch.einsum("nij,nj->ni", T_wc_h[:, :3, :3], p_ref) + \
        T_wc_h[:, :3, 3]

    T_tw = se3.inverse(T_wc_target)
    px_t, z_t = _project(T_tw, pw, K)
    pxi = px_t.to(torch.int64)
    inb = (pts_valid & (z_t > 0)
           & (pxi[:, 0] >= PROJ_BOUNDARY) & (pxi[:, 0] < w - PROJ_BOUNDARY)
           & (pxi[:, 1] >= PROJ_BOUNDARY) & (pxi[:, 1] < h - PROJ_BOUNDARY))

    n_cols = -(-w // CELL_SIZE)
    n_rows = -(-h // CELL_SIZE)
    n_cells = n_cols * n_rows
    cell = torch.where(inb, (pxi[:, 1] // CELL_SIZE) * n_cols
                       + (pxi[:, 0] // CELL_SIZE),
                       torch.full_like(pxi[:, 0], n_cells))

    idxs = torch.arange(N, device=dev)
    if per_cell:
        BIGQ = 1e30
        q = torch.where(inb, pts_quality, torch.full_like(pts_quality, BIGQ))
        cell_minq = torch.full((n_cells + 1,), BIGQ, dtype=q.dtype,
                               device=dev)
        cell_minq.scatter_reduce_(0, cell, q, reduce="amin")
        tie = inb & (q == cell_minq[cell])
        cell_mini = torch.full((n_cells + 1,), N, dtype=torch.int64,
                               device=dev)
        cell_mini.scatter_reduce_(
            0, torch.where(tie, cell, torch.full_like(cell, n_cells)),
            torch.where(tie, idxs, torch.full_like(idxs, N)), reduce="amin")
        winner = tie & (cell_mini[cell] == idxs)
        M = -(-n_cells // 8) * 8
        cidx = nonzero_fixed(winner, M, 0)
        lane_valid = torch.arange(M, device=dev) < winner.sum()
        overflow = torch.zeros((), dtype=torch.int64, device=dev)
    else:
        cap = lane_cap if lane_cap > 0 else max(1, int(lane_cap_frac * N))
        cap = min(-(-cap // 8) * 8, N)
        cidx = nonzero_fixed(inb, cap, 0)
        lane_valid = torch.arange(cap, device=dev) < inb.sum()
        overflow = torch.clamp(inb.sum() - cap, min=0)

    pw_c = pw[cidx]
    px_t_c = px_t[cidx]
    type_c = pts_type[cidx]

    ref_idx = torch.clamp(ref_idx_per_point.to(torch.int64), 0, F - 1)[cidx]
    if closest_view:
        T_fw = se3.inverse(T_wc_stack)
        pf_all = torch.einsum("fij,mj->fmi", T_fw[:, :3, :3], pw_c) + \
            T_fw[:, None, :3, 3]
        z_all = pf_all[..., 2]
        zs_all = torch.where(z_all == 0, torch.full_like(z_all, 1e-9), z_all)
        u_all = fx * pf_all[..., 0] / zs_all + cx
        v_all = fy * pf_all[..., 1] / zs_all + cy
        vis = ((z_all > 0)
               & (u_all >= REF_BOUNDARY) & (u_all < w - REF_BOUNDARY)
               & (v_all >= REF_BOUNDARY) & (v_all < h - REF_BOUNDARY))
        if frame_valid is not None:
            vis = vis & frame_valid[:, None]
        vis = vis & (torch.arange(F, device=dev)[:, None]
                     != torch.as_tensor(exclude_slot, device=dev))
        c_f = T_wc_stack[:, :3, 3]
        d_f = c_f[:, None, :] - pw_c[None, :, :]
        d_f = d_f / torch.clamp(torch.linalg.vector_norm(d_f, dim=-1,
                                                         keepdim=True),
                                min=1e-9)
        d_t = T_wc_target[:3, 3][None, :] - pw_c
        d_t = d_t / torch.clamp(torch.linalg.vector_norm(d_t, dim=-1,
                                                         keepdim=True),
                                min=1e-9)
        score = torch.where(vis, torch.einsum("fmi,mi->fm", d_f, d_t),
                            torch.full_like(z_all, float("-inf")))
        # argmax keeps the FIRST maximum: far points' view-ray cosines tie
        # in float32, and they all re-reference to the lowest slot
        best = torch.argmax(score, dim=0)
        smax = torch.amax(score, dim=0)
        any_vis = smax > float("-inf")
        host_score = torch.gather(score, 0, ref_idx[None, :])[0]
        better = smax > host_score + closest_view_margin
        if closest_view_sensor_only:
            better = better & pts_is_sensor[cidx]
        ref_idx = torch.where(any_vis & better, best, ref_idx)
    T_wc_r = T_wc_stack[ref_idx]
    T_rw = se3.inverse(T_wc_r)
    pf_r = torch.einsum("nij,nj->ni", T_rw[:, :3, :3], pw_c) + T_rw[:, :3, 3]
    z_r = pf_r[:, 2]
    zs = torch.where(z_r == 0, torch.full_like(z_r, 1e-9), z_r)
    px_r = torch.stack([fx * pf_r[:, 0] / zs + cx,
                        fy * pf_r[:, 1] / zs + cy], dim=-1)
    pxi_r = px_r.to(torch.int64)
    ref_ok = ((z_r > 0)
              & (pxi_r[:, 0] >= REF_BOUNDARY) & (pxi_r[:, 0] < w - REF_BOUNDARY)
              & (pxi_r[:, 1] >= REF_BOUNDARY) & (pxi_r[:, 1] < h - REF_BOUNDARY))
    cand = lane_valid & ref_ok

    T_cur_ref = torch.einsum("ij,njk->nik", T_tw, T_wc_r)
    A = warp_matrix_affine(px_r, z_r, K, T_cur_ref)
    lvl = best_search_level(A, max_level)
    if quad_stack is None:
        quad_stack = stack_quads(dI0_stack)
    patches = warp_affine_patches(dI0_stack, ref_idx, px_r, A, lvl,
                                  quad_stack=quad_stack)

    exp_r = exposure_stack[ref_idx]
    a_rel = torch.exp(aff_target[0] - aff_stack[ref_idx, 0]) * torch.where(
        (exp_r == 0) | (exposure_target == 0), torch.ones_like(exp_r),
        exposure_target / exp_r)
    b_rel = aff_target[1] - a_rel * aff_stack[ref_idx, 1]

    scale = torch.pow(2.0, lvl.to(torch.float32))
    center_off = 0.5 * (scale - 1.0)
    px_scaled = (px_t_c - center_off[:, None]) / scale[:, None]

    hh, ww = dI0_stack.shape[1], dI0_stack.shape[2]
    flat0 = dI0_stack.reshape(-1, 3)
    gidx = ref_idx * (hh * ww) + pxi_r[:, 1] * ww + pxi_r[:, 0]
    g = flat0[torch.clamp(gidx, 0, flat0.shape[0] - 1)][:, 1:]
    gn = g / torch.clamp(torch.linalg.vector_norm(g, dim=-1, keepdim=True),
                         min=1e-9)
    dir_cur = torch.einsum("nij,nj->ni", A, gn)
    dir_cur = dir_cur / torch.clamp(torch.linalg.vector_norm(
        dir_cur, dim=-1, keepdim=True), min=1e-9)

    is_edge = type_c == 1
    if quad_pyr is None:
        quad_pyr = quad_from_flat(flat_pyr, w, h, max_level + 1)
    px_a, m_c, afail = align_batch(quad_pyr, offsets, widths, heights, lvl,
                                   patches, px_scaled, dir_cur, is_edge,
                                   a_rel, b_rel, cand, n_iter=n_iter)
    px_c = px_a * scale[:, None] + center_off[:, None]
    m_c = m_c & cand & torch.isfinite(px_c).all(dim=-1)

    tgt = torch.where(m_c, cidx, torch.full_like(cidx, N))
    matched = torch.zeros(N + 1, dtype=torch.bool, device=dev)
    matched[tgt] = m_c
    px_out = torch.zeros((N + 1, 2), dtype=px_c.dtype, device=dev)
    px_out[tgt] = px_c
    diag = torch.cat([torch.stack([inb.sum(), cand.sum(), m_c.sum()]),
                      afail])
    return dict(matched=matched[:N], px=px_out[:N], overflow=overflow,
                diag=diag)


def reproject_and_match_multi(pts_u, pts_v, pts_idepth, pts_host, pts_type,
                              pts_valid, pts_quality, pts_is_sensor,
                              T_wc_stack, aff_stack, exposure_stack,
                              dI0_stack, flat_pyr_stack, offsets, widths,
                              heights, T_wc_targets, aff_targets,
                              exposure_targets, K, ref_idx_stack,
                              w: int, h: int, max_level: int,
                              per_cell: bool = True,
                              lane_cap_frac: float = 1.0,
                              lane_cap: int = 0,
                              closest_view: bool = False,
                              frame_valid=None,
                              exclude_slots=None,
                              closest_view_margin=0.0,
                              closest_view_sensor_only=False,
                              n_iter: int = 10, target_mask=None,
                              quad_stack=None):
    """Match the point pool into several target frames (the keyframe
    matcher refresh's pass 2). flat_pyr_stack: list of S flat pyramids (None
    for targets that are skipped); `target_mask` (S,) bool host list of the
    targets to run — skipped targets return unmatched rows, which is what
    the caller's mask makes of them anyway. Returns dict(matched (S, N),
    px (S, N, 2), overflow (S,), diag (S, 5))."""
    S = T_wc_targets.shape[0]
    N = pts_u.shape[0]
    dev = pts_u.device
    if quad_stack is None:
        quad_stack = stack_quads(dI0_stack)
    matched = torch.zeros((S, N), dtype=torch.bool, device=dev)
    px = torch.zeros((S, N, 2), dtype=torch.float32, device=dev)
    overflow = torch.zeros(S, dtype=torch.int64, device=dev)
    diag = torch.zeros((S, 5), dtype=torch.int64, device=dev)
    for s in range(S):
        if target_mask is not None and not target_mask[s]:
            continue
        excl = -1 if exclude_slots is None else int(exclude_slots[s])
        out = reproject_and_match(
            pts_u, pts_v, pts_idepth, pts_host, pts_type, pts_valid,
            pts_quality, pts_is_sensor, T_wc_stack, aff_stack,
            exposure_stack, dI0_stack, flat_pyr_stack[s], offsets, widths,
            heights, T_wc_targets[s], aff_targets[s], exposure_targets[s], K,
            ref_idx_stack[s], w=w, h=h, max_level=max_level,
            per_cell=per_cell, lane_cap_frac=lane_cap_frac,
            lane_cap=lane_cap, closest_view=closest_view,
            frame_valid=frame_valid, exclude_slot=excl,
            closest_view_margin=closest_view_margin,
            closest_view_sensor_only=closest_view_sensor_only,
            n_iter=n_iter, quad_stack=quad_stack)
        matched[s] = out["matched"]
        px[s] = out["px"]
        overflow[s] = out["overflow"]
        diag[s] = out["diag"]
    return dict(matched=matched, px=px, overflow=overflow, diag=diag)
