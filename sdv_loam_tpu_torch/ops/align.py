"""Batched SVO-style direct feature alignment (the semi-direct matcher core).

Counterpart of `sdv_loam_tpu/ops/align.py` (reference Reprojector.cpp:
getWarpMatrixAffine :14-35, getBestSearchLevel :37-49, warpAffine :51-82,
align2D :448-551, align1D :344-446). All candidates align at once over a
flattened target pyramid; each candidate reads through its level's
offset and width. The GN loop keeps the reference's 10-iteration cap
(`align_max_iters`), which also acts as a match-quality filter.

The patch warp and the alignment are one hand-written kernel on CUDA
(K5, with K6's patch warp as its prologue: `warp_align`, as the matcher
calls them), which `warp_affine_patches` and `align_batch` also reach
alone, with their plain versions on the CPU (`ops/hopper_kernels`).
"""

from __future__ import annotations

import numpy as np
import torch

from sdv_loam_tpu_torch.ops import hopper_kernels
from sdv_loam_tpu_torch.ops.warp import quad_from_image
from sdv_loam_tpu_torch.utils import device_loop


def flatten_pyramid(dI_pyr):
    """Concatenate pyramid levels into one flat (sum_l H_l*W_l, C) buffer.

    Returns (flat, offsets (L,), widths (L,), heights (L,)); the index
    arrays are int64 tensors on the pyramid's device."""
    dev = dI_pyr[0].device
    offsets = np.cumsum([0] + [p.shape[0] * p.shape[1] for p in dI_pyr[:-1]])
    flat = torch.cat([p.reshape(-1, p.shape[-1]) for p in dI_pyr], dim=0)
    return (flat, *(device_loop.constant(t, dev, torch.int64) for t in (
        offsets, [p.shape[1] for p in dI_pyr], [p.shape[0] for p in dI_pyr])))


def quad_from_flat(flat, w: int, h: int, levels: int):
    """Quad-pack channel 0 of a flatten_pyramid buffer, level by level."""
    outs = []
    off = 0
    for lvl in range(levels):
        wl, hl = w >> lvl, h >> lvl
        outs.append(quad_from_image(flat[off:off + wl * hl, 0]
                                    .reshape(hl, wl)))
        off += wl * hl
    return torch.cat(outs, dim=0)


def warp_affine_patches(dI_ref0_stack, host_idx, px_ref, A_cur_ref,
                        search_level, quad_stack=None):
    """Warp 10x10 border patches from each candidate's host level-0 image
    (warpAffine). dI_ref0_stack (F, H, W, 3); host_idx (M,); px_ref (M, 2);
    A_cur_ref (M, 2, 2); search_level (M,) int64. `quad_stack` is the
    (F*H*W, 4) quad pack of the stack's intensities when the caller has it.
    Returns (M, 10, 10) patches (0 outside the image). On CUDA the fused
    kernel's patches-only mode (`hopper_kernels.warp_affine_patches`), its
    plain version on the CPU."""
    return hopper_kernels.warp_affine_patches(
        dI_ref0_stack, host_idx, px_ref, A_cur_ref, search_level,
        quad_stack=quad_stack)


def align_batch(quad_pyr, offsets, widths, heights, search_level,
                border_patch, px_init_scaled, direction, is_edge,
                aff_a, aff_b, valid, n_iter: int = 10, n_lanes: int = 0):
    """Unified corner (align2D) + edgelet (align1D) inverse-compositional
    alignment over the quad-packed target pyramid: at most `n_iter`
    Gauss-Newton iterations per candidate, each stopping on its own.
    Edgelet rows use J = [dgrad, 1, 0] with the update moved along
    `direction`. Returns (px (M, 2) on the search level, converged (M,),
    [n walked out of bounds, n out of iterations]); with `n_lanes` the M
    rows are that many sequences' candidates, lane after lane, and the
    counts come per sequence, (n_lanes, 2). On CUDA the fused kernel
    reading the given patches (the whole loop in one kernel, after a
    one-block kernel zeroing the counts: `hopper_kernels.align_batch`),
    its plain version (the batched loop) on the CPU."""
    return hopper_kernels.align_batch(
        quad_pyr, offsets, widths, heights, search_level, border_patch,
        px_init_scaled, direction, is_edge, aff_a, aff_b, valid,
        n_iter=n_iter, n_lanes=n_lanes)


def warp_align(dI_ref0_stack, host_idx, px_ref, A_cur_ref, warp_level,
               quad_pyr, offsets, widths, heights, search_level,
               px_init_scaled, direction, is_edge, aff_a, aff_b, valid,
               n_iter: int = 10, n_lanes: int = 0, quad_stack=None):
    """`warp_affine_patches` (the first five arguments and `quad_stack`,
    `warp_level` being its `search_level`), then `align_batch` on the
    patches it warps (the rest; `search_level` indexes the level tables).
    Returns `align_batch`'s results. On CUDA the fused kernel (after a
    one-block kernel zeroing the failure counts), which keeps each patch
    on chip
    (`hopper_kernels.warp_align`); on the CPU the two plain versions in
    turn."""
    return hopper_kernels.warp_align(
        dI_ref0_stack, host_idx, px_ref, A_cur_ref, warp_level, quad_pyr,
        offsets, widths, heights, search_level, px_init_scaled, direction,
        is_edge, aff_a, aff_b, valid, n_iter=n_iter, n_lanes=n_lanes,
        quad_stack=quad_stack)


def warp_matrix_affine(px_ref, z_ref, K, T_cur_ref):
    """Batched getWarpMatrixAffine: px_ref (M, 2), z_ref (M,) depth in the
    ref frame, T_cur_ref (M, 4, 4), K (4,) or per row (M, 4). Returns
    A_cur_ref (M, 2, 2)."""
    fx, fy, cx, cy = K[..., 0], K[..., 1], K[..., 2], K[..., 3]

    def to_unit(px):
        return torch.stack([(px[..., 0] - cx) / fx, (px[..., 1] - cy) / fy,
                            torch.ones_like(px[..., 0])], dim=-1)

    hp = 5.0
    px_ref = px_ref.to(torch.float32)
    z_ref = z_ref.to(torch.float32)
    xyz = to_unit(px_ref) * z_ref[:, None]
    # px_ref + [hp, 0] and + [0, hp], with no host tensor (a program)
    du = to_unit(torch.stack([px_ref[:, 0] + hp, px_ref[:, 1] + 0.0], -1))
    dv = to_unit(torch.stack([px_ref[:, 0] + 0.0, px_ref[:, 1] + hp], -1))
    du = du * (xyz[:, 2:3] / du[:, 2:3])
    dv = dv * (xyz[:, 2:3] / dv[:, 2:3])
    R = T_cur_ref[:, :3, :3]
    t = T_cur_ref[:, :3, 3]

    def proj(p):
        q = torch.einsum("mij,mj->mi", R, p) + t
        return torch.stack([fx * q[:, 0] / q[:, 2] + cx,
                            fy * q[:, 1] / q[:, 2] + cy], dim=-1)

    p0 = proj(xyz)
    pu = proj(du)
    pv = proj(dv)
    return torch.stack([(pu - p0) / hp, (pv - p0) / hp], dim=-1)


def best_search_level(A_cur_ref, max_level: int):
    """Batched getBestSearchLevel: halve while |det A| > 3."""
    D = torch.abs(torch.linalg.det(A_cur_ref))
    lvl = torch.zeros(D.shape, dtype=torch.int64, device=D.device)
    for _ in range(max_level):
        step = (D > 3.0) & (lvl < max_level)
        lvl = torch.where(step, lvl + 1, lvl)
        D = torch.where(step, D * 0.25, D)
    return lvl
