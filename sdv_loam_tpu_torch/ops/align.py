"""Batched SVO-style direct feature alignment (the semi-direct matcher core).

Counterpart of `sdv_loam_tpu/ops/align.py` (reference Reprojector.cpp:
getWarpMatrixAffine :14-35, getBestSearchLevel :37-49, warpAffine :51-82,
align2D :448-551, align1D :344-446). All candidates align at once over a
flattened target pyramid; each candidate reads through its level's
offset and width. The GN loop keeps the reference's 10-iteration cap
(`align_max_iters`), which also acts as a match-quality filter.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tnf

HALF_PATCH = 4
PATCH = 8
BORDER_PATCH = PATCH + 2
MIN_UPDATE_SQ = 0.03 * 0.03


def flatten_pyramid(dI_pyr):
    """Concatenate pyramid levels into one flat (sum_l H_l*W_l, C) buffer.

    Returns (flat, offsets (L,), widths (L,), heights (L,)); the index
    arrays are int64 tensors on the pyramid's device."""
    dev = dI_pyr[0].device
    offsets = np.cumsum([0] + [p.shape[0] * p.shape[1] for p in dI_pyr[:-1]])
    flat = torch.cat([p.reshape(-1, p.shape[-1]) for p in dI_pyr], dim=0)
    return (flat, torch.as_tensor(offsets, dtype=torch.int64, device=dev),
            torch.tensor([p.shape[1] for p in dI_pyr], dtype=torch.int64,
                         device=dev),
            torch.tensor([p.shape[0] for p in dI_pyr], dtype=torch.int64,
                         device=dev))


def quad_from_image(img):
    """(H, W) image -> (H*W, 4) rows [I(x,y), I(x+1,y), I(x,y+1),
    I(x+1,y+1)], edge rows/columns replicated."""
    h, w = img.shape
    p = tnf.pad(img[None, None], (0, 1, 0, 1), mode="replicate")[0, 0]
    q = torch.stack([p[:h, :w], p[:h, 1:], p[1:, :w], p[1:, 1:]], dim=-1)
    return q.reshape(h * w, 4)


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


def _quad_bilinear(quad, base, w, x, y):
    """Bilinear sample from a quad-packed buffer, one row per sample.
    Caller guarantees in-bounds. quad (T, 4) or (T, 4*C); base, w
    broadcastable to x; returns x.shape (4-wide) or x.shape + (C,)."""
    c = quad.shape[-1] // 4
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    ax = (x - x0).to(quad.dtype)
    ay = (y - y0).to(quad.dtype)
    idx = base + y0.to(torch.int64) * w + x0.to(torch.int64)
    # non-finite coordinates give out-of-range rows: they read NaN, like
    # the "fill" mode of the reference's gather
    ok = (idx >= 0) & (idx < quad.shape[0])
    g = quad.index_select(0, torch.where(ok, idx, torch.zeros_like(idx))
                          .reshape(-1)).reshape(x.shape + (4 * c,))
    w4 = torch.stack([(1 - ax) * (1 - ay), ax * (1 - ay),
                      (1 - ax) * ay, ax * ay], dim=-1)
    nan = torch.full((), float("nan"), dtype=quad.dtype, device=quad.device)
    if c == 1:
        return torch.where(ok, (g * w4).sum(dim=-1), nan)
    g = g.reshape(x.shape + (4, c))
    return torch.where(ok[..., None], (g * w4[..., None]).sum(dim=-2), nan)


def _patch_offsets(n, device, dtype=torch.float32):
    ar = torch.arange(n, device=device)
    ys = ar[:, None].expand(n, n).reshape(-1)
    xs = ar[None, :].expand(n, n).reshape(-1)
    return xs.to(dtype), ys.to(dtype)


def warp_affine_patches(dI_ref0_stack, host_idx, px_ref, A_cur_ref,
                        search_level, quad_stack=None):
    """Warp 10x10 border patches from each candidate's host level-0 image
    (warpAffine). dI_ref0_stack (F, H, W, 3); host_idx (M,); px_ref (M, 2);
    A_cur_ref (M, 2, 2); search_level (M,). `quad_stack` is the
    (F*H*W, 4) quad pack of the stack's intensities when the caller has it.
    Returns (M, 10, 10) patches (0 outside the image)."""
    h, w = dI_ref0_stack.shape[1:3]
    dev = px_ref.device
    Ainv = torch.linalg.inv_ex(A_cur_ref)[0]
    Ainv = torch.where(torch.isfinite(Ainv), Ainv, torch.zeros_like(Ainv))
    xs, ys = _patch_offsets(BORDER_PATCH, dev)
    offs = torch.stack([xs, ys], dim=-1) - (HALF_PATCH + 1)
    scale = torch.pow(2.0, search_level.to(torch.float32))
    px_patch = offs[None, :, :] * scale[:, None, None]
    src = torch.einsum("mij,mpj->mpi", Ainv, px_patch) + px_ref[:, None, :]
    x = src[..., 0]
    y = src[..., 1]
    ok = (x >= 0) & (y >= 0) & (x < w - 1) & (y < h - 1)
    xc = torch.clamp(x, 0.0, w - 1.001)
    yc = torch.clamp(y, 0.0, h - 1.001)
    if quad_stack is None:
        quad_stack = torch.cat([quad_from_image(im[..., 0])
                                for im in dI_ref0_stack], dim=0)
    base = (host_idx.to(torch.int64) * (h * w))[:, None]
    inten = _quad_bilinear(quad_stack, base, w, xc, yc)
    inten = torch.where(ok, inten, torch.zeros_like(inten))
    return inten.reshape(-1, BORDER_PATCH, BORDER_PATCH)


def _patch_grads(border_patch):
    """Reference-patch gradients from the 10x10 border patch (align2D)."""
    inner = border_patch[:, 1:-1, 1:-1]
    dx = 0.5 * (border_patch[:, 1:-1, 2:] - border_patch[:, 1:-1, :-2])
    dy = 0.5 * (border_patch[:, 2:, 1:-1] - border_patch[:, :-2, 1:-1])
    m = border_patch.shape[0]
    return inner.reshape(m, -1), dx.reshape(m, -1), dy.reshape(m, -1)


def align_batch(quad_pyr, offsets, widths, heights, search_level,
                border_patch, px_init_scaled, direction, is_edge,
                aff_a, aff_b, valid, n_iter: int = 10):
    """Unified corner (align2D) + edgelet (align1D) inverse-compositional
    alignment in one loop over the quad-packed target pyramid.

    Edgelet lanes use J = [dgrad, 1, 0] with the update moved along
    `direction`. The loop runs at most `n_iter` iterations and stops early
    once no lane is still active. Returns (px (M, 2) on the search level,
    converged (M,), [n walked out of bounds, n out of iterations])."""
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

    base = offsets[search_level][:, None]
    wv = widths[search_level][:, None]
    hv = heights[search_level]
    po_x, po_y = _patch_offsets(PATCH, border_patch.device)
    po_x = po_x - HALF_PATCH
    po_y = po_y - HALF_PATCH
    target = aff_a[:, None] * ref + aff_b[:, None]

    u = px_init_scaled[:, 0]
    v = px_init_scaled[:, 1]
    mean_diff = torch.zeros_like(u)
    conv = torch.zeros_like(valid)
    alive = valid.clone()
    for _ in range(n_iter):
        if not bool((alive & valid & (~conv)).any()):
            break
        ur = torch.floor(u)
        vr = torch.floor(v)
        inb = ((ur >= HALF_PATCH) & (vr >= HALF_PATCH)
               & (ur < wv[:, 0] - HALF_PATCH) & (vr < hv - HALF_PATCH))
        act = alive & inb & (~conv) & valid
        x = torch.minimum(torch.clamp(u[:, None], min=HALF_PATCH),
                          (wv - HALF_PATCH).to(u.dtype)) + po_x[None, :]
        y = torch.minimum(torch.clamp(v[:, None], min=HALF_PATCH),
                          (hv[:, None] - HALF_PATCH).to(v.dtype)) \
            + po_y[None, :]
        cur = _quad_bilinear(quad_pyr, base, wv, x, y)
        res = cur - target + mean_diff[:, None]
        Jres = -torch.einsum("mp,mpi->mi", res, J)
        upd = torch.einsum("mij,mj->mi", Hinv, Jres)
        upd = torch.where(act[:, None], upd, torch.zeros_like(upd))
        du = torch.where(is_edge, upd[:, 0] * direction[:, 0], upd[:, 0])
        dv = torch.where(is_edge, upd[:, 0] * direction[:, 1], upd[:, 1])
        dmd = torch.where(is_edge, upd[:, 1], upd[:, 2])
        u = u + du
        v = v + dv
        mean_diff = mean_diff + dmd
        step_sq = upd[:, 0] ** 2 + upd[:, 1] ** 2
        conv = conv | (act & (step_sq < MIN_UPDATE_SQ))
        alive = alive & inb
    fail_oob = valid & ~conv & ~alive
    fail_iters = valid & ~conv & alive
    return torch.stack([u, v], dim=-1), conv & valid, \
        torch.stack([fail_oob.sum(), fail_iters.sum()])


def warp_matrix_affine(px_ref, z_ref, K, T_cur_ref):
    """Batched getWarpMatrixAffine: px_ref (M, 2), z_ref (M,) depth in the
    ref frame, T_cur_ref (M, 4, 4). Returns A_cur_ref (M, 2, 2)."""
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]

    def to_unit(px):
        return torch.stack([(px[..., 0] - cx) / fx, (px[..., 1] - cy) / fy,
                            torch.ones_like(px[..., 0])], dim=-1)

    hp = 5.0
    px_ref = px_ref.to(torch.float32)
    z_ref = z_ref.to(torch.float32)
    xyz = to_unit(px_ref) * z_ref[:, None]
    du = to_unit(px_ref + torch.tensor([hp, 0.0], device=px_ref.device))
    dv = to_unit(px_ref + torch.tensor([0.0, hp], device=px_ref.device))
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
