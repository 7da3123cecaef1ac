"""Half-resolution distance map for activation spreading + Shi-Tomasi score.

Counterpart of `sdv_loam_tpu/ops/distmap.py` (reference:
CoarseDistanceMap::makeDistanceMap / growDistBFS, CoarseTracker.cpp:
1139-1284; FullSystem::shiTomasiScore, FullSystem.cpp:1540-1583). The BFS
is an iterated 8-neighbour min-plus relaxation, run by the K2 kernel
(`hopper_kernels.distance_transform`).
"""

from __future__ import annotations

import torch

from sdv_loam_tpu_torch.ops.hopper_kernels import distance_transform


def distance_map(u1, v1, valid, w1: int, h1: int, iters: int = 32):
    """Distance transform seeded at projected active points.

    u1, v1: (N,) level-1 integer pixel coords; valid: (N,). Returns the
    (h1, w1) float32 chamfer distances. Seeds need u1 > 0 and v1 > 0
    (strictly: column 0 and row 0 never seed), as in the reference."""
    ok = valid & (u1 > 0) & (v1 > 0) & (u1 < w1) & (v1 < h1)
    idx = torch.where(ok, v1.to(torch.int64) * w1 + u1.to(torch.int64),
                      torch.full_like(u1, w1 * h1, dtype=torch.int64))
    seed = torch.full((w1 * h1 + 1,), 1000.0, dtype=torch.float32,
                      device=u1.device)
    vals = (~valid).to(torch.float32) * 1000.0   # 0 at seeds
    seed.scatter_reduce_(0, idx, vals, reduce="amin")
    d = seed[:w1 * h1].reshape(h1, w1).contiguous()
    return distance_transform(d, iters)


def shi_tomasi(dI0, u, v):
    """Batched shiTomasiScore at integer pixels (FullSystem.cpp:1540-1583)."""
    h, w = dI0.shape[:2]
    img = dI0[..., 0]
    hb = 4
    ui = u.to(torch.int64)
    vi = v.to(torch.int64)
    ok = (ui - hb >= 1) & (ui + hb < w - 1) & (vi - hb >= 1) & \
        (vi + hb < h - 1)
    uc = torch.clamp(ui, hb + 1, w - hb - 2)
    vc = torch.clamp(vi, hb + 1, h - hb - 2)
    ar = torch.arange(8, device=u.device) - hb
    oy = ar[:, None].expand(8, 8).reshape(-1)
    ox = ar[None, :].expand(8, 8).reshape(-1)
    flat = img.reshape(-1)

    def take(du, dv):
        iy = vc[:, None] + oy[None, :] + dv
        ix = uc[:, None] + ox[None, :] + du
        return flat[iy * w + ix]

    dx = take(1, 0) - take(-1, 0)
    dy = take(0, 1) - take(0, -1)
    box_area = 64.0
    dXX = torch.sum(dx * dx, -1) / (2.0 * box_area)
    dYY = torch.sum(dy * dy, -1) / (2.0 * box_area)
    dXY = torch.sum(dx * dy, -1) / (2.0 * box_area)
    tr = dXX + dYY
    disc = torch.sqrt(torch.clamp(tr * tr - 4.0 * (dXX * dYY - dXY * dXY),
                                  min=0.0))
    l1 = 0.5 * (tr - disc)
    l2 = 0.5 * (tr + disc)
    score = l1 * l2 - 0.04 * (l1 + l2) ** 2
    return torch.where(ok, score, torch.zeros_like(score))
