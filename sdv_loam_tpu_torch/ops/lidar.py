"""LiDAR preprocessing: range image, ground removal, segmentation, projection.

Counterpart of `sdv_loam_tpu/ops/lidar.py` (LeGO-LOAM style, reference
src/main.cpp:562-858). Same outputs, same winner rules:

  * the range image keeps, per cell, the smallest range with ties to the
    lowest point index (two stable sorts: range, then cell);
  * the per-pixel camera depth map keeps the nearest depth per pixel, ties
    to the lowest range-image cell (same two-sort rule);
  * segmentation is exact connected components under the angle criterion,
    iterated to convergence: min-label hooking over the column-wrapped
    4-neighbourhood, a min over every connected run along rows and columns,
    and one pointer jump per sweep. Every step is monotone and mixes labels
    only inside a component, so the fixpoint is each component's minimum
    cell index, whatever the sweep schedule.
"""

from __future__ import annotations

import numpy as np
import torch

from sdv_loam_tpu_torch.config import (ANG_BOTTOM, ANG_RES_X, ANG_RES_Y,
                                       GROUND_SCAN_IND, HORIZON_SCAN, N_SCAN,
                                       SEGMENT_ALPHA_X, SEGMENT_ALPHA_Y,
                                       SEGMENT_THETA, SEGMENT_VALID_LINE_NUM,
                                       SEGMENT_VALID_POINT_NUM,
                                       SENSOR_MOUNT_ANGLE)

_NCELL = N_SCAN * HORIZON_SCAN


def _lexsort_perm(primary, secondary):
    """Permutation sorting by (primary, secondary, original index)."""
    o1 = torch.argsort(secondary, stable=True)
    o2 = torch.argsort(primary[o1], stable=True)
    return o1[o2]


def project_point_cloud(cloud: torch.Tensor, mask: torch.Tensor):
    """Bin points into the 64 x 1800 range image (main.cpp:562-606).

    Returns range_img (64, 1800) with +inf where empty, and xyz_img
    (64, 1800, 3) of the nearest point per cell (0 where empty)."""
    x, y, z = cloud[:, 0], cloud[:, 1], cloud[:, 2]
    horiz_dist = torch.sqrt(x * x + y * y)
    vert_deg = torch.rad2deg(torch.atan2(z, horiz_dist))
    row = torch.floor((vert_deg + ANG_BOTTOM) / ANG_RES_Y).to(torch.int64)
    horiz_deg = torch.rad2deg(torch.atan2(x, y))
    col = (-torch.round((horiz_deg - 90.0) / ANG_RES_X)).to(torch.int64) \
        + HORIZON_SCAN // 2
    col = torch.where(col >= HORIZON_SCAN, col - HORIZON_SCAN, col)
    rng = torch.sqrt(x * x + y * y + z * z)
    ok = (mask & (row >= 0) & (row < N_SCAN) & (col >= 0)
          & (col < HORIZON_SCAN) & (rng >= 0.1))
    idx = torch.where(ok, row * HORIZON_SCAN + col,
                      torch.full_like(row, _NCELL))
    rng_s = torch.where(ok, rng, torch.full_like(rng, float("inf")))

    perm = _lexsort_perm(idx, rng_s)
    idx_s = idx[perm]
    rng_sorted = rng_s[perm]
    first = torch.ones_like(idx_s, dtype=torch.bool)
    first[1:] = idx_s[1:] != idx_s[:-1]
    win = first & (idx_s < _NCELL) & torch.isfinite(rng_sorted)
    payload = torch.cat([rng_sorted[:, None], cloud[perm]], dim=-1)
    maps = torch.full((_NCELL, 4), float("inf"), dtype=cloud.dtype,
                      device=cloud.device)
    maps[idx_s[win]] = payload[win]
    range_img = maps[:, 0].reshape(N_SCAN, HORIZON_SCAN)
    xyz_img = torch.where(torch.isfinite(range_img)[..., None],
                          maps[:, 1:].reshape(N_SCAN, HORIZON_SCAN, 3),
                          torch.zeros((), dtype=cloud.dtype,
                                      device=cloud.device))
    return range_img, xyz_img


def ground_removal(range_img: torch.Tensor, xyz_img: torch.Tensor):
    """Ground mask from ring-pair vertical angles (main.cpp:608-656):
    (64, 1800) int8, 1 ground, 0 not ground, -1 unknown."""
    has = torch.isfinite(range_img)
    lower = xyz_img[:GROUND_SCAN_IND]
    upper = xyz_img[1:GROUND_SCAN_IND + 1]
    diff = upper - lower
    angle = torch.rad2deg(torch.atan2(
        diff[..., 2], torch.sqrt(diff[..., 0] ** 2 + diff[..., 1] ** 2)))
    pair_ok = has[:GROUND_SCAN_IND] & has[1:GROUND_SCAN_IND + 1]
    is_ground_pair = pair_ok & (torch.abs(angle - SENSOR_MOUNT_ANGLE) <= 10.0)

    ground = torch.zeros((N_SCAN, HORIZON_SCAN), dtype=torch.int8,
                         device=range_img.device)
    ground[:GROUND_SCAN_IND] = torch.where(
        pair_ok, torch.zeros((), dtype=torch.int8, device=ground.device),
        torch.full((), -1, dtype=torch.int8, device=ground.device))
    g = torch.zeros((N_SCAN, HORIZON_SCAN), dtype=torch.bool,
                    device=range_img.device)
    g[:GROUND_SCAN_IND] = is_ground_pair
    g[1:GROUND_SCAN_IND + 1] |= is_ground_pair
    return torch.where(g, torch.ones_like(ground), ground)


def _edge_connected(range_img, shifted_range, alpha):
    """Angle criterion between neighbouring cells (main.cpp:700-712)."""
    d1 = torch.maximum(range_img, shifted_range)
    d2 = torch.minimum(range_img, shifted_range)
    ang = torch.atan2(d2 * np.sin(alpha), d1 - d2 * np.cos(alpha))
    both = torch.isfinite(range_img) & torch.isfinite(shifted_range)
    return both & (ang > SEGMENT_THETA)


def _run_min(lbl, conn_prev, dim):
    """Min of `lbl` over every maximal run of cells connected to their
    predecessor along `dim` (conn_prev True = joined to the previous cell);
    each cell takes its run's minimum."""
    x = lbl if dim == 1 else lbl.t()
    c = conn_prev if dim == 1 else conn_prev.t()
    rows, n = x.shape
    start = ~c
    start[:, 0] = True
    run_id = torch.cumsum(start.reshape(-1).to(torch.int64), 0) - 1
    flat = x.reshape(-1)
    mins = torch.full((flat.numel(),), _NCELL, dtype=flat.dtype,
                      device=flat.device)
    mins.scatter_reduce_(0, run_id, flat, reduce="amin")
    out = mins[run_id].reshape(rows, n)
    return out if dim == 1 else out.t().contiguous()


def segment_cloud(range_img: torch.Tensor, ground: torch.Tensor):
    """Connected components under the angle criterion; feasibility gating
    (labelComponents, main.cpp:658-748). Iterates to the exact fixpoint.

    Returns seg_mask (64, 1800) bool (feasible cluster or ground) and
    is_ground (64, 1800) bool (ground subset of seg_mask)."""
    dev = range_img.device
    inf = torch.full((1, HORIZON_SCAN), float("inf"), dtype=range_img.dtype,
                     device=dev)
    valid = torch.isfinite(range_img) & (ground != 1)

    up = torch.cat([inf, range_img[:-1]], dim=0)
    down = torch.cat([range_img[1:], inf], dim=0)
    left = torch.roll(range_img, 1, dims=1)    # column wrap (main.cpp:688-691)
    right = torch.roll(range_img, -1, dims=1)

    f_row = torch.zeros((1, HORIZON_SCAN), dtype=torch.bool, device=dev)
    vup = torch.cat([f_row, valid[:-1]], dim=0)
    vdown = torch.cat([valid[1:], f_row], dim=0)
    vleft = torch.roll(valid, 1, dims=1)
    vright = torch.roll(valid, -1, dims=1)
    conn_up = _edge_connected(range_img, up, SEGMENT_ALPHA_Y) & valid & vup
    conn_down = _edge_connected(range_img, down, SEGMENT_ALPHA_Y) & valid \
        & vdown
    conn_left = _edge_connected(range_img, left, SEGMENT_ALPHA_X) & valid \
        & vleft
    conn_right = _edge_connected(range_img, right, SEGMENT_ALPHA_X) & valid \
        & vright
    # non-wrapping "joined to the previous column" for the run minima
    conn_left_nw = conn_left.clone()
    conn_left_nw[:, 0] = False

    idx = torch.arange(_NCELL, device=dev).reshape(N_SCAN, HORIZON_SCAN)
    big = torch.full_like(idx, _NCELL)
    label = torch.where(valid, idx, big)
    big_row = torch.full((1, HORIZON_SCAN), _NCELL, dtype=idx.dtype,
                         device=dev)

    def hook(lbl):
        lup = torch.cat([big_row, lbl[:-1]], dim=0)
        ldown = torch.cat([lbl[1:], big_row], dim=0)
        lleft = torch.roll(lbl, 1, dims=1)
        lright = torch.roll(lbl, -1, dims=1)
        m = lbl
        m = torch.minimum(m, torch.where(conn_up, lup, big))
        m = torch.minimum(m, torch.where(conn_down, ldown, big))
        m = torch.minimum(m, torch.where(conn_left, lleft, big))
        m = torch.minimum(m, torch.where(conn_right, lright, big))
        return torch.where(valid, m, big)

    def jump(lbl):
        flat = torch.cat([lbl.reshape(-1), big_row[0, :1]])
        return flat[lbl.reshape(-1)].reshape(lbl.shape)

    def sweep(lbl):
        lbl = hook(lbl)
        lbl = _run_min(lbl, conn_left_nw, dim=1)
        lbl = _run_min(lbl, conn_up, dim=0)
        lbl = torch.where(valid, lbl, big)
        return jump(lbl)

    while True:
        nxt = sweep(label)
        if torch.equal(nxt, label):
            break
        label = nxt

    flat_label = label.reshape(-1)
    live = flat_label < _NCELL
    # cluster sizes (integer counts: exact in any order; the sentinel
    # label _NCELL collects the invalid cells and is never read)
    sizes = torch.bincount(flat_label, minlength=_NCELL + 1)

    # distinct-ring count per component: a presence grid (component, ring)
    rows = idx.reshape(-1) // HORIZON_SCAN
    pres_idx = torch.where(live, flat_label * N_SCAN + rows,
                           torch.full_like(flat_label, _NCELL * N_SCAN))
    presence = torch.zeros(_NCELL * N_SCAN + 1, dtype=torch.bool, device=dev)
    presence[pres_idx] = True
    line_count = presence[:-1].reshape(_NCELL, N_SCAN).sum(dim=1)

    feasible_root = (sizes[:_NCELL] >= 30) | (
        (sizes[:_NCELL] >= SEGMENT_VALID_POINT_NUM)
        & (line_count >= SEGMENT_VALID_LINE_NUM))
    feasible = torch.cat([feasible_root, feasible_root.new_zeros(1)])[
        flat_label].reshape(N_SCAN, HORIZON_SCAN)
    is_ground = ground == 1
    seg_mask = (feasible & valid) | is_ground
    return seg_mask, is_ground & seg_mask


def project_to_camera(xyz_img, seg_mask, is_ground, R_cl, t_cl, fx, fy, cx,
                      cy, w, h):
    """Project segmented cells into the camera (lidarCloudHandler,
    main.cpp:810-848): candidate grid, ground ratio, splatted nearest-depth
    map with each winner's exact float projection, LiDAR bbox area."""
    pts = xyz_img.reshape(-1, 3)
    cam = pts @ R_cl.T + t_cl
    zc = cam[:, 2]
    u = cam[:, 0] / zc
    v = cam[:, 1] / zc
    ku = u * fx + cx
    kv = v * fy + cy
    kui = ku.to(torch.int64)   # C-style trunc toward 0 for the bounds test
    kvi = kv.to(torch.int64)
    sm = seg_mask.reshape(-1)
    ok = (sm & (zc >= 0.2) & (kui >= 4) & (kui < w - 5) & (kvi >= 4)
          & (kvi < h - 4))
    grd = is_ground.reshape(-1) & ok
    n_all = ok.sum()
    ground_ratio = grd.sum() / torch.clamp(n_all, min=1)

    pix = torch.where(ok, kvi * w + kui, torch.full_like(kvi, w * h))
    zsc = torch.where(ok, zc, torch.full_like(zc, float("inf")))
    perm = _lexsort_perm(pix, zsc)
    pix_s = pix[perm]
    z_s = zsc[perm]
    first = torch.ones_like(pix_s, dtype=torch.bool)
    first[1:] = pix_s[1:] != pix_s[:-1]
    win = first & (pix_s < w * h)
    zero = torch.zeros((), dtype=zc.dtype, device=zc.device)
    payload = torch.stack([torch.where(torch.isfinite(z_s), z_s, zero),
                           ku[perm], kv[perm], grd[perm].to(zc.dtype)],
                          dim=-1)
    maps = torch.zeros((w * h, 4), dtype=xyz_img.dtype, device=xyz_img.device)
    maps[pix_s[win]] = payload[win]
    depth_map = maps[:, 0].reshape(h, w)
    neg = torch.full((), -1.0, dtype=zc.dtype, device=zc.device)
    px_u_map = torch.where(depth_map > 0, maps[:, 1].reshape(h, w), neg)
    px_v_map = torch.where(depth_map > 0, maps[:, 2].reshape(h, w), neg)
    ground_map = (maps[:, 3] > 0).reshape(h, w)

    big = 1 << 20
    umin = torch.where(ok, kui, torch.full_like(kui, big)).min()
    umax = torch.where(ok, kui, torch.full_like(kui, -big)).max()
    vmin = torch.where(ok, kvi, torch.full_like(kvi, big)).min()
    vmax = torch.where(ok, kvi, torch.full_like(kvi, -big)).max()
    bbox_area = torch.where(
        n_all >= 2, ((umax - umin) * (vmax - vmin)).to(xyz_img.dtype),
        torch.ones((), dtype=xyz_img.dtype, device=xyz_img.device))

    return dict(
        cand_u=ku.reshape(N_SCAN, HORIZON_SCAN),
        cand_v=kv.reshape(N_SCAN, HORIZON_SCAN),
        cand_z=zc.reshape(N_SCAN, HORIZON_SCAN),
        cand_valid=ok.reshape(N_SCAN, HORIZON_SCAN),
        cand_ground=grd.reshape(N_SCAN, HORIZON_SCAN),
        ground_ratio=ground_ratio,
        depth_map=depth_map,
        ground_map=ground_map,
        px_u_map=px_u_map,
        px_v_map=px_v_map,
        bbox_area=bbox_area,
    )


def preprocess_scan(cloud, mask, R_cl, t_cl, fx, fy, cx, cy, w: int, h: int):
    """Full per-scan LiDAR pipeline. `cloud` (N, 3) float32 and `mask` (N,)
    bool on the system's device; R_cl (3, 3), t_cl (3,) likewise."""
    range_img, xyz_img = project_point_cloud(cloud, mask)
    ground = ground_removal(range_img, xyz_img)
    seg_mask, is_ground = segment_cloud(range_img, ground)
    out = project_to_camera(xyz_img, seg_mask, is_ground, R_cl, t_cl,
                            fx, fy, cx, cy, w, h)
    out["range_img"] = range_img
    out["seg_mask"] = seg_mask
    # addFeaturePoint flag: > 0.8 ground among projected candidates
    out["add_feature_point"] = out["ground_ratio"] > 0.8
    return out
