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
from sdv_loam_tpu_torch.utils import device_loop

_NCELL = N_SCAN * HORIZON_SCAN


def _lexsort_perm(primary, secondary):
    """Permutation sorting by (primary, secondary, original index)."""
    o1 = torch.argsort(secondary, stable=True)
    o2 = torch.argsort(primary[o1], stable=True)
    return o1[o2]


def _lanes(x, dims):
    """(x with a leading lane dimension, whether one was added)."""
    return (x[None], True) if x.dim() == dims else (x, False)


def project_point_cloud(cloud: torch.Tensor, mask: torch.Tensor):
    """Bin points into the 64 x 1800 range image (main.cpp:562-606).

    Returns range_img (64, 1800) with +inf where empty, and xyz_img
    (64, 1800, 3) of the nearest point per cell (0 where empty). A lane
    stack (L, N, 3) of clouds gives (L, 64, 1800) images: one sort for all
    lanes, whose cells never mix."""
    cloud, single = _lanes(cloud, 2)
    mask = mask[None] if single else mask
    L = cloud.shape[0]
    dev = cloud.device
    x, y, z = cloud[..., 0], cloud[..., 1], cloud[..., 2]
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
    idx = idx + (torch.arange(L, device=dev) * (_NCELL + 1))[:, None]
    rng_s = torch.where(ok, rng, torch.full_like(rng, float("inf")))

    perm = _lexsort_perm(idx.reshape(-1), rng_s.reshape(-1))
    idx_s = idx.reshape(-1)[perm]
    rng_sorted = rng_s.reshape(-1)[perm]
    first = torch.ones_like(idx_s, dtype=torch.bool)
    first[1:] = idx_s[1:] != idx_s[:-1]
    win = first & (idx_s % (_NCELL + 1) < _NCELL) & torch.isfinite(rng_sorted)
    payload = torch.cat([rng_sorted[:, None], cloud.reshape(-1, 3)[perm]],
                        dim=-1)
    # every winner writes its cell; the rest write one spare row past the
    # lanes' cells (a fixed-size scatter: no host sync)
    maps = torch.full((L * (_NCELL + 1) + 1, 4), float("inf"),
                      dtype=cloud.dtype, device=dev)
    maps[torch.where(win, idx_s, L * (_NCELL + 1))] = payload
    maps = maps[:-1].reshape(L, _NCELL + 1, 4)[:, :_NCELL]
    range_img = maps[..., 0].reshape(L, N_SCAN, HORIZON_SCAN)
    xyz_img = torch.where(torch.isfinite(range_img)[..., None],
                          maps[..., 1:].reshape(L, N_SCAN, HORIZON_SCAN, 3),
                          torch.zeros((), dtype=cloud.dtype, device=dev))
    if single:
        return range_img[0], xyz_img[0]
    return range_img, xyz_img


def ground_removal(range_img: torch.Tensor, xyz_img: torch.Tensor):
    """Ground mask from ring-pair vertical angles (main.cpp:608-656):
    (64, 1800) int8, 1 ground, 0 not ground, -1 unknown (per lane for a
    (L, 64, 1800) stack)."""
    G = GROUND_SCAN_IND
    has = torch.isfinite(range_img)
    lower = xyz_img[..., :G, :, :]
    upper = xyz_img[..., 1:G + 1, :, :]
    diff = upper - lower
    angle = torch.rad2deg(torch.atan2(
        diff[..., 2], torch.sqrt(diff[..., 0] ** 2 + diff[..., 1] ** 2)))
    pair_ok = has[..., :G, :] & has[..., 1:G + 1, :]
    is_ground_pair = pair_ok & (torch.abs(angle - SENSOR_MOUNT_ANGLE) <= 10.0)

    dev = range_img.device
    ground = torch.zeros(range_img.shape, dtype=torch.int8, device=dev)
    ground[..., :G, :] = torch.where(
        pair_ok, torch.zeros((), dtype=torch.int8, device=dev),
        torch.full((), -1, dtype=torch.int8, device=dev))
    g = torch.zeros(range_img.shape, dtype=torch.bool, device=dev)
    g[..., :G, :] = is_ground_pair
    g[..., 1:G + 1, :] |= is_ground_pair
    return torch.where(g, torch.ones_like(ground), ground)


def _edge_connected(range_img, shifted_range, alpha):
    """Angle criterion between neighbouring cells (main.cpp:700-712)."""
    d1 = torch.maximum(range_img, shifted_range)
    d2 = torch.minimum(range_img, shifted_range)
    ang = torch.atan2(d2 * np.sin(alpha), d1 - d2 * np.cos(alpha))
    both = torch.isfinite(range_img) & torch.isfinite(shifted_range)
    return both & (ang > SEGMENT_THETA)


def _run_min(lbl, conn_prev, dim):
    """Min of `lbl` (L, rows, cols) over every maximal run of cells
    connected to their predecessor along `dim` (2 along a row, 1 along a
    column; conn_prev True = joined to the previous cell); each cell takes
    its run's minimum. Runs never cross a row, a column or a lane."""
    x = lbl if dim == 2 else lbl.transpose(1, 2)
    c = conn_prev if dim == 2 else conn_prev.transpose(1, 2)
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    start = ~c.reshape(-1, shape[-1])
    start[:, 0].fill_(True)
    run_id = torch.cumsum(start.reshape(-1).to(torch.int64), 0) - 1
    flat = x.reshape(-1)
    mins = torch.full((flat.numel(),), _NCELL, dtype=flat.dtype,
                      device=flat.device)
    mins.scatter_reduce_(0, run_id, flat, reduce="amin")
    out = mins[run_id].reshape(shape)
    return out if dim == 2 else out.transpose(1, 2).contiguous()


def _sweep_body(x, st):
    """One components sweep (hook over the 4-neighbourhood, run minima
    along rows and columns, one pointer jump) of every lane; a lane at its
    fixpoint is unchanged. The flag: did any label change."""
    lbl = st["label"]
    valid, big = x["valid"], x["big"]
    L = lbl.shape[0]
    big_row = big[:, :1]
    lup = torch.cat([big_row, lbl[:, :-1]], dim=1)
    ldown = torch.cat([lbl[:, 1:], big_row], dim=1)
    lleft = torch.roll(lbl, 1, dims=2)
    lright = torch.roll(lbl, -1, dims=2)
    m = lbl
    m = torch.minimum(m, torch.where(x["conn_up"], lup, big))
    m = torch.minimum(m, torch.where(x["conn_down"], ldown, big))
    m = torch.minimum(m, torch.where(x["conn_left"], lleft, big))
    m = torch.minimum(m, torch.where(x["conn_right"], lright, big))
    nxt = torch.where(valid, m, big)
    nxt = _run_min(nxt, x["conn_left_nw"], dim=2)
    nxt = _run_min(nxt, x["conn_up"], dim=1)
    nxt = torch.where(valid, nxt, big)
    flat = torch.cat([nxt.reshape(L, -1), big_row[:, 0, :1]], dim=1)
    nxt = flat.gather(1, nxt.reshape(L, -1)).reshape(nxt.shape)
    return dict(label=nxt), (nxt != lbl).any()


def segment_cloud(range_img: torch.Tensor, ground: torch.Tensor,
                  n_iters: int = 24):
    """Connected components under the angle criterion; feasibility gating
    (labelComponents, main.cpp:658-748). Sweeps (`device_loop.run`: graph
    replays on CUDA) until a sweep changes no label or `n_iters` sweeps
    have run, as the JAX package's while_loop (`n_iters` caps the sweeps in
    all; the fixpoint comes in a few).

    Returns seg_mask (64, 1800) bool (feasible cluster or ground) and
    is_ground (64, 1800) bool (ground subset of seg_mask); per lane for an
    (L, 64, 1800) stack, whose sweeps run until every lane has reached its
    fixpoint (a lane at its fixpoint is unchanged by further sweeps)."""
    range_img, single = _lanes(range_img, 2)
    ground = ground[None] if single else ground
    L = range_img.shape[0]
    dev = range_img.device
    inf = torch.full((L, 1, HORIZON_SCAN), float("inf"),
                     dtype=range_img.dtype, device=dev)
    valid = torch.isfinite(range_img) & (ground != 1)

    up = torch.cat([inf, range_img[:, :-1]], dim=1)
    down = torch.cat([range_img[:, 1:], inf], dim=1)
    left = torch.roll(range_img, 1, dims=2)    # column wrap (main.cpp:688-691)
    right = torch.roll(range_img, -1, dims=2)

    f_row = torch.zeros((L, 1, HORIZON_SCAN), dtype=torch.bool, device=dev)
    vup = torch.cat([f_row, valid[:, :-1]], dim=1)
    vdown = torch.cat([valid[:, 1:], f_row], dim=1)
    vleft = torch.roll(valid, 1, dims=2)
    vright = torch.roll(valid, -1, dims=2)
    conn_up = _edge_connected(range_img, up, SEGMENT_ALPHA_Y) & valid & vup
    conn_down = _edge_connected(range_img, down, SEGMENT_ALPHA_Y) & valid \
        & vdown
    conn_left = _edge_connected(range_img, left, SEGMENT_ALPHA_X) & valid \
        & vleft
    conn_right = _edge_connected(range_img, right, SEGMENT_ALPHA_X) & valid \
        & vright
    # non-wrapping "joined to the previous column" for the run minima
    conn_left_nw = conn_left.clone()
    conn_left_nw[..., 0].fill_(False)

    idx = torch.arange(_NCELL, device=dev).reshape(N_SCAN, HORIZON_SCAN)
    big = torch.full((L, N_SCAN, HORIZON_SCAN), _NCELL, dtype=idx.dtype,
                     device=dev)
    label = torch.where(valid, idx, big)
    x = dict(valid=valid, big=big, conn_up=conn_up, conn_down=conn_down,
             conn_left=conn_left, conn_right=conn_right,
             conn_left_nw=conn_left_nw)
    label = device_loop.run("sweep", _sweep_body, x, dict(label=label),
                            n_iters)["label"]

    flat_label = label.reshape(L, -1)
    live = flat_label < _NCELL
    lane = torch.arange(L, device=dev)[:, None]
    # cluster sizes (integer counts: exact in any order; the sentinel
    # label _NCELL collects the invalid cells and is never read)
    lab = (flat_label + lane * (_NCELL + 1)).reshape(-1)
    sizes = torch.zeros(L * (_NCELL + 1), dtype=torch.int64, device=dev)
    sizes = sizes.index_add_(0, lab, torch.ones_like(lab)).reshape(L, -1)

    # distinct-ring count per component: a presence grid (component, ring)
    n_pres = _NCELL * N_SCAN + 1
    rows = idx.reshape(-1) // HORIZON_SCAN
    pres_idx = torch.where(live, flat_label * N_SCAN + rows,
                           torch.full_like(flat_label, _NCELL * N_SCAN))
    presence = torch.zeros(L * n_pres, dtype=torch.bool, device=dev)
    presence.index_fill_(0, (pres_idx + lane * n_pres).reshape(-1), True)
    line_count = presence.reshape(L, n_pres)[:, :-1].reshape(
        L, _NCELL, N_SCAN).sum(dim=2)

    feasible_root = (sizes[:, :_NCELL] >= 30) | (
        (sizes[:, :_NCELL] >= SEGMENT_VALID_POINT_NUM)
        & (line_count >= SEGMENT_VALID_LINE_NUM))
    feasible = torch.cat([feasible_root, feasible_root.new_zeros(L, 1)],
                         1).gather(1, flat_label).reshape(label.shape)
    is_ground = ground == 1
    seg_mask = (feasible & valid) | is_ground
    is_ground = is_ground & seg_mask
    if single:
        return seg_mask[0], is_ground[0]
    return seg_mask, is_ground


def project_to_camera(xyz_img, seg_mask, is_ground, R_cl, t_cl, K, w, h):
    """Project segmented cells into the camera (lidarCloudHandler,
    main.cpp:810-848) for a lane stack: xyz_img (L, 64, 1800, 3), R_cl
    (L, 3, 3), t_cl (L, 3), K (L, 4) [fx, fy, cx, cy]. Returns per lane:
    candidate grid, ground ratio, splatted nearest-depth map with each
    winner's exact float projection, LiDAR bbox area."""
    L = xyz_img.shape[0]
    dev = xyz_img.device
    fx, fy, cx, cy = (K[:, i:i + 1] for i in range(4))
    pts = xyz_img.reshape(L, -1, 3)
    cam = torch.matmul(pts, R_cl.transpose(1, 2)) + t_cl[:, None, :]
    zc = cam[..., 2]
    u = cam[..., 0] / zc
    v = cam[..., 1] / zc
    ku = u * fx + cx
    kv = v * fy + cy
    kui = ku.to(torch.int64)   # C-style trunc toward 0 for the bounds test
    kvi = kv.to(torch.int64)
    sm = seg_mask.reshape(L, -1)
    ok = (sm & (zc >= 0.2) & (kui >= 4) & (kui < w - 5) & (kvi >= 4)
          & (kvi < h - 4))
    grd = is_ground.reshape(L, -1) & ok
    n_all = ok.sum(-1)
    ground_ratio = grd.sum(-1) / torch.clamp(n_all, min=1)

    npix = w * h + 1
    pix = torch.where(ok, kvi * w + kui, torch.full_like(kvi, w * h)) \
        + (torch.arange(L, device=dev) * npix)[:, None]
    zsc = torch.where(ok, zc, torch.full_like(zc, float("inf")))
    perm = _lexsort_perm(pix.reshape(-1), zsc.reshape(-1))
    pix_s = pix.reshape(-1)[perm]
    z_s = zsc.reshape(-1)[perm]
    first = torch.ones_like(pix_s, dtype=torch.bool)
    first[1:] = pix_s[1:] != pix_s[:-1]
    win = first & (pix_s % npix < w * h)
    zero = torch.zeros((), dtype=zc.dtype, device=dev)
    payload = torch.stack([torch.where(torch.isfinite(z_s), z_s, zero),
                           ku.reshape(-1)[perm], kv.reshape(-1)[perm],
                           grd.reshape(-1)[perm].to(zc.dtype)], dim=-1)
    maps = torch.zeros((L * npix + 1, 4), dtype=xyz_img.dtype, device=dev)
    maps[torch.where(win, pix_s, L * npix)] = payload
    maps = maps[:-1].reshape(L, npix, 4)[:, :w * h]
    depth_map = maps[..., 0].reshape(L, h, w)
    neg = torch.full((), -1.0, dtype=zc.dtype, device=dev)
    px_u_map = torch.where(depth_map > 0, maps[..., 1].reshape(L, h, w), neg)
    px_v_map = torch.where(depth_map > 0, maps[..., 2].reshape(L, h, w), neg)
    ground_map = (maps[..., 3] > 0).reshape(L, h, w)

    big = 1 << 20
    umin = torch.where(ok, kui, torch.full_like(kui, big)).amin(-1)
    umax = torch.where(ok, kui, torch.full_like(kui, -big)).amax(-1)
    vmin = torch.where(ok, kvi, torch.full_like(kvi, big)).amin(-1)
    vmax = torch.where(ok, kvi, torch.full_like(kvi, -big)).amax(-1)
    bbox_area = torch.where(
        n_all >= 2, ((umax - umin) * (vmax - vmin)).to(xyz_img.dtype),
        torch.ones((), dtype=xyz_img.dtype, device=dev))

    grid = (L, N_SCAN, HORIZON_SCAN)
    return dict(
        cand_u=ku.reshape(grid), cand_v=kv.reshape(grid),
        cand_z=zc.reshape(grid), cand_valid=ok.reshape(grid),
        cand_ground=grd.reshape(grid),
        ground_ratio=ground_ratio,
        depth_map=depth_map,
        ground_map=ground_map,
        px_u_map=px_u_map,
        px_v_map=px_v_map,
        bbox_area=bbox_area,
    )


def preprocess_scan_batch(clouds, masks, R_cl, t_cl, K, w: int, h: int):
    """Full LiDAR pipeline for L scans at once (the JAX package's
    `preprocess_scan_batch`): clouds (L, N, 3) float32 padded to one shared
    bucket, masks (L, N) bool, R_cl (L, 3, 3), t_cl (L, 3), K (L, 4)
    [fx, fy, cx, cy], all on one device. Returns preprocess_scan's dict
    with a leading L. One stage program (`device_loop.program`, "lidar"),
    the components sweeps inside it a loop decided on the device."""
    return device_loop.program(
        "lidar", _preprocess_program,
        dict(clouds=clouds, masks=masks, R_cl=R_cl, t_cl=t_cl, K=K),
        dict(w=int(w), h=int(h)))


def _preprocess_program(x, w, h):
    clouds, masks, R_cl, t_cl, K = (x[k] for k in ("clouds", "masks", "R_cl",
                                                   "t_cl", "K"))
    range_img, xyz_img = project_point_cloud(clouds, masks)
    ground = ground_removal(range_img, xyz_img)
    seg_mask, is_ground = segment_cloud(range_img, ground)
    out = project_to_camera(xyz_img, seg_mask, is_ground, R_cl, t_cl, K,
                            w, h)
    out["range_img"] = range_img
    out["seg_mask"] = seg_mask
    # addFeaturePoint flag: > 0.8 ground among projected candidates
    out["add_feature_point"] = out["ground_ratio"] > 0.8
    return out


def preprocess_scan(cloud, mask, R_cl, t_cl, fx, fy, cx, cy, w: int, h: int):
    """Full per-scan LiDAR pipeline. `cloud` (N, 3) float32 and `mask` (N,)
    bool on the system's device; R_cl (3, 3), t_cl (3,) likewise. One scan
    is lane 0 of `preprocess_scan_batch`."""
    K = torch.tensor([[fx, fy, cx, cy]], dtype=torch.float32,
                     device=cloud.device)
    out = preprocess_scan_batch(cloud[None], mask[None], R_cl[None],
                                t_cl[None], K, w, h)
    return {k: v[0] for k, v in out.items()}
