"""Brute-force k-nearest-neighbors — the nanoflann equivalent.

Counterpart of `sdv_loam_tpu/ops/knn.py` (reference src/util/nanoflann.h,
used only by CoarseInitializer::makeNN, CoarseInitializer.cpp:998-1075:
10-NN among the selected points per pyramid level plus a parent link to
the nearest point one level up, for the monocular initializer's
depth-smoothness regularizer).

The distance matrix is built in blocks of rows, each block keeping its k
smallest entries, so the peak memory stays bounded at the initializer's
level-0 cap (16384 points: a whole matrix would be 1 GiB). Selected points
sit on the pixel grid (+0.1), so their squared distances are near-integers
and ties are everywhere: the k smallest are taken with a stable sort, which
puts the lower index first on ties as `jax.lax.top_k` does. A squared
distance is rounded as the JAX package's fused program rounds it: the
first coordinate's square in float32, then one fused multiply-add per
further coordinate. The +0.1 offsets make the grid coordinates inexact in
float32, so a different rounding would reorder near-equal distances and
change the neighbour graph.
"""

from __future__ import annotations

import torch

# rows per block: at 16384 points a block's distances are 64 MiB (float32)
# and its float64 temporaries twice that
BLOCK_ROWS = 1024


def _d2(a, b):
    """(na, nb) squared distances between the rows of a and of b: the
    first square rounded, then fma(d, d, acc) per coordinate (the product
    exact in float64, one rounding to the points' dtype)."""
    diff = a[:, None, :] - b[None, :, :]
    acc = diff[..., 0] * diff[..., 0]
    for j in range(1, diff.shape[-1]):
        d = diff[..., j].to(torch.float64)
        acc = (d * d + acc.to(torch.float64)).to(a.dtype)
    return acc


def knn(points, valid, k: int = 10, block: int = BLOCK_ROWS):
    """Exact k-NN among `points` ((N, D) with (N,) validity).

    Returns (idx (N, k) int64, dist2 (N, k)) — nearest first, self
    excluded, ties in index order; invalid pairs have +inf distance."""
    n = points.shape[0]
    idx = torch.empty((n, k), dtype=torch.int64, device=points.device)
    dist = torch.empty((n, k), dtype=points.dtype, device=points.device)
    inf = torch.full((), float("inf"), dtype=points.dtype,
                     device=points.device)
    for s in range(0, n, block):
        e = min(n, s + block)
        rows = torch.arange(s, e, device=points.device)
        d2 = torch.where(valid[s:e, None] & valid[None, :],
                         _d2(points[s:e], points), inf)
        d2[rows - s, rows] = inf                       # exclude self
        vals, order = torch.sort(d2, dim=1, stable=True)
        idx[s:e] = order[:, :k]
        dist[s:e] = vals[:, :k]
    return idx, dist


def nearest_cross(points_a, valid_a, points_b, valid_b,
                  block: int = BLOCK_ROWS):
    """Nearest neighbor of each a-point among b-points (the initializer's
    parent link to the coarser level, CoarseInitializer.cpp:1044-1071);
    the first minimum on ties, as `jnp.argmin`.

    Returns (idx (Na,) int64, dist2 (Na,))."""
    na = points_a.shape[0]
    idx = torch.empty(na, dtype=torch.int64, device=points_a.device)
    dist = torch.empty(na, dtype=points_a.dtype, device=points_a.device)
    inf = torch.full((), float("inf"), dtype=points_a.dtype,
                     device=points_a.device)
    for s in range(0, na, block):
        e = min(na, s + block)
        d2 = torch.where(valid_a[s:e, None] & valid_b[None, :],
                         _d2(points_a[s:e], points_b), inf)
        i = torch.argmin(d2, dim=1)
        idx[s:e] = i
        dist[s:e] = torch.take_along_dim(d2, i[:, None], dim=1)[:, 0]
    return idx, dist
