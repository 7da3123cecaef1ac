"""Parity of the port's LiDAR preprocessing with the JAX package.

The same padded clouds go through sdv_loam_tpu.ops.lidar.preprocess_scan
and its port. Segmentation must match exactly (the exact connected
components of test_lidar.py's BFS oracle), as must every winner mask; the
float values agree to an ulp or two.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_parity import mid_bin
from sdv_loam_tpu.data.synthetic import make_sequence
from sdv_loam_tpu.ops import lidar as jl
from sdv_loam_tpu_torch.ops import lidar as tl


def _pad(cloud, cap):
    out = np.zeros((cap, 3), np.float32)
    out[:cloud.shape[0]] = cloud
    mask = np.zeros(cap, bool)
    mask[:cloud.shape[0]] = True
    return out, mask


def _with_ties(cloud, rng, n=400):
    """Append copies of some points rotated by a tiny yaw: the same range,
    the same range-image cell, another position — the tie goes to the
    lowest point index."""
    idx = rng.choice(cloud.shape[0], n, replace=False)
    a = 1e-5
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                  [0, 0, 1]], np.float32)
    return np.concatenate([cloud, cloud[idx] @ R.T]).astype(np.float32)


def _run_both(cloud, mask, calib, sensor, w, h):
    K = [float(calib.fx[0]), float(calib.fy[0]), float(calib.cx[0]),
         float(calib.cy[0])]
    R = np.asarray(sensor.R_cl, np.float32)
    t = np.asarray(sensor.t_cl, np.float32)
    jo = jl.preprocess_scan(jnp.asarray(cloud), jnp.asarray(mask),
                            jnp.asarray(R), jnp.asarray(t),
                            *[np.float32(k) for k in K], w, h)
    to = tl.preprocess_scan(torch.from_numpy(cloud), torch.from_numpy(mask),
                            torch.from_numpy(R), torch.from_numpy(t),
                            *K, w, h)
    return jo, to


@pytest.mark.parametrize("frame,ties", [(0, False), (3, True)])
def test_preprocess_scan_matches(frame, ties):
    seq = make_sequence(n_frames=4, w=320, h=96, lidar_stride=2)
    cloud = mid_bin(seq.get_cloud(frame))
    if ties:
        cloud = _with_ties(cloud, np.random.default_rng(frame))
    cloud, mask = _pad(cloud, 1 << 17)
    jo, to = _run_both(cloud, mask, seq.calib, seq.sensor, 320, 96)
    # masks exact: same winner rule, same component fixpoint
    for k in ("seg_mask", "cand_valid", "cand_ground", "ground_map"):
        np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(np.isfinite(to["range_img"].numpy()),
                                  np.isfinite(np.asarray(jo["range_img"])))
    np.testing.assert_array_equal(to["depth_map"].numpy() > 0,
                                  np.asarray(jo["depth_map"]) > 0)
    # values: the two frameworks associate sqrt(x^2+y^2+z^2) and the 3x3
    # transform differently, so ranges agree to <= 1e-6 relative; a pixel
    # whose two nearest candidates tie to an ulp may keep the other one
    # (depth <= 1e-5 relative, projection <= 1e-4 px)
    np.testing.assert_allclose(to["range_img"].numpy(),
                               np.asarray(jo["range_img"]), rtol=1e-6)
    np.testing.assert_allclose(to["depth_map"].numpy(),
                               np.asarray(jo["depth_map"]), rtol=1e-5)
    # (the appended near-duplicates sit 1e-5 rad from their originals:
    # a flipped near-tie there moves the projection <= 1e-2 px)
    px_tol = 1e-2 if ties else 1e-4
    for k in ("px_u_map", "px_v_map"):
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                   rtol=0, atol=px_tol, err_msg=k)
    assert float(to["bbox_area"]) == float(jo["bbox_area"])
    assert bool(to["add_feature_point"]) == bool(jo["add_feature_point"])
    np.testing.assert_allclose(float(to["ground_ratio"]),
                               float(jo["ground_ratio"]), rtol=1e-6)


def test_segmentation_matches_on_a_ring_wide_wall():
    """A wall spanning the whole 1800-column ring plus isolated clutter:
    the run minima must unify across the column wrap."""
    rng = np.random.default_rng(5)
    cols = np.arange(1800)
    yaw = np.deg2rad((900 - cols) * 0.2 + 90.0)
    pts = []
    for ring in range(52, 60):
        vert = np.deg2rad((ring + 0.5) * 0.427 - 24.9)
        d = 12.0
        pts.append(np.stack([d * np.cos(vert) * np.sin(yaw),
                             d * np.cos(vert) * np.cos(yaw),
                             np.full_like(yaw, d * np.sin(vert))], -1))
    clutter = rng.uniform(-30, 30, (3000, 3)) * np.array([1, 1, 0.1])
    cloud = np.concatenate(pts + [clutter]).astype(np.float32)
    cloud, mask = _pad(cloud, 1 << 15)
    jr, jx = jl.project_point_cloud(jnp.asarray(cloud), jnp.asarray(mask))
    tr, tx = tl.project_point_cloud(torch.from_numpy(cloud),
                                    torch.from_numpy(mask))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr),
                               rtol=1e-6)      # ulp-level, see above
    jg = jl.ground_removal(jr, jx)
    tg = tl.ground_removal(tr, tx)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    js, jgm = jl.segment_cloud(jr, jg)
    ts, tgm = tl.segment_cloud(tr, tg)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tgm.numpy(), np.asarray(jgm))
    # the wall is one feasible component (clutter hides a few of its cells)
    assert ts.numpy()[52:60].mean() > 0.9


@pytest.mark.parametrize("n_iters", [1, 2, 24])
def test_segment_cloud_sweep_cap(n_iters):
    """The components fixpoint stops after `n_iters` sweeps in all, as the
    JAX package's while_loop does (default 24). A full-density scan of the
    seed-3 scene reaches its fixpoint in two sweeps and needs a third to
    see no change: one and two sweeps cut the loop, 24 does not, and both
    packages give the same masks each time."""
    from sdv_loam_tpu_torch.utils import device_loop
    seq = make_sequence(n_frames=1, w=320, h=96, lidar_stride=1, seed=3)
    cloud, mask = _pad(mid_bin(seq.get_cloud(0)), 1 << 17)
    jr, jx = jl.project_point_cloud(jnp.asarray(cloud), jnp.asarray(mask))
    tr, tx = tl.project_point_cloud(torch.from_numpy(cloud),
                                    torch.from_numpy(mask))
    jg = jl.ground_removal(jr, jx)
    tg = tl.ground_removal(tr, tx)
    js, jgm = jl.segment_cloud(jr, jg, n_iters=n_iters)
    device_loop.reset_counts()
    ts, tgm = tl.segment_cloud(tr, tg, n_iters=n_iters)
    assert device_loop.HIST["sweep"] == {min(n_iters, 3): 1}
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tgm.numpy(), np.asarray(jgm))
