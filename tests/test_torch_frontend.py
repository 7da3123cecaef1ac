"""Parity of the port's per-frame and keyframe-front stages with the JAX
package: pixel selection (the JAX random draws injected), immature-point
trace and activation, the distance map, the matcher (align_batch inside)
and the struct-pose LM.

Inputs come from the 320x96 synthetic scene with ground-truth poses and
depths; the same float32 numpy arrays go to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdv_loam_tpu.data.synthetic import make_sequence
from sdv_loam_tpu.models import matcher as jm
from sdv_loam_tpu.ops import distmap as jd
from sdv_loam_tpu.ops import lidar as jl
from sdv_loam_tpu.ops import select as js
from sdv_loam_tpu.ops import struct_pose as jsp
from sdv_loam_tpu.ops import trace as jt
from sdv_loam_tpu.ops.align import flatten_pyramid as j_flatten
from sdv_loam_tpu.ops.pyramid import make_images as j_make_images
from sdv_loam_tpu_torch.models import matcher as tm
from sdv_loam_tpu_torch.ops import distmap as td
from sdv_loam_tpu_torch.ops import select as ts
from sdv_loam_tpu_torch.ops import struct_pose as tsp
from sdv_loam_tpu_torch.ops import trace as tt
from sdv_loam_tpu_torch.ops.align import flatten_pyramid as t_flatten

W, H = 320, 96


def T(x, dtype=None):
    """numpy -> torch (float32 unless an integer/bool array)."""
    a = np.asarray(x)
    if dtype is None and a.dtype.kind == "f":
        dtype = torch.float32
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(dtype) if dtype is not None else t


def N(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def scene():
    seq = make_sequence(n_frames=4, w=W, h=H, step=0.8, yaw_rate=0.01,
                        lidar_stride=2)
    imgs = [seq.get_image(i) for i in range(4)]
    dI = []
    for im in imgs:
        d, ag = j_make_images(jnp.asarray(im), seq.calib.levels)
        dI.append(([np.asarray(x, np.float32) for x in d],
                   [np.asarray(x, np.float32) for x in ag]))
    depth0 = seq.get_depth(0)
    c = seq.calib
    K0 = np.array([c.fx[0], c.fy[0], c.cx[0], c.cy[0]], np.float32)
    cloud = seq.get_cloud(0)
    buf = np.zeros((1 << 17, 3), np.float32)
    buf[:cloud.shape[0]] = cloud
    mask = np.zeros(1 << 17, bool)
    mask[:cloud.shape[0]] = True
    scan = jl.preprocess_scan(jnp.asarray(buf), jnp.asarray(mask),
                              jnp.asarray(seq.sensor.R_cl, jnp.float32),
                              jnp.asarray(seq.sensor.t_cl, jnp.float32),
                              *[np.float32(k) for k in K0], W, H)
    scan = {k: np.asarray(scan[k]) for k in ("depth_map", "px_u_map",
                                             "px_v_map")}
    return dict(seq=seq, dI=dI, depth0=depth0, K0=K0, scan=scan,
                poses=seq.poses_wc)


def _jax_dirs(key, h, w, pot):
    k1, k2, k3 = jax.random.split(key, 3)
    return tuple(np.asarray(jax.random.randint(k, s, 0, 16))
                 for k, s in zip((k1, k2, k3),
                                 ts.cascade_grid_shapes(h, w, pot)))


@pytest.mark.parametrize("pot,lidar", [(3, True), (2, False)])
def test_select_compact_matches_with_jax_draws(scene, pot, lidar):
    (d, ag), _ = scene["dI"][0], None
    sc = scene["scan"]
    cand = sc["depth_map"] > 0 if lidar else np.ones((H, W), bool)
    key = jax.random.PRNGKey(3)
    jo = js._select_compact_impl(
        jnp.asarray(d[0]), jnp.asarray(ag[0]), jnp.asarray(ag[1]),
        jnp.asarray(ag[2]), jnp.asarray(cand), jnp.asarray(sc["depth_map"]),
        jnp.asarray(sc["px_u_map"]), jnp.asarray(sc["px_v_map"]), key,
        pot=pot, cap=2048)
    to = ts.select_compact(
        T(d[0]), T(ag[0]), T(ag[1]), T(ag[2]), T(cand),
        T(sc["depth_map"]), T(sc["px_u_map"]), T(sc["px_v_map"]),
        tuple(T(x) for x in _jax_dirs(key, H, W, pot)), pot=pot, cap=2048)
    # the cascade is exact: same thresholds, same draws, same tie rule
    for k in ("valid", "counts", "u", "v", "z", "finite"):
        np.testing.assert_array_equal(to[k].numpy(), N(jo[k]), err_msg=k)
    assert int(to["n_sel"]) == int(jo["n_sel"])
    assert int(to["counts"].sum()) > 20
    # pattern samples: bilinear float32 sums, <= 1e-5 relative / 1e-3 abs;
    # the Shi-Tomasi score is a difference of products of gradient sums
    # (cancellation): <= 1e-3 relative
    for k in ("color", "weights", "gradH", "gcen"):
        np.testing.assert_allclose(to[k].numpy(), N(jo[k]), rtol=1e-5,
                                   atol=1e-3, err_msg=k)
    np.testing.assert_allclose(to["score"].numpy(), N(jo["score"]),
                               rtol=1e-3, atol=1e-2)


def test_grad_hist_thresholds_match(scene):
    ag0 = scene["dI"][1][1][0]
    np.testing.assert_array_equal(
        ts.grad_hist_thresholds(T(ag0)).numpy(),
        N(js.grad_hist_thresholds(jnp.asarray(ag0))))


def _rel(poses, a, b):
    """host a -> target b transform (world->cam)."""
    return np.linalg.inv(poses[b]) @ poses[a]


def _immature_pool(scene, n=600, seed=0):
    rng = np.random.default_rng(seed)
    d0 = scene["dI"][0][0][0]
    u = rng.uniform(10, W - 10, n).astype(np.float32)
    v = rng.uniform(10, H - 10, n).astype(np.float32)
    z = scene["depth0"][v.astype(int), u.astype(int)]
    idgt = (1.0 / z).astype(np.float32)
    color, wts, gradH, _, _ = (np.asarray(x, np.float32) for x in
                               jt.pattern_colors(jnp.asarray(d0),
                                                 jnp.asarray(u),
                                                 jnp.asarray(v)))
    bounded = rng.random(n) < 0.5
    idmin = np.where(bounded, idgt * 0.8, 0.0).astype(np.float32)
    idmax = np.where(bounded, idgt * 1.25, np.inf).astype(np.float32)
    status = np.where(bounded, jt.IPS_GOOD, jt.IPS_UNINITIALIZED).astype(
        np.int32)
    return dict(u=u, v=v, idgt=idgt, color=color, weights=wts, gradH=gradH,
                idmin=idmin, idmax=idmax, status=status)


def test_pattern_colors_match(scene):
    p = _immature_pool(scene)
    d0 = scene["dI"][0][0][0]
    jo = jt.pattern_colors(jnp.asarray(d0), jnp.asarray(p["u"]),
                           jnp.asarray(p["v"]))
    to = tt.pattern_colors(T(d0), T(p["u"]), T(p["v"]))
    for a, b in zip(jo, to):    # bilinear float32: <= 1e-5 rel / 1e-3 abs
        np.testing.assert_allclose(b.numpy(), N(a), rtol=1e-5, atol=1e-3)


def test_trace_points_matches(scene):
    p = _immature_pool(scene)
    K0 = scene["K0"]
    Km = np.array([[K0[0], 0, K0[2]], [0, K0[1], K0[3]], [0, 0, 1]])
    F = 4
    KRKi = np.zeros((F, 3, 3), np.float32)
    Kt = np.zeros((F, 3), np.float32)
    Th = _rel(scene["poses"], 0, 2)
    KRKi[0] = Km @ Th[:3, :3] @ np.linalg.inv(Km)
    Kt[0] = Km @ Th[:3, 3]
    aff = np.tile(np.array([1.0, 0.0], np.float32), (F, 1))
    n = p["u"].shape[0]
    args = (p["u"], p["v"], p["idmin"], p["idmax"], p["status"],
            np.full(n, 10000.0, np.float32), p["color"], p["weights"],
            p["gradH"], np.full(n, 8 * 144.0, np.float32),
            np.zeros(n, np.int32), KRKi, Kt, aff)
    d2 = scene["dI"][2][0][0]
    jo = jt.trace_points(*[jnp.asarray(a) for a in args], jnp.asarray(d2),
                         np.float32(0.027), np.float32(6.0), w=W, h=H)
    to = tt.trace_points(*[T(a, torch.int64 if a.dtype == np.int32
                             else None) for a in args], T(d2), 0.027, 6.0,
                         w=W, h=H)
    st_j, st_t = N(jo["status"]), to["status"].numpy()
    # a status can flip where an energy sits at a threshold to an ulp:
    # >= 99% agree; the rest are counted
    agree = st_j == st_t
    assert agree.mean() >= 0.99, agree.mean()
    good = agree & (st_j == jt.IPS_GOOD)
    assert good.sum() > 50
    # the 3-step subpixel GN keeps or halves a step on an energy
    # comparison: >= 98% of the intervals agree to 1e-4 relative, all
    # to 1e-2 (1e-5 absolute near zero)
    for k in ("idepth_min", "idepth_max", "pixel_interval"):
        a, b = to[k].numpy()[good], N(jo[k])[good]
        assert np.isclose(a, b, rtol=1e-4, atol=1e-6).mean() >= 0.98, k
        np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-5, err_msg=k)


def test_activate_points_matches(scene):
    p = _immature_pool(scene, n=400, seed=1)
    F = 4
    poses = scene["poses"]
    R = np.tile(np.eye(3, dtype=np.float32), (F * F, 1, 1))
    t = np.zeros((F * F, 3), np.float32)
    aff = np.tile(np.array([1.0, 0.0], np.float32), (F * F, 1))
    for a in range(3):
        for b in range(3):
            Tab = _rel(poses, a, b)
            R[a * F + b] = Tab[:3, :3]
            t[a * F + b] = Tab[:3, 3]
    stack = np.stack([scene["dI"][i][0][0] for i in range(F)])
    fvalid = np.array([True, True, True, False])
    n = p["u"].shape[0]
    rng = np.random.default_rng(2)
    idinit = (p["idgt"] * rng.uniform(0.95, 1.05, n)).astype(np.float32)
    is_sensor = rng.random(n) < 0.3
    args = (p["u"], p["v"], idinit, p["color"], p["weights"],
            np.zeros(n, np.int32), is_sensor, np.ones(n, bool), fvalid, R,
            t, aff, stack, scene["K0"], np.full(n, 8 * 144.0, np.float32))
    jo = jt.activate_points(*[jnp.asarray(a) for a in args], w=W, h=H,
                            n_frames=F)
    to = tt.activate_points(*[T(a, torch.int64 if a.dtype == np.int32
                                else None) for a in args], w=W, h=H,
                            n_frames=F)
    sj, st = N(jo["success"]), to["success"].numpy()
    assert (sj == st).mean() >= 0.99            # threshold flips only
    both = sj & st
    assert both.sum() > 50
    # 3-step depth LM in float32: <= 1e-4 relative
    np.testing.assert_allclose(to["idepth"].numpy()[both],
                               N(jo["idepth"])[both], rtol=1e-4)
    np.testing.assert_array_equal(to["inlier_targets"].numpy()[both],
                                  N(jo["inlier_targets"])[both])


def test_distance_map_matches(scene):
    rng = np.random.default_rng(3)
    w1, h1 = W // 2, H // 2
    n = 500
    u = rng.integers(-3, w1 + 3, n)
    v = rng.integers(-3, h1 + 3, n)
    valid = rng.random(n) < 0.8
    a = N(jd.distance_map(jnp.asarray(u), jnp.asarray(v),
                          jnp.asarray(valid), w1, h1))
    b = td.distance_map(T(u), T(v), T(valid), w1, h1).numpy()
    np.testing.assert_array_equal(b, a)                     # exact
    d0 = scene["dI"][0][0][0]
    uu = rng.uniform(0, W, 300).astype(np.float32)
    vv = rng.uniform(0, H, 300).astype(np.float32)
    np.testing.assert_allclose(      # cancellation: <= 1e-3 relative
        td.shi_tomasi(T(d0), T(uu), T(vv)).numpy(),
        N(jd.shi_tomasi(jnp.asarray(d0), jnp.asarray(uu), jnp.asarray(vv))),
        rtol=1e-3, atol=1e-2)


def _pool_points(scene, n=1500, seed=4):
    """Map points hosted in frame 0 (slot 0) at ground-truth depth."""
    rng = np.random.default_rng(seed)
    d0 = scene["dI"][0][0][0]
    u = rng.uniform(12, W - 12, n).astype(np.float32)
    v = rng.uniform(12, H - 12, n).astype(np.float32)
    z = scene["depth0"][v.astype(int), u.astype(int)]
    g = np.hypot(d0[v.astype(int), u.astype(int), 1],
                 d0[v.astype(int), u.astype(int), 2]).astype(np.float32)
    return dict(u=u, v=v, idepth=(1.0 / z).astype(np.float32),
                host=np.zeros(n, np.int32),
                type=(rng.random(n) < 0.2).astype(np.int32),
                valid=np.isfinite(z) & (z > 0), quality=g,
                is_sensor=rng.random(n) < 0.5)


@pytest.mark.parametrize("per_cell,closest_view", [(True, True),
                                                   (False, False)])
def test_reproject_and_match_matches(scene, per_cell, closest_view):
    pts = _pool_points(scene)
    poses = scene["poses"].astype(np.float32)
    F = 4
    T_wc_stack = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    T_wc_stack[0], T_wc_stack[1] = poses[0], poses[1]
    aff = np.zeros((F, 2), np.float32)
    expo = np.ones(F, np.float32)
    stack = np.stack([scene["dI"][i][0][0] for i in range(F)])
    jflat = j_flatten(tuple(jnp.asarray(x) for x in scene["dI"][3][0]))
    tflat = t_flatten(tuple(T(x) for x in scene["dI"][3][0]))
    fvalid = np.array([True, True, False, False])
    common = (pts["u"], pts["v"], pts["idepth"], pts["host"], pts["type"],
              pts["valid"], pts["quality"], pts["is_sensor"], T_wc_stack,
              aff, expo, stack)
    kw = dict(w=W, h=H, max_level=len(scene["dI"][3][0]) - 1,
              per_cell=per_cell, closest_view=closest_view,
              lane_cap_frac=1.0)
    jo = jm.reproject_and_match(
        *[jnp.asarray(a) for a in common], *jflat, jnp.asarray(poses[3]),
        jnp.zeros(2, jnp.float32), jnp.float32(1.0),
        jnp.asarray(scene["K0"]), jnp.asarray(pts["host"]),
        frame_valid=jnp.asarray(fvalid), **kw)
    to = tm.reproject_and_match(
        *[T(a, torch.int64 if a.dtype == np.int32 else None)
          for a in common], *tflat, T(poses[3]), torch.zeros(2),
        torch.tensor(1.0), T(scene["K0"]), T(pts["host"], torch.int64),
        frame_valid=T(fvalid), **kw)
    mj, mt = N(jo["matched"]), to["matched"].numpy()
    assert mj.sum() > 20
    # the inverse-compositional align stops at |step| < 0.03 px: a lane at
    # that threshold can converge on one side only (>= 97% agree)
    assert (mj == mt).mean() >= 0.97, ((mj == mt).mean(), mj.sum(), mt.sum())
    both = mj & mt
    np.testing.assert_allclose(to["px"].numpy()[both], N(jo["px"])[both],
                               atol=0.05)              # pixels
    np.testing.assert_array_equal(to["diag"].numpy()[:2], N(jo["diag"])[:2])


def test_struct_pose_estimate_matches(scene):
    rng = np.random.default_rng(6)
    pts = _pool_points(scene, n=800)
    K0 = scene["K0"]
    poses = scene["poses"]
    xn = (pts["u"] - K0[2]) / K0[0]
    yn = (pts["v"] - K0[3]) / K0[1]
    pc = np.stack([xn, yn, np.ones_like(xn)], -1) / pts["idepth"][:, None]
    pw = (pc @ poses[0][:3, :3].T + poses[0][:3, 3]).astype(np.float32)
    Tcw = np.linalg.inv(poses[2])
    pf = pw @ Tcw[:3, :3].T + Tcw[:3, 3]
    obs = np.stack([K0[0] * pf[:, 0] / pf[:, 2] + K0[2],
                    K0[1] * pf[:, 1] / pf[:, 2] + K0[3]], -1)
    obs = (obs + rng.normal(0, 0.3, obs.shape)).astype(np.float32)
    obs[:40] += rng.uniform(-15, 15, (40, 2)).astype(np.float32)  # outliers
    T0 = poses[2].copy()
    T0[:3, 3] += [0.05, -0.02, 0.08]
    T0 = T0.astype(np.float32)
    valid = pts["valid"]
    for mad in (True, False):
        jo = jsp.struct_pose_estimate(jnp.asarray(T0), jnp.asarray(pw),
                                      jnp.asarray(obs), jnp.asarray(valid),
                                      jnp.asarray(K0), W, H,
                                      standardize=mad)
        to = tsp.struct_pose_estimate(T(T0), T(pw), T(obs), T(valid),
                                      T(K0), W, H, standardize=mad)
        Tj = N(jo["T_cur_to_world"]).astype(np.float64)
        Tt = to["T_cur_to_world"].double().numpy()
        # float32 LM: <= 1 mm and 1e-4 rad apart
        assert np.linalg.norm(Tj[:3, 3] - Tt[:3, 3]) < 1e-3
        dR = Tj[:3, :3].T @ Tt[:3, :3]
        assert np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)) < 1e-4
        assert int(to["n_inliers"]) == int(jo["n_inliers"])
