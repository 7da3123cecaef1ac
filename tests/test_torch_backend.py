"""Parity of the port's windowed-BA backend with the JAX package:
make_pairs, linearize_residuals (FEJ), build_system, solve_system (the
solveSystemF contract, 1e-3 relative), marginalize_points and
marginalize_frame, on a 3-frame window of the 320x96 synthetic scene.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdv_loam_tpu.data.synthetic import make_sequence
from sdv_loam_tpu.models import backend as jb
from sdv_loam_tpu.ops.pyramid import make_images as j_make_images
from sdv_loam_tpu.utils import se3 as jse3
from sdv_loam_tpu_torch.models import backend as tb

W, H, F = 320, 96, 4


def T(x):
    a = np.ascontiguousarray(np.asarray(x))
    t = torch.from_numpy(a)
    if a.dtype.kind == "f":
        t = t.to(torch.float32)
    if a.dtype == np.int32:
        t = t.to(torch.int64)
    return t


def J(x):
    a = np.asarray(x)
    return jnp.asarray(a.astype(np.float32) if a.dtype.kind == "f" else a)


@pytest.fixture(scope="module")
def window():
    rng = np.random.default_rng(0)
    seq = make_sequence(n_frames=3, w=W, h=H, step=0.8, yaw_rate=0.01,
                        lidar_stride=2)
    c = seq.calib
    K = np.array([c.fx[0], c.fy[0], c.cx[0], c.cy[0]], np.float32)
    stack = np.zeros((F, H, W, 3), np.float32)
    for i in range(3):
        d, _ = j_make_images(jnp.asarray(seq.get_image(i)), 1)
        stack[i] = np.asarray(d[0])
    T_cw_fej = np.tile(np.eye(4), (F, 1, 1))
    for i in range(3):
        T_cw_fej[i] = np.linalg.inv(seq.poses_wc[i])
    eps = np.zeros((F, 6), np.float32)
    eps[1:3] = rng.normal(0, 2e-3, (2, 6))
    n = 400
    host = rng.integers(0, 3, n).astype(np.int32)
    u = rng.uniform(12, W - 12, n).astype(np.float32)
    v = rng.uniform(12, H - 12, n).astype(np.float32)
    depth = [seq.get_depth(i) for i in range(3)]
    z = np.array([depth[hh][int(vv), int(uu)] for hh, uu, vv in
                  zip(host, u, v)])
    idepth = (1.0 / z * rng.uniform(0.97, 1.03, n)).astype(np.float32)
    res_active = np.zeros((n, F), bool)
    matcher_px = np.zeros((n, F, 2), np.float32)
    for i in range(n):
        Twc_h = seq.poses_wc[host[i]]
        p = np.array([(u[i] - K[2]) / K[0], (v[i] - K[3]) / K[1], 1.0]) \
            / idepth[i]
        pw = Twc_h[:3, :3] @ p + Twc_h[:3, 3]
        for t in range(3):
            if t == host[i]:
                continue
            pc = T_cw_fej[t][:3, :3] @ pw + T_cw_fej[t][:3, 3]
            matcher_px[i, t] = [K[0] * pc[0] / pc[2] + K[2],
                                K[1] * pc[1] / pc[2] + K[3]]
            res_active[i, t] = True
    matcher_px += rng.normal(0, 0.5, matcher_px.shape).astype(np.float32)
    color = rng.uniform(20, 200, (n, 8)).astype(np.float32)
    weights = rng.uniform(0.5, 1.0, (n, 8)).astype(np.float32)
    is_sensor = rng.random(n) < 0.4
    prior = np.where(is_sensor, 2500.0, 0.0).astype(np.float32)
    aff = np.zeros((F, 2), np.float32)
    expo = np.ones(F, np.float32)
    fvalid = np.array([True, True, True, False])
    return dict(K=K, stack=stack, T_cw_fej=T_cw_fej.astype(np.float32),
                eps=eps, u=u, v=v, idepth=idepth, host=host,
                res_active=res_active, res_state=np.zeros((n, F), np.int8),
                matcher_px=matcher_px, matcher_valid=res_active.copy(),
                color=color, weights=weights, is_sensor=is_sensor,
                prior=prior, aff=aff, expo=expo, fvalid=fvalid,
                feth=np.full(F, 12.0 * 12.0 * 8.0 * 4, np.float32))


def _pairs(w, lib, se3mod, conv):
    T_cw = se3mod.se3_exp(conv(w["eps"])) @ conv(w["T_cw_fej"])
    return lib.make_pairs(T_cw, conv(w["T_cw_fej"]), conv(w["aff"]),
                          conv(w["expo"]), conv(w["K"]))


def _both(w, resf_at_fej=True):
    from sdv_loam_tpu_torch.utils import se3 as tse3
    jp = _pairs(w, jb, jse3, J)
    tp = _pairs(w, tb, tse3, T)
    args = ("u", "v", "idepth", "host", "color", "weights", "res_active",
            "res_state", "matcher_px", "matcher_valid")
    jl = jb.linearize_residuals(*[J(w[a]) for a in args], jp, J(w["stack"]),
                                J(w["feth"]), J(w["K"]), w=W, h=H,
                                resf_at_fej=resf_at_fej)
    tl = tb.linearize_residuals(*[T(w[a]) for a in args], tp, T(w["stack"]),
                                T(w["feth"]), T(w["K"]), w=W, h=H,
                                resf_at_fej=resf_at_fej)
    return jp, tp, jl, tl


def test_make_pairs_matches(window):
    jp, tp, _, _ = _both(window)
    for k in ("R0", "t0", "Rc", "tc", "KRKi", "Kt", "adH", "aff_a",
              "aff_b"):
        # float32 4x4 compositions: <= 1e-5 relative / 1e-4 abs
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("resf_at_fej", [True, False])
def test_linearize_matches(window, resf_at_fej):
    _, _, jl, tl = _both(window, resf_at_fej)
    st_j = np.asarray(jl["new_state"])
    st_t = tl["new_state"].numpy()
    assert (st_j == st_t).mean() >= 0.995    # gate threshold flips only
    both_in = (st_j == 0) & (st_t == 0)
    assert both_in.sum() > 300
    for k in ("resF", "Jxi", "Jc", "Jd", "center"):
        a = tl[k].numpy()[both_in]
        b = np.asarray(jl[k])[both_in]
        # Jacobians of float32 projections: <= 1e-4 relative (scaled)
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max(), err_msg=k)
    np.testing.assert_allclose(tl["energy_phot"].numpy(),
                               np.asarray(jl["energy_phot"]), rtol=1e-3,
                               atol=1e-2)


def test_build_and_solve_system_match(window):
    w = window
    jp, tp, jl, _ = _both(w)
    # both systems get the JAX linearization: build/solve compared on
    # identical inputs
    lin_t = {k: T(np.asarray(v)) for k, v in jl.items()}
    fd = (w["eps"] * w["fvalid"][:, None]).astype(np.float32)
    cd = np.zeros(4, np.float32)
    jsys = jb.build_system(jl, J(w["host"]), J(w["is_sensor"]),
                           J(w["prior"]), jp, J(fd), J(cd), n_frames=F)
    tsys = tb.build_system(lin_t, T(w["host"]), T(w["is_sensor"]),
                           T(w["prior"]), tp, T(fd), T(cd), n_frames=F)
    for k in ("H_top", "b_top", "H_sc", "b_sc", "Hdd", "bd", "Vpt"):
        b = np.asarray(jsys[k])
        # float32 accumulations over ~1000 residuals: <= 1e-3 of the
        # block's scale
        np.testing.assert_allclose(tsys[k].numpy(), b, rtol=1e-3,
                                   atol=1e-4 * np.abs(b).max(), err_msg=k)

    D = 4 + 6 * F
    rng = np.random.default_rng(1)
    A = rng.normal(0, 1, (D, D))
    HM = (A @ A.T * 10.0).astype(np.float32)
    HM[:, 4 + 18:] = 0.0
    HM[4 + 18:, :] = 0.0
    bM = rng.normal(0, 1, D).astype(np.float32)
    bM[4 + 18:] = 0.0
    dstt = np.concatenate([cd, fd.reshape(-1)]).astype(np.float32)
    c_prior = np.full(4, 5e9 / 2500.0, np.float32)
    fprior = np.zeros((F, 6), np.float32)
    fprior[0] = [1e10] * 3 + [1e11] * 3
    Tf = w["T_cw_fej"]
    Nj = jb.make_nullspaces(J(Tf), J(w["fvalid"].astype(np.float32)))
    Nt = tb.make_nullspaces(T(Tf), T(w["fvalid"].astype(np.float32)))
    np.testing.assert_allclose(Nt.numpy(), np.asarray(Nj), rtol=1e-6,
                               atol=1e-6)
    for it, lam in ((0, 0.1), (3, 1e-3)):
        sj = jb.solve_system(jsys, J(HM), J(bM), J(dstt), J(c_prior), J(cd),
                             J(fprior), J(fd), J(w["fvalid"]), Nj,
                             jnp.float32(lam), J(w["host"]),
                             J(w["is_sensor"]), jp, n_frames=F,
                             orthogonalize_x=it >= 2)
        st = tb.solve_system(tsys, T(HM), T(bM), T(dstt), T(c_prior),
                             T(cd), T(fprior), T(fd), T(w["fvalid"]), Nt,
                             lam, T(w["host"]), T(w["is_sensor"]), tp,
                             n_frames=F, orthogonalize_x=it >= 2)
        # the solveSystemF contract: 1e-3 relative (of the step's scale)
        for k in ("x", "dframes", "dc", "didepth"):
            b = np.asarray(sj[k])
            np.testing.assert_allclose(st[k].numpy(), b, rtol=1e-3,
                                       atol=1e-3 * np.abs(b).max(),
                                       err_msg=k)


def test_marginalize_matches(window):
    w = window
    jp, tp, jl, _ = _both(w)
    lin_t = {k: T(np.asarray(v)) for k, v in jl.items()}
    n = w["u"].shape[0]
    marg = np.random.default_rng(2).random(n) < 0.3
    fd = (w["eps"] * w["fvalid"][:, None]).astype(np.float32)
    prior_m = (w["prior"] * 600.0 ** 2).astype(np.float32)
    jH, jbm = jb.marginalize_points(jl, J(w["host"]), J(w["is_sensor"]),
                                    J(prior_m), J(marg), J(fd),
                                    jnp.zeros(4, jnp.float32), jp,
                                    n_frames=F, marg_weight_fac=0.25)
    tH, tbm = tb.marginalize_points(lin_t, T(w["host"]), T(w["is_sensor"]),
                                    T(prior_m), T(marg), T(fd),
                                    torch.zeros(4), tp, n_frames=F,
                                    marg_weight_fac=0.25)
    jH = np.asarray(jH)
    # <= 1e-3 of the block's scale (float32 accumulation)
    np.testing.assert_allclose(tH.numpy(), jH, rtol=1e-3,
                               atol=1e-4 * np.abs(jH).max())
    fprior = np.array([1e10] * 3 + [1e11] * 3, np.float32)
    HMj, bMj = jb.marginalize_frame(J(jH), J(jbm), J(fprior),
                                    jnp.zeros(6, jnp.float32), 0, n_frames=F)
    HMt, bMt = tb.marginalize_frame(tH, tbm, T(fprior), torch.zeros(6), 0,
                                    n_frames=F)
    HMj = np.asarray(HMj)
    np.testing.assert_allclose(HMt.numpy(), HMj, rtol=1e-3,
                               atol=1e-3 * np.abs(HMj).max())
