"""Struct (reprojection) pose refinement — stage 2 of frame tracking.

Counterpart of `sdv_loam_tpu/ops/struct_pose.py` (reference:
CoarseTracker::structPoseEstimation, CoarseTracker.cpp:949-1007): a 6-DoF
LM on normalized-image-plane reprojection residuals of the matched map
points with Tukey bi-square weights (b = 4.6851), optionally on
MAD-standardized residuals.
"""

from __future__ import annotations

import torch

from sdv_loam_tpu_torch.utils import device_loop, se3

TUKEY_B = 4.6851
LAMBDA_EXTRAPOLATION_LIMIT = 0.001


def _tukey(x):
    b2 = TUKEY_B * TUKEY_B
    x2 = x * x
    t = 1.0 - x2 / b2
    return torch.where(x2 <= b2, t * t, torch.zeros_like(t))


def _residuals(T_wc_inv, pts_world, obs_uv, valid, K, w, h):
    """Normalized-plane residuals, in-front/in-image mask, cam points (one
    row of each per lane: T (L, 4, 4), points (L, N, 3), K (L, 4))."""
    fx, fy, cx, cy = (K[:, i:i + 1] for i in range(4))
    pf = torch.matmul(pts_world, T_wc_inv[:, :3, :3].transpose(1, 2)) + \
        T_wc_inv[:, None, :3, 3]
    z = pf[..., 2]
    u = pf[..., 0] / z
    v = pf[..., 1] / z
    Ku = u * fx + cx
    Kv = v * fy + cy
    ok = valid & (Ku > 1.1) & (Kv > 1.1) & (Ku < w - 3) & (Kv < h - 3) & \
        (z > 0)
    obs_n = torch.stack([(obs_uv[..., 0] - cx) / fx,
                         (obs_uv[..., 1] - cy) / fy], dim=-1)
    res_n = torch.stack([u, v], dim=-1) - obs_n
    return res_n, ok, pf


def nanmedian_mid(x):
    """Median of the finite entries along the last dimension, averaging the
    two middle values for an even count (`jnp.nanmedian`); NaN when empty."""
    s = torch.sort(torch.where(torch.isnan(x), torch.full_like(x, float("inf")),
                               x), dim=-1)[0]
    n = (~torch.isnan(x)).sum(-1)
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, min=0)
    med = 0.5 * (s.gather(-1, lo[..., None])[..., 0]
                 + s.gather(-1, hi[..., None])[..., 0])
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def _mad_sigma(x, ok):
    """Robust scale 1.4826 * MAD of masked residual norms, per row."""
    nan = torch.full_like(x, float("nan"))
    med = nanmedian_mid(torch.where(ok, x, nan))
    mad = nanmedian_mid(torch.where(ok, torch.abs(x - med[..., None]), nan))
    return 1.4826 * mad


def _build_system(res_n, ok, pf, standardize: bool):
    """Tukey-weighted 6x6 normal equations per lane (calcHandb:889-947);
    with `standardize` the MAD scale is recomputed from the current
    residuals."""
    x, y, z = pf[..., 0], pf[..., 1], pf[..., 2]
    iz = 1.0 / torch.where(z == 0, torch.ones_like(z), z)
    iz2 = iz * iz
    zero = torch.zeros_like(iz)
    one = torch.ones_like(iz)
    Jx = torch.stack([iz, zero, -x * iz2, -x * y * iz2, one + x * x * iz2,
                      -y * iz], dim=-1)
    Jy = torch.stack([zero, iz, -y * iz2, -(one + y * y * iz2), x * y * iz2,
                      x * iz], dim=-1)
    rn = torch.linalg.vector_norm(res_n, dim=-1)
    if standardize:
        sigma = torch.clamp(_mad_sigma(rn, ok), min=1e-5)[:, None]
    else:
        sigma = torch.ones((), dtype=rn.dtype, device=rn.device)
    wgt = torch.where(ok, _tukey(rn / sigma), zero)
    L = res_n.shape[0]
    J = torch.stack([Jx, Jy], dim=2).reshape(L, -1, 6)     # (L, N*2, 6)
    Jw = J * wgt[..., None].expand(-1, -1, 2).reshape(L, -1)[..., None]
    # H and b from ONE batched product: a matrix-vector product of a
    # single lane takes another kernel than a batch's, and a lane's sums
    # must not depend on the lane count
    Hb = Jw.transpose(1, 2) @ torch.cat([J, res_n.reshape(L, -1, 1)], -1)
    return Hb[..., :6], Hb[..., 6]


def struct_pose_estimate(T_cur_to_world, pts_world, obs_uv, valid, K, w, h,
                         max_iters: int = 10, standardize: bool = False):
    """LM refinement of the current camToWorld against matched map points.
    Returns dict(T_cur_to_world, energy, n_inliers).

    Lanes: T_cur_to_world (L, 4, 4), pts_world (L, N, 3), obs_uv (L, N, 2),
    valid (L, N) and K (L, 4) refine L poses at once, each lane with its own
    damping and its own stop test (a lane that has stopped no longer
    changes, as under the JAX package's vmap); outputs then carry a leading
    L. One lane's unbatched inputs run as lane 0. The LM runs through
    `device_loop.run` (graph replays on CUDA)."""
    single = T_cur_to_world.dim() == 2
    if single:
        T_cur_to_world, pts_world, obs_uv, valid, K = (
            a[None] for a in (T_cur_to_world, pts_world, obs_uv, valid, K))
    T_wc = se3.inverse(T_cur_to_world)
    L = T_wc.shape[0]
    dev = T_wc.device
    if standardize:
        rn0, ok0, _ = _residuals(T_wc, pts_world, obs_uv, valid, K, w, h)
        sigma0 = torch.clamp(_mad_sigma(torch.linalg.vector_norm(rn0, dim=-1),
                                        ok0), min=1e-5)[:, None]
    else:
        sigma0 = torch.ones((), dtype=torch.float32, device=dev)
    x = dict(pts_world=pts_world, obs_uv=obs_uv, valid=valid, K=K,
             sigma0=sigma0)
    static = dict(w=int(w), h=int(h), standardize=bool(standardize))
    e_old, _ = _energy(x, T_wc, w, h)
    st = dict(T_wc=T_wc, e_old=e_old,
              lam=torch.full((L,), 0.01, dtype=torch.float32, device=dev),
              done=torch.zeros(L, dtype=torch.bool, device=dev))
    st = device_loop.run("struct", _lm_body, x, st, max_iters, static)
    T_wc, e_old = st["T_wc"], st["e_old"]
    _, n = _energy(x, T_wc, w, h)
    out = dict(T_cur_to_world=se3.inverse(T_wc), energy=e_old, n_inliers=n)
    return {k: v[0] for k, v in out.items()} if single else out


def _rho(x):
    b2_6 = TUKEY_B * TUKEY_B / 6.0
    t = 1.0 - torch.square(x / TUKEY_B)
    return torch.where(torch.abs(x) <= TUKEY_B, b2_6 * (1.0 - t * t * t),
                       torch.full_like(t, b2_6))


def _energy(x, Twc, w, h):
    res_n, ok, _ = _residuals(Twc, x["pts_world"], x["obs_uv"], x["valid"],
                              x["K"], w, h)
    rn = torch.linalg.vector_norm(res_n, dim=-1)
    pe = torch.where(ok, _rho(rn / x["sigma0"]), torch.zeros_like(rn))
    n = ok.sum(-1)
    return pe.sum(-1) / torch.clamp(n, min=1), n


def _lm_body(x, st, w, h, standardize):
    """One LM iteration of every lane; lanes that have stopped keep their
    carries."""
    T_wc, e_old, lam, done = st["T_wc"], st["e_old"], st["lam"], st["done"]
    act = ~done
    res_n, ok, pf = _residuals(T_wc, x["pts_world"], x["obs_uv"], x["valid"],
                               x["K"], w, h)
    H, b = _build_system(res_n, ok, pf, standardize)
    eye = torch.eye(6, dtype=torch.float32, device=H.device)
    Hl = H + torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1)) \
        * lam[:, None, None] + eye * 1e-12
    inc = torch.linalg.solve_ex(Hl, -b)[0]
    extrap = torch.where(
        lam < LAMBDA_EXTRAPOLATION_LIMIT,
        torch.sqrt(torch.sqrt(LAMBDA_EXTRAPOLATION_LIMIT
                              / torch.clamp(lam, min=1e-12))),
        torch.ones_like(lam))
    inc = inc * extrap[:, None]
    inc = torch.where(torch.isfinite(inc), inc, torch.zeros_like(inc))
    Twc_new = se3.se3_exp(inc) @ T_wc
    e_new, n_new = _energy(x, Twc_new, w, h)
    e_new = torch.where(n_new == 0, torch.full_like(e_new, 1e6), e_new)
    accept = e_new < e_old
    acc = accept & act
    T_wc = torch.where(acc[:, None, None], Twc_new, T_wc)
    e_old = torch.where(acc, e_new, e_old)
    lam = torch.where(act, torch.where(
        accept, lam * 0.5,
        torch.clamp(lam * 4.0, min=LAMBDA_EXTRAPOLATION_LIMIT)), lam)
    done = done | (act & ~(torch.linalg.vector_norm(inc, dim=-1) > 1e-5))
    return dict(T_wc=T_wc, e_old=e_old, lam=lam, done=done), (~done).any()
