"""Struct (reprojection) pose refinement — stage 2 of frame tracking.

Counterpart of `sdv_loam_tpu/ops/struct_pose.py` (reference:
CoarseTracker::structPoseEstimation, CoarseTracker.cpp:949-1007): a 6-DoF
LM on normalized-image-plane reprojection residuals of the matched map
points with Tukey bi-square weights (b = 4.6851), optionally on
MAD-standardized residuals.
"""

from __future__ import annotations

import torch

from sdv_loam_tpu_torch.utils import se3

TUKEY_B = 4.6851
LAMBDA_EXTRAPOLATION_LIMIT = 0.001


def _tukey(x):
    b2 = TUKEY_B * TUKEY_B
    x2 = x * x
    t = 1.0 - x2 / b2
    return torch.where(x2 <= b2, t * t, torch.zeros_like(t))


def _residuals(T_wc_inv, pts_world, obs_uv, valid, K, w, h):
    """Normalized-plane residuals, in-front/in-image mask, cam points."""
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    pf = pts_world @ T_wc_inv[:3, :3].T + T_wc_inv[:3, 3]
    z = pf[:, 2]
    u = pf[:, 0] / z
    v = pf[:, 1] / z
    Ku = u * fx + cx
    Kv = v * fy + cy
    ok = valid & (Ku > 1.1) & (Kv > 1.1) & (Ku < w - 3) & (Kv < h - 3) & \
        (z > 0)
    obs_n = torch.stack([(obs_uv[:, 0] - cx) / fx, (obs_uv[:, 1] - cy) / fy],
                        dim=-1)
    res_n = torch.stack([u, v], dim=-1) - obs_n
    return res_n, ok, pf


def nanmedian_mid(x):
    """Median of the finite entries of a 1-D tensor, averaging the two
    middle values for an even count (`jnp.nanmedian`); NaN when empty."""
    s = torch.sort(torch.where(torch.isnan(x), torch.full_like(x, float("inf")),
                               x))[0]
    n = (~torch.isnan(x)).sum()
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, min=0)
    med = 0.5 * (s[lo] + s[hi])
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def _mad_sigma(x, ok):
    """Robust scale 1.4826 * MAD of masked residual norms."""
    nan = torch.full_like(x, float("nan"))
    med = nanmedian_mid(torch.where(ok, x, nan))
    mad = nanmedian_mid(torch.where(ok, torch.abs(x - med), nan))
    return 1.4826 * mad


def _build_system(res_n, ok, pf, standardize: bool):
    """Tukey-weighted 6x6 normal equations (calcHandb:889-947); with
    `standardize` the MAD scale is recomputed from the current residuals."""
    x, y, z = pf[:, 0], pf[:, 1], pf[:, 2]
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
        sigma = torch.clamp(_mad_sigma(rn, ok), min=1e-5)
    else:
        sigma = torch.ones((), dtype=rn.dtype, device=rn.device)
    wgt = torch.where(ok, _tukey(rn / sigma), zero)
    J = torch.stack([Jx, Jy], dim=1)                       # (N, 2, 6)
    H = torch.einsum("nai,n,naj->ij", J, wgt, J)
    b = torch.einsum("nai,n,na->i", J, wgt, res_n)
    return H, b


def struct_pose_estimate(T_cur_to_world, pts_world, obs_uv, valid, K, w, h,
                         max_iters: int = 10, standardize: bool = False):
    """LM refinement of the current camToWorld against matched map points.
    Returns dict(T_cur_to_world, energy, n_inliers)."""
    T_wc = se3.inverse(T_cur_to_world)
    dev = T_wc.device
    if standardize:
        rn0, ok0, _ = _residuals(T_wc, pts_world, obs_uv, valid, K, w, h)
        sigma0 = torch.clamp(_mad_sigma(torch.linalg.vector_norm(rn0, dim=-1),
                                        ok0), min=1e-5)
    else:
        sigma0 = torch.ones((), dtype=torch.float32, device=dev)
    b2_6 = TUKEY_B * TUKEY_B / 6.0

    def _rho(x):
        t = 1.0 - torch.square(x / TUKEY_B)
        return torch.where(torch.abs(x) <= TUKEY_B, b2_6 * (1.0 - t * t * t),
                           torch.full_like(t, b2_6))

    def energy(Twc):
        res_n, ok, _ = _residuals(Twc, pts_world, obs_uv, valid, K, w, h)
        rn = torch.linalg.vector_norm(res_n, dim=-1)
        pe = torch.where(ok, _rho(rn / sigma0), torch.zeros_like(rn))
        n = ok.sum()
        return pe.sum() / torch.clamp(n, min=1), n

    e_old, _ = energy(T_wc)
    lam = torch.full((), 0.01, dtype=torch.float32, device=dev)
    eye = torch.eye(6, dtype=torch.float32, device=dev)
    for _ in range(max_iters):
        res_n, ok, pf = _residuals(T_wc, pts_world, obs_uv, valid, K, w, h)
        H, b = _build_system(res_n, ok, pf, standardize)
        Hl = H + torch.diag(torch.diagonal(H)) * lam + eye * 1e-12
        inc = torch.linalg.solve_ex(Hl, -b)[0]
        extrap = torch.where(
            lam < LAMBDA_EXTRAPOLATION_LIMIT,
            torch.sqrt(torch.sqrt(LAMBDA_EXTRAPOLATION_LIMIT
                                  / torch.clamp(lam, min=1e-12))),
            torch.ones_like(lam))
        inc = inc * extrap
        inc = torch.where(torch.isfinite(inc), inc, torch.zeros_like(inc))
        Twc_new = se3.se3_exp(inc) @ T_wc
        e_new, n_new = energy(Twc_new)
        e_new = torch.where(n_new == 0, torch.full_like(e_new, 1e6), e_new)
        accept = e_new < e_old
        T_wc = torch.where(accept, Twc_new, T_wc)
        e_old = torch.where(accept, e_new, e_old)
        lam = torch.where(accept, lam * 0.5,
                          torch.clamp(lam * 4.0, min=LAMBDA_EXTRAPOLATION_LIMIT))
        if not bool(torch.linalg.vector_norm(inc) > 1e-5):
            break
    _, n = energy(T_wc)
    return dict(T_cur_to_world=se3.inverse(T_wc), energy=e_old, n_inliers=n)
