"""SE(3) / SO(3) Lie-group operations in torch.

Counterpart of `sdv_loam_tpu/utils/se3.py`. Transforms are (..., 4, 4)
homogeneous matrices; tangent vectors follow the Sophus convention
``xi = [upsilon(3), omega(3)]`` (translation first). All functions broadcast
over leading batch dimensions and keep the input's dtype and device. The
small-angle branches use the same Taylor expansions as the reference,
selected with `torch.where`.

The NumPy twins (`se3_exp_np`, `se3_log_np`) are the host-side control math
and are copied unchanged.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_EPS = 1e-8


def hat(w):
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def _taylor_coeffs(theta2):
    """(A, B, C) of Rodrigues: R = I + A W + B W^2, V = I + B W + C W^2."""
    theta = torch.sqrt(torch.clamp(theta2, min=1e-30))
    small = theta2 < _EPS
    t2c = torch.clamp(theta2, min=1e-30)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / t2c)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / t2c)
    return a, b, c


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def so3_log(R):
    """(..., 3, 3) rotation matrix -> (..., 3) rotation vector."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1) * 0.5
    sin_t = torch.sin(theta)
    small = theta < 1e-5
    scale = torch.where(small, 1.0 + theta * theta / 6.0,
                        theta / torch.clamp(sin_t, min=1e-30))
    w_generic = v * scale[..., None]
    near_pi = theta > math.pi - 1e-3
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, min=0.0))
    one = torch.ones_like(theta)
    sx = torch.where(R[..., 2, 1] - R[..., 1, 2] >= 0, one, -one)
    sy = torch.where(R[..., 0, 2] - R[..., 2, 0] >= 0, one, -one)
    sz = torch.where(R[..., 1, 0] - R[..., 0, 1] >= 0, one, -one)
    axis = axis * torch.stack([sx, sy, sz], dim=-1)
    return torch.where(near_pi[..., None], axis * theta[..., None], w_generic)


def se3_exp(xi):
    """(..., 6) twist [upsilon, omega] -> (..., 4, 4) transform."""
    v, w = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)
    a, b, c = _taylor_coeffs(theta2)
    W = hat(w)
    W2 = W @ W
    eye = _eye3(xi)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    t = torch.einsum("...ij,...j->...i", V, v)
    return from_rt(R, t)


def se3_log(T):
    """(..., 4, 4) transform -> (..., 6) twist [upsilon, omega]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta2 = torch.sum(w * w, dim=-1)
    a, b, _ = _taylor_coeffs(theta2)
    W = hat(w)
    coef_reg = (1.0 - a / torch.clamp(2.0 * b, min=1e-30)) / \
        torch.clamp(theta2, min=1e-30)
    coef = torch.where(theta2 < _EPS, 1.0 / 12.0 + theta2 / 720.0, coef_reg)
    Vinv = _eye3(T) - 0.5 * W + coef[..., None, None] * (W @ W)
    v = torch.einsum("...ij,...j->...i", Vinv, t)
    return torch.cat([v, w], dim=-1)


def from_rt(R, t):
    """Build (..., 4, 4) from rotation (..., 3, 3) and translation (..., 3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3].fill_(1.0)        # no host scalar tensor
    return torch.cat([top, bottom], dim=-2)


def inverse(T):
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return from_rt(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def apply(T, pts):
    """Transform points: (..., 4, 4) x (..., N, 3) -> (..., N, 3)."""
    return torch.einsum("...ij,...nj->...ni", T[..., :3, :3], pts) + \
        T[..., None, :3, 3]


def adjoint(T):
    """(..., 4, 4) -> (..., 6, 6) adjoint for xi = [v, w] ordering:
    Ad(T) = [[R, hat(t) R], [0, R]]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    tR = hat(t) @ R
    top = torch.cat([R, tR], dim=-1)
    bottom = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


# ---------------------------------------------------------------------------
# NumPy twins for host-side control math (copied from the JAX package)
# ---------------------------------------------------------------------------

def se3_exp_np(xi):
    """NumPy (..., 6) twist -> (..., 4, 4); same math as se3_exp."""
    xi = np.asarray(xi, dtype=np.float64)
    v, w = xi[..., :3], xi[..., 3:]
    theta2 = np.sum(w * w, axis=-1)
    theta = np.sqrt(np.maximum(theta2, 1e-30))
    small = theta2 < _EPS
    with np.errstate(invalid="ignore", divide="ignore"):
        a = np.where(small, 1.0 - theta2 / 6.0, np.sin(theta) / theta)
        b = np.where(small, 0.5 - theta2 / 24.0,
                     (1.0 - np.cos(theta)) / np.maximum(theta2, 1e-30))
        c = np.where(small, 1.0 / 6.0 - theta2 / 120.0,
                     (1.0 - a) / np.maximum(theta2, 1e-30))
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = np.zeros_like(wx)
    W = np.stack([np.stack([z, -wz, wy], -1), np.stack([wz, z, -wx], -1),
                  np.stack([-wy, wx, z], -1)], -2)
    W2 = W @ W
    eye = np.eye(3)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    t = np.einsum("...ij,...j->...i", V, v)
    out = np.zeros(xi.shape[:-1] + (4, 4))
    out[..., :3, :3] = R
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out


def se3_log_np(T):
    """NumPy (..., 4, 4) -> (..., 6); same math as se3_log (generic branch)."""
    T = np.asarray(T, dtype=np.float64)
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = np.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(cos_t)
    vee = 0.5 * np.stack([R[..., 2, 1] - R[..., 1, 2],
                          R[..., 0, 2] - R[..., 2, 0],
                          R[..., 1, 0] - R[..., 0, 1]], -1)
    sin_t = np.sin(theta)
    small = theta < 1e-5
    with np.errstate(invalid="ignore", divide="ignore"):
        scale = np.where(small, 1.0 + theta * theta / 6.0,
                         theta / np.maximum(sin_t, 1e-30))
    w = vee * scale[..., None]
    theta2 = np.sum(w * w, axis=-1)
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = np.zeros_like(wx)
    W = np.stack([np.stack([z, -wz, wy], -1), np.stack([wz, z, -wx], -1),
                  np.stack([-wy, wx, z], -1)], -2)
    W2 = W @ W
    with np.errstate(invalid="ignore", divide="ignore"):
        theta_s = np.sqrt(np.maximum(theta2, 1e-30))
        a = np.where(theta2 < _EPS, 1.0 - theta2 / 6.0,
                     np.sin(theta_s) / theta_s)
        b = np.where(theta2 < _EPS, 0.5 - theta2 / 24.0,
                     (1.0 - np.cos(theta_s)) / np.maximum(theta2, 1e-30))
        coef = np.where(theta2 < _EPS, 1.0 / 12.0 + theta2 / 720.0,
                        (1.0 - a / np.maximum(2.0 * b, 1e-30))
                        / np.maximum(theta2, 1e-30))
    Vinv = np.eye(3) - 0.5 * W + coef[..., None, None] * W2
    v = np.einsum("...ij,...j->...i", Vinv, t)
    return np.concatenate([v, w], axis=-1)
