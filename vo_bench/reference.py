"""Plain references for the benchmark's correctness check.

Plain PyTorch / NumPy, independent of the program under test (nothing
here imports the port): each function re-derives one kernel's outputs
from that kernel's inputs, in the arithmetic the port's kernels are
specified by (their plain versions, copied here at the time the benchmark
was defined), in float32 with TF32 off, as the configurations state.

* `dilate_pyramid` (K1): the tracking reference's hole-filling chain;
* `distance_transform` (K2): the keyframe's chamfer distance map;
* `track_res_gs` (K3): a residual evaluation of the tracking LM (energy,
  counts, the scaled 8x8 system, the flow indicators);
* `lm_step` and `lm_accept_step` (K4): the LM's damped step, and the
  accept test with the next step;
* `warp_align` (K5 with K6 as its prologue): the matcher's affine patch
  warp, then each candidate's Gauss-Newton alignment to its own stop;
* `ate_rmse`: each lane's trajectory against the rendered ground truth.

The sums and solves run in float64 (`acc`), where the kernels' own
specification rounds more; each point's arithmetic and each decision in
float32, as the specification takes them, every operation rounded on its
own in the order the specification writes it (no contraction). A decision
that float32 rounding in another order could tip (a residual within
rounding of K3's cutoff) is reported (`near`), so that the check can take
either side of it. The control computes the same
in float32 with TF32 matrix products (`precision(True)`, `acc` float32):
the nearest precision below float32 with TF32 off.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as tnf

STEP_SCALE = (1.0, 1.0, 1.0, 0.5, 0.5, 0.5, 10.0, 1000.0)
LAMBDA_EXTRAPOLATION_LIMIT = 0.001


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 products with TF32 on (the control) or off."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


# ---------------------------------------------------------------------------
# K1, K2
# ---------------------------------------------------------------------------

def _shift(x, dy, dx):
    h, w = x.shape[-2:]
    out = torch.zeros_like(x)
    out[..., max(0, -dy):min(h, h - dy), max(0, -dx):min(w, w - dx)] = \
        x[..., max(0, dy):min(h, h + dy), max(0, dx):min(w, w + dx)]
    return out


_DIAG = ((1, 1), (-1, -1), (1, -1), (-1, 1))
_CROSS = ((0, -1), (0, 1), (-1, 0), (1, 0))


def _dilate(idepth, weight, diagonal):
    """One hole-filling pass: an empty cell (weight <= 0) with filled
    neighbours takes their mean inverse depth and weight."""
    ssum = torch.zeros_like(idepth)
    nsum = torch.zeros_like(idepth)
    cnt = torch.zeros_like(idepth)
    zero = torch.zeros((), dtype=idepth.dtype, device=idepth.device)
    for dy, dx in (_DIAG if diagonal else _CROSS):
        si, sw = _shift(idepth, dy, dx), _shift(weight, dy, dx)
        filled = sw > 0
        ssum = ssum + torch.where(filled, si, zero)
        nsum = nsum + torch.where(filled, sw, zero)
        cnt = cnt + filled.to(idepth.dtype)
    ok = (weight <= 0) & (cnt > 0)
    den = torch.clamp(cnt, min=1.0)
    return (torch.where(ok, ssum / den, idepth),
            torch.where(ok, nsum / den, weight))


def _pool2(x):
    h, w = x.shape[-2:]
    x = x[..., : (h // 2) * 2, : (w // 2) * 2]
    return ((x[..., 0::2, 0::2] + x[..., 0::2, 1::2])
            + (x[..., 1::2, 0::2] + x[..., 1::2, 1::2]))


def dilate_pyramid(idepth0, weight0, levels):
    """K1: level 0 filled (diagonal pass), then per coarser level the 2x2
    sum-pool of the level above and its pass (diagonal on level 1, the
    cross below). A tuple over levels of (idepth, weight)."""
    out, idl, wl = [], idepth0, weight0
    for lvl in range(levels):
        if lvl:
            idl, wl = _pool2(idl), _pool2(wl)
        idl, wl = _dilate(idl, wl, lvl < 2)
        out.append((idl, wl))
    return tuple(out)


def distance_transform(seed, iters=32):
    """K2: `iters` sweeps of 8-neighbour min-plus (+1) relaxation, 1000
    outside the map."""
    h, w = seed.shape[-2:]
    d = seed
    for _ in range(iters):
        p = tnf.pad(d, (1, 1, 1, 1), value=1000.0)
        m = d
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    m = torch.minimum(m, p[..., 1 + dy:1 + dy + h,
                                           1 + dx:1 + dx + w] + 1.0)
        d = torch.minimum(d, m)
    return d


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

def pack_bilinear(img):
    """(L, H, W, C) or (H, W, C) -> (L*H*W, 4*C): each pixel's 2x2 support,
    corner-major, the last row and column replicated."""
    if img.dim() == 3:
        img = img[None]
    n, h, w, c = img.shape
    p = tnf.pad(img.permute(0, 3, 1, 2), (0, 1, 0, 1),
                mode="replicate").permute(0, 2, 3, 1)
    q = torch.stack([p[:, :h, :w], p[:, :h, 1:], p[:, 1:, :w],
                     p[:, 1:, 1:]], dim=3)
    return q.reshape(n * h * w, 4 * c)


def _bilinear(packed, h, w, x, y, base):
    """Each channel's sample ((q0 w0 + q1 w1) + q2 w2) + q3 w3 at (x, y),
    the weights (1 - ax)(1 - ay), ax (1 - ay), (1 - ax) ay, ax ay; the
    support inside the level; and each channel's sum of |q_k w_k|."""
    c = packed.shape[-1] // 4
    x0f, y0f = torch.floor(x), torch.floor(y)
    ax, ay = x - x0f, y - y0f
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    valid = (x0 >= 0) & (x0 <= w - 2) & (y0 >= 0) & (y0 <= h - 2)
    idx = base + torch.clamp(y0, 0, h - 2) * w + torch.clamp(x0, 0, w - 2)
    g = packed.index_select(0, idx.reshape(-1)).reshape(x.shape + (4, c))
    bx, by = 1 - ax, 1 - ay
    w4 = (bx * by, ax * by, bx * ay, ax * ay)
    out = g[..., 0, :] * w4[0][..., None]
    mag = out.abs()
    for k in range(1, 4):
        term = g[..., k, :] * w4[k][..., None]
        out = out + term
        mag = mag + term.abs()
    out = torch.where(valid[..., None], out, torch.zeros_like(out))
    return out, valid, mag


def _scale(like):
    return torch.tensor(STEP_SCALE, dtype=like.dtype, device=like.device)


def track_res_gs(pool, dI_new, K, T_ref_to_new, aff_rel, ref_aff_b, cutoff,
                 huber_th, packed=None, lane=None, hw=None, acc=torch.float64,
                 flip=None):
    """K3: for B pose rows, each against its lane's reference pool (u, v,
    idepth, color, valid) and image level (intensity, dx, dy): Huber
    energy, in-bound count, saturated share, the scaled 8x8 system H, b
    (J^T W J and J^T W r over the inliers, per inlier) and the flow
    indicators over every 32nd pool slot. Each point's projection, tests,
    residual, weight and Jacobian in float32, as the kernel's
    specification rounds them; the sums over the points in `acc`. Also
    `H_abs`, `b_abs`: the same sums of the terms' magnitudes, the scale
    against which a sum's rounding is judged; and `near` (B, N): the
    in-bound points whose |r| lies within float32 rounding of the cutoff
    (`NEAR_ULPS` rounding errors of r, propagated from the projection,
    the sample and the brightness transfer), whose side another order of
    the same float32 operations could change. `flip` (B, N), where given,
    moves the points it marks to the other side of the cutoff."""
    h, w = hw if hw is not None else (dI_new.shape[-3], dI_new.shape[-2])
    if packed is None:
        packed = pack_bilinear(dI_new)
    B = T_ref_to_new.shape[0]
    dev = T_ref_to_new.device
    if lane is None:
        pool = {k: pool[k][None] for k in ("u", "v", "idepth", "color",
                                           "valid")}
        K = K[None]
        lane = torch.zeros(B, dtype=torch.int64, device=dev)
    rows = {k: pool[k].index_select(0, lane)
            for k in ("u", "v", "idepth", "color", "valid")}
    Kb = K.index_select(0, lane)
    u0, v0 = rows["u"], rows["v"]
    idp, color, valid = rows["idepth"], rows["color"], rows["valid"]
    fx, fy, cx, cy = (Kb[:, i:i + 1] for i in range(4))
    cutoff = torch.as_tensor(cutoff, dtype=torch.float32,
                             device=dev).expand(B)[:, None]
    ref_aff_b = torch.as_tensor(ref_aff_b, dtype=torch.float32,
                                device=dev).expand(B)[:, None]
    xn = (u0 - cx) / fx
    yn = (v0 - cy) / fy
    T = T_ref_to_new
    # p = (xn, yn, 1): pr_k = (xn R_k0 + yn R_k1) + R_k2, pt_k = pr_k + t_k
    # idepth, each operation rounded on its own
    pr = [(xn * T[:, k, 0:1] + yn * T[:, k, 1:2]) + T[:, k, 2:3]
          for k in range(3)]
    ti = [T[:, k, 3:4] * idp for k in range(3)]
    pt = [pr[k] + ti[k] for k in range(3)]
    u = pt[0] / pt[2]
    v = pt[1] / pt[2]
    Ku = fx * u + cx
    Kv = fy * v + cy
    new_idepth = idp / pt[2]
    inb = valid & (Ku > 2) & (Kv > 2) & (Ku < w - 3) & (Kv < h - 3) \
        & (new_idepth > 0)
    hit, hit_ok, hit_mag = _bilinear(packed, h, w, Ku, Kv,
                                     lane[:, None] * (h * w))
    inb = inb & hit_ok & torch.isfinite(hit[..., 0])
    pred = aff_rel[:, 0:1] * color
    r = hit[..., 0] - (pred + aff_rel[:, 1:2])
    absr = torch.abs(r)
    one = torch.ones_like(absr)
    hwt = torch.where(absr < huber_th, one,
                      huber_th / torch.clamp(absr, min=1e-12))
    near = inb & ((absr - cutoff).abs() <= _r_rounding(
        xn, yn, idp, T, pt, u, v, Ku, Kv, fx, fy, hit, hit_mag, pred,
        aff_rel[:, 1:2], r))
    over = absr > cutoff
    if flip is not None:
        over = over ^ (flip & inb)
    saturated = inb & over
    inlier = inb & ~over
    zero = torch.zeros_like(absr)
    max_energy = 2.0 * huber_th * cutoff - huber_th * huber_th
    E = torch.where(inlier, hwt * r * r * (2.0 - hwt), zero).to(acc).sum(-1) \
        + torch.where(saturated, max_energy.expand_as(absr),
                      zero).to(acc).sum(-1)
    n_terms = inb.sum(-1)
    sat_frac = saturated.sum(-1) / torch.clamp(n_terms, min=1)
    dxf = hit[..., 1] * fx
    dyf = hit[..., 2] * fy
    J = torch.stack([
        new_idepth * dxf, new_idepth * dyf,
        -new_idepth * (u * dxf + v * dyf),
        -(u * v * dxf + (1.0 + v * v) * dyf),
        u * v * dyf + (1.0 + u * u) * dxf,
        u * dyf - v * dxf,
        aff_rel[:, 0:1] * (ref_aff_b - color),
        -torch.ones_like(u)], dim=-1)
    wgt = torch.where(inlier, hwt, zero)
    n_in = torch.clamp(inlier.sum(-1), min=1).to(acc)
    Jw = J * wgt[..., None]
    J, Jw, ra = J.to(acc), Jw.to(acc), r.to(acc)
    S = _scale(J)
    SS = S[:, None] * S[None, :]
    Hm = (J.transpose(1, 2) @ Jw) / n_in[:, None, None] * SS
    bv = (Jw.transpose(1, 2) @ ra[..., None])[..., 0] / n_in[:, None] * S
    H_abs = (J.abs().transpose(1, 2) @ Jw.abs()) / n_in[:, None, None] * SS
    b_abs = (Jw.abs().transpose(1, 2) @ ra.abs()[..., None])[..., 0] \
        / n_in[:, None] * S
    m = valid & (torch.arange(u0.shape[1], device=dev) % 32 == 0)

    def shift(q0, q1, q2):
        du = (fx * (q0 / q2) + cx) - u0
        dv = (fy * (q1 / q2) + cy) - v0
        return du * du + dv * dv

    p0 = (xn, yn, torch.ones_like(xn))
    num = m.sum(-1).to(acc) * 2.0
    zf = torch.zeros((), dtype=u.dtype, device=dev)
    ft = shift(*(p0[k] + ti[k] for k in range(3))) \
        + shift(*(p0[k] - ti[k] for k in range(3)))
    frt = shift(*pt) + shift(*(pr[k] - ti[k] for k in range(3)))
    flow_t = torch.where(m, ft, zf).to(acc).sum(-1) / (num + 0.1)
    flow_rt = torch.where(m, frt, zf).to(acc).sum(-1) / (num + 0.1)
    return dict(E=E, n=n_terms, sat_frac=sat_frac, H=Hm, b=bv,
                flow_t=flow_t, flow_rt=flow_rt, H_abs=H_abs, b_abs=b_abs,
                near=near)


# a float32 rounding error
EPS32 = 2.0 ** -24
# how many of r's first-order rounding errors a residual may lie from the
# cutoff and still count as near it
NEAR_ULPS = 8.0


def _r_rounding(xn, yn, idp, T, pt, u, v, Ku, Kv, fx, fy, hit, hit_mag,
                pred, aff_b, r):
    """A bound on how far float32 rounding in another order moves a
    point's residual r: each projected coordinate's terms' magnitudes
    (three roundings of pt_k), through the division and K onto the
    pixel, times the image's gradient there; the sample's four terms; the
    brightness transfer; all times `NEAR_ULPS`."""
    mag = [(xn * T[:, k, 0:1]).abs() + (yn * T[:, k, 1:2]).abs()
           + T[:, k, 2:3].abs() + (T[:, k, 3:4] * idp).abs()
           for k in range(3)]
    z = pt[2].abs()
    du = (3 * mag[0] + 3 * u.abs() * mag[2]) / z + u.abs()
    dv = (3 * mag[1] + 3 * v.abs() * mag[2]) / z + v.abs()
    dKu = fx.abs() * du + Ku.abs()
    dKv = fy.abs() * dv + Kv.abs()
    dr = (hit[..., 1].abs() * dKu + hit[..., 2].abs() * dKv
          + 4 * hit_mag[..., 0] + 2 * (pred.abs() + aff_b.abs()) + r.abs())
    return NEAR_ULPS * EPS32 * torch.nan_to_num(dr, nan=0.0, posinf=0.0)


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

def _hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def se3_exp(xi):
    """(..., 6) twist [upsilon, omega] -> (..., 4, 4)."""
    v, w = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-30))
    small = theta2 < 1e-8
    t2c = torch.clamp(theta2, min=1e-30)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / t2c)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / t2c)
    W = _hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    t = torch.einsum("...ij,...j->...i", V, v)
    out = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype,
                      device=xi.device)
    out[..., :3, :3] = R
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out


def _aff_transfer(exposure_ref, exposure_new, aff_ref, aff_new):
    zero = (exposure_ref == 0) | (exposure_new == 0)
    one = torch.ones_like(exposure_ref)
    er = torch.where(zero, one, exposure_ref)
    en = torch.where(zero, one, exposure_new)
    a = torch.exp(aff_new[..., 0] - aff_ref[..., 0]) * en / er
    return torch.stack([a, aff_new[..., 1] - a * aff_ref[..., 1]], dim=-1)


def lm_step(H, b, lam, T, aff, exposures, ref_aff, acc=torch.float64):
    """K4's step: the LM-damped solve of each row's scaled system
    (lambda on the diagonal, extrapolated below the limit), the pose and
    affine update, the new brightness transfer, all in `acc`. (T_new,
    aff_new, aff_rel, inc)."""
    H, b, lam, T, aff, exposures, ref_aff = (
        x.to(acc) for x in (H, b, lam, T, aff, exposures, ref_aff))
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    Hl = H + torch.diag_embed(diag) * lam[:, None, None] + eye * 1e-12
    inc = torch.linalg.solve_ex(Hl, -b)[0]
    extrap = torch.where(
        lam < LAMBDA_EXTRAPOLATION_LIMIT,
        torch.sqrt(torch.sqrt(LAMBDA_EXTRAPOLATION_LIMIT
                              / torch.clamp(lam, min=1e-12))),
        torch.ones_like(lam))
    inc = inc * extrap[:, None]
    inc = torch.where(torch.isfinite(inc), inc, torch.zeros_like(inc))
    sc = inc * _scale(inc)
    T_new = se3_exp(sc[:, :6]) @ T
    aff_new = aff + sc[:, 6:]
    aff_rel = _aff_transfer(exposures[..., 0], exposures[..., 1], ref_aff,
                            aff_new)
    return T_new, aff_new, aff_rel, inc


def _select(mask, new, old):
    if isinstance(new, dict):
        return {k: _select(mask, new[k], old[k]) for k in new}
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)),
                       new, old)


def lm_accept_step(r, r_new, T, T_new, aff, aff_new, lam, done, n_it, inc,
                   exposures, ref_aff, acc=torch.float64):
    """K4's fused entry: rows still running take the new state where its
    energy per term is lower; lambda halves on an accept and grows
    fourfold (at least to the limit) on a reject; a row is done once its
    step's norm is not above 1e-3 (these decisions in float32, as the
    kernel's specification takes them); then the next step from the
    selected carries, in `acc`."""
    act = ~done
    accept = (r_new["E"] / torch.clamp(r_new["n"], min=1)) < \
        (r["E"] / torch.clamp(r["n"], min=1))
    take = accept & act
    T = _select(take, T_new, T)
    aff = _select(take, aff_new, aff)
    lam_n = torch.where(accept, lam * 0.5,
                        torch.clamp(lam * 4.0, min=LAMBDA_EXTRAPOLATION_LIMIT))
    lam = torch.where(act, lam_n, lam)
    r = _select(take, r_new, r)
    done = done | (act & ~(torch.linalg.vector_norm(inc, dim=-1) > 1e-3))
    n_it = n_it + act.to(torch.int64)
    step = lm_step(r["H"], r["b"], lam, T, aff, exposures, ref_aff, acc)
    return dict(r=r, T=T, aff=aff, lam=lam, done=done, n_it=n_it,
                active=(~done).any(),
                **dict(zip(("T_new", "aff_new", "aff_rel", "inc"), step)))


# ---------------------------------------------------------------------------
# K5 with K6 as its prologue
# ---------------------------------------------------------------------------

HALF_PATCH = 4
PATCH = 8
BORDER_PATCH = PATCH + 2
MIN_UPDATE_SQ = 0.03 * 0.03
H_EPS = 1e-9


def quad_pack(img):
    """(H, W) -> (H*W, 4) rows [I(x, y), I(x+1, y), I(x, y+1),
    I(x+1, y+1)], the last row and column replicated."""
    h, w = img.shape
    p = tnf.pad(img[None, None], (0, 1, 0, 1), mode="replicate")[0, 0]
    return torch.stack([p[:h, :w], p[:h, 1:], p[1:, :w], p[1:, 1:]],
                       dim=-1).reshape(h * w, 4)


def _sample(quad, base, w, x, y):
    """The bilinear sample ((q0 w0 + q1 w1) + q2 w2) + q3 w3 of a quad
    pack at (x, y) (inside the level: the caller's), row base + floor(y)
    w + floor(x); a row outside the pack reads NaN."""
    x0, y0 = torch.floor(x), torch.floor(y)
    ax, ay = x - x0, y - y0
    idx = base + y0.to(torch.int64) * w + x0.to(torch.int64)
    ok = (idx >= 0) & (idx < quad.shape[0])
    q = quad.index_select(0, torch.where(ok, idx, torch.zeros_like(idx))
                          .reshape(-1)).reshape(x.shape + (4,))
    bx, by = 1 - ax, 1 - ay
    s = ((q[..., 0] * (bx * by) + q[..., 1] * (ax * by))
         + q[..., 2] * (bx * ay)) + q[..., 3] * (ax * ay)
    return torch.where(ok, s, torch.full_like(s, float("nan")))


def _inverse(A, acc):
    """inv(A) of float32 matrices, solved in `acc`, each entry rounded to
    float32 once and 0 where not finite."""
    inv = torch.linalg.inv_ex(A.to(acc))[0].to(torch.float32)
    return torch.where(torch.isfinite(inv), inv, torch.zeros_like(inv))


def warp_patches(dI_ref0_stack, host_idx, px_ref, A_cur_ref, level,
                 acc=torch.float64):
    """K6: each candidate's 10x10 border patch, warped from its host's
    level-0 intensities through inv(A_cur_ref) at 2^level pixels a
    patch pixel around px_ref; 0 where the source point leaves [0, w-1)
    x [0, h-1), sampled at the point clamped to [0, w - 1.001] x
    [0, h - 1.001]. (M, 10, 10)."""
    F, h, w = dI_ref0_stack.shape[:3]
    quad = torch.cat([quad_pack(im[..., 0].to(torch.float32))
                      for im in dI_ref0_stack], dim=0)
    Ainv = _inverse(A_cur_ref.to(torch.float32), acc)
    ar = torch.arange(BORDER_PATCH, device=px_ref.device)
    oy, ox = torch.meshgrid(ar, ar, indexing="ij")
    scale = torch.pow(2.0, level.to(torch.float32))[:, None]
    ox = (ox.reshape(-1) - (HALF_PATCH + 1)).to(torch.float32)[None] * scale
    oy = (oy.reshape(-1) - (HALF_PATCH + 1)).to(torch.float32)[None] * scale
    px_ref = px_ref.to(torch.float32)
    if acc == torch.float32:
        # the control: the source points as a (TF32) product
        src = torch.einsum("mij,mpj->mpi", Ainv,
                           torch.stack([ox, oy], -1)) + px_ref[:, None]
        x, y = src[..., 0], src[..., 1]
    else:
        x = (Ainv[:, 0, 0:1] * ox + Ainv[:, 0, 1:2] * oy) + px_ref[:, 0:1]
        y = (Ainv[:, 1, 0:1] * ox + Ainv[:, 1, 1:2] * oy) + px_ref[:, 1:2]
    inside = (x >= 0) & (y >= 0) & (x < w - 1) & (y < h - 1)
    xc = torch.clamp(x, 0.0, w - 1.001)
    yc = torch.clamp(y, 0.0, h - 1.001)
    base = (host_idx.to(torch.int64) * (h * w))[:, None]
    val = _sample(quad, base, w, xc, yc)
    val = torch.where(inside, val, torch.zeros_like(val))
    return val.reshape(-1, BORDER_PATCH, BORDER_PATCH)


def _patch_sum(a, b, acc):
    """Per row the sum over the patch's pixels of a * b ((M, P) each):
    exact products summed in `acc` (float64), rounded to float32 once; in
    the control (float32) a (TF32) product."""
    if acc == torch.float32:
        return torch.einsum("mp,mp->m", a, b)
    return (a.to(acc) * b.to(acc)).sum(1).to(torch.float32)


def _mat_vec(A, x, acc):
    """(M, 3, 3) @ (M, 3): per entry sum_j A_ij x_j in `acc`, j = 0, 1, 2 in
    order, rounded to float32 once; in the control a (TF32) product."""
    if acc == torch.float32:
        return torch.einsum("mij,mj->mi", A, x)
    A, x = A.to(acc), x.to(acc)
    return ((A[..., 0] * x[:, None, 0] + A[..., 1] * x[:, None, 1])
            + A[..., 2] * x[:, None, 2]).to(torch.float32)


def align(quad_pyr, offsets, widths, heights, search_level, border_patch,
          px_init, direction, is_edge, aff_a, aff_b, valid, n_iter=10,
          n_lanes=0, acc=torch.float64):
    """K5: each valid candidate's inverse-compositional alignment of its
    8x8 patch (the border patch's inner pixels, with central-difference
    gradients) on its search level, at most `n_iter` Gauss-Newton
    iterations, each row to its own stop: it leaves when floor(u, v)
    walks out of [4, w-4) x [4, h-4), and converges when its step's
    squared length falls under 0.03^2. A corner updates (u, v,
    mean_diff) by Hinv J^T res; an edgelet moves along its direction.
    Returns (px (M, 2), converged (M,), failure counts [out of bounds,
    out of iterations] ((2,), or (n_lanes, 2)), iterations run (M,))."""
    f32 = torch.float32
    bp = border_patch.to(f32)
    direction = direction.to(f32)
    ref = bp[:, 1:-1, 1:-1].reshape(len(bp), -1)
    dx = (0.5 * (bp[:, 1:-1, 2:] - bp[:, 1:-1, :-2])).reshape(len(bp), -1)
    dy = (0.5 * (bp[:, 2:, 1:-1] - bp[:, :-2, 1:-1])).reshape(len(bp), -1)
    dgrad = direction[:, 0:1] * dx + direction[:, 1:2] * dy
    e = is_edge[:, None]
    J = (torch.where(e, dgrad, dx), torch.where(e, torch.ones_like(dx), dy),
         torch.where(e, torch.zeros_like(dx), torch.ones_like(dx)))
    H = torch.stack([torch.stack([_patch_sum(J[i], J[j], acc)
                                  for j in range(3)], -1) for i in range(3)], -2)
    H = H + torch.eye(3, dtype=f32, device=H.device) * H_EPS
    Hinv = _inverse(H, acc)
    target = aff_a.to(f32)[:, None] * ref + aff_b.to(f32)[:, None]
    base = offsets[search_level][:, None]
    wv = widths[search_level][:, None]
    hv = heights[search_level]
    ar = torch.arange(PATCH, device=bp.device)
    oy, ox = torch.meshgrid(ar, ar, indexing="ij")
    ox = (ox.reshape(-1) - HALF_PATCH).to(f32)[None]
    oy = (oy.reshape(-1) - HALF_PATCH).to(f32)[None]
    u = px_init[:, 0].to(f32).clone()
    v = px_init[:, 1].to(f32).clone()
    md = torch.zeros_like(u)
    conv = torch.zeros_like(valid)
    alive = valid.clone()
    iters = torch.zeros(len(u), dtype=torch.int64, device=u.device)
    for _ in range(n_iter):
        running = alive & valid & ~conv
        if not bool(running.any()):
            break
        ur, vr = torch.floor(u), torch.floor(v)
        inb = ((ur >= HALF_PATCH) & (vr >= HALF_PATCH)
               & (ur < wv[:, 0] - HALF_PATCH) & (vr < hv - HALF_PATCH))
        act = running & inb
        uc = torch.minimum(torch.clamp(u, min=HALF_PATCH),
                           (wv[:, 0] - HALF_PATCH).to(f32))
        vc = torch.minimum(torch.clamp(v, min=HALF_PATCH),
                           (hv - HALF_PATCH).to(f32))
        cur = _sample(quad_pyr, base, wv, uc[:, None] + ox,
                      vc[:, None] + oy)
        res = (cur - target) + md[:, None]
        Jres = torch.stack([-_patch_sum(res, J[i], acc) for i in range(3)],
                           -1)
        upd = _mat_vec(Hinv, Jres, acc)
        upd = torch.where(act[:, None], upd, torch.zeros_like(upd))
        du = torch.where(is_edge, upd[:, 0] * direction[:, 0], upd[:, 0])
        dv = torch.where(is_edge, upd[:, 0] * direction[:, 1], upd[:, 1])
        dmd = torch.where(is_edge, upd[:, 1], upd[:, 2])
        u = torch.where(act, u + du, u)
        v = torch.where(act, v + dv, v)
        md = torch.where(act, md + dmd, md)
        iters = iters + act.to(torch.int64)
        step_sq = upd[:, 0] * upd[:, 0] + upd[:, 1] * upd[:, 1]
        conv = conv | (act & (step_sq < MIN_UPDATE_SQ))
        alive = torch.where(running, inb, alive)
    fails = torch.stack([valid & ~conv & ~alive, valid & ~conv & alive],
                        -1).to(torch.int64)
    fails = fails.reshape(n_lanes, -1, 2).sum(1) if n_lanes else fails.sum(0)
    return torch.stack([u, v], dim=-1), conv & valid, fails, iters


def warp_align(dI_ref0_stack, host_idx, px_ref, A_cur_ref, warp_level,
               quad_pyr, offsets, widths, heights, search_level, px_init,
               direction, is_edge, aff_a, aff_b, valid, n_iter=10,
               n_lanes=0, quad_stack=None, acc=torch.float64):
    """K5 with K6 as its prologue, as the matcher calls it: `warp_patches`
    from the host images (the call's `quad_stack`, the program's pack of
    them, is not read: the pack is made here again), then `align` on
    those patches over the target pyramid's quad pack. `align`'s
    results."""
    patches = warp_patches(dI_ref0_stack, host_idx, px_ref, A_cur_ref,
                           warp_level, acc)
    return align(quad_pyr, offsets, widths, heights, search_level, patches,
                 px_init, direction, is_edge, aff_a, aff_b, valid,
                 n_iter=n_iter, n_lanes=n_lanes, acc=acc)


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------

def ate_rmse(est, gt):
    """RMSE of the camera positions after the least-squares rigid
    alignment (Umeyama, no scale) of `est` onto `gt` ((N, 4, 4) each)."""
    pe, pg = est[:, :3, 3], gt[:, :3, 3]
    ms, md = pe.mean(0), pg.mean(0)
    cov = (pg - md).T @ (pe - ms) / len(pe)
    U, _, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    err = np.linalg.norm((R @ pe.T).T + (md - R @ ms) - pg, axis=1)
    return float(np.sqrt(np.mean(err ** 2)))


def path_length(poses):
    return float(np.linalg.norm(np.diff(poses[:, :3, 3], axis=0),
                                axis=1).sum())
