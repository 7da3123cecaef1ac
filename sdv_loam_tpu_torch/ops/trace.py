"""Immature-point epipolar tracing and activation depth-GN.

Counterpart of `sdv_loam_tpu/ops/trace.py` (reference: ImmaturePoint
constructor :8-35, traceOn :50-352, linearizeResidual :410-476,
FullSystem::optimizeImmaturePoint, FullSystemOptPoint.cpp:18-183). The
whole pool traces against one target at once; `idepth_max = +inf` encodes
the reference's "not yet bounded" state.
"""

from __future__ import annotations

import torch

from sdv_loam_tpu_torch.config import PATTERN_P
from sdv_loam_tpu_torch.ops.warp import (bilinear_sample_packed,
                                         pack_bilinear, quad_bilinear)
from sdv_loam_tpu_torch.utils import device_loop

# ImmaturePointStatus (ImmaturePoint.h:20-30)
IPS_GOOD = 0
IPS_OOB = 1
IPS_OUTLIER = 2
IPS_SKIPPED = 3
IPS_BADCONDITION = 4
IPS_UNINITIALIZED = 5

TRACE_STEPS = 64


def _pattern(device):
    """PATTERN_P on `device` (made once)."""
    return device_loop.constant(PATTERN_P, device)


def pattern_colors(dI0, u, v):
    """8-pattern colors, weights, gradH [Gxx, Gxy, Gyy], finite flag and
    |grad| at the center pixel (ImmaturePoint constructor). dI0 (H, W, 3)
    with points (N,), or a lane stack (L, H, W, 3) with points (L, N)."""
    single = dI0.dim() == 3
    img = dI0[None] if single else dI0
    uu, vv = (u[None], v[None]) if single else (u, v)
    L, ht, wt = img.shape[:3]
    pat = _pattern(u.device)
    base = (torch.arange(L, device=u.device) * (ht * wt))[:, None, None]
    vals, ok = bilinear_sample_packed(pack_bilinear(img), ht, wt,
                                      uu[..., None] + pat[:, 0],
                                      vv[..., None] + pat[:, 1], base=base)
    color = vals[..., 0]
    gx = vals[..., 1]
    gy = vals[..., 2]
    gradH = torch.stack([torch.sum(gx * gx, -1), torch.sum(gx * gy, -1),
                         torch.sum(gy * gy, -1)], dim=-1)
    c = 50.0 * 50.0
    weights = torch.sqrt(c / (c + gx * gx + gy * gy))
    finite = torch.isfinite(color).all(dim=-1) & ok.all(dim=-1)
    grad_center = torch.hypot(gx[..., 4], gy[..., 4])
    out = (color, weights, gradH, finite, grad_center)
    return tuple(x[0] for x in out) if single else out


def _huber_w(absr, huber_th):
    return torch.where(absr < huber_th, torch.ones_like(absr),
                       huber_th / torch.clamp(absr, min=1e-12))


def trace_points(u, v, idepth_min, idepth_max, status, quality,
                 color, weights, gradH, energy_th, host_idx,
                 KRKi_stack, Kt_stack, aff_stack, dI_target0,
                 max_pix_search_frac=0.027, huber_th=6.0, *, w: int, h: int):
    """Batched traceOn of the immature pool against one target frame: lane
    0 of `trace_points_lanes`. Returns dict(idepth_min, idepth_max, status,
    quality, last_u, last_v, pixel_interval)."""
    out = trace_points_lanes(
        *(x[None] for x in (u, v, idepth_min, idepth_max, status, quality,
                            color, weights, gradH, energy_th, host_idx,
                            KRKi_stack, Kt_stack, aff_stack, dI_target0)),
        [max_pix_search_frac], [huber_th], w=w, h=h)
    return {k: x[0] for k, x in out.items()}


def _lane_floats(xs, like, ndim):
    """Per-lane host floats as a float32 (L, 1, ...) tensor of `ndim` dims:
    each value rounds to float32 as a python scalar operand would (made
    outside the stage programs, which take it as an input)."""
    t = torch.tensor([float(x) for x in xs], dtype=torch.float32,
                     device=like.device)
    return t.reshape((-1,) + (1,) * (ndim - 1))


def trace_points_lanes(u, v, idepth_min, idepth_max, status, quality,
                       color, weights, gradH, energy_th, host_idx,
                       KRKi_stack, Kt_stack, aff_stack, dI_target0,
                       max_pix_search_frac, huber_th, *, w: int, h: int):
    """`trace_points` of L immature pools, each against its own target
    frame (the JAX package's `trace_points_batch`): every tensor carries a
    leading L (pools (L, M), window stacks (L, F, ...), dI_target0
    (L, H, W, 3)); `max_pix_search_frac` and `huber_th` are per-lane host
    floats. The loops are fixed-count, so lanes never wait for each other.
    Returns trace_points' dict with a leading L. One stage program
    (`device_loop.program`, "trace"), the per-lane floats its inputs."""
    x = dict(u=u, v=v, idepth_min=idepth_min, idepth_max=idepth_max,
             status=status, quality=quality, color=color, weights=weights,
             gradH=gradH, energy_th=energy_th, host_idx=host_idx,
             KRKi_stack=KRKi_stack, Kt_stack=Kt_stack, aff_stack=aff_stack,
             dI_target0=dI_target0,
             max_pix_search=_lane_floats([(w + h) * float(f)
                                          for f in max_pix_search_frac], u,
                                         2),
             hub2=_lane_floats(huber_th, u, 2))
    return device_loop.program("trace", _trace_program, x,
                               dict(w=int(w), h=int(h)))


def _trace_program(x, w, h):
    (u, v, idepth_min, idepth_max, status, quality, color, weights, gradH,
     energy_th, host_idx, KRKi_stack, Kt_stack, aff_stack, dI_target0,
     max_pix_search, hub2) = (x[k] for k in (
         "u", "v", "idepth_min", "idepth_max", "status", "quality", "color",
         "weights", "gradH", "energy_th", "host_idx", "KRKi_stack",
         "Kt_stack", "aff_stack", "dI_target0", "max_pix_search", "hub2"))
    dev = u.device
    L = u.shape[0]
    ar = torch.arange(L, device=dev)[:, None]
    host_idx = host_idx.to(torch.int64)
    KRKi = KRKi_stack[ar, host_idx]                               # (L,M,3,3)
    Kt = Kt_stack[ar, host_idx]
    aff = aff_stack[ar, host_idx]
    hub4 = hub2[..., None, None]
    f32 = torch.float32

    active = (status != IPS_OOB) & (status != IPS_SKIPPED)
    ones = torch.ones_like(u)
    pr = torch.einsum("lnij,lnj->lni", KRKi, torch.stack([u, v, ones], -1))
    ptpMin = pr + Kt * idepth_min[..., None]
    uMin = ptpMin[..., 0] / ptpMin[..., 2]
    vMin = ptpMin[..., 1] / ptpMin[..., 2]
    oob = ~((uMin > 4) & (vMin > 4) & (uMin < w - 5) & (vMin < h - 5))

    finite_max = torch.isfinite(idepth_max)
    id_max_safe = torch.where(finite_max, idepth_max,
                              torch.full_like(idepth_max, 0.01))
    ptpMax = pr + Kt * id_max_safe[..., None]
    uMax0 = ptpMax[..., 0] / ptpMax[..., 2]
    vMax0 = ptpMax[..., 1] / ptpMax[..., 2]

    dist_f = torch.hypot(uMin - uMax0, vMin - vMax0)
    oob = oob | (finite_max & ~((uMax0 > 4) & (vMax0 > 4) & (uMax0 < w - 5)
                                & (vMax0 < h - 5)))
    skip = finite_max & (dist_f < 1.5)

    ddx = uMax0 - uMin
    ddy = vMax0 - vMin
    dnorm = 1.0 / torch.clamp(torch.hypot(ddx, ddy), min=1e-12)
    uMax_inf = uMin + max_pix_search * ddx * dnorm
    vMax_inf = vMin + max_pix_search * ddy * dnorm
    oob = oob | (~finite_max & ~((uMax_inf > 4) & (vMax_inf > 4)
                                 & (uMax_inf < w - 5) & (vMax_inf < h - 5)))

    uMax = torch.where(finite_max, uMax0, uMax_inf)
    vMax = torch.where(finite_max, vMax0, vMax_inf)
    dist = torch.where(finite_max, dist_f, max_pix_search.expand_as(dist_f))

    oob = oob | ~((idepth_min < 0) | ((ptpMin[..., 2] > 0.75)
                                      & (ptpMin[..., 2] < 1.5)))

    dx = uMax - uMin
    dy = vMax - vMin
    a = dx * dx * gradH[..., 0] + 2 * dx * dy * gradH[..., 1] + \
        dy * dy * gradH[..., 2]
    b = dy * dy * gradH[..., 0] - 2 * dx * dy * gradH[..., 1] + \
        dx * dx * gradH[..., 2]
    err_px = 0.2 + 0.2 * (a + b) / torch.clamp(a, min=1e-12)
    badcond = (err_px * 2.0 > dist) & finite_max
    err_px = torch.clamp(err_px, max=10.0)

    dxn = dx / torch.clamp(dist, min=1e-12)
    dyn = dy / torch.clamp(dist, min=1e-12)
    oob = oob | ~torch.isfinite(dxn) | ~torch.isfinite(dyn)

    clipped = dist > max_pix_search
    uMax = torch.where(clipped, uMin + max_pix_search * dxn, uMax)
    vMax = torch.where(clipped, vMin + max_pix_search * dyn, vMax)
    dist_c = torch.where(clipped, max_pix_search.expand_as(dist), dist)

    n_steps = torch.clamp((1.9999 + dist_c).to(torch.int64),
                          max=TRACE_STEPS - 1)
    Rp = KRKi[..., :2, :2]
    rot_pat = torch.einsum("lnij,pj->lnpi", Rp, _pattern(dev))  # (L,M,8,2)

    rand_shift = uMin * 1000.0 - torch.floor(uMin * 1000.0)
    px0 = uMin - rand_shift * dxn
    py0 = vMin - rand_shift * dyn

    steps = torch.arange(TRACE_STEPS, dtype=f32, device=dev)
    sx = px0[..., None] + steps * dxn[..., None]
    sy = py0[..., None] + steps * dyn[..., None]
    gx = sx[..., None] + rot_pat[:, :, None, :, 0]
    gy = sy[..., None] + rot_pat[:, :, None, :, 1]

    ht, wt = dI_target0.shape[1:3]
    packed1 = pack_bilinear(dI_target0[..., :1])
    packed3 = pack_bilinear(dI_target0)
    base = ar * (ht * wt)
    hit, hok = bilinear_sample_packed(packed1, ht, wt, gx, gy,
                                      base=base[..., None, None])
    res = hit - (aff[..., None, None, 0] * color[:, :, None, :]
                 + aff[..., None, None, 1])
    absr = torch.abs(res)
    hw = _huber_w(absr, hub4)
    e_pat = torch.where(hok, hw * res * res * (2.0 - hw),
                        torch.full_like(res, 1e5))
    energies = torch.sum(e_pat, dim=-1)
    step_valid = steps < n_steps[..., None].to(f32)
    energies = torch.where(step_valid, energies,
                           torch.full_like(energies, 1e10))

    best_idx = torch.argmin(energies, dim=-1)
    best_energy = torch.gather(energies, 2, best_idx[..., None])[..., 0]
    bestU = px0 + best_idx.to(f32) * dxn
    bestV = py0 + best_idx.to(f32) * dyn

    far = torch.abs(steps - best_idx[..., None].to(f32)) > 2
    second = torch.where(far & step_valid, energies,
                         torch.full_like(energies, 1e10)).amin(dim=-1)
    new_quality = second / torch.clamp(best_energy, min=1e-12)
    quality_out = torch.where((new_quality < quality) | (n_steps > 10),
                              new_quality, quality)

    # GN refine (3 iterations along the epipolar direction)
    bU, bV = bestU, bestV
    bE = torch.full_like(bestU, 1e5)
    uBak, vBak = bestU, bestV
    stepBack = torch.zeros_like(bestU)
    done = torch.zeros_like(bestU, dtype=torch.bool)
    zero = torch.zeros((), dtype=f32, device=dev)
    hub3 = hub2[..., None]
    for _ in range(3):
        gxp = bU[..., None] + rot_pat[..., 0]
        gyp = bV[..., None] + rot_pat[..., 1]
        hit3, ok3 = bilinear_sample_packed(packed3, ht, wt, gxp, gyp,
                                           base=base[..., None])
        r3 = hit3[..., 0] - (aff[..., 0:1] * color + aff[..., 1:2])
        dResdDist = dxn[..., None] * hit3[..., 1] + \
            dyn[..., None] * hit3[..., 2]
        hw3 = _huber_w(torch.abs(r3), hub3)
        Hgn = 1.0 + torch.where(ok3, hw3 * dResdDist * dResdDist, zero).sum(-1)
        bgn = torch.where(ok3, hw3 * r3 * dResdDist, zero).sum(-1)
        energy = torch.where(ok3, weights * weights * hw3 * r3 * r3
                             * (2.0 - hw3), torch.full_like(r3, 1e5)).sum(-1)
        worse = energy > bE
        sb_w = stepBack * 0.5
        bU_w = uBak + sb_w * dxn
        bV_w = vBak + sb_w * dyn
        step = torch.clamp(-bgn / Hgn, -0.5, 0.5)
        step = torch.where(torch.isfinite(step), step, zero)
        bU_g = bU + step * dxn
        bV_g = bV + step * dyn

        uBak_n = torch.where(worse, uBak, bU)
        vBak_n = torch.where(worse, vBak, bV)
        sb_n = torch.where(worse, sb_w, step)
        bU_n = torch.where(worse, bU_w, bU_g)
        bV_n = torch.where(worse, bV_w, bV_g)
        bE_n = torch.where(worse, bE, energy)
        upd = ~done
        bU = torch.where(upd, bU_n, bU)
        bV = torch.where(upd, bV_n, bV)
        bE = torch.where(upd, bE_n, bE)
        uBak = torch.where(upd, uBak_n, uBak)
        vBak = torch.where(upd, vBak_n, vBak)
        stepBack = torch.where(upd, sb_n, stepBack)
        done = done | (torch.abs(stepBack) < 0.1)
    bestU, bestV, best_energy_gn = bU, bV, bE

    outlier = ~(best_energy_gn < energy_th * 1.2)

    use_x = dxn * dxn > dyn * dyn
    eU_lo = bestU - err_px * dxn
    eU_hi = bestU + err_px * dxn
    eV_lo = bestV - err_px * dyn
    eV_hi = bestV + err_px * dyn

    def id_from_u(bu):
        return (pr[..., 2] * bu - pr[..., 0]) / (Kt[..., 0] - Kt[..., 2] * bu)

    def id_from_v(bv):
        return (pr[..., 2] * bv - pr[..., 1]) / (Kt[..., 1] - Kt[..., 2] * bv)

    id_lo = torch.where(use_x, id_from_u(eU_lo), id_from_v(eV_lo))
    id_hi = torch.where(use_x, id_from_u(eU_hi), id_from_v(eV_hi))
    new_min = torch.minimum(id_lo, id_hi)
    new_max = torch.maximum(id_lo, id_hi)
    bad_interval = (~torch.isfinite(new_min)) | (~torch.isfinite(new_max)) | \
        (new_max < 0)

    def const(c):
        return torch.full_like(status, c)

    new_status = const(IPS_GOOD)
    new_status = torch.where(outlier | bad_interval,
                             torch.where(status == IPS_OUTLIER, const(IPS_OOB),
                                         const(IPS_OUTLIER)), new_status)
    new_status = torch.where(badcond, const(IPS_BADCONDITION), new_status)
    new_status = torch.where(skip, const(IPS_SKIPPED), new_status)
    new_status = torch.where(oob, const(IPS_OOB), new_status)

    good = (new_status == IPS_GOOD) & active
    neg1 = torch.full_like(bestU, -1.0)
    return dict(
        idepth_min=torch.where(good, new_min, idepth_min),
        idepth_max=torch.where(good, new_max, idepth_max),
        status=torch.where(active, new_status, status),
        quality=torch.where(good, quality_out, quality),
        last_u=torch.where(good, bestU,
                           torch.where(active & skip, (uMax + uMin) * 0.5,
                                       neg1)),
        last_v=torch.where(good, bestV,
                           torch.where(active & skip, (vMax + vMin) * 0.5,
                                       neg1)),
        pixel_interval=torch.where(good, 2.0 * err_px,
                                   torch.where(active & skip, dist_f,
                                               torch.zeros_like(dist_f))))


# ---------------------------------------------------------------------------
# activation depth-GN
# ---------------------------------------------------------------------------

def _point_residual_system(u, v, idepth, color, weights, host_idx,
                           R_stack, t_stack, aff_stack, target_idx,
                           quad12, F, K, w, h, energy_th, outlier_slack):
    """One temporary residual (point x target) of L lanes: pattern energy +
    (Hdd, bd) (ImmaturePoint::linearizeResidual). Points (L, A), pair
    stacks (L, F*F, ...) with pair id = host * F + target, K (L, 4);
    `quad12` packs the lanes' window stacks lane after lane."""
    L = u.shape[0]
    ar = torch.arange(L, device=u.device)[:, None]
    fx, fy, cx, cy = (K[:, i, None, None] for i in range(4))      # (L,1,1)
    pair = host_idx * F + target_idx
    R = R_stack[ar, pair]
    t = t_stack[ar, pair]
    aff = aff_stack[ar, pair]

    pat = _pattern(u.device)
    up = u[..., None] + pat[:, 0]
    vp = v[..., None] + pat[:, 1]
    KliP = torch.stack([(up - cx) / fx, (vp - cy) / fy,
                        torch.ones_like(up)], -1)
    ptp = torch.einsum("lnij,lnpj->lnpi", R, KliP) + \
        (t * idepth[..., None])[..., None, :]
    drescale = 1.0 / ptp[..., 2]
    un = ptp[..., 0] * drescale
    vn = ptp[..., 1] * drescale
    Ku = un * fx + cx
    Kv = vn * fy + cy
    ok = (drescale > 0) & (Ku > 1.1) & (Kv > 1.1) & (Ku < w - 3) & \
        (Kv < h - 3)

    base = ((ar * F + target_idx) * (w * h))[..., None]
    Kuc = torch.clamp(Ku, 0.0, w - 1.01)
    Kvc = torch.clamp(Kv, 0.0, h - 1.01)
    hit = quad_bilinear(quad12, base, w, Kuc, Kvc)

    res = hit[..., 0] - (aff[..., 0:1] * color + aff[..., 1:2])
    hw = _huber_w(torch.abs(res), 6.0)
    zero = torch.zeros((), dtype=res.dtype, device=res.device)
    energy = torch.where(ok, weights * weights * hw * res * res * (2.0 - hw),
                         zero)
    all_ok = ok.all(dim=-1)
    e_total = torch.sum(energy, dim=-1)

    dxI = hit[..., 1] * fx
    dyI = hit[..., 2] * fy
    d_id = (dxI * drescale * (t[..., None, 0] - t[..., None, 2] * un)
            + dyI * drescale * (t[..., None, 1] - t[..., None, 2] * vn))
    hww = hw * weights * weights
    Hdd = torch.where(ok, hww * d_id * d_id, zero).sum(-1)
    bd = torch.where(ok, hww * res * d_id, zero).sum(-1)

    is_outlier = e_total > energy_th * outlier_slack
    e_clamped = torch.minimum(e_total, energy_th * outlier_slack)
    state = torch.where(~all_ok, torch.ones_like(pair),
                        torch.where(is_outlier, torch.full_like(pair, 2),
                                    torch.zeros_like(pair)))
    return (torch.where(all_ok, e_clamped, zero),
            torch.where(all_ok, Hdd, zero), torch.where(all_ok, bd, zero),
            state)


def stack_quad12(dI0_stack):
    """(F*H*W, 12) quad pack of a window stack's 3-channel level-0 images;
    a lane stack (L, F, H, W, 3) packs lane after lane."""
    return pack_bilinear(dI0_stack.reshape((-1,) + dI0_stack.shape[-3:]))


def activate_points(u, v, idepth_init, color, weights, host_idx, is_sensor,
                    valid, frame_valid, R_pair, t_pair, aff_pair,
                    dI0_stack, K, energy_th, w: int, h: int, n_frames: int,
                    min_idepth_h_act: float = 100.0, min_obs: int = 1,
                    gn_iters: int = 3, quad12=None):
    """Batched optimizeImmaturePoint: LM on idepth over residuals to all
    other valid frames for monocular points; sensor points keep their
    depth. Lane 0 of `activate_points_lanes`. Returns dict(idepth,
    success, inlier_targets (N, F))."""
    out = activate_points_lanes(
        *(x[None] for x in (u, v, idepth_init, color, weights, host_idx,
                            is_sensor, valid, frame_valid, R_pair, t_pair,
                            aff_pair, dI0_stack, K, energy_th)),
        w=w, h=h, n_frames=n_frames, min_idepth_h_act=[min_idepth_h_act],
        min_obs=min_obs, gn_iters=gn_iters, quad12=quad12)
    return {k: x[0] for k, x in out.items()}


def activate_points_lanes(u, v, idepth_init, color, weights, host_idx,
                          is_sensor, valid, frame_valid, R_pair, t_pair,
                          aff_pair, dI0_stack, K, energy_th, w: int, h: int,
                          n_frames: int, min_idepth_h_act=(100.0,),
                          min_obs: int = 1, gn_iters: int = 3, quad12=None):
    """`activate_points` of L lanes: points (L, A), frame_valid (L, F),
    pair stacks (L, F*F, ...), dI0_stack (L, F, H, W, 3), K (L, 4);
    `min_idepth_h_act` per-lane host floats (or their (L, 1) float32
    tensor). The per-target loop runs over the F slots and the GN loop is
    fixed-count, so lanes never wait for each other."""
    L, N = u.shape
    F = n_frames
    dev = u.device
    host_idx = host_idx.to(torch.int64)
    if quad12 is None:
        quad12 = stack_quad12(dI0_stack)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    h_act = min_idepth_h_act if isinstance(min_idepth_h_act, torch.Tensor) \
        else _lane_floats(min_idepth_h_act, u, 2)

    def all_targets_system(idepth):
        es, Hs, bs, states = [], [], [], []
        for tgt in range(F):
            ti = torch.full((L, N), tgt, dtype=torch.int64, device=dev)
            e, Hdd, bd, st = _point_residual_system(
                u, v, idepth, color, weights, host_idx, R_pair, t_pair,
                aff_pair, ti, quad12, F, K, w, h, energy_th, 1.0)
            use = frame_valid[:, tgt, None] & (host_idx != tgt)
            es.append(torch.where(use, e, zero))
            Hs.append(torch.where(use, Hdd, zero))
            bs.append(torch.where(use, bd, zero))
            states.append(torch.where(use, st, torch.ones_like(st)))
        return (torch.stack(es, -1), torch.stack(Hs, -1),
                torch.stack(bs, -1), torch.stack(states, -1))

    e0, H0, b0, st0 = all_targets_system(idepth_init)
    lastE = e0.sum(-1)
    lastH = H0.sum(-1)
    lastb = b0.sum(-1)
    constrained0 = torch.isfinite(lastE) & (lastH >= h_act)

    idepth = idepth_init
    lam = torch.full((L, N), 0.1, dtype=torch.float32, device=dev)
    states = st0
    ok = constrained0
    done = torch.zeros((L, N), dtype=torch.bool, device=dev)
    for _ in range(gn_iters):
        step = (1.0 / (lastH * (1.0 + lam))) * lastb
        new_id = idepth - step
        e1, H1, b1, st1 = all_targets_system(new_id)
        E1 = e1.sum(-1)
        Hs = H1.sum(-1)
        bs = b1.sum(-1)
        ok = ok & torch.isfinite(lastE) & (Hs >= h_act)
        accept = (E1 < lastE) & ~done
        idepth = torch.where(accept, new_id, idepth)
        lastE = torch.where(accept, E1, lastE)
        lastH = torch.where(accept, Hs, lastH)
        lastb = torch.where(accept, bs, lastb)
        states = torch.where(accept[..., None], st1, states)
        lam = torch.where(accept, lam * 0.5, lam * 5.0)
        done = done | (torch.abs(step) < 1e-4 * idepth)

    tgt_ids = torch.arange(F, device=dev)
    sensor_states = torch.where(
        frame_valid[:, None, :] & (host_idx[..., None] != tgt_ids),
        torch.zeros((), dtype=states.dtype, device=dev),
        torch.ones((), dtype=states.dtype, device=dev))
    idepth_out = torch.where(is_sensor, idepth_init, idepth)
    states_out = torch.where(is_sensor[..., None], sensor_states, states)
    mono_ok = torch.where(is_sensor, torch.ones_like(ok), ok & constrained0)
    inlier = states_out == 0
    n_good = inlier.sum(-1)
    success = valid & mono_ok & torch.isfinite(idepth_out) & \
        (n_good >= min_obs) & (idepth_out > 0)
    return dict(idepth=idepth_out, success=success, inlier_targets=inlier)
