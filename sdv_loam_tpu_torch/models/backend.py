"""Sliding-window bundle-adjustment backend — the EnergyFunctional.

Counterpart of `sdv_loam_tpu/models/backend.py` (reference
src/OptimizationBackend/*, Residuals.cpp, FullSystemOptimize.cpp): dense
(N points, F frames) residual grid with masks, FEJ linearization of the 2-D
reprojection residual plus the 8-point photometric outlier gate, per-pair
accumulation transported to the absolute (4 + 6F) system by the pair
adjoints, Schur complement over non-sensor point depths, marginalization
prior, preconditioned solve with nullspace orthogonalization, and the whole
windowed LM (`ba_core`) as a Python loop with the reference's accept /
lambda / early-break rules.

State: frame pose variable eps (F, 6), T_cw = exp(eps) @ T_cw_fej.
"""

from __future__ import annotations

import torch

from sdv_loam_tpu_torch.config import CPARS, PATTERN_P
from sdv_loam_tpu_torch.ops import hopper_kernels
from sdv_loam_tpu_torch.ops.trace import stack_quad12
from sdv_loam_tpu_torch.ops.warp import quad_bilinear
from sdv_loam_tpu_torch.utils import device_loop, se3

RES_IN = 0
RES_OOB = 1
RES_OUTLIER = 2

# Lanes: every function of the windowed LM has a lane form over L
# independent windows (the lockstep fleet's sequences): each argument
# carries a leading L and each lane reduces over the same shapes as one
# window alone. The single-window functions are lane 0 of their lane
# forms.

_SHARED_PAIR_KEYS = ("host", "target")


def _bmm_idx(F, device):
    ar = torch.arange(F, device=device)
    hi = ar[:, None].expand(F, F).reshape(-1)                  # host of pair
    ti = ar.repeat(F)                                          # target
    return hi, ti


def _lane0(d):
    """A single window's dict as lane 0 of a lane dict."""
    return {k: (v if k in _SHARED_PAIR_KEYS else v[None])
            for k, v in d.items()}


def _unlane(d):
    return {k: (v if k in _SHARED_PAIR_KEYS else v[0]) for k, v in d.items()}


def make_pairs(T_cw, T_cw_fej, aff, exposure, K):
    """Per (host, target) pair transforms, adjoints and brightness transfer
    (FrameFramePrecalc::set + setAdjointsF); pair = host * F + target."""
    return _unlane(make_pairs_lanes(T_cw[None], T_cw_fej[None], aff[None],
                                    exposure[None], K[None]))


def make_pairs_lanes(T_cw, T_cw_fej, aff, exposure, K):
    """`make_pairs` of L windows: T_cw (L, F, 4, 4), aff (L, F, 2),
    exposure (L, F), K (L, 4); `host` / `target` are shared (F*F,)."""
    L, F = T_cw.shape[:2]
    dev = T_cw.device
    fx, fy, cx, cy = (K[:, i] for i in range(4))
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    Km = torch.stack([torch.stack([fx, z, cx], -1),
                      torch.stack([z, fy, cy], -1),
                      torch.stack([z, z, o], -1)], -2).to(T_cw.dtype)
    Kim = torch.stack([torch.stack([1.0 / fx, z, -cx / fx], -1),
                       torch.stack([z, 1.0 / fy, -cy / fy], -1),
                       torch.stack([z, z, o], -1)], -2).to(T_cw.dtype)
    hi, ti = _bmm_idx(F, dev)
    T_th_fej = T_cw_fej[:, ti] @ se3.inverse(T_cw_fej)[:, hi]
    T_th = T_cw[:, ti] @ se3.inverse(T_cw)[:, hi]
    KRKi = Km[:, None] @ T_th[..., :3, :3] @ Kim[:, None]
    Kt = torch.einsum("lij,lpj->lpi", Km, T_th[..., :3, 3])
    adH = -se3.adjoint(T_th_fej).transpose(-1, -2)
    adT = torch.eye(6, dtype=T_cw.dtype, device=dev).expand(L, F * F, 6, 6)
    e_h, e_t = exposure[:, hi], exposure[:, ti]
    zero_e = (e_h == 0) | (e_t == 0)
    er = torch.where(zero_e, torch.ones_like(e_h), e_h)
    et = torch.where(zero_e, torch.ones_like(e_t), e_t)
    a_rel = torch.exp(aff[:, ti, 0] - aff[:, hi, 0]) * et / er
    b_rel = aff[:, ti, 1] - a_rel * aff[:, hi, 1]
    return dict(host=hi, target=ti, R0=T_th_fej[..., :3, :3],
                t0=T_th_fej[..., :3, 3], Rc=T_th[..., :3, :3],
                tc=T_th[..., :3, 3], KRKi=KRKi, Kt=Kt, adH=adH, adT=adT,
                aff_a=a_rel, aff_b=b_rel, b0=aff[:, hi, 1])


def _pair_rows(pt_host, F):
    """(L, N, F) pair index host * F + target of every residual."""
    return pt_host[..., None] * F + torch.arange(F, device=pt_host.device)


def _mv(A, x):
    """Per-lane matrix-vector product (L, m, n) x (L, n) -> (L, m), one
    window at a time: a batched product rounds differently from one
    window's, and the monocular points' depths (which BA owns) would then
    depend on the fleet's composition."""
    return torch.stack([A[i] @ x[i] for i in range(A.shape[0])])


def _take(x, idx):
    """x (L, P, ...) at per-lane indices idx (L, ...)."""
    ar = torch.arange(x.shape[0], device=x.device).reshape(
        (-1,) + (1,) * (idx.dim() - 1))
    return x[ar, idx]


_PATTERN: dict = {}


def _pattern(dev):
    """PATTERN_P on `dev`, made once (a host copy cannot run inside a
    graph capture)."""
    if dev not in _PATTERN:
        _PATTERN[dev] = torch.as_tensor(PATTERN_P, dtype=torch.float32,
                                        device=dev)
    return _PATTERN[dev]


def photometric_gate(pt_u, pt_v, pt_idepth, pt_host, pt_color, pt_weights,
                     pairs, dI0_stack, w: int, h: int, huber_th: float = 6.0,
                     quad12=None):
    """8-point pattern outlier-gate energies at the pairs' CURRENT pose
    (Residuals.cpp:157-194). Returns (energy_phot, wJI2), both (N, F)."""
    e, g = photometric_gate_lanes(
        pt_u[None], pt_v[None], pt_idepth[None], pt_host[None],
        pt_color[None], pt_weights[None], _lane0(pairs), dI0_stack[None],
        w=w, h=h, huber_th=huber_th, quad12=quad12)
    return e[0], g[0]


def photometric_gate_lanes(pt_u, pt_v, pt_idepth, pt_host, pt_color,
                           pt_weights, pairs, dI0_stack, w: int, h: int,
                           huber_th: float = 6.0, quad12=None):
    """`photometric_gate` of L windows: points (L, N), dI0_stack
    (L, F, H, W, 3); returns (L, N, F) twice."""
    L, N = pt_u.shape
    F = dI0_stack.shape[1]
    dev = pt_u.device
    pair_idx = _pair_rows(pt_host, F)
    KRKi = _take(pairs["KRKi"], pair_idx)
    Kt = _take(pairs["Kt"], pair_idx)
    a_rel = _take(pairs["aff_a"], pair_idx)
    b_rel = _take(pairs["aff_b"], pair_idx)

    pat = _pattern(dev)
    up = pt_u[..., None] + pat[:, 0]
    vp = pt_v[..., None] + pat[:, 1]
    pix = torch.stack([up, vp, torch.ones_like(up)], -1)        # (L,N,8,3)
    ptp2 = torch.einsum("lnfij,lnpj->lnfpi", KRKi, pix) + \
        (Kt * pt_idepth[..., None, None])[..., None, :]
    Ku2 = ptp2[..., 0] / ptp2[..., 2]
    Kv2 = ptp2[..., 1] / ptp2[..., 2]
    pat_ok = (Ku2 > 1.1) & (Kv2 > 1.1) & (Ku2 < w - 3) & (Kv2 < h - 3)
    # the reference breaks at the first failed pattern point
    pat_ok = torch.cumprod(pat_ok.to(torch.int32), dim=-1).to(torch.bool)

    if quad12 is None:
        quad12 = stack_quad12(dI0_stack)
    Hh, Ww = dI0_stack.shape[2], dI0_stack.shape[3]
    slot = torch.arange(L * F, device=dev).reshape(L, 1, F) * (Hh * Ww)
    base = slot.expand(L, N, F).reshape(L * N * F, 1)
    Ku2c = torch.clamp(Ku2, 0.0, Ww - 1.01).reshape(L * N * F, 8)
    Kv2c = torch.clamp(Kv2, 0.0, Hh - 1.01).reshape(L * N * F, 8)
    hit = quad_bilinear(quad12, base, Ww, Ku2c, Kv2c).reshape(L, N, F, 8, 3)

    resp = hit[..., 0] - (a_rel[..., None] * pt_color[:, :, None, :]
                          + b_rel[..., None])
    wgrad = torch.sqrt(2500.0 / (2500.0 + hit[..., 1] ** 2
                                 + hit[..., 2] ** 2))
    wpat = 0.5 * (wgrad + pt_weights[:, :, None, :])
    absr = torch.abs(resp)
    hwp = torch.where(absr < huber_th, torch.ones_like(absr),
                      huber_th / torch.clamp(absr, min=1e-12))
    zero = torch.zeros((), dtype=resp.dtype, device=dev)
    e_pat = torch.where(pat_ok, wpat * wpat * hwp * resp * resp * (2.0 - hwp),
                        zero)
    energy_phot = e_pat.sum(-1)
    hws = torch.where(hwp < 1.0, torch.sqrt(hwp), hwp) * wpat
    wJI2 = torch.where(pat_ok, (hws * hit[..., 1]) ** 2
                       + (hws * hit[..., 2]) ** 2, zero).sum(-1)
    return energy_phot, wJI2


def linearize_residuals(pt_u, pt_v, pt_idepth, pt_host, pt_color, pt_weights,
                        res_active, res_state, matcher_px, matcher_valid,
                        pairs, dI0_stack, frame_energy_th, K,
                        w: int, h: int, huber_th: float = 6.0,
                        gate=None, resf_at_fej: bool = True, quad12=None):
    """Linearize the dense (N, F) residual grid (PointFrameResidual::
    linearize). Returns dict(resF, Jxi, Jc, Jd, new_state, energy,
    energy_phot, wJI2, center, proj_ok). `gate` reuses cached
    (energy_phot, wJI2)."""
    out = linearize_residuals_lanes(
        *(x[None] for x in (pt_u, pt_v, pt_idepth, pt_host, pt_color,
                            pt_weights, res_active, res_state, matcher_px,
                            matcher_valid)),
        _lane0(pairs), dI0_stack[None], frame_energy_th[None], K[None],
        w=w, h=h, huber_th=huber_th,
        gate=None if gate is None else tuple(g[None] for g in gate),
        resf_at_fej=resf_at_fej, quad12=quad12)
    return {k: v[0] for k, v in out.items()}


def linearize_residuals_lanes(pt_u, pt_v, pt_idepth, pt_host, pt_color,
                              pt_weights, res_active, res_state, matcher_px,
                              matcher_valid, pairs, dI0_stack,
                              frame_energy_th, K, w: int, h: int,
                              huber_th: float = 6.0, gate=None,
                              resf_at_fej: bool = True, quad12=None):
    """`linearize_residuals` of L windows: points (L, N), residual grids
    (L, N, F), frame_energy_th (L, F), K (L, 4). CPU -> the plain version
    (`linearize_residuals_lanes_plain`); CUDA -> K7
    (`hopper_kernels.ba_linearize`), after the plain photometric gate where
    `gate` is None."""
    if pt_u.device.type == "cpu":
        return linearize_residuals_lanes_plain(
            pt_u, pt_v, pt_idepth, pt_host, pt_color, pt_weights, res_active,
            res_state, matcher_px, matcher_valid, pairs, dI0_stack,
            frame_energy_th, K, w=w, h=h, huber_th=huber_th, gate=gate,
            resf_at_fej=resf_at_fej, quad12=quad12)
    if gate is None:
        gate = photometric_gate_lanes(
            pt_u, pt_v, pt_idepth, pt_host, pt_color, pt_weights, pairs,
            dI0_stack, w=w, h=h, huber_th=huber_th, quad12=quad12)
    return hopper_kernels.ba_linearize(
        pt_u, pt_v, pt_idepth, pt_host, res_active, res_state, matcher_px,
        matcher_valid, pairs, frame_energy_th, K, gate, w=w, h=h,
        huber_th=huber_th, resf_at_fej=resf_at_fej)


def linearize_residuals_lanes_plain(pt_u, pt_v, pt_idepth, pt_host,
                                    pt_color, pt_weights, res_active,
                                    res_state, matcher_px, matcher_valid,
                                    pairs, dI0_stack, frame_energy_th, K,
                                    w: int, h: int, huber_th: float = 6.0,
                                    gate=None, resf_at_fej: bool = True,
                                    quad12=None):
    """K7's plain version: `linearize_residuals_lanes` in tensor
    operations (the pairs gathered per residual)."""
    F = dI0_stack.shape[1]
    dev = pt_u.device
    fx, fy, cx, cy = (K[:, i, None] for i in range(4))            # (L,1)
    fxi, fyi = 1.0 / fx, 1.0 / fy
    fx3, fy3 = fx[..., None], fy[..., None]                       # (L,1,1)
    cx3, cy3 = cx[..., None], cy[..., None]

    pair_idx = _pair_rows(pt_host, F)
    R0 = _take(pairs["R0"], pair_idx)
    t0 = _take(pairs["t0"], pair_idx)
    Rc = _take(pairs["Rc"], pair_idx)
    tc = _take(pairs["tc"], pair_idx)

    KliP = torch.stack([(pt_u - cx) * fxi, (pt_v - cy) * fyi,
                        torch.ones_like(pt_u)], -1)
    ptp = torch.einsum("lnfij,lnj->lnfi", R0, KliP) + \
        t0 * pt_idepth[..., None, None]
    drescale = 1.0 / ptp[..., 2]
    new_idepth0 = pt_idepth[..., None] * drescale
    u = ptp[..., 0] * drescale
    v = ptp[..., 1] * drescale
    Ku0 = u * fx3 + cx3
    Kv0 = v * fy3 + cy3
    proj_ok_fej = (drescale > 0) & (Ku0 > 1.1) & (Kv0 > 1.1) & \
        (Ku0 < w - 3) & (Kv0 < h - 3)

    if resf_at_fej:
        Ku, Kv = Ku0, Kv0
        new_idepth = new_idepth0
        proj_ok = proj_ok_fej
    else:
        ptc = torch.einsum("lnfij,lnj->lnfi", Rc, KliP) + \
            tc * pt_idepth[..., None, None]
        drescale_c = 1.0 / ptc[..., 2]
        new_idepth = pt_idepth[..., None] * drescale_c
        Ku = ptc[..., 0] * drescale_c * fx3 + cx3
        Kv = ptc[..., 1] * drescale_c * fy3 + cy3
        proj_ok = (drescale_c > 0) & (Ku > 1.1) & (Kv > 1.1) & \
            (Ku < w - 3) & (Kv < h - 3) & (drescale > 0)

    oob = (~proj_ok) | (~matcher_valid) | (res_state == RES_OOB) | \
        (~res_active)

    dd_x = drescale * (t0[..., 0] - t0[..., 2] * u) * fx3
    dd_y = drescale * (t0[..., 1] - t0[..., 2] * v) * fy3

    fxi3, fyi3 = fxi[..., None], fyi[..., None]
    dCx2 = drescale * (R0[..., 2, 0] * u - R0[..., 0, 0])
    dCx3 = fx3 * drescale * (R0[..., 2, 1] * u - R0[..., 0, 1]) * fyi3
    dCx0 = KliP[..., None, 0] * dCx2
    dCx1 = KliP[..., None, 1] * dCx3
    dCy2 = fy3 * drescale * (R0[..., 2, 0] * v - R0[..., 1, 0]) * fxi3
    dCy3 = drescale * (R0[..., 2, 1] * v - R0[..., 1, 1])
    dCy0 = KliP[..., None, 0] * dCy2
    dCy1 = KliP[..., None, 1] * dCy3
    Jc_x = torch.stack([dCx0 + u, dCx1, dCx2 + 1.0, dCx3], -1)
    Jc_y = torch.stack([dCy0, dCy1 + v, dCy2, dCy3 + 1.0], -1)

    zu = torch.zeros_like(u)
    Jxi_x = torch.stack([new_idepth0 * fx3, zu, -new_idepth0 * u * fx3,
                         -u * v * fx3, (1 + u * u) * fx3, -v * fx3], -1)
    Jxi_y = torch.stack([zu, new_idepth0 * fy3, -new_idepth0 * v * fy3,
                         -(1 + v * v) * fy3, u * v * fy3, u * fy3], -1)

    if gate is None:
        energy_phot, wJI2 = photometric_gate_lanes(
            pt_u, pt_v, pt_idepth, pt_host, pt_color, pt_weights,
            pairs, dI0_stack, w=w, h=h, huber_th=huber_th, quad12=quad12)
    else:
        energy_phot, wJI2 = gate

    r2 = torch.stack([Ku, Kv], -1) - matcher_px
    rnorm = torch.linalg.vector_norm(r2, dim=-1)
    hw2 = torch.where(rnorm < huber_th, torch.ones_like(rnorm),
                      huber_th / torch.clamp(rnorm, min=1e-12))
    energy2d = hw2 * (rnorm * rnorm) * (2.0 - hw2)
    hw2s = torch.where(hw2 < 1.0, torch.sqrt(hw2), hw2)

    resF = r2 * hw2s[..., None]
    Jxi = torch.stack([Jxi_x, Jxi_y], dim=-2) * hw2s[..., None, None]
    Jc = torch.stack([Jc_x, Jc_y], dim=-2) * hw2s[..., None, None]
    Jd = torch.stack([dd_x, dd_y], dim=-1) * hw2s[..., None]

    th = torch.maximum(_take(frame_energy_th, pt_host)[..., None],
                       frame_energy_th[:, None, :])
    is_outlier = (energy_phot > th) | (wJI2 < 2.0)
    st_in = torch.full_like(pair_idx, RES_IN)
    new_state = torch.where(oob, torch.full_like(st_in, RES_OOB),
                            torch.where(is_outlier,
                                        torch.full_like(st_in, RES_OUTLIER),
                                        st_in))
    new_state = torch.where(res_active, new_state,
                            torch.full_like(st_in, RES_OOB)).to(torch.int8)

    zm = (new_state == RES_IN)
    zero = torch.zeros((), dtype=resF.dtype, device=dev)
    resF = torch.where(zm[..., None], resF, zero)
    Jxi = torch.where(zm[..., None, None], Jxi, zero)
    Jc = torch.where(zm[..., None, None], Jc, zero)
    Jd = torch.where(zm[..., None], Jd, zero)

    center = torch.stack([Ku, Kv, new_idepth], -1)
    return dict(resF=resF, Jxi=Jxi, Jc=Jc, Jd=Jd, new_state=new_state,
                energy=torch.where(proj_ok & matcher_valid & res_active,
                                   energy2d, zero),
                energy_phot=energy_phot, wJI2=wJI2, center=center,
                proj_ok=proj_ok)


def _stitch(Hpair, bpair, adH, adT, F, dtype):
    """Transport per-pair (10x10, 10) blocks [calib(4), relpose(6)] of L
    windows (Hpair (L, F*F, 10, 10)) to the absolute (4+6F) systems
    (stitchDouble, AccumulatedTopHessian.cpp)."""
    L = Hpair.shape[0]
    dev = Hpair.device
    D = CPARS + 6 * F
    Hcc = Hpair[:, :, :4, :4]
    Hcx = Hpair[:, :, :4, 4:]
    Hxx = Hpair[:, :, 4:, 4:]
    bc = bpair[:, :, :4]
    bx = bpair[:, :, 4:]
    H = torch.zeros((L, D, D), dtype=dtype, device=dev)
    b = torch.zeros((L, D), dtype=dtype, device=dev)
    H[:, :4, :4] += Hcc.sum(1)
    b[:, :4] += bc.sum(1)

    AH_Hxx = adH @ Hxx
    AT_Hxx = adT @ Hxx
    hh = AH_Hxx @ adH.transpose(-1, -2)
    tt = AT_Hxx @ adT.transpose(-1, -2)
    ht = AH_Hxx @ adT.transpose(-1, -2)
    hc = adH @ Hcx.transpose(-1, -2)
    tc = adT @ Hcx.transpose(-1, -2)
    bh = torch.einsum("lpij,lpj->lpi", adH, bx)
    bt = torch.einsum("lpij,lpj->lpi", adT, bx)

    # pairs are laid out pair = host * F + target (make_pairs), so the
    # scatter-adds over host / target are sums over one axis of an (F, F)
    # grid: deterministic, no atomics
    def grid(x):
        return x.reshape((L, F, F) + x.shape[2:])

    eye_f = torch.eye(F, dtype=dtype, device=dev)
    Hdiag = (eye_f[:, :, None, None]
             * (grid(hh).sum(2) + grid(tt).sum(1))[:, :, None])
    Mfc = grid(hc).sum(2) + grid(tc).sum(1)
    bf = grid(bh).sum(2) + grid(bt).sum(1)

    Hd_flat = Hdiag.permute(0, 1, 3, 2, 4).reshape(L, 6 * F, 6 * F)
    Mo_flat = grid(ht).permute(0, 1, 3, 2, 4).reshape(L, 6 * F, 6 * F)
    H[:, 4:, 4:] += Hd_flat + Mo_flat + Mo_flat.transpose(1, 2)
    H[:, 4:, :4] += Mfc.reshape(L, 6 * F, 4)
    H[:, :4, 4:] += Mfc.reshape(L, 6 * F, 4).transpose(1, 2)
    b[:, 4:] += bf.reshape(L, 6 * F)
    return H, b


def _one_hot(idx, n: int):
    """`torch.nn.functional.one_hot(idx, n)` for indices in [0, n), with no
    host read of the indices' range (the CPU one_hot reads it)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(
        torch.int64)


def _accumulate(Jc, Jxi, Jd, resF, active, pt_host, pt_is_sensor,
                pt_prior, sc_mask, pairs, F):
    """Shared body of build_system / marginalize_points for L windows:
    per-pair blocks, stitch, per-point depth terms and the Schur
    complement over the points in `sc_mask`. CPU -> the plain version
    (`_accumulate_plain`); CUDA -> K8 (`hopper_kernels.ba_accumulate`)."""
    if resF.device.type == "cpu":
        return _accumulate_plain(
            Jc, Jxi, Jd, resF, active, pt_host, pt_is_sensor, pt_prior,
            sc_mask, pairs, F)
    return hopper_kernels.ba_accumulate(
        Jc, Jxi, Jd, resF, active, pt_host, pt_is_sensor, pt_prior, sc_mask,
        pairs["adH"], pairs["adT"], F)


def _accumulate_plain(Jc, Jxi, Jd, resF, active, pt_host, pt_is_sensor,
                      pt_prior, sc_mask, pairs, F):
    """K8's plain version: `_accumulate` in tensor operations (a one-hot
    pair product, gathered per-residual adjoints)."""
    L, N = resF.shape[:2]
    dev = resF.device
    dtype = resF.dtype
    pt_host = pt_host.long()
    pair_idx = _pair_rows(pt_host, F).reshape(L, N * F)
    Jgeo = torch.cat([Jc, Jxi], dim=-1).reshape(L, N * F, 2, 10)
    res_f = resF.reshape(L, N * F, 2)
    outer = torch.einsum("lrai,lraj->lrij", Jgeo, Jgeo).reshape(
        L, N * F, 100)
    onehot_t = _one_hot(pair_idx, F * F).to(dtype).transpose(1, 2)
    Hpair = (onehot_t @ outer).reshape(L, F * F, 10, 10)
    bout = torch.einsum("lrai,lra->lri", Jgeo, res_f)
    bpair = onehot_t @ bout
    H_top, b_top = _stitch(Hpair, bpair, pairs["adH"], pairs["adT"], F,
                           dtype)

    Hdd = torch.einsum("lnfa,lnfa->ln", Jd, Jd) + pt_prior
    bd = torch.einsum("lnfa,lnfa->ln", Jd, resF)
    Hcd = torch.einsum("lnfai,lnfa->lni", Jc, Jd)
    JpJd = torch.einsum("lnfai,lnfa->lnfi", Jxi, Jd)
    n_act = active.sum(-1)
    HdiF = torch.where(n_act > 0, 1.0 / torch.clamp(Hdd, min=1e-10),
                       torch.zeros_like(Hdd))

    adH_p = _take(pairs["adH"].reshape(L, F, F, 6, 6), pt_host)
    adT_p = _take(pairs["adT"].reshape(L, F, F, 6, 6), pt_host)
    vh = torch.einsum("lnfij,lnfj->lnfi", adH_p, JpJd)
    vt = torch.einsum("lnfij,lnfj->lnfi", adT_p, JpJd)
    host_onehot = _one_hot(pt_host, F).to(dtype)
    Vframes = vt + host_onehot[..., None] * vh.sum(dim=2)[:, :, None, :]
    Vpt = torch.cat([Hcd, Vframes.reshape(L, N, 6 * F)], dim=-1)

    sc_ok = sc_mask & (~pt_is_sensor) & (n_act > 0)
    wsc = torch.where(sc_ok, HdiF, torch.zeros_like(HdiF))
    H_sc = (Vpt * wsc[..., None]).transpose(1, 2) @ Vpt
    b_sc = _mv(Vpt.transpose(1, 2), wsc * bd)
    return H_top, b_top, H_sc, b_sc, Hdd, bd, HdiF, Vpt, n_act


def build_system(lin, pt_host, pt_is_sensor, pt_prior, pairs,
                 frame_delta, c_delta, n_frames: int):
    """Accumulate the absolute H, b and the Schur-complement terms.
    Returns dict(H_top, b_top, H_sc, b_sc, Hdd, bd, HdiF, Vpt, n_active,
    e_quad)."""
    out = build_system_lanes(
        {k: v[None] for k, v in lin.items()}, pt_host[None],
        pt_is_sensor[None], pt_prior[None], _lane0(pairs), frame_delta[None],
        c_delta[None], n_frames=n_frames)
    return {k: v[0] for k, v in out.items()}


def build_system_lanes(lin, pt_host, pt_is_sensor, pt_prior, pairs,
                       frame_delta, c_delta, n_frames: int):
    """`build_system` of L windows (every field with a leading L)."""
    active = lin["new_state"] == RES_IN
    resF = torch.where(active[..., None], lin["resF"],
                       torch.zeros((), dtype=lin["resF"].dtype,
                                   device=pt_host.device))
    H_top, b_top, H_sc, b_sc, Hdd, bd, HdiF, Vpt, n_act = _accumulate(
        lin["Jc"], lin["Jxi"], lin["Jd"], resF, active, pt_host,
        pt_is_sensor, pt_prior, torch.ones_like(pt_is_sensor), pairs,
        n_frames)
    return dict(H_top=H_top, b_top=b_top, H_sc=H_sc, b_sc=b_sc, Hdd=Hdd,
                bd=bd, HdiF=HdiF, Vpt=Vpt, n_active=n_act,
                e_quad=torch.sum(resF * resF, dim=(1, 2, 3)))


def make_nullspaces(T_cw_fej, frame_valid):
    """(D, 7) nullspace matrix: 6 gauge + 1 scale (getNullspaces); lane
    stacks (L, F, 4, 4) / (L, F) give (L, D, 7)."""
    single = T_cw_fej.dim() == 3
    T = T_cw_fej[None] if single else T_cw_fej
    fv = frame_valid[None] if single else frame_valid
    L, F = T.shape[:2]
    D = CPARS + 6 * F
    Ad = se3.adjoint(T)
    t = T[..., :3, 3]
    scale_col = torch.cat([t, torch.zeros_like(t)], -1)
    cols = torch.cat([Ad, scale_col[..., None]], -1)
    cols = cols * fv[..., None, None]
    Ns = torch.zeros((L, D, 7), dtype=T.dtype, device=T.device)
    Ns[:, 4:, :] = cols.reshape(L, 6 * F, 7)
    return Ns[0] if single else Ns


def orthogonalize(vec, Ns):
    """Project `vec` (L, D) off span(Ns) (L, D, 7) per lane (modified
    Gram-Schmidt, near-dependent columns dropped)."""
    norms = torch.linalg.vector_norm(Ns, dim=1, keepdim=True)
    Nn = Ns / torch.clamp(norms, min=1e-12)
    Q = torch.zeros_like(Nn)

    def proj(v):
        return _mv(Q, _mv(Q.transpose(1, 2), v))
    for j in range(Nn.shape[2]):
        v = Nn[:, :, j]
        v = v - proj(v)
        nv = torch.linalg.vector_norm(v, dim=1, keepdim=True)
        Q[:, :, j] = torch.where(nv > 1e-5, v / torch.clamp(nv, min=1e-12),
                                 torch.zeros_like(v))
    return vec - proj(vec)


def solve_system(sys_, HM, bM, delta_stitched, c_prior, c_delta,
                 frame_prior, frame_delta, frame_valid, nullspaces,
                 lam, pt_host, pt_is_sensor, pairs, n_frames: int,
                 orthogonalize_x=True, diag_floor_rel=0.0, solve_dtype=None):
    """Assemble the final system and solve (solveSystemF:650-759) +
    resubstitute the idepth steps. `lam` is a host float. Lane 0 of
    `solve_system_lanes`. Returns dict(x, dc, dframes, didepth)."""
    out = solve_system_lanes(
        {k: v[None] for k, v in sys_.items()}, HM[None], bM[None],
        delta_stitched[None], c_prior[None], c_delta[None],
        frame_prior[None], frame_delta[None], frame_valid[None],
        nullspaces[None], torch.tensor([float(lam)], dtype=torch.float64,
                                       device=HM.device),
        pt_host[None], pt_is_sensor[None], _lane0(pairs), n_frames=n_frames,
        orthogonalize_x=orthogonalize_x, diag_floor_rel=diag_floor_rel,
        solve_dtype=solve_dtype)
    return {k: v[0] for k, v in out.items()}


def solve_system_lanes(sys_, HM, bM, delta_stitched, c_prior, c_delta,
                       frame_prior, frame_delta, frame_valid, nullspaces,
                       lam, pt_host, pt_is_sensor, pairs, n_frames: int,
                       orthogonalize_x=True, diag_floor_rel=0.0,
                       solve_dtype=None):
    """`solve_system` of L windows; `lam` is an (L,) float64 tensor (the
    host float of one window's LM, kept per lane on the device), and
    `diag_floor_rel` a host float or an (L,) float64 tensor of the same
    values (the product with `lam` is the same either way). The dense
    solve runs window by window, so each lane uses the solver library a
    single window uses whatever L is (a batched call may pick another
    library, whose last bits the windowed BA amplifies)."""
    F = n_frames
    D = CPARS + 6 * F
    L = HM.shape[0]
    dev = HM.device
    dtype = sys_["H_top"].dtype
    ar = torch.arange(D, device=dev)

    H = sys_["H_top"] - sys_["H_sc"] + HM
    b = sys_["b_top"] - sys_["b_sc"] + \
        (bM + _mv(HM, delta_stitched))
    H[:, ar[:4], ar[:4]] += c_prior
    b[:, :4] += c_prior * c_delta
    fp = frame_prior.reshape(L, 6 * F)
    fd = frame_delta.reshape(L, 6 * F)
    H[:, ar[4:], ar[4:]] += fp
    b[:, 4:] += fp * fd

    slot_mask = torch.cat([torch.ones((L, 4), dtype=torch.bool, device=dev),
                           frame_valid.to(torch.bool)[..., None]
                           .expand(L, F, 6).reshape(L, 6 * F)], 1)
    zero = torch.zeros((), dtype=dtype, device=dev)
    H = torch.where(slot_mask[:, :, None] & slot_mask[:, None, :], H, zero)
    H[:, ar, ar] += torch.where(slot_mask, zero, torch.ones_like(zero))
    b = torch.where(slot_mask, b, zero)

    diag = torch.diagonal(H, dim1=1, dim2=2)
    Hd = H.clone()
    # (1 + lam) and lam * floor in float64, rounded once to the system's
    # dtype: what one window's python-float arithmetic does
    Hd[:, ar, ar] = diag * (1.0 + lam).to(dtype)[:, None]
    smf = slot_mask.to(dtype)
    dmean = torch.sum(torch.abs(diag) * smf, 1) / \
        torch.clamp(smf.sum(1), min=1.0)
    floor = diag_floor_rel if isinstance(diag_floor_rel, torch.Tensor) \
        else float(diag_floor_rel)
    Hd[:, ar, ar] += (lam * floor).to(dtype)[:, None] * dmean[:, None] * smf
    SVecI = 1.0 / torch.sqrt(torch.abs(torch.diagonal(Hd, dim1=1, dim2=2))
                             + 10.0)
    Hs = Hd * SVecI[:, :, None] * SVecI[:, None, :]
    bs = b * SVecI
    sdt = dtype if solve_dtype is None else getattr(torch, solve_dtype)
    A = (Hs + torch.eye(D, dtype=dtype, device=dev) * 1e-12).to(sdt)
    bsd = bs.to(sdt)
    x = SVecI * torch.stack([torch.linalg.solve_ex(A[i], bsd[i])[0]
                             for i in range(L)]).to(dtype)

    if orthogonalize_x:
        x = orthogonalize(x, nullspaces)

    dc = -x[:, :4]
    dframes = -x[:, 4:].reshape(L, F, 6) * frame_valid[..., None]
    b_pt = sys_["bd"] - _mv(sys_["Vpt"], x)
    step = -b_pt * sys_["HdiF"]
    step = torch.where(pt_is_sensor | (sys_["n_active"] == 0),
                       torch.zeros_like(step), step)
    return dict(x=x, dc=dc, dframes=dframes, didepth=step)


def marg_energy(HM, bM, delta_stitched):
    """calcMEnergyF (EnergyFunctional.cpp:284-293), per lane of (L, D)."""
    q = 2.0 * bM + _mv(HM, delta_stitched)
    return torch.stack([delta_stitched[i] @ q[i]
                        for i in range(q.shape[0])])


def prior_energy(c_prior, c_delta, frame_prior, frame_delta):
    """Prior quadratic terms of calcLEnergyF_MT, per lane."""
    return torch.sum(c_prior * c_delta * c_delta, 1) + \
        torch.sum(frame_prior * frame_delta * frame_delta, dim=(1, 2))


def marginalize_points(lin, pt_host, pt_is_sensor, pt_prior_marg, marg_mask,
                       frame_delta, c_delta, pairs, n_frames: int,
                       marg_weight_fac: float = 0.25):
    """Marginalize flagged points into (dHM, dbM) (marginalizePointsF with
    res_toZeroF = resF - J * delta)."""
    dH, db = marginalize_points_lanes(
        {k: v[None] for k, v in lin.items()}, pt_host[None],
        pt_is_sensor[None], pt_prior_marg[None], marg_mask[None],
        frame_delta[None], c_delta[None], _lane0(pairs), n_frames=n_frames,
        marg_weight_fac=marg_weight_fac)
    return dH[0], db[0]


def marginalize_points_lanes(lin, pt_host, pt_is_sensor, pt_prior_marg,
                             marg_mask, frame_delta, c_delta, pairs,
                             n_frames: int, marg_weight_fac: float = 0.25):
    """`marginalize_points` of L windows -> (L, D, D), (L, D)."""
    F = n_frames
    dev = pt_host.device
    active = (lin["new_state"] == RES_IN) & marg_mask[..., None]
    hi, ti = pairs["host"], pairs["target"]
    dp_pair = torch.einsum("lpj,lpji->lpi", frame_delta[:, hi],
                           pairs["adH"]) + \
        torch.einsum("lpj,lpji->lpi", frame_delta[:, ti], pairs["adT"])
    dp = _take(dp_pair, _pair_rows(pt_host, F))
    Jp_delta = torch.einsum("lnfai,lnfi->lnfa", lin["Jxi"], dp) + \
        torch.einsum("lnfai,li->lnfa", lin["Jc"], c_delta)
    zero = torch.zeros((), dtype=lin["resF"].dtype, device=dev)
    res_tz = torch.where(active[..., None], lin["resF"] - Jp_delta, zero)
    Jxi_m = torch.where(active[..., None, None], lin["Jxi"], zero)
    Jc_m = torch.where(active[..., None, None], lin["Jc"], zero)
    Jd_m = torch.where(active[..., None], lin["Jd"], zero)
    H_top, b_top, H_sc, b_sc, *_ = _accumulate(
        Jc_m, Jxi_m, Jd_m, res_tz, active, pt_host, pt_is_sensor,
        pt_prior_marg, marg_mask, pairs, F)
    return marg_weight_fac * (H_top - H_sc), marg_weight_fac * (b_top - b_sc)


def marginalize_frame(HM, bM, frame_prior_slot, frame_delta_slot, slot: int,
                      n_frames: int):
    """Schur-eliminate one frame slot from the marginalization prior
    (marginalizeFrame), then zero the slot. One window's (D, D) prior; a
    fleet calls it once per flagged (lane, slot) pair."""
    D = HM.shape[0]
    dev = HM.device
    kidx = CPARS + 6 * slot + torch.arange(6, device=dev)
    HM = HM.clone()
    bM = bM.clone()
    HM[kidx, kidx] += frame_prior_slot
    bM[kidx] += frame_prior_slot * frame_delta_slot

    SVec = torch.sqrt(torch.abs(torch.diagonal(HM)) + 10.0)
    SVecI = 1.0 / SVec
    Hs = HM * SVecI[:, None] * SVecI[None, :]
    bs = bM * SVecI
    Hkk = Hs[kidx][:, kidx]
    Hkk = 0.5 * (Hkk + Hkk.T)
    Hkk_inv = torch.linalg.inv_ex(
        Hkk + torch.eye(6, dtype=HM.dtype, device=dev) * 1e-10)[0]
    Hkk_inv = 0.5 * (Hkk_inv + Hkk_inv.T)
    C = Hs[:, kidx]
    Hs_new = Hs - C @ Hkk_inv @ C.T
    bs_new = bs - C @ (Hkk_inv @ bs[kidx])
    HM_new = Hs_new * SVec[:, None] * SVec[None, :]
    bM_new = bs_new * SVec
    HM_new = 0.5 * (HM_new + HM_new.T)
    ar = torch.arange(D, device=dev)
    mask = (ar < CPARS + 6 * slot) | (ar >= CPARS + 6 * slot + 6)
    zero = torch.zeros((), dtype=HM.dtype, device=dev)
    return (torch.where(mask[:, None] & mask[None, :], HM_new, zero),
            torch.where(mask, bM_new, zero))


def frame_energy_quantile(energy_phot, mask, q: float = 0.7):
    """setNewFrameEnergyTH: q-quantile of the newest frame's gate
    energies, blended with a constant and squared; (L, N) -> (L,)."""
    e = torch.where(mask, energy_phot, torch.full_like(energy_phot,
                                                       float("inf")))
    order = torch.sort(e, dim=1)[0]
    n = mask.sum(1)
    nth = torch.clamp((q * n).to(torch.int64), 0, e.shape[1] - 1)
    nth_val = torch.sqrt(torch.clamp(order.gather(1, nth[:, None])[:, 0],
                                     min=0.0))
    th = nth_val * 1.5
    th = 26.0 * 0.5 + th * 0.5
    th = th * th
    return torch.where(n > 0, th, torch.full_like(th, 12.0 * 12.0 * 8.0))


def stitched_delta(c_delta, eps, frame_valid):
    """Per lane: [c_delta (L, 4), eps * valid (L, F*6)]."""
    return torch.cat([c_delta, (eps * frame_valid[..., None]).reshape(
        eps.shape[0], -1)], 1)


def _expT(eps, T_cw_fej):
    return se3.se3_exp(eps) @ T_cw_fej


def _where_lanes(mask, new, old):
    """Per-lane select (mask (L,)) over tensors or dicts of tensors with a
    leading L; shared pair indices pass through."""
    if isinstance(new, dict):
        return {k: (new[k] if k in _SHARED_PAIR_KEYS
                    else _where_lanes(mask, new[k], old[k])) for k in new}
    return torch.where(mask.reshape((-1,) + (1,) * (new.dim() - 1)), new,
                       old)


def _at_newest(x, newest):
    """x (L, N, F, ...) at each lane's newest column -> (L, N, ...)."""
    return x[torch.arange(x.shape[0], device=x.device), :, newest]


def ba_core(T_cw_fej, eps, calib, calib_zero, frame_valid,
            frame_prior, c_prior, aff, exposure, HM, bM, newest,
            frame_energy_th, pt_u, pt_v, pt_idepth, pt_host,
            pt_color, pt_weights, pt_is_sensor, pt_prior,
            res_active, res_state, matcher_px, matcher_valid,
            dI0_stack, max_iters, min_opt_iterations,
            th_opt_iterations, force_accept,
            n_frames: int, w: int, h: int,
            gate_refresh: bool = False, resf_at_fej: bool = True,
            lm_diag_floor=0.0, solve_dtype=None):
    """The whole windowed LM (FullSystem::optimize) of one window: lane 0
    of `ba_core_lanes`. `newest`, `max_iters` and the other scalars are
    host values. Returns (out dict, lin_f, pairs_f)."""
    out, lin_f, pairs_f = ba_core_lanes(
        *(x[None] for x in (T_cw_fej, eps, calib, calib_zero, frame_valid,
                            frame_prior, c_prior, aff, exposure, HM, bM)),
        [newest], frame_energy_th[None],
        *(x[None] for x in (pt_u, pt_v, pt_idepth, pt_host, pt_color,
                            pt_weights, pt_is_sensor, pt_prior, res_active,
                            res_state, matcher_px, matcher_valid,
                            dI0_stack)),
        [max_iters], [min_opt_iterations], [th_opt_iterations],
        [force_accept], n_frames=n_frames, w=w, h=h,
        gate_refresh=gate_refresh, resf_at_fej=resf_at_fej,
        lm_diag_floor=lm_diag_floor, solve_dtype=solve_dtype)
    return ({k: v[0] for k, v in out.items()},
            {k: v[0] for k, v in lin_f.items()}, _unlane(pairs_f))


_BA_LIN_KEYS = ("resF", "Jxi", "Jc", "Jd", "new_state")


def _ba_pair_keys(gate_refresh):
    return ("adH", "adT") + (("KRKi", "Kt", "aff_a", "aff_b")
                             if gate_refresh else ())


def _ba_linearize(x, eps_, calib_, idepth_, feth_, gate, quad12, F, w, h,
                  img, gate_refresh, resf_at_fej, **_):
    """The BA's pairs and residual linearization at (eps, calib, idepth)
    from a loop's inputs `x`."""
    L = eps_.shape[0]
    pairs = make_pairs_lanes(_expT(eps_, x["T_cw_fej"]), x["T_cw_fej"],
                             x["aff"], x["exposure"], calib_)
    # the image stack's shape (quad12 holds its pixels)
    shape = torch.zeros((), device=eps_.device).expand((L, F) + img + (3,))
    lin = linearize_residuals_lanes(
        x["pt_u"], x["pt_v"], idepth_, x["pt_host"], x["pt_color"],
        x["pt_weights"], x["res_active"], x["res_state"], x["matcher_px"],
        x["matcher_valid"], pairs, shape, feth_, calib_, w=w, h=h,
        gate=gate, resf_at_fej=resf_at_fej, quad12=quad12)
    return lin, pairs


def _ba_update_feth(x, lin, feth_):
    ar = torch.arange(feth_.shape[0], device=feth_.device)
    newest = x["newest"]
    mask = _at_newest(x["res_active"], newest) & \
        (_at_newest(lin["new_state"], newest) != RES_OOB)
    out = feth_.clone()
    out[ar, newest] = frame_energy_quantile(
        _at_newest(lin["energy_phot"], newest), mask)
    return out


def _ba_total_energy(x, lin, eps_, calib_):
    c_delta = calib_ - x["calib_zero"]
    fvalid_f = x["fvalid_f"]
    dstt = stitched_delta(c_delta, eps_, fvalid_f)
    return (torch.sum(lin["energy"], dim=(1, 2))
            + marg_energy(x["HM"], x["bM"], dstt)
            + prior_energy(x["c_prior"], c_delta, x["frame_prior"],
                           eps_ * fvalid_f[..., None]))


def _ba_body(x, st, F, w, h, img, gate_refresh, resf_at_fej, solve_dtype,
             orthogonalize):
    """One windowed-LM iteration of every lane (FullSystem::optimize's
    loop body); a lane that has stopped keeps every carry."""
    static = dict(F=F, w=w, h=h, img=img, gate_refresh=gate_refresh,
                  resf_at_fej=resf_at_fej)
    quad12 = x.get("quad12")
    eps, calib, idepth, feth = st["eps"], st["calib"], st["idepth"], \
        st["feth"]
    lam, active, it = st["lam"], st["active"], st["it"]
    lin = {k: st["lin_" + k] for k in _BA_LIN_KEYS}
    pairs = {k: st["pairs_" + k] for k in _ba_pair_keys(gate_refresh)}
    gate = (st["gate_e"], st["gate_w"]) if gate_refresh else \
        (x["gate_e"], x["gate_w"])
    fvalid_f, frame_valid = x["fvalid_f"], x["frame_valid"]
    pt_host, pt_is_sensor = x["pt_host"], x["pt_is_sensor"]

    c_delta = calib - x["calib_zero"]
    fd = eps * fvalid_f[..., None]
    sys_ = build_system_lanes(lin, pt_host, pt_is_sensor, x["pt_prior"],
                              pairs, fd, c_delta, n_frames=F)
    sol = solve_system_lanes(
        sys_, x["HM"], x["bM"], stitched_delta(c_delta, eps, fvalid_f),
        x["c_prior"], c_delta, x["frame_prior"], fd, frame_valid,
        x["nullspaces"], lam, pt_host, pt_is_sensor, pairs, n_frames=F,
        orthogonalize_x=orthogonalize, diag_floor_rel=x["diag_floor"],
        solve_dtype=solve_dtype)
    eps_n = eps + sol["dframes"]
    calib_n = calib + sol["dc"]
    idepth_n = torch.where(pt_is_sensor, idepth, idepth + sol["didepth"])
    lin_n, pairs_n = _ba_linearize(x, eps_n, calib_n, idepth_n, feth, gate,
                                   quad12, **static)
    feth_n = _ba_update_feth(x, lin_n, feth)
    E_new = _ba_total_energy(x, lin_n, eps_n, calib_n)

    d = sol["dframes"]
    nvf = x["n_valid_frames"]
    sumT = torch.sum(d[..., :3] ** 2, dim=(1, 2)).to(torch.float64) / nvf
    sumR = torch.sum(d[..., 3:] ** 2, dim=(1, 2)).to(torch.float64) / nvf
    brk = x["brk"]
    canbreak = (torch.sqrt(sumR) < brk) & (torch.sqrt(sumT) < brk)
    accept = (E_new < st["E_last"]) | x["forced"]
    acc = accept & active
    out = dict(eps=_where_lanes(acc, eps_n, eps),
               calib=_where_lanes(acc, calib_n, calib),
               idepth=_where_lanes(acc, idepth_n, idepth),
               feth=_where_lanes(acc, feth_n, feth),
               E_last=_where_lanes(acc, E_new, st["E_last"]),
               lam=torch.where(active, torch.where(accept, lam * 0.25,
                                                   lam * 1e2), lam))
    out.update({"lin_" + k: _where_lanes(acc, lin_n[k], lin[k])
                for k in _BA_LIN_KEYS})
    out.update({"pairs_" + k: _where_lanes(acc, pairs_n[k], pairs[k])
                for k in pairs})
    if gate_refresh:
        pairs_a = {k: out["pairs_" + k] for k in pairs}
        ge, gw = photometric_gate_lanes(
            x["pt_u"], x["pt_v"], out["idepth"], pt_host, x["pt_color"],
            x["pt_weights"], pairs_a,
            torch.zeros((), device=eps.device).expand(
                (eps.shape[0], F) + img + (3,)), w=w, h=h, quad12=quad12)
        out.update(gate_e=_where_lanes(acc, ge, gate[0]),
                   gate_w=_where_lanes(acc, gw, gate[1]))
    out["lm_iters"] = st["lm_iters"] + active.to(torch.int64)
    act_n = active & ~(canbreak & (it >= x["min_it"])) & \
        (it + 1 < x["max_it"])
    out.update(active=act_n, it=it + active.any().to(torch.int64))
    return out, act_n.any()


def ba_controls(newest, max_iters, min_opt_iterations, th_opt_iterations,
                force_accept, lm_diag_floor, device):
    """The windowed LM's per-lane controls as device tensors (L,), made on
    the host from per-lane host lists with the expressions one window forms
    them with: the newest slot, the iteration budget and minimum, the
    break threshold (a float64 product of host floats), the forced accept
    and the LM diagonal floor."""
    return dict(
        newest=torch.as_tensor([int(x) for x in newest], device=device),
        max_it=torch.as_tensor([int(v) for v in max_iters], device=device),
        min_it=torch.as_tensor([int(v) for v in min_opt_iterations],
                               device=device),
        brk=torch.tensor([0.00005 * float(t) for t in th_opt_iterations],
                         dtype=torch.float64, device=device),
        forced=torch.as_tensor([bool(v) for v in force_accept],
                               device=device),
        diag_floor=torch.tensor([float(f) for f in lm_diag_floor],
                                dtype=torch.float64, device=device))


def ba_core_lanes(T_cw_fej, eps, calib, calib_zero, frame_valid,
                  frame_prior, c_prior, aff, exposure, HM, bM, newest,
                  frame_energy_th, pt_u, pt_v, pt_idepth, pt_host,
                  pt_color, pt_weights, pt_is_sensor, pt_prior,
                  res_active, res_state, matcher_px, matcher_valid,
                  dI0_stack, max_iters, min_opt_iterations,
                  th_opt_iterations, force_accept,
                  n_frames: int, w: int, h: int,
                  gate_refresh: bool = False, resf_at_fej: bool = True,
                  lm_diag_floor=0.0, solve_dtype=None):
    """The windowed LM of L windows at once (the JAX package's vmapped
    `ba_core`). Tensors carry a leading L; `newest`, `max_iters`,
    `min_opt_iterations`, `th_opt_iterations` and `force_accept` are
    per-lane host lists, `lm_diag_floor` a host float. Each lane keeps its
    own lambda, accept and break state and iteration count; the loop runs
    until every lane has stopped (fleet-max iterations), a stopped lane's
    carries frozen, through `device_loop.run` (graph replays on CUDA; one
    host read per replay for the whole fleet). `out["lm_iters"]` counts
    the iterations each lane ran. Returns (out dict, lin_f, pairs_f), each
    with a leading L."""
    L = T_cw_fej.shape[0]
    ctl = ba_controls(newest, max_iters, min_opt_iterations,
                      th_opt_iterations, force_accept,
                      [lm_diag_floor] * L, T_cw_fej.device)
    return ba_core_ctl(
        T_cw_fej, eps, calib, calib_zero, frame_valid, frame_prior, c_prior,
        aff, exposure, HM, bM, frame_energy_th, pt_u, pt_v, pt_idepth,
        pt_host, pt_color, pt_weights, pt_is_sensor, pt_prior, res_active,
        res_state, matcher_px, matcher_valid, dI0_stack, ctl,
        n_frames=n_frames, w=w, h=h,
        iter_cap=max((int(v) for v in max_iters), default=0),
        gate_refresh=gate_refresh, resf_at_fej=resf_at_fej,
        solve_dtype=solve_dtype)


def ba_core_ctl(T_cw_fej, eps, calib, calib_zero, frame_valid, frame_prior,
                c_prior, aff, exposure, HM, bM, frame_energy_th, pt_u, pt_v,
                pt_idepth, pt_host, pt_color, pt_weights, pt_is_sensor,
                pt_prior, res_active, res_state, matcher_px, matcher_valid,
                dI0_stack, ctl, n_frames: int, w: int, h: int, iter_cap: int,
                gate_refresh: bool = False, resf_at_fej: bool = True,
                solve_dtype=None):
    """`ba_core_lanes` with its per-lane controls on the device (`ctl`,
    from `ba_controls`) and `iter_cap`, a static bound on every lane's
    budget: no host value enters, so the keyframe program runs it
    (`kf_ops.kf_opt_step_lanes`). Each lane stops at its own budget on the
    device, so any cap at or above the largest budget gives the same
    result."""
    F = n_frames
    L = T_cw_fej.shape[0]
    dev = T_cw_fej.device
    fvalid_f = frame_valid.to(T_cw_fej.dtype)
    quad12 = stack_quad12(dI0_stack)
    newest_t = ctl["newest"]
    x = dict(T_cw_fej=T_cw_fej, calib_zero=calib_zero,
             frame_valid=frame_valid, fvalid_f=fvalid_f,
             frame_prior=frame_prior, c_prior=c_prior, aff=aff,
             exposure=exposure, HM=HM, bM=bM, newest=newest_t, pt_u=pt_u,
             pt_v=pt_v, pt_host=pt_host, pt_color=pt_color,
             pt_weights=pt_weights, pt_is_sensor=pt_is_sensor,
             pt_prior=pt_prior, res_active=res_active, res_state=res_state,
             matcher_px=matcher_px, matcher_valid=matcher_valid,
             diag_floor=ctl["diag_floor"])
    static = dict(F=F, w=w, h=h, img=tuple(dI0_stack.shape[2:4]),
                  gate_refresh=bool(gate_refresh),
                  resf_at_fej=bool(resf_at_fej), solve_dtype=solve_dtype)
    if gate_refresh:
        x["quad12"] = quad12

    lin0, _ = _ba_linearize(x, eps, calib, pt_idepth, frame_energy_th, None,
                            quad12, **static)
    gate = (lin0["energy_phot"], lin0["wJI2"])
    feth = _ba_update_feth(x, lin0, frame_energy_th)
    lin, pairs = _ba_linearize(x, eps, calib, pt_idepth, feth, gate, quad12,
                               **static)
    x.update(nullspaces=make_nullspaces(T_cw_fej, fvalid_f),
             n_valid_frames=torch.clamp(frame_valid.to(torch.int64).sum(1),
                                        min=1).to(torch.float64),
             brk=ctl["brk"], min_it=ctl["min_it"], max_it=ctl["max_it"],
             forced=ctl["forced"])
    st = dict(eps=eps, calib=calib, idepth=pt_idepth, feth=feth,
              E_last=_ba_total_energy(x, lin, eps, calib),
              lam=torch.full((L,), 1e-1, dtype=torch.float64, device=dev),
              active=x["max_it"] > 0,
              lm_iters=torch.zeros(L, dtype=torch.int64, device=dev),
              it=torch.zeros((), dtype=torch.int64, device=dev))
    st.update({"lin_" + k: lin[k] for k in _BA_LIN_KEYS})
    st.update({"pairs_" + k: pairs[k]
               for k in _ba_pair_keys(gate_refresh)})
    if gate_refresh:
        st.update(gate_e=gate[0], gate_w=gate[1])
    else:
        x.update(gate_e=gate[0], gate_w=gate[1])

    # iterations 0-1 solve without the nullspace projection, the rest with
    # it: one loop each, the second entered where a lane is still running
    # (a host read in the stage form, an IF node in a program)
    st = device_loop.run("ba0", _ba_body, x, st, min(2, iter_cap),
                         dict(static, orthogonalize=False))
    if iter_cap > 2:
        st = device_loop.cond(
            "ba", st["active"].any(),
            lambda c: device_loop.run("ba", _ba_body, x, c, iter_cap - 2,
                                      dict(static, orthogonalize=True)), st)
    eps, calib, idepth, feth = st["eps"], st["calib"], st["idepth"], \
        st["feth"]
    E_last, lm_iters = st["E_last"], st["lm_iters"]

    # fix the newest frame's eval point, then the final linearization
    T_cw = _expT(eps, T_cw_fej)
    at_newest = (torch.arange(F, device=dev) == newest_t[:, None])[..., None]
    T_cw_fej_out = torch.where(at_newest[..., None], T_cw, T_cw_fej)
    eps_out = torch.where(at_newest, torch.zeros((), dtype=eps.dtype,
                                                 device=dev), eps)
    pairs_f = make_pairs_lanes(_expT(eps_out, T_cw_fej_out), T_cw_fej_out,
                               aff, exposure, calib)
    lin_f = linearize_residuals_lanes(
        pt_u, pt_v, idepth, pt_host, pt_color, pt_weights, res_active,
        res_state, matcher_px, matcher_valid, pairs_f, dI0_stack, feth,
        calib, w=w, h=h, resf_at_fej=resf_at_fej, quad12=quad12)
    sys_f = build_system_lanes(lin_f, pt_host, pt_is_sensor, pt_prior,
                               pairs_f, eps_out * fvalid_f[..., None],
                               calib - calib_zero, n_frames=F)
    rmse = torch.sqrt(torch.sum(lin_f["energy"], dim=(1, 2))
                      / torch.clamp((lin_f["new_state"] == RES_IN)
                                    .sum(dim=(1, 2)), min=1))
    # the final assembled system and the nullspaces, exported for the
    # deep-log streams (FullSystem.cpp:1419-1499)
    out = dict(eps=eps_out, calib=calib, idepth=idepth, feth=feth,
               T_cw_fej=T_cw_fej_out, new_state=lin_f["new_state"],
               center=lin_f["center"], Hdd=sys_f["Hdd"], energy=E_last,
               rmse=rmse, lm_iters=lm_iters,
               H_final=sys_f["H_top"] - sys_f["H_sc"] + HM,
               b_final=sys_f["b_top"] - sys_f["b_sc"] + bM,
               nullspaces=make_nullspaces(T_cw_fej_out, fvalid_f))
    return out, lin_f, pairs_f
