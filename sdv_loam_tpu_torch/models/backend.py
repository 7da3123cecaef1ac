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
from sdv_loam_tpu_torch.ops.align import _quad_bilinear
from sdv_loam_tpu_torch.ops.trace import stack_quad12
from sdv_loam_tpu_torch.utils import se3

RES_IN = 0
RES_OOB = 1
RES_OUTLIER = 2


def _bmm_idx(F, device):
    hi = torch.arange(F, device=device).repeat_interleave(F)   # host of pair
    ti = torch.arange(F, device=device).repeat(F)              # target
    return hi, ti


def make_pairs(T_cw, T_cw_fej, aff, exposure, K):
    """Per (host, target) pair transforms, adjoints and brightness transfer
    (FrameFramePrecalc::set + setAdjointsF); pair = host * F + target."""
    F = T_cw.shape[0]
    dev = T_cw.device
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    Km = torch.stack([torch.stack([fx, z, cx]), torch.stack([z, fy, cy]),
                      torch.stack([z, z, o])]).to(T_cw.dtype)
    Kim = torch.stack([torch.stack([1.0 / fx, z, -cx / fx]),
                       torch.stack([z, 1.0 / fy, -cy / fy]),
                       torch.stack([z, z, o])]).to(T_cw.dtype)
    hi, ti = _bmm_idx(F, dev)
    T_th_fej = T_cw_fej[ti] @ se3.inverse(T_cw_fej)[hi]
    T_th = T_cw[ti] @ se3.inverse(T_cw)[hi]
    KRKi = Km @ T_th[:, :3, :3] @ Kim
    Kt = torch.einsum("ij,pj->pi", Km, T_th[:, :3, 3])
    adH = -se3.adjoint(T_th_fej).transpose(-1, -2)
    adT = torch.eye(6, dtype=T_cw.dtype, device=dev).expand(F * F, 6, 6)
    zero_e = (exposure[hi] == 0) | (exposure[ti] == 0)
    er = torch.where(zero_e, torch.ones_like(exposure[hi]), exposure[hi])
    et = torch.where(zero_e, torch.ones_like(exposure[ti]), exposure[ti])
    a_rel = torch.exp(aff[ti, 0] - aff[hi, 0]) * et / er
    b_rel = aff[ti, 1] - a_rel * aff[hi, 1]
    return dict(host=hi, target=ti, R0=T_th_fej[:, :3, :3],
                t0=T_th_fej[:, :3, 3], Rc=T_th[:, :3, :3], tc=T_th[:, :3, 3],
                KRKi=KRKi, Kt=Kt, adH=adH, adT=adT, aff_a=a_rel, aff_b=b_rel,
                b0=aff[hi, 1])


def photometric_gate(pt_u, pt_v, pt_idepth, pt_host, pt_color, pt_weights,
                     pairs, dI0_stack, w: int, h: int, huber_th: float = 6.0,
                     quad12=None):
    """8-point pattern outlier-gate energies at the pairs' CURRENT pose
    (Residuals.cpp:157-194). Returns (energy_phot, wJI2), both (N, F)."""
    N = pt_u.shape[0]
    F = dI0_stack.shape[0]
    dev = pt_u.device
    pair_idx = pt_host[:, None] * F + torch.arange(F, device=dev)[None, :]
    KRKi = pairs["KRKi"][pair_idx]
    Kt = pairs["Kt"][pair_idx]
    a_rel = pairs["aff_a"][pair_idx]
    b_rel = pairs["aff_b"][pair_idx]

    pat = torch.as_tensor(PATTERN_P, dtype=torch.float32, device=dev)
    up = pt_u[:, None] + pat[:, 0]
    vp = pt_v[:, None] + pat[:, 1]
    pix = torch.stack([up, vp, torch.ones_like(up)], -1)          # (N, 8, 3)
    ptp2 = torch.einsum("nfij,npj->nfpi", KRKi, pix) + \
        (Kt * pt_idepth[:, None, None])[:, :, None, :]
    Ku2 = ptp2[..., 0] / ptp2[..., 2]
    Kv2 = ptp2[..., 1] / ptp2[..., 2]
    pat_ok = (Ku2 > 1.1) & (Kv2 > 1.1) & (Ku2 < w - 3) & (Kv2 < h - 3)
    # the reference breaks at the first failed pattern point
    pat_ok = torch.cumprod(pat_ok.to(torch.int32), dim=-1).to(torch.bool)

    if quad12 is None:
        quad12 = stack_quad12(dI0_stack)
    hw_img = dI0_stack.shape[1] * dI0_stack.shape[2]
    base = (torch.arange(F, device=dev) * hw_img)[None, :, None].expand(
        N, F, 1).reshape(N * F, 1)
    W = dI0_stack.shape[2]
    Ku2c = torch.clamp(Ku2, 0.0, W - 1.01).reshape(N * F, 8)
    Kv2c = torch.clamp(Kv2, 0.0, dI0_stack.shape[1] - 1.01).reshape(N * F, 8)
    hit = _quad_bilinear(quad12, base, W, Ku2c, Kv2c).reshape(N, F, 8, 3)

    resp = hit[..., 0] - (a_rel[..., None] * pt_color[:, None, :]
                          + b_rel[..., None])
    wgrad = torch.sqrt(2500.0 / (2500.0 + hit[..., 1] ** 2
                                 + hit[..., 2] ** 2))
    wpat = 0.5 * (wgrad + pt_weights[:, None, :])
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
    F = dI0_stack.shape[0]
    dev = pt_u.device
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    fxi, fyi = 1.0 / fx, 1.0 / fy

    pair_idx = pt_host[:, None] * F + torch.arange(F, device=dev)[None, :]
    R0 = pairs["R0"][pair_idx]
    t0 = pairs["t0"][pair_idx]
    Rc = pairs["Rc"][pair_idx]
    tc = pairs["tc"][pair_idx]

    KliP = torch.stack([(pt_u - cx) * fxi, (pt_v - cy) * fyi,
                        torch.ones_like(pt_u)], -1)
    ptp = torch.einsum("nfij,nj->nfi", R0, KliP) + \
        t0 * pt_idepth[:, None, None]
    drescale = 1.0 / ptp[..., 2]
    new_idepth0 = pt_idepth[:, None] * drescale
    u = ptp[..., 0] * drescale
    v = ptp[..., 1] * drescale
    Ku0 = u * fx + cx
    Kv0 = v * fy + cy
    proj_ok_fej = (drescale > 0) & (Ku0 > 1.1) & (Kv0 > 1.1) & \
        (Ku0 < w - 3) & (Kv0 < h - 3)

    if resf_at_fej:
        Ku, Kv = Ku0, Kv0
        new_idepth = new_idepth0
        proj_ok = proj_ok_fej
    else:
        ptc = torch.einsum("nfij,nj->nfi", Rc, KliP) + \
            tc * pt_idepth[:, None, None]
        drescale_c = 1.0 / ptc[..., 2]
        new_idepth = pt_idepth[:, None] * drescale_c
        Ku = ptc[..., 0] * drescale_c * fx + cx
        Kv = ptc[..., 1] * drescale_c * fy + cy
        proj_ok = (drescale_c > 0) & (Ku > 1.1) & (Kv > 1.1) & \
            (Ku < w - 3) & (Kv < h - 3) & (drescale > 0)

    oob = (~proj_ok) | (~matcher_valid) | (res_state == RES_OOB) | \
        (~res_active)

    dd_x = drescale * (t0[..., 0] - t0[..., 2] * u) * fx
    dd_y = drescale * (t0[..., 1] - t0[..., 2] * v) * fy

    dCx2 = drescale * (R0[..., 2, 0] * u - R0[..., 0, 0])
    dCx3 = fx * drescale * (R0[..., 2, 1] * u - R0[..., 0, 1]) * fyi
    dCx0 = KliP[:, None, 0] * dCx2
    dCx1 = KliP[:, None, 1] * dCx3
    dCy2 = fy * drescale * (R0[..., 2, 0] * v - R0[..., 1, 0]) * fxi
    dCy3 = drescale * (R0[..., 2, 1] * v - R0[..., 1, 1])
    dCy0 = KliP[:, None, 0] * dCy2
    dCy1 = KliP[:, None, 1] * dCy3
    Jc_x = torch.stack([dCx0 + u, dCx1, dCx2 + 1.0, dCx3], -1)
    Jc_y = torch.stack([dCy0, dCy1 + v, dCy2, dCy3 + 1.0], -1)

    zu = torch.zeros_like(u)
    Jxi_x = torch.stack([new_idepth0 * fx, zu, -new_idepth0 * u * fx,
                         -u * v * fx, (1 + u * u) * fx, -v * fx], -1)
    Jxi_y = torch.stack([zu, new_idepth0 * fy, -new_idepth0 * v * fy,
                         -(1 + v * v) * fy, u * v * fy, u * fy], -1)

    if gate is None:
        energy_phot, wJI2 = photometric_gate(
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
    Jxi = torch.stack([Jxi_x, Jxi_y], dim=2) * hw2s[..., None, None]
    Jc = torch.stack([Jc_x, Jc_y], dim=2) * hw2s[..., None, None]
    Jd = torch.stack([dd_x, dd_y], dim=2) * hw2s[..., None]

    th = torch.maximum(frame_energy_th[pt_host][:, None],
                       frame_energy_th[None, :])
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
    """Transport per-pair (10x10, 10) blocks [calib(4), relpose(6)] to the
    absolute (4+6F) system (stitchDouble, AccumulatedTopHessian.cpp)."""
    dev = Hpair.device
    D = CPARS + 6 * F
    Hcc = Hpair[:, :4, :4]
    Hcx = Hpair[:, :4, 4:]
    Hxx = Hpair[:, 4:, 4:]
    bc = bpair[:, :4]
    bx = bpair[:, 4:]
    H = torch.zeros((D, D), dtype=dtype, device=dev)
    b = torch.zeros(D, dtype=dtype, device=dev)
    H[:4, :4] += Hcc.sum(0)
    b[:4] += bc.sum(0)

    AH_Hxx = adH @ Hxx
    AT_Hxx = adT @ Hxx
    hh = AH_Hxx @ adH.transpose(1, 2)
    tt = AT_Hxx @ adT.transpose(1, 2)
    ht = AH_Hxx @ adT.transpose(1, 2)
    hc = adH @ Hcx.transpose(1, 2)
    tc = adT @ Hcx.transpose(1, 2)
    bh = torch.einsum("pij,pj->pi", adH, bx)
    bt = torch.einsum("pij,pj->pi", adT, bx)

    # pairs are laid out pair = host * F + target (make_pairs), so the
    # scatter-adds over host / target are sums over one axis of an (F, F)
    # grid: deterministic, no atomics
    def grid(x):
        return x.reshape((F, F) + x.shape[1:])

    eye_f = torch.eye(F, dtype=dtype, device=dev)
    Hdiag = (eye_f[:, :, None, None]
             * (grid(hh).sum(1) + grid(tt).sum(0))[:, None]).reshape(
        F * F, 6, 6)
    Moff = ht
    Mfc = grid(hc).sum(1) + grid(tc).sum(0)
    bf = grid(bh).sum(1) + grid(bt).sum(0)

    Hd_flat = Hdiag.reshape(F, F, 6, 6).permute(0, 2, 1, 3).reshape(
        6 * F, 6 * F)
    Mo_flat = Moff.reshape(F, F, 6, 6).permute(0, 2, 1, 3).reshape(
        6 * F, 6 * F)
    H[4:, 4:] += Hd_flat + Mo_flat + Mo_flat.T
    H[4:, :4] += Mfc.reshape(6 * F, 4)
    H[:4, 4:] += Mfc.reshape(6 * F, 4).T
    b[4:] += bf.reshape(6 * F)
    return H, b


def _accumulate(Jc, Jxi, Jd, resF, active, pt_host, pt_is_sensor,
                pt_prior, sc_mask, pairs, F):
    """Shared body of build_system / marginalize_points: per-pair blocks,
    stitch, per-point depth terms and the Schur complement."""
    N = resF.shape[0]
    dev = resF.device
    dtype = resF.dtype
    pt_host = pt_host.long()
    pair_idx = (pt_host[:, None] * F + torch.arange(F, device=dev)[None, :]
                ).reshape(-1)
    Jgeo = torch.cat([Jc, Jxi], dim=-1).reshape(N * F, 2, 10)
    res_f = resF.reshape(N * F, 2)
    outer = torch.einsum("rai,raj->rij", Jgeo, Jgeo).reshape(N * F, 100)
    onehot = torch.nn.functional.one_hot(pair_idx, F * F).to(dtype)
    Hpair = (onehot.T @ outer).reshape(F * F, 10, 10)
    bout = torch.einsum("rai,ra->ri", Jgeo, res_f)
    bpair = onehot.T @ bout
    H_top, b_top = _stitch(Hpair, bpair, pairs["adH"], pairs["adT"], F,
                           dtype)

    Hdd = torch.einsum("nfa,nfa->n", Jd, Jd) + pt_prior
    bd = torch.einsum("nfa,nfa->n", Jd, resF)
    Hcd = torch.einsum("nfai,nfa->ni", Jc, Jd)
    JpJd = torch.einsum("nfai,nfa->nfi", Jxi, Jd)
    n_act = active.sum(-1)
    HdiF = torch.where(n_act > 0, 1.0 / torch.clamp(Hdd, min=1e-10),
                       torch.zeros_like(Hdd))

    adH_p = pairs["adH"].reshape(F, F, 6, 6)[pt_host]
    adT_p = pairs["adT"].reshape(F, F, 6, 6)[pt_host]
    vh = torch.einsum("nfij,nfj->nfi", adH_p, JpJd)
    vt = torch.einsum("nfij,nfj->nfi", adT_p, JpJd)
    host_onehot = torch.nn.functional.one_hot(pt_host, F).to(dtype)
    Vframes = vt + host_onehot[:, :, None] * vh.sum(dim=1)[:, None, :]
    Vpt = torch.cat([Hcd, Vframes.reshape(N, 6 * F)], dim=-1)

    sc_ok = sc_mask & (~pt_is_sensor) & (n_act > 0)
    wsc = torch.where(sc_ok, HdiF, torch.zeros_like(HdiF))
    H_sc = (Vpt * wsc[:, None]).T @ Vpt
    b_sc = Vpt.T @ (wsc * bd)
    return H_top, b_top, H_sc, b_sc, Hdd, bd, HdiF, Vpt, n_act


def build_system(lin, pt_host, pt_is_sensor, pt_prior, pairs,
                 frame_delta, c_delta, n_frames: int):
    """Accumulate the absolute H, b and the Schur-complement terms.
    Returns dict(H_top, b_top, H_sc, b_sc, Hdd, bd, HdiF, Vpt, n_active,
    e_quad)."""
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
                e_quad=torch.sum(resF * resF))


def make_nullspaces(T_cw_fej, frame_valid):
    """(D, 7) nullspace matrix: 6 gauge + 1 scale (getNullspaces)."""
    F = T_cw_fej.shape[0]
    D = CPARS + 6 * F
    Ad = se3.adjoint(T_cw_fej)
    t = T_cw_fej[:, :3, 3]
    scale_col = torch.cat([t, torch.zeros_like(t)], -1)
    cols = torch.cat([Ad, scale_col[:, :, None]], -1)
    cols = cols * frame_valid[:, None, None]
    Ns = torch.zeros((D, 7), dtype=T_cw_fej.dtype, device=T_cw_fej.device)
    Ns[4:, :] = cols.reshape(6 * F, 7)
    return Ns


def orthogonalize(vec, Ns):
    """Project `vec` off span(Ns) (modified Gram-Schmidt, near-dependent
    columns dropped)."""
    norms = torch.linalg.vector_norm(Ns, dim=0, keepdim=True)
    Nn = Ns / torch.clamp(norms, min=1e-12)
    Q = torch.zeros_like(Nn)
    for j in range(Nn.shape[1]):
        v = Nn[:, j]
        v = v - Q @ (Q.T @ v)
        nv = torch.linalg.vector_norm(v)
        Q[:, j] = torch.where(nv > 1e-5, v / torch.clamp(nv, min=1e-12),
                              torch.zeros_like(v))
    return vec - Q @ (Q.T @ vec)


def solve_system(sys_, HM, bM, delta_stitched, c_prior, c_delta,
                 frame_prior, frame_delta, frame_valid, nullspaces,
                 lam, pt_host, pt_is_sensor, pairs, n_frames: int,
                 orthogonalize_x=True, diag_floor_rel=0.0, solve_dtype=None):
    """Assemble the final system and solve (solveSystemF:650-759) +
    resubstitute the idepth steps. `solve_dtype` (Settings.solve_dtype)
    is the precision of the dense solve. Returns dict(x, dc, dframes,
    didepth)."""
    F = n_frames
    D = CPARS + 6 * F
    dev = HM.device
    dtype = sys_["H_top"].dtype
    ar = torch.arange(D, device=dev)

    H = sys_["H_top"] - sys_["H_sc"] + HM
    b = sys_["b_top"] - sys_["b_sc"] + (bM + HM @ delta_stitched)
    H[ar[:4], ar[:4]] += c_prior
    b[:4] += c_prior * c_delta
    fp = frame_prior.reshape(6 * F)
    fd = frame_delta.reshape(6 * F)
    H[ar[4:], ar[4:]] += fp
    b[4:] += fp * fd

    slot_mask = torch.cat([torch.ones(4, dtype=torch.bool, device=dev),
                           frame_valid.repeat_interleave(6)])
    zero = torch.zeros((), dtype=dtype, device=dev)
    H = torch.where(slot_mask[:, None] & slot_mask[None, :], H, zero)
    H[ar, ar] += torch.where(slot_mask, zero, torch.ones_like(zero))
    b = torch.where(slot_mask, b, zero)

    diag = torch.diagonal(H)
    Hd = H.clone()
    Hd[ar, ar] = diag * (1.0 + lam)
    smf = slot_mask.to(dtype)
    dmean = torch.sum(torch.abs(diag) * smf) / torch.clamp(smf.sum(), min=1.0)
    Hd[ar, ar] += lam * diag_floor_rel * dmean * smf
    SVecI = 1.0 / torch.sqrt(torch.abs(torch.diagonal(Hd)) + 10.0)
    Hs = Hd * SVecI[:, None] * SVecI[None, :]
    bs = b * SVecI
    sdt = dtype if solve_dtype is None else getattr(torch, solve_dtype)
    A = (Hs + torch.eye(D, dtype=dtype, device=dev) * 1e-12).to(sdt)
    x = SVecI * torch.linalg.solve_ex(A, bs.to(sdt))[0].to(dtype)

    if orthogonalize_x:
        x = orthogonalize(x, nullspaces)

    dc = -x[:4]
    dframes = -x[4:].reshape(F, 6) * frame_valid[:, None]
    b_pt = sys_["bd"] - sys_["Vpt"] @ x
    step = -b_pt * sys_["HdiF"]
    step = torch.where(pt_is_sensor | (sys_["n_active"] == 0),
                       torch.zeros_like(step), step)
    return dict(x=x, dc=dc, dframes=dframes, didepth=step)


def marg_energy(HM, bM, delta_stitched):
    """calcMEnergyF (EnergyFunctional.cpp:284-293)."""
    return delta_stitched @ (2.0 * bM + HM @ delta_stitched)


def prior_energy(c_prior, c_delta, frame_prior, frame_delta):
    """Prior quadratic terms of calcLEnergyF_MT."""
    return torch.sum(c_prior * c_delta * c_delta) + \
        torch.sum(frame_prior * frame_delta * frame_delta)


def marginalize_points(lin, pt_host, pt_is_sensor, pt_prior_marg, marg_mask,
                       frame_delta, c_delta, pairs, n_frames: int,
                       marg_weight_fac: float = 0.25):
    """Marginalize flagged points into (dHM, dbM) (marginalizePointsF with
    res_toZeroF = resF - J * delta)."""
    F = n_frames
    dev = pt_host.device
    active = (lin["new_state"] == RES_IN) & marg_mask[:, None]
    hi, ti = pairs["host"], pairs["target"]
    dp_pair = torch.einsum("pj,pji->pi", frame_delta[hi], pairs["adH"]) + \
        torch.einsum("pj,pji->pi", frame_delta[ti], pairs["adT"])
    pair_idx = pt_host[:, None] * F + torch.arange(F, device=dev)[None, :]
    dp = dp_pair[pair_idx]
    Jp_delta = torch.einsum("nfai,nfi->nfa", lin["Jxi"], dp) + \
        torch.einsum("nfai,i->nfa", lin["Jc"], c_delta)
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
    (marginalizeFrame), then zero the slot."""
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
    mask = torch.ones(D, dtype=torch.bool, device=dev)
    mask[kidx] = False
    zero = torch.zeros((), dtype=HM.dtype, device=dev)
    return (torch.where(mask[:, None] & mask[None, :], HM_new, zero),
            torch.where(mask, bM_new, zero))


def frame_energy_quantile(energy_phot, mask, q: float = 0.7):
    """setNewFrameEnergyTH: q-quantile of the newest frame's gate
    energies, blended with a constant and squared."""
    e = torch.where(mask, energy_phot, torch.full_like(energy_phot,
                                                       float("inf")))
    order = torch.sort(e.reshape(-1))[0]
    n = mask.sum()
    nth = torch.clamp((q * n).to(torch.int64), 0, e.numel() - 1)
    nth_val = torch.sqrt(torch.clamp(order[nth], min=0.0))
    th = nth_val * 1.5
    th = 26.0 * 0.5 + th * 0.5
    th = th * th
    return torch.where(n > 0, th, torch.full_like(th, 12.0 * 12.0 * 8.0))


def stitched_delta(c_delta, eps, frame_valid):
    return torch.cat([c_delta, (eps * frame_valid[:, None]).reshape(-1)])


def _expT(eps, T_cw_fej):
    return se3.se3_exp(eps) @ T_cw_fej


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
    """The whole windowed LM (FullSystem::optimize). `newest`, `max_iters`
    and the other scalars are host values. Returns (out dict, lin_f,
    pairs_f)."""
    F = n_frames
    fvalid_f = frame_valid.to(T_cw_fej.dtype)
    quad12 = stack_quad12(dI0_stack)

    def linearize(eps_, calib_, idepth_, feth_, gate=None):
        pairs = make_pairs(_expT(eps_, T_cw_fej), T_cw_fej, aff, exposure,
                           calib_)
        lin = linearize_residuals(
            pt_u, pt_v, idepth_, pt_host, pt_color, pt_weights,
            res_active, res_state, matcher_px, matcher_valid,
            pairs, dI0_stack, feth_, calib_, w=w, h=h, gate=gate,
            resf_at_fej=resf_at_fej, quad12=quad12)
        return lin, pairs

    def update_feth(lin, feth_):
        mask = res_active[:, newest] & (lin["new_state"][:, newest] != RES_OOB)
        out = feth_.clone()
        out[newest] = frame_energy_quantile(lin["energy_phot"][:, newest],
                                            mask)
        return out

    def total_energy(lin, eps_, calib_):
        c_delta = calib_ - calib_zero
        dstt = stitched_delta(c_delta, eps_, fvalid_f)
        return (torch.sum(lin["energy"]) + marg_energy(HM, bM, dstt)
                + prior_energy(c_prior, c_delta, frame_prior,
                               eps_ * fvalid_f[:, None]))

    nullspaces = make_nullspaces(T_cw_fej, fvalid_f)
    lin0, _ = linearize(eps, calib, pt_idepth, frame_energy_th)
    gate = (lin0["energy_phot"], lin0["wJI2"])
    feth = update_feth(lin0, frame_energy_th)
    lin, pairs = linearize(eps, calib, pt_idepth, feth, gate)
    E_last = total_energy(lin, eps, calib)
    idepth = pt_idepth
    n_valid_frames = max(int(frame_valid.sum()), 1)
    lam = 1e-1

    for it in range(int(max_iters)):
        c_delta = calib - calib_zero
        sys_ = build_system(lin, pt_host, pt_is_sensor, pt_prior, pairs,
                            eps * fvalid_f[:, None], c_delta, n_frames=F)
        sol = solve_system(sys_, HM, bM, stitched_delta(c_delta, eps,
                                                        fvalid_f),
                           c_prior, c_delta, frame_prior,
                           eps * fvalid_f[:, None], frame_valid, nullspaces,
                           lam, pt_host, pt_is_sensor, pairs, n_frames=F,
                           orthogonalize_x=(it >= 2),
                           diag_floor_rel=lm_diag_floor,
                           solve_dtype=solve_dtype)
        eps_n = eps + sol["dframes"]
        calib_n = calib + sol["dc"]
        idepth_n = torch.where(pt_is_sensor, idepth, idepth + sol["didepth"])
        lin_n, pairs_n = linearize(eps_n, calib_n, idepth_n, feth, gate)
        feth_n = update_feth(lin_n, feth)
        E_new = total_energy(lin_n, eps_n, calib_n)

        d = sol["dframes"]
        sumT = float(torch.sum(d[:, :3] ** 2)) / n_valid_frames
        sumR = float(torch.sum(d[:, 3:] ** 2)) / n_valid_frames
        canbreak = (sumR ** 0.5 < 0.00005 * th_opt_iterations and
                    sumT ** 0.5 < 0.00005 * th_opt_iterations)
        accept = bool(E_new < E_last) or bool(force_accept)
        if accept:
            eps, calib, idepth, feth = eps_n, calib_n, idepth_n, feth_n
            lin, pairs, E_last = lin_n, pairs_n, E_new
            lam *= 0.25
            if gate_refresh:
                gate = photometric_gate(pt_u, pt_v, idepth, pt_host,
                                        pt_color, pt_weights, pairs,
                                        dI0_stack, w=w, h=h, quad12=quad12)
        else:
            lam *= 1e2
        if canbreak and it >= min_opt_iterations:
            break

    # fix the newest frame's eval point, then the final linearization
    T_cw = _expT(eps, T_cw_fej)
    T_cw_fej_out = T_cw_fej.clone()
    T_cw_fej_out[newest] = T_cw[newest]
    eps_out = eps.clone()
    eps_out[newest] = 0.0
    pairs_f = make_pairs(_expT(eps_out, T_cw_fej_out), T_cw_fej_out, aff,
                         exposure, calib)
    lin_f = linearize_residuals(
        pt_u, pt_v, idepth, pt_host, pt_color, pt_weights, res_active,
        res_state, matcher_px, matcher_valid, pairs_f, dI0_stack, feth,
        calib, w=w, h=h, resf_at_fej=resf_at_fej, quad12=quad12)
    sys_f = build_system(lin_f, pt_host, pt_is_sensor, pt_prior, pairs_f,
                         eps_out * fvalid_f[:, None], calib - calib_zero,
                         n_frames=F)
    rmse = torch.sqrt(torch.sum(lin_f["energy"])
                      / torch.clamp((lin_f["new_state"] == RES_IN).sum(),
                                    min=1))
    out = dict(eps=eps_out, calib=calib, idepth=idepth, feth=feth,
               T_cw_fej=T_cw_fej_out, new_state=lin_f["new_state"],
               center=lin_f["center"], Hdd=sys_f["Hdd"], energy=E_last,
               rmse=rmse)
    return out, lin_f, pairs_f
