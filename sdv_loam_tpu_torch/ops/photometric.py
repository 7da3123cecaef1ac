"""Pyramidal photometric Gauss-Newton tracking — the CoarseTracker compute.

Counterpart of `sdv_loam_tpu/ops/photometric.py` (reference:
CoarseTracker.cpp makeCoarseDepthL0 :258-423, calcRes :486-634, calcGSSSE
:427-484, trackNewestCoarse :662-838).

PyTorch idiom: the JAX `vmap` over pose hypotheses is an explicit leading
batch dimension B, and each `lax.while_loop` is a Python loop with the same
exit conditions and iteration caps. Lanes of a batch stop updating once
their own condition fails, exactly as a vmapped while_loop behaves.
"""

from __future__ import annotations

import torch

from sdv_loam_tpu_torch.ops.hopper_kernels import dilate_depth
from sdv_loam_tpu_torch.ops.warp import bilinear_sample_packed, pack_bilinear
from sdv_loam_tpu_torch.utils import se3

STEP_SCALE = (1.0, 1.0, 1.0, 0.5, 0.5, 0.5, 10.0, 1000.0)
LAMBDA_EXTRAPOLATION_LIMIT = 0.001


def _step_scale(like):
    return torch.tensor(STEP_SCALE, dtype=like.dtype, device=like.device)


def aff_transfer(exposure_ref, exposure_new, aff_ref, aff_new):
    """AffLight::fromToVecExposure: (a, b) with I_new ~ a * I_ref + b.
    `aff_new` may carry leading batch dimensions (..., 2)."""
    zero = (exposure_ref == 0) | (exposure_new == 0)
    one = torch.ones_like(exposure_ref)
    er = torch.where(zero, one, exposure_ref)
    en = torch.where(zero, one, exposure_new)
    a = torch.exp(aff_new[..., 0] - aff_ref[0]) * en / er
    b = aff_new[..., 1] - a * aff_ref[1]
    return torch.stack([a, b], dim=-1)


# ---------------------------------------------------------------------------
# reference depth-map construction
# ---------------------------------------------------------------------------

def splat_idepth(u, v, idepth, weight, valid, w: int, h: int):
    """Scatter-add inverse depths into level-0 maps (makeCoarseDepthL0).

    Deterministic: `index_put_(accumulate=True)` runs serially in point
    order on the CPU (the JAX CPU order) and through the sort-based
    deterministic path on CUDA, never through order-dependent atomics."""
    idx = torch.where(valid, v.to(torch.int64) * w + u.to(torch.int64),
                      torch.full_like(u, w * h, dtype=torch.int64))
    zero = torch.zeros((), dtype=torch.float32, device=u.device)
    vi = torch.where(valid, (idepth * weight).to(torch.float32), zero)
    vw = torch.where(valid, weight.to(torch.float32), zero)
    acc_i = torch.zeros(w * h + 1, dtype=torch.float32, device=u.device)
    acc_w = torch.zeros(w * h + 1, dtype=torch.float32, device=u.device)
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        acc_i.index_put_((idx,), vi, accumulate=True)
        acc_w.index_put_((idx,), vw, accumulate=True)
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)
    return acc_i[:w * h].reshape(h, w), acc_w[:w * h].reshape(h, w)


def _sum_pool2(x):
    h, w = x.shape
    x = x[: (h // 2) * 2, : (w // 2) * 2]
    # (row-0 pair) + (row-1 pair): the order XLA sums this 2x2 window in
    # the JAX package's build_track_ref (make_images' pooling sums left to
    # right instead), so the pools agree bit for bit
    return (x[0::2, 0::2] + x[0::2, 1::2]) + (x[1::2, 0::2] + x[1::2, 1::2])


def nonzero_fixed(mask: torch.Tensor, size: int, fill: int):
    """`jnp.nonzero(mask, size=size, fill_value=fill)` for a 1-D mask: the
    first `size` set indices in order, padded with `fill` — computed with a
    prefix sum and a unique-index scatter, so no host sync."""
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    take = mask & (pos < size)
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=mask.device)
    src = torch.arange(mask.shape[0], device=mask.device)
    out[torch.where(take, pos, torch.full_like(pos, size))] = torch.where(
        take, src, torch.full_like(src, fill))
    return out[:size]


def build_track_ref(dI_pyr, idepth0, weight0, levels: int,
                    cap: int | tuple = 16384):
    """Per-level tracking-reference pools from level-0 splat maps.

    Returns a tuple over levels of dicts {u, v, idepth, color, valid, n}
    with fixed per-level capacity (`cap` int, or tuple with the last entry
    repeated); overflow is stride-subsampled in scan order. One hole-filling
    pass per level runs through the K1 kernel (`hopper_kernels.dilate_depth`,
    diagonal neighbours on levels 0-1, the cross on coarser levels)."""
    if isinstance(cap, int):
        caps = (cap,) * levels
    else:
        caps = tuple(cap) + (cap[-1],) * (levels - len(cap))
    pools = []
    idl, wl = idepth0, weight0
    for lvl in range(levels):
        if lvl > 0:
            idl = _sum_pool2(idl)
            wl = _sum_pool2(wl)
        idl, wl = dilate_depth(idl.contiguous(), wl.contiguous(),
                               diagonal=(lvl < 2))
        h, w = idl.shape
        dev = idl.device
        neg = torch.full((), -1.0, dtype=idl.dtype, device=dev)
        norm_id = torch.where(wl > 0, idl / torch.clamp(wl, min=1e-12), neg)
        color = dI_pyr[lvl][..., 0]
        yy = torch.arange(h, device=dev)[:, None]
        xx = torch.arange(w, device=dev)[None, :]
        interior = (xx >= 2) & (xx < w - 2) & (yy >= 2) & (yy < h - 2)
        good = interior & (norm_id > 0) & torch.isfinite(color)
        c = min(caps[lvl], w * h)
        gf = good.reshape(-1)
        n_all = gf.sum()
        stride = torch.clamp((n_all + c - 1) // c, min=1)
        rank = torch.cumsum(gf.to(torch.int64), 0) - 1
        keep = gf & (torch.remainder(rank, stride) == 0)
        flat_idx = nonzero_fixed(keep, c, w * h - 1)
        n = keep.sum()
        slot_valid = torch.arange(c, device=dev) < n
        pools.append(dict(
            u=(flat_idx % w).to(torch.float32),
            v=(flat_idx // w).to(torch.float32),
            idepth=norm_id.reshape(-1)[flat_idx],
            color=color.reshape(-1)[flat_idx],
            valid=slot_valid, n=n))
    return tuple(pools)


# ---------------------------------------------------------------------------
# residual + Hessian evaluation (calcRes + calcGSSSE fused), batched over B
# ---------------------------------------------------------------------------

def calc_res_gs(pool, dI_new, K, T_ref_to_new, aff_rel, ref_aff_b, cutoff,
                huber_th, packed=None):
    """Fused residual + 8x8 system evaluation for one level.

    T_ref_to_new: (B, 4, 4); aff_rel: (B, 2); `cutoff` a float or (B,)
    tensor. `packed` is `pack_bilinear(dI_new)` when the caller hoists it
    out of an LM loop. Returns dict(E, n, sat_frac, H (B,8,8), b (B,8),
    flow_t, flow_rt), each with leading dimension B."""
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    h, w = dI_new.shape[:2]
    if packed is None:
        packed = pack_bilinear(dI_new)
    u0, v0 = pool["u"], pool["v"]
    idp, color, valid = pool["idepth"], pool["color"], pool["valid"]
    B = T_ref_to_new.shape[0]
    cutoff = torch.as_tensor(cutoff, dtype=torch.float32,
                             device=u0.device).expand(B)[:, None]

    xn = (u0 - cx) / fx
    yn = (v0 - cy) / fy
    R = T_ref_to_new[:, :3, :3]
    t = T_ref_to_new[:, :3, 3]
    p = torch.stack([xn, yn, torch.ones_like(xn)], dim=-1)         # (N, 3)
    pr = torch.einsum("nj,bij->bni", p, R)                           # p @ R^T
    pt = pr + t[:, None, :] * idp[None, :, None]                     # (B,N,3)
    u = pt[..., 0] / pt[..., 2]
    v = pt[..., 1] / pt[..., 2]
    Ku = fx * u + cx
    Kv = fy * v + cy
    new_idepth = idp[None, :] / pt[..., 2]

    inb = valid[None] & (Ku > 2) & (Kv > 2) & (Ku < w - 3) & (Kv < h - 3) \
        & (new_idepth > 0)
    hit, hit_ok = bilinear_sample_packed(packed, h, w, Ku, Kv)      # (B,N,3)
    inb = inb & hit_ok & torch.isfinite(hit[..., 0])

    r = hit[..., 0] - (aff_rel[:, 0:1] * color[None] + aff_rel[:, 1:2])
    absr = torch.abs(r)
    one = torch.ones_like(absr)
    hw = torch.where(absr < huber_th, one,
                     huber_th / torch.clamp(absr, min=1e-12))
    saturated = inb & (absr > cutoff)
    inlier = inb & (absr <= cutoff)
    zero = torch.zeros_like(absr)

    max_energy = 2.0 * huber_th * cutoff - huber_th * huber_th       # (B,1)
    E = torch.where(inlier, hw * r * r * (2.0 - hw), zero).sum(-1) + \
        torch.where(saturated, max_energy.expand_as(absr), zero).sum(-1)
    n_terms = inb.sum(-1)
    sat_frac = saturated.sum(-1) / torch.clamp(n_terms, min=1)

    dxf = hit[..., 1] * fx
    dyf = hit[..., 2] * fy
    idn = new_idepth
    J = torch.stack([
        idn * dxf,
        idn * dyf,
        -idn * (u * dxf + v * dyf),
        -(u * v * dxf + (1.0 + v * v) * dyf),
        u * v * dyf + (1.0 + u * u) * dxf,
        u * dyf - v * dxf,
        (aff_rel[:, 0:1] * (ref_aff_b - color[None])).expand_as(u),
        -torch.ones_like(u),
    ], dim=-1)                                                        # (B,N,8)
    wgt = torch.where(inlier, hw, zero)
    n_in = torch.clamp(inlier.sum(-1), min=1).to(J.dtype)
    Jw = J * wgt[..., None]
    Hm = (J.transpose(1, 2) @ Jw) / n_in[:, None, None]
    bv = (Jw.transpose(1, 2) @ r[..., None])[..., 0] / n_in[:, None]
    S = _step_scale(J)
    Hm = Hm * S[:, None] * S[None, :]
    bv = bv * S

    # flow indicators (calcRes:538-565): every 32nd pool slot
    m = valid & (torch.arange(u0.shape[0], device=u0.device) % 32 == 0)
    ti = t[:, None, :] * idp[None, :, None]
    ptT = p[None] + ti
    ptT2 = p[None] - ti
    pt3 = pr - ti

    def pix_shift(q):
        uu = fx * (q[..., 0] / q[..., 2]) + cx
        vv = fy * (q[..., 1] / q[..., 2]) + cy
        return (uu - u0) ** 2 + (vv - v0) ** 2

    num = m.sum() * 2.0
    zf = torch.zeros((), dtype=u.dtype, device=u.device)
    flow_t = torch.where(m, pix_shift(ptT) + pix_shift(ptT2), zf).sum(-1) \
        / (num + 0.1)
    flow_rt = torch.where(m, pix_shift(pt) + pix_shift(pt3), zf).sum(-1) \
        / (num + 0.1)
    return dict(E=E, n=n_terms, sat_frac=sat_frac, H=Hm, b=bv,
                flow_t=flow_t, flow_rt=flow_rt)


def _solve_scaled(H, b, lam):
    """LM-damped solve of the scaled (B, 8, 8) systems; lam (B,)."""
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
    return torch.where(torch.isfinite(inc), inc, torch.zeros_like(inc))


def _select(mask, new, old):
    """Per-lane select over a dict or tensor with leading batch dim."""
    if isinstance(new, dict):
        return {k: _select(mask, new[k], old[k]) for k in new}
    m = mask.reshape(mask.shape + (1,) * (new.dim() - 1))
    return torch.where(m, new, old)


def track_level(pool, dI_new, K, T0, aff0, ref_aff, exposures, cutoff_base,
                huber_th, max_iters: int, packed=None):
    """One pyramid level of trackNewestCoarse for B pose lanes: the
    cutoff-doubling pre-loop and the LM loop. T0 (B,4,4), aff0 (B,2),
    `cutoff_base` float or (B,). Returns (T, aff, stats dict, cutoff_rep)."""
    if packed is None:
        packed = pack_bilinear(dI_new)
    B = T0.shape[0]
    dev = T0.device
    cutoff_base = torch.as_tensor(cutoff_base, dtype=torch.float32,
                                  device=dev).expand(B)

    def res(T, aff, cutoff):
        aff_rel = aff_transfer(exposures[0], exposures[1], ref_aff, aff)
        return calc_res_gs(pool, dI_new, K, T, aff_rel, ref_aff[1], cutoff,
                           huber_th, packed=packed)

    # cutoff doubling while > 60% saturated (:694-701)
    cutoff_rep = torch.ones(B, dtype=torch.float32, device=dev)
    r0 = res(T0, aff0, cutoff_base)
    while True:
        go = (r0["sat_frac"] > 0.6) & (cutoff_rep < 50.0)
        if not bool(go.any()):
            break
        rep_n = torch.where(go, cutoff_rep * 2.0, cutoff_rep)
        r_n = res(T0, aff0, cutoff_base * rep_n)
        r0 = _select(go, r_n, r0)
        cutoff_rep = rep_n
    cutoff = cutoff_base * cutoff_rep

    S = _step_scale(T0)
    T, aff, r = T0, aff0, r0
    lam = torch.full((B,), 0.01, dtype=torch.float32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    n_it = torch.zeros(B, dtype=torch.int64, device=dev)
    for _ in range(max_iters):
        act = ~done
        if not bool(act.any()):
            break
        inc = _solve_scaled(r["H"], r["b"], lam)
        inc_scaled = inc * S
        T_new = se3.se3_exp(inc_scaled[:, :6]) @ T
        aff_new = aff + inc_scaled[:, 6:]
        r_new = res(T_new, aff_new, cutoff)
        accept = (r_new["E"] / torch.clamp(r_new["n"], min=1)) < \
            (r["E"] / torch.clamp(r["n"], min=1))
        acc = accept & act
        T = _select(acc, T_new, T)
        aff = _select(acc, aff_new, aff)
        lam_n = torch.where(accept, lam * 0.5,
                            torch.clamp(lam * 4.0,
                                        min=LAMBDA_EXTRAPOLATION_LIMIT))
        lam = torch.where(act, lam_n, lam)
        r = _select(acc, r_new, r)
        done = done | (act & ~(torch.linalg.vector_norm(inc, dim=-1) > 1e-3))
        n_it = n_it + act.to(torch.int64)
    r = dict(r, n_iters=n_it)
    return T, aff, r, cutoff_rep


def track_pyramid(pools, dI_new_pyr, Ks, T_init, aff_init, ref_aff,
                  exposures, min_res_for_abort, cutoff_th, huber_th,
                  coarsest_lvl: int, finest_lvl: int = 0,
                  max_iters=(10, 20, 50, 50, 50), packed_pyr=None):
    """Coarse-to-fine track (trackNewestCoarse) of B pose lanes.

    T_init (B,4,4) or (4,4); aff_init (B,2) or (2,). Returns dict with T,
    aff, per-level rmse `res` (NaN for levels not run), `flow` from the
    finest level run, `ok`, and per-level LM iteration counts; batched
    inputs give outputs with a leading B, single inputs without."""
    single = T_init.dim() == 2
    T = T_init[None] if single else T_init
    B = T.shape[0]
    aff = aff_init.expand(B, 2) if aff_init.dim() == 1 else aff_init
    dev = T.device
    if packed_pyr is None:
        packed_pyr = [None] * len(dI_new_pyr)
    last_res = torch.full((B, 5), float("nan"), dtype=torch.float32,
                          device=dev)
    flow = torch.full((B, 3), 1000.0, dtype=torch.float32, device=dev)
    ok = torch.ones(B, dtype=torch.bool, device=dev)
    have_repeated = torch.zeros(B, dtype=torch.bool, device=dev)
    lvl_iters = torch.zeros((B, 6), dtype=torch.int64, device=dev)

    for lvl in range(coarsest_lvl, finest_lvl - 1, -1):
        packed = packed_pyr[lvl]
        if packed is None:
            packed = pack_bilinear(dI_new_pyr[lvl])
        mi = max_iters[min(lvl, len(max_iters) - 1)]

        def run_level(T_, aff_):
            return track_level(pools[lvl], dI_new_pyr[lvl], Ks[lvl], T_,
                               aff_, ref_aff, exposures, cutoff_th, huber_th,
                               mi, packed=packed)

        T, aff, r, cutoff_rep = run_level(T, aff)
        # single level-repeat when the cutoff was raised (:826-833)
        do_repeat = (cutoff_rep > 1.0) & (~have_repeated)
        have_repeated = have_repeated | do_repeat
        if bool(do_repeat.any()):
            T2, aff2, r2, _ = run_level(T, aff)
            T = _select(do_repeat, T2, T)
            aff = _select(do_repeat, aff2, aff)
            r = _select(do_repeat, r2, r)

        rmse = torch.sqrt(r["E"] / torch.clamp(r["n"], min=1))
        last_res[:, lvl] = rmse
        flow = torch.stack([r["flow_t"], torch.zeros_like(r["flow_t"]),
                            r["flow_rt"]], dim=-1)
        ok = ok & ~(rmse > 1.5 * min_res_for_abort[lvl])
        lvl_iters[:, lvl] += r["n_iters"]

    ok = ok & (torch.abs(aff[:, 0]) <= 1.2) & (torch.abs(aff[:, 1]) <= 200.0)
    out = dict(T=T, aff=aff, res=last_res, flow=flow, ok=ok,
               lvl_iters=lvl_iters)
    if single:
        out = {k: v[0] for k, v in out.items()}
    return out


def track_coarsest_batch(pool, dI_new, K, T_tries, aff_init, ref_aff,
                         exposures, cutoff_th, huber_th, max_iters: int = 10,
                         packed=None):
    """LM-refine ALL pose hypotheses on the coarsest level at once.
    Returns dict(T (B,4,4), E (B,), n (B,))."""
    B = T_tries.shape[0]
    aff0 = aff_init[None].expand(B, 2)
    T, _, r, _ = track_level(pool, dI_new, K, T_tries, aff0, ref_aff,
                             exposures, cutoff_th, huber_th, max_iters,
                             packed=packed)
    return dict(T=T, E=r["E"], n=r["n"])
