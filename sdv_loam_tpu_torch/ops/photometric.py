"""Pyramidal photometric Gauss-Newton tracking — the CoarseTracker compute.

Counterpart of `sdv_loam_tpu/ops/photometric.py` (reference:
CoarseTracker.cpp makeCoarseDepthL0 :258-423, calcRes :486-634, calcGSSSE
:427-484, trackNewestCoarse :662-838).

PyTorch idiom: the JAX `vmap` over pose hypotheses is an explicit leading
batch dimension B, and each `lax.while_loop` is a Python loop with the same
exit conditions and iteration caps. Rows of a batch stop updating once
their own condition fails, exactly as a vmapped while_loop behaves.

Lanes: the fleet's vmap over sequences folds into the same row dimension.
With `lane` (B,) given, row b tracks against lane lane[b]'s pool, image
and intrinsics, stacked (L, ...) per field; per-row arguments (affine,
exposures, cutoff) then carry a leading B. Without it the inputs are one
lane's and run as lane 0 of the same code, so a sequence computes the same
thing alone and in a fleet.
"""

from __future__ import annotations

import torch

from sdv_loam_tpu_torch.ops.hopper_kernels import dilate_pyramid
from sdv_loam_tpu_torch.ops.warp import bilinear_sample_packed, pack_bilinear
from sdv_loam_tpu_torch.utils import device_loop, se3

STEP_SCALE = (1.0, 1.0, 1.0, 0.5, 0.5, 0.5, 10.0, 1000.0)
LAMBDA_EXTRAPOLATION_LIMIT = 0.001


def _step_scale(like):
    """STEP_SCALE on `like`'s device and dtype (made once)."""
    return device_loop.constant(STEP_SCALE, like.device, like.dtype)


def aff_transfer(exposure_ref, exposure_new, aff_ref, aff_new):
    """AffLight::fromToVecExposure: (a, b) with I_new ~ a * I_ref + b.
    `aff_new` may carry leading batch dimensions (..., 2); `aff_ref` and
    the exposures are one frame's or carry the same leading dimensions."""
    zero = (exposure_ref == 0) | (exposure_new == 0)
    one = torch.ones_like(exposure_ref)
    er = torch.where(zero, one, exposure_ref)
    en = torch.where(zero, one, exposure_new)
    a = torch.exp(aff_new[..., 0] - aff_ref[..., 0]) * en / er
    b = aff_new[..., 1] - a * aff_ref[..., 1]
    return torch.stack([a, b], dim=-1)


# ---------------------------------------------------------------------------
# reference depth-map construction
# ---------------------------------------------------------------------------

def splat_idepth(u, v, idepth, weight, valid, w: int, h: int):
    """Scatter-add inverse depths into level-0 maps (makeCoarseDepthL0).
    Points (N,) -> (h, w) maps, or L lanes of points (L, N) -> (L, h, w).

    Deterministic, and each cell sums its points in point order (the JAX
    CPU order): a stable sort groups the points of a cell, and the r-th
    point of every cell is added in round r, where no two writes share a
    cell. The rounds are a loop on the device (`device_loop.run`,
    "splat"), which stops after the round of the fullest cell. Each lane
    has cells of its own (index offset by lane * (w*h+1)), so a lane sums
    exactly as it would alone. No atomics and no process-wide
    deterministic-algorithms switch, so systems on other threads are never
    affected."""
    if u.dim() == 1:
        out = splat_idepth(u[None], v[None], idepth[None], weight[None],
                           valid[None], w, h)
        return out[0][0], out[1][0]
    L = u.shape[0]
    dev = u.device
    cells = w * h + 1                    # the lane's cells and its spare
    lane0 = (torch.arange(L, device=dev) * cells)[:, None]
    idx = lane0 + torch.where(
        valid, v.to(torch.int64) * w + u.to(torch.int64),
        torch.full_like(u, w * h, dtype=torch.int64))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    vi = torch.where(valid, (idepth * weight).to(torch.float32), zero)
    vw = torch.where(valid, weight.to(torch.float32), zero)
    dump = L * cells
    acc_i = torch.zeros(dump + 1, dtype=torch.float32, device=dev)
    acc_w = torch.zeros(dump + 1, dtype=torch.float32, device=dev)
    idx, vi, vw = idx.reshape(-1), vi.reshape(-1), vw.reshape(-1)
    n = idx.shape[0]
    if n:
        order = torch.sort(idx, stable=True).indices
        idx_s = idx[order]
        pos = torch.arange(n, device=dev)
        start = torch.ones(n, dtype=torch.bool, device=dev)
        start[1:] = idx_s[1:] != idx_s[:-1]
        seg0 = torch.cummax(torch.where(start, pos, torch.zeros_like(pos)),
                            0).values
        live = torch.remainder(idx_s, cells) < w * h
        rank = torch.where(live, pos - seg0, torch.full_like(pos, -1))
        x = dict(rank=rank, idx_s=idx_s, spill=torch.full_like(idx_s, dump),
                 vi_s=vi[order], vw_s=vw[order])
        st = device_loop.run("splat", _splat_body, x, dict(
            acc_i=acc_i, acc_w=acc_w,
            r=torch.zeros((), dtype=torch.int64, device=dev)), n)
        acc_i, acc_w = st["acc_i"], st["acc_w"]

    def maps(acc):
        return acc[:dump].reshape(L, cells)[:, :w * h].reshape(L, h, w)
    return maps(acc_i), maps(acc_w)


def _splat_body(x, st):
    """Round r of `splat_idepth`: the r-th point of every cell added to
    it. The other points write their spill cell's value back unchanged, so
    a round after the last one changes no carry; `r` advances only past a
    round that added a point."""
    r = st["r"]
    now = x["rank"] == r
    tgt = torch.where(now, x["idx_s"], x["spill"])
    out = {}
    for k, val in (("acc_i", x["vi_s"]), ("acc_w", x["vw_s"])):
        acc = st[k]
        old = acc[tgt]
        out[k] = acc.index_put((tgt,), torch.where(now, old + val, old))
    out["r"] = r + now.any().to(r.dtype)
    return out, (x["rank"] == out["r"]).any()


def nonzero_fixed(mask: torch.Tensor, size: int, fill: int):
    """`jnp.nonzero(mask, size=size, fill_value=fill)` along the last
    dimension of `mask` ((n,) or (L, n), row by row): the first `size` set
    indices in order, padded with `fill` — computed with a prefix sum and a
    unique-index scatter, so no host sync."""
    single = mask.dim() == 1
    m = mask[None] if single else mask
    rows, n = m.shape
    dev = m.device
    pos = torch.cumsum(m.to(torch.int64), 1) - 1
    take = m & (pos < size)
    row0 = (torch.arange(rows, device=dev) * (size + 1))[:, None]
    out = torch.full((rows * (size + 1),), fill, dtype=torch.int64,
                     device=dev)
    src = torch.arange(n, device=dev).expand(rows, n)
    out[torch.where(take, row0 + pos, row0 + size)] = torch.where(
        take, src, torch.full_like(src, fill))
    out = out.reshape(rows, size + 1)[:, :size]
    return out[0] if single else out


def build_track_ref(dI_pyr, idepth0, weight0, levels: int,
                    cap: int | tuple = 16384):
    """Per-level tracking-reference pools from level-0 splat maps.

    Returns a tuple over levels of dicts {u, v, idepth, color, valid, n}
    with fixed per-level capacity (`cap` int, or tuple with the last entry
    repeated); overflow is stride-subsampled in scan order. The maps of all
    levels come from one call of the K1 kernel
    (`hopper_kernels.dilate_pyramid`: per level a 2x2 sum-pool of the level
    above and one hole-filling pass, diagonal neighbours on levels 0-1, the
    cross on coarser levels).

    Lanes: with (L, H, W) splat maps and (L, h_l, w_l, 3) pyramid levels,
    one K1 launch takes every lane, each lane's pools are compacted on
    their own, and every field carries a leading L; (H, W) maps run as
    lane 0."""
    if idepth0.dim() == 2:
        pools = build_track_ref([d[None] for d in dI_pyr], idepth0[None],
                                weight0[None], levels, cap)
        return tuple({k: x[0] for k, x in p.items()} for p in pools)
    if isinstance(cap, int):
        caps = (cap,) * levels
    else:
        caps = tuple(cap) + (cap[-1],) * (levels - len(cap))
    pools = []
    maps = dilate_pyramid(idepth0.contiguous(), weight0.contiguous(), levels)
    for lvl, (idl, wl) in enumerate(maps):
        L, h, w = idl.shape
        dev = idl.device
        neg = torch.full((), -1.0, dtype=idl.dtype, device=dev)
        norm_id = torch.where(wl > 0, idl / torch.clamp(wl, min=1e-12), neg)
        color = dI_pyr[lvl][..., 0]
        yy = torch.arange(h, device=dev)[:, None]
        xx = torch.arange(w, device=dev)[None, :]
        interior = (xx >= 2) & (xx < w - 2) & (yy >= 2) & (yy < h - 2)
        good = interior & (norm_id > 0) & torch.isfinite(color)
        c = min(caps[lvl], w * h)
        gf = good.reshape(L, -1)
        n_all = gf.sum(-1, keepdim=True)
        stride = torch.clamp((n_all + c - 1) // c, min=1)
        rank = torch.cumsum(gf.to(torch.int64), 1) - 1
        keep = gf & (torch.remainder(rank, stride) == 0)
        flat_idx = nonzero_fixed(keep, c, w * h - 1)
        n = keep.sum(-1)
        slot_valid = torch.arange(c, device=dev) < n[:, None]
        pools.append(dict(
            u=(flat_idx % w).to(torch.float32),
            v=(flat_idx // w).to(torch.float32),
            idepth=norm_id.reshape(L, -1).gather(1, flat_idx),
            color=color.reshape(L, -1).gather(1, flat_idx),
            valid=slot_valid, n=n))
    return tuple(pools)


# ---------------------------------------------------------------------------
# residual + Hessian evaluation (calcRes + calcGSSSE fused), batched over B
# ---------------------------------------------------------------------------

def _lane_inputs(pool, K, B, lane, device):
    """(pool fields (B, N), K (B, 4), lane) for B rows: each row reads its
    lane's pool; one lane's (N,) pool runs as lane 0."""
    if lane is None:
        pool = {k: pool[k][None] for k in ("u", "v", "idepth", "color",
                                           "valid")}
        K = K[None]
        lane = torch.zeros(B, dtype=torch.int64, device=device)
    rows = {k: pool[k].index_select(0, lane)
            for k in ("u", "v", "idepth", "color", "valid")}
    return rows, K.index_select(0, lane), lane


def calc_res_gs(pool, dI_new, K, T_ref_to_new, aff_rel, ref_aff_b, cutoff,
                huber_th, packed=None, lane=None, hw=None):
    """Fused residual + 8x8 system evaluation for one level.

    T_ref_to_new: (B, 4, 4); aff_rel: (B, 2); `cutoff` and `ref_aff_b` a
    float or (B,) tensor. `packed` is `pack_bilinear(dI_new)` when the
    caller hoists it out of an LM loop. With `lane` (B,), the pool fields
    are (L, N), K (L, 4), dI_new (L, H, W, 3) and `packed` their stacked
    packs; `hw` = (h, w) stands for `dI_new` when `packed` is given.
    Returns dict(E, n, sat_frac, H (B,8,8), b (B,8), flow_t, flow_rt),
    each with leading dimension B."""
    h, w = hw if hw is not None else (dI_new.shape[-3], dI_new.shape[-2])
    if packed is None:
        packed = pack_bilinear(dI_new)
    B = T_ref_to_new.shape[0]
    dev = T_ref_to_new.device
    rows, Kb, lane = _lane_inputs(pool, K, B, lane, dev)
    u0, v0 = rows["u"], rows["v"]                                    # (B,N)
    idp, color, valid = rows["idepth"], rows["color"], rows["valid"]
    fx, fy, cx, cy = (Kb[:, i:i + 1] for i in range(4))              # (B,1)
    cutoff = torch.as_tensor(cutoff, dtype=torch.float32,
                             device=dev).expand(B)[:, None]
    ref_aff_b = torch.as_tensor(ref_aff_b, dtype=torch.float32,
                                device=dev).expand(B)[:, None]

    xn = (u0 - cx) / fx
    yn = (v0 - cy) / fy
    R = T_ref_to_new[:, :3, :3]
    t = T_ref_to_new[:, :3, 3]
    p = torch.stack([xn, yn, torch.ones_like(xn)], dim=-1)         # (B,N,3)
    pr = torch.einsum("bnj,bij->bni", p, R)                          # p @ R^T
    pt = pr + t[:, None, :] * idp[:, :, None]                        # (B,N,3)
    u = pt[..., 0] / pt[..., 2]
    v = pt[..., 1] / pt[..., 2]
    Ku = fx * u + cx
    Kv = fy * v + cy
    new_idepth = idp / pt[..., 2]

    inb = valid & (Ku > 2) & (Kv > 2) & (Ku < w - 3) & (Kv < h - 3) \
        & (new_idepth > 0)
    hit, hit_ok = bilinear_sample_packed(packed, h, w, Ku, Kv,
                                         base=lane[:, None] * (h * w))
    inb = inb & hit_ok & torch.isfinite(hit[..., 0])

    r = hit[..., 0] - (aff_rel[:, 0:1] * color + aff_rel[:, 1:2])
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
        aff_rel[:, 0:1] * (ref_aff_b - color),
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
    m = valid & (torch.arange(u0.shape[1], device=dev) % 32 == 0)
    ti = t[:, None, :] * idp[:, :, None]
    ptT = p + ti
    ptT2 = p - ti
    pt3 = pr - ti

    def pix_shift(q):
        uu = fx * (q[..., 0] / q[..., 2]) + cx
        vv = fy * (q[..., 1] / q[..., 2]) + cy
        return (uu - u0) ** 2 + (vv - v0) ** 2

    num = m.sum(-1) * 2.0
    zf = torch.zeros((), dtype=u.dtype, device=dev)
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


_POOL_FIELDS = ("u", "v", "idepth", "color", "valid")


def _level_res(x, T, aff, cutoff, h, w, huber_th, lanes):
    """The level's residual and system at (T, aff, cutoff) from a loop's
    inputs `x` (see track_level)."""
    pool = {k: x["pool_" + k] for k in _POOL_FIELDS}
    aff_rel = aff_transfer(x["exposures"][..., 0], x["exposures"][..., 1],
                           x["ref_aff"], aff)
    return calc_res_gs(pool, None, x["K"], T, aff_rel, x["ref_aff"][..., 1],
                       cutoff, huber_th, packed=x["packed"],
                       lane=x["lane"] if lanes else None, hw=(h, w))


def _cutoff_body(x, st, h, w, huber_th, lanes):
    """One doubling of the rows more than 60 % saturated (:694-701)."""
    r0 = {k[2:]: v for k, v in st.items() if k.startswith("r_")}
    rep = st["rep"]
    go = (r0["sat_frac"] > 0.6) & (rep < 50.0)
    rep_n = torch.where(go, rep * 2.0, rep)
    r_n = _level_res(x, x["T0"], x["aff0"], x["cutoff_base"] * rep_n, h, w,
                     huber_th, lanes)
    r0 = _select(go, r_n, r0)
    out = dict({"r_" + k: v for k, v in r0.items()}, rep=rep_n)
    return out, ((r0["sat_frac"] > 0.6) & (rep_n < 50.0)).any()


def _lm_body(x, st, h, w, huber_th, lanes):
    """One LM iteration of every row; rows that have stopped keep their
    carries."""
    r = {k[2:]: v for k, v in st.items() if k.startswith("r_")}
    T, aff, lam, done = st["T"], st["aff"], st["lam"], st["done"]
    act = ~done
    inc = _solve_scaled(r["H"], r["b"], lam)
    inc_scaled = inc * _step_scale(inc)
    T_new = se3.se3_exp(inc_scaled[:, :6]) @ T
    aff_new = aff + inc_scaled[:, 6:]
    r_new = _level_res(x, T_new, aff_new, x["cutoff"], h, w, huber_th, lanes)
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
    n_it = st["n_it"] + act.to(torch.int64)
    out = dict({"r_" + k: v for k, v in r.items()}, T=T, aff=aff, lam=lam,
               done=done, n_it=n_it)
    return out, (~done).any()


def track_level(pool, dI_new, K, T0, aff0, ref_aff, exposures, cutoff_base,
                huber_th, max_iters: int, packed=None, lane=None,
                chunk=None):
    """One pyramid level of trackNewestCoarse for B pose rows: the
    cutoff-doubling pre-loop and the LM loop, each through
    `device_loop.run` (IF chunks in a stage program, graph replays in the
    stage form). T0 (B,4,4), aff0 (B,2), `cutoff_base` a device tensor ()
    or (B,) (a float only outside a program); `ref_aff` and `exposures`
    (2,), or (B, 2) per row with `lane` (see calc_res_gs); `chunk`: the
    LM's iterations per chunk (default `device_loop.CHUNK["lm"]`). Returns
    (T, aff, stats dict, cutoff_rep)."""
    if packed is None:
        packed = pack_bilinear(dI_new)
    B = T0.shape[0]
    dev = T0.device
    h, w = dI_new.shape[-3], dI_new.shape[-2]
    cutoff_base = torch.as_tensor(cutoff_base, dtype=torch.float32,
                                  device=dev).expand(B)
    lanes = lane is not None
    x = {"pool_" + k: pool[k] for k in _POOL_FIELDS}
    x.update(K=K, packed=packed, ref_aff=ref_aff, exposures=exposures)
    if lanes:
        x["lane"] = lane
    static = dict(h=int(h), w=int(w), huber_th=float(huber_th), lanes=lanes)

    # cutoff doubling while > 60% saturated (:694-701): the doublings (at
    # most 6) run as a loop, only when some row needs one
    cutoff_rep = torch.ones(B, dtype=torch.float32, device=dev)
    r0 = _level_res(x, T0, aff0, cutoff_base, **static)
    need = ((r0["sat_frac"] > 0.6) & (cutoff_rep < 50.0)).any()
    xc = dict(x, T0=T0, aff0=aff0, cutoff_base=cutoff_base)
    out = device_loop.cond(
        "cutoff", need,
        lambda c: device_loop.run("cutoff", _cutoff_body, xc, c, 6, static),
        dict({"r_" + k: v for k, v in r0.items()}, rep=cutoff_rep))
    r0 = {k[2:]: v for k, v in out.items() if k.startswith("r_")}
    cutoff_rep = out["rep"]
    cutoff = cutoff_base * cutoff_rep

    st = dict({"r_" + k: v for k, v in r0.items()}, T=T0, aff=aff0,
              lam=torch.full((B,), 0.01, dtype=torch.float32, device=dev),
              done=torch.zeros(B, dtype=torch.bool, device=dev),
              n_it=torch.zeros(B, dtype=torch.int64, device=dev))
    out = device_loop.run("lm", _lm_body, dict(x, cutoff=cutoff), st,
                          max_iters, static, chunk=chunk)
    r = {k[2:]: v for k, v in out.items() if k.startswith("r_")}
    r = dict(r, n_iters=out["n_it"])
    return out["T"], out["aff"], r, cutoff_rep


def track_pyramid(pools, dI_new_pyr, Ks, T_init, aff_init, ref_aff,
                  exposures, min_res_for_abort, cutoff_th, huber_th,
                  coarsest_lvl: int, finest_lvl: int = 0,
                  max_iters=(10, 20, 50, 50, 50), packed_pyr=None,
                  lane=None):
    """Coarse-to-fine track (trackNewestCoarse) of B pose rows.

    T_init (B,4,4) or (4,4); aff_init (B,2) or (2,). With `lane` (B,), the
    pools, images and Ks are lane stacks and `ref_aff`, `exposures` and
    `min_res_for_abort` carry a leading B (see calc_res_gs). Returns dict
    with T, aff, per-level rmse `res` (NaN for levels not run), `flow` from
    the finest level run, `ok`, and per-level LM iteration counts; batched
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
                               mi, packed=packed, lane=lane)

        T, aff, r, cutoff_rep = run_level(T, aff)
        # single level-repeat of the rows whose cutoff was raised
        # (:826-833), when there is one
        do_repeat = (cutoff_rep > 1.0) & (~have_repeated)
        have_repeated = have_repeated | do_repeat

        def repeat(c, run_level=run_level, do_repeat=do_repeat):
            T2, aff2, r2, _ = run_level(c["T"], c["aff"])
            return _select(do_repeat, dict(r2, T=T2, aff=aff2), c)
        c = device_loop.cond("repeat", do_repeat.any(), repeat,
                             dict(r, T=T, aff=aff))
        T, aff = c.pop("T"), c.pop("aff")
        r = c

        rmse = torch.sqrt(r["E"] / torch.clamp(r["n"], min=1))
        last_res[:, lvl] = rmse
        flow = torch.stack([r["flow_t"], torch.zeros_like(r["flow_t"]),
                            r["flow_rt"]], dim=-1)
        ok = ok & ~(rmse > 1.5 * min_res_for_abort[..., lvl])
        lvl_iters[:, lvl] += r["n_iters"]

    ok = ok & (torch.abs(aff[:, 0]) <= 1.2) & (torch.abs(aff[:, 1]) <= 200.0)
    out = dict(T=T, aff=aff, res=last_res, flow=flow, ok=ok,
               lvl_iters=lvl_iters)
    if single:
        out = {k: v[0] for k, v in out.items()}
    return out


def track_coarsest_batch(pool, dI_new, K, T_tries, aff_init, ref_aff,
                         exposures, cutoff_th, huber_th, max_iters: int = 10,
                         packed=None, lane=None):
    """LM-refine ALL pose hypotheses on the coarsest level at once
    (`aff_init` (2,), or (B, 2) per row with `lane`): some hypothesis runs
    to the iteration cap on nearly every frame, so the LM is one replay of
    `max_iters` iterations. Returns dict(T (B,4,4), E (B,), n (B,))."""
    B = T_tries.shape[0]
    aff0 = aff_init.expand(B, 2)
    T, _, r, _ = track_level(pool, dI_new, K, T_tries, aff0, ref_aff,
                             exposures, cutoff_th, huber_th, max_iters,
                             packed=packed, lane=lane, chunk=max_iters)
    return dict(T=T, E=r["E"], n=r["n"])
