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

from sdv_loam_tpu_torch.ops.hopper_kernels import (
    RES_KEYS, STEP_KEYS, aff_transfer, dilate_pyramid,
    lm_update_accept_step, lm_update_step, select_rows, track_res_gs)
from sdv_loam_tpu_torch.ops.warp import pack_bilinear
from sdv_loam_tpu_torch.utils import device_loop


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

def calc_res_gs(pool, dI_new, K, T_ref_to_new, aff_rel, ref_aff_b, cutoff,
                huber_th, packed=None, lane=None, hw=None):
    """Fused residual + 8x8 system evaluation for one level.

    T_ref_to_new: (B, 4, 4); aff_rel: (B, 2); `cutoff` and `ref_aff_b` a
    float or (B,) tensor. `packed` is `pack_bilinear(dI_new)` when the
    caller hoists it out of an LM loop. With `lane` (B,), the pool fields
    are (L, N), K (L, 4), dI_new (L, H, W, 3) and `packed` their stacked
    packs; `hw` = (h, w) stands for `dI_new` when `packed` is given.
    Returns dict(E, n, sat_frac, H (B,8,8), b (B,8), flow_t, flow_rt),
    each with leading dimension B. The K3 kernel on CUDA
    (`hopper_kernels.track_res_gs`), its plain version on the CPU."""
    return track_res_gs(pool, dI_new, K, T_ref_to_new, aff_rel, ref_aff_b,
                        cutoff, huber_th, packed=packed, lane=lane, hw=hw)


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
    r0 = select_rows(go, r_n, r0)
    out = dict({"r_" + k: v for k, v in r0.items()}, rep=rep_n)
    return out, ((r0["sat_frac"] > 0.6) & (rep_n < 50.0)).any()


def _lm_body(x, st, h, w, huber_th, lanes):
    """One LM iteration of every row; rows that have stopped keep their
    carries. The step proposed by the previous iteration (or, in the
    first, before the loop) is a carry: K3 evaluates at it, then K4's
    accept-step takes this iteration's accept and, from the carries it
    selected, proposes the next step. Two launches on CUDA."""
    r = {k: st["r_" + k] for k in RES_KEYS}
    r_new = calc_res_gs({k: x["pool_" + k] for k in _POOL_FIELDS}, None,
                        x["K"], st["T_new"], st["aff_rel"],
                        x["ref_aff"][..., 1], x["cutoff"], huber_th,
                        packed=x["packed"],
                        lane=x["lane"] if lanes else None, hw=(h, w))
    o = lm_update_accept_step(r, r_new, st["T"], st["T_new"], st["aff"],
                              st["aff_new"], st["lam"], st["done"],
                              st["n_it"], st["inc"], x["exposures"],
                              x["ref_aff"])
    out = dict({"r_" + k: v for k, v in o["r"].items()},
               **{k: o[k] for k in ("T", "aff", "lam", "done", "n_it")
                  + STEP_KEYS})
    return out, o["active"]


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

    lam = torch.full((B,), 0.01, dtype=torch.float32, device=dev)
    # the first iteration's step (K4's step entry), then the loop
    step = lm_update_step(r0["H"], r0["b"], lam, T0, aff0, exposures,
                          ref_aff)
    st = dict({"r_" + k: v for k, v in r0.items()}, T=T0, aff=aff0,
              lam=lam, done=torch.zeros(B, dtype=torch.bool, device=dev),
              n_it=torch.zeros(B, dtype=torch.int64, device=dev),
              **dict(zip(STEP_KEYS, step)))
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
            return select_rows(do_repeat, dict(r2, T=T2, aff=aff2), c)
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
