"""Gradient-based pixel selection — the PixelSelector stage.

Counterpart of `sdv_loam_tpu/ops/select.py` (reference PixelSelector2.cpp:
makeHists :47-106, select :209-352, makeMaps :108-207, the LiDAR variants
:354-622). The random draws are arguments: `cascade_direction_draws` draws
the three per-cell direction-index grids from a `torch.Generator`, and the
selection functions take those grids, so a test can feed the JAX draws.
The keep sub-sampling uses numpy's `default_rng(sub_seed)` as in the JAX
package, so it is identical in both.

One selection attempt is one stage program (`utils/device_loop.program`):
"select" (`select_compact_lanes`, the JAX package's compiled
`_select_compact_impl` and `select_compact_batch`) and "select_map"
(`select_cascade`, the status-map form of the camera-only bootstrap).
The density feedback between attempts stays on the host, as in the JAX
package: it reads an attempt's `counts` after the attempt.
"""

from __future__ import annotations

import numpy as np
import torch

from sdv_loam_tpu_torch.config import Settings
from sdv_loam_tpu_torch.utils import device_loop

# the 16 candidate directions (PixelSelector2.cpp:214-229)
DIRECTIONS = np.array(
    [[0, 1.0000], [0.3827, 0.9239], [0.1951, 0.9808], [0.9239, 0.3827],
     [0.7071, 0.7071], [0.3827, -0.9239], [0.8315, 0.5556], [0.8315, -0.5556],
     [0.5556, -0.8315], [0.9808, 0.1951], [0.9239, -0.3827], [0.7071, -0.7071],
     [0.5556, 0.8315], [0.9808, -0.1951], [1.0000, 0.0000], [0.1951, -0.9808]],
    dtype=np.float32)


def grad_hist_thresholds(abs_grad0: torch.Tensor, min_grad_hist_cut=0.5,
                         min_grad_hist_add=3.0):
    """Per-32x32-block smoothed squared gradient thresholds (makeHists):
    (h//32, w//32), or (L, h//32, w//32) for a lane stack (L, h, w)."""
    single = abs_grad0.dim() == 2
    ag = abs_grad0[None] if single else abs_grad0
    L, h, w = ag.shape
    h32, w32 = h // 32, w // 32
    dev = ag.device
    g = torch.sqrt(ag[:, :h32 * 32, :w32 * 32])
    gi = torch.clamp(g.to(torch.int64), 0, 48)
    yy = torch.arange(h32 * 32, device=dev)[:, None]
    xx = torch.arange(w32 * 32, device=dev)[None, :]
    inb = (xx >= 1) & (xx <= w - 2) & (yy >= 1) & (yy <= h - 2)
    blocks = gi.reshape(L, h32, 32, w32, 32).permute(0, 1, 3, 2, 4).reshape(
        L, h32, w32, -1)
    binb = inb.reshape(h32, 32, w32, 32).permute(0, 2, 1, 3).reshape(
        h32, w32, -1).expand(L, h32, w32, -1)
    bid = torch.arange(L * h32 * w32, device=dev).reshape(L, h32, w32, 1) * 49
    # an integer sum: exact in any order (on CUDA an accumulating
    # `index_put_` reads the indices' range on the host; `index_add_` does
    # not)
    hist = torch.zeros(L * h32 * w32 * 49, dtype=torch.int64, device=dev)
    hist.index_add_(0, (bid + blocks).reshape(-1),
                    binb.reshape(-1).to(torch.int64))
    hist = hist.reshape(L, h32, w32, 49)
    total = hist.sum(dim=-1)
    cum = torch.cumsum(hist, dim=-1)
    th = float(min_grad_hist_cut) * total[..., None].to(torch.float32) + 0.5
    above = cum > th
    qbin = torch.argmax(above.to(torch.int64), dim=-1).to(torch.float32)
    qbin = torch.where(cum[..., -1] > th[..., 0], qbin,
                       torch.full_like(qbin, 90.0))
    ths = qbin + float(min_grad_hist_add)
    pad = torch.nn.functional.pad(ths, (1, 1, 1, 1))
    cnt = torch.nn.functional.pad(torch.ones_like(ths), (1, 1, 1, 1))
    ssum = sum(pad[:, 1 + dy:1 + dy + h32, 1 + dx:1 + dx + w32]
               for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    scnt = sum(cnt[:, 1 + dy:1 + dy + h32, 1 + dx:1 + dx + w32]
               for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    sm = ssum / scnt
    out = sm * sm
    return out[0] if single else out


def _block_reduce_argmax(score, block):
    """Blockwise max and the smallest flat pixel index attaining it, per
    lane of an (L, h, w) stack."""
    L, h, w = score.shape
    nby, nbx = h // block, w // block
    v = score.reshape(L, nby, block, nbx, block).amax(dim=(2, 4))
    vb = v.repeat_interleave(block, 1).repeat_interleave(block, 2)
    flat = (torch.arange(h, device=score.device)[:, None] * w
            + torch.arange(w, device=score.device)[None, :])
    first = torch.where(score == vb, flat, torch.full_like(flat, h * w))
    idx = first.reshape(L, nby, block, nbx, block).amin(dim=(2, 4))
    return v, idx


def _pad_to(img, hp, wp, value):
    L, h, w = img.shape
    out = torch.full((L, hp, wp), value, dtype=img.dtype, device=img.device)
    out[:, :h, :w] = img
    return out


def cascade_grid_shapes(h: int, w: int, pot: int):
    """Shapes of the three per-cell direction-index grids for one pot."""
    p4 = 4 * pot
    nc_y, nc_x = -(-h // p4) * p4 // pot, -(-w // p4) * p4 // pot
    return ((nc_y, nc_x), (nc_y // 2 + 1, nc_x // 2 + 1),
            (nc_y // 4 + 1, nc_x // 4 + 1))


def cascade_direction_draws(h: int, w: int, pot: int,
                            generator: torch.Generator, device):
    """Draw the three direction-index grids (values in [0, 16))."""
    return tuple(torch.randint(0, 16, s, generator=generator).to(device)
                 for s in cascade_grid_shapes(h, w, pot))


def _cascade_winners(dI0, ag0, ag1, ag2, ths_smoothed, cand_mask, dir_idx,
                     pot: int, th_factor: float = 1.0,
                     grad_downweight_per_level: float = 0.75,
                     select_direction_distribution: bool = True):
    """The 3-scale selection cascade of L lanes (every argument carries a
    leading L); `dir_idx` are the three direction grids. Returns
    ([(sel, idx, code)] x 3, counts (L, 3), (hp, wp))."""
    L, h, w = ag0.shape
    dev = ag0.device
    gx = dI0[..., 1]
    gy = dI0[..., 2]
    yy = torch.arange(h, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, device=dev)[None, :].expand(h, w)
    inb = (xx >= 4) & (xx < w - 5) & (yy >= 4) & (yy < h - 4)
    cand = cand_mask & inb

    th0 = ths_smoothed[:, torch.clamp(yy >> 5, max=ths_smoothed.shape[1] - 1),
                       torch.clamp(xx >> 5, max=ths_smoothed.shape[2] - 1)]
    dw1 = grad_downweight_per_level
    th1 = th0 * dw1
    th2 = th1 * dw1 * dw1

    x1 = (xx.to(torch.float32) * 0.5 + 0.25).to(torch.int64)
    y1 = (yy.to(torch.float32) * 0.5 + 0.25).to(torch.int64)
    ag1v = ag1[:, torch.clamp(y1, 0, ag1.shape[1] - 1),
               torch.clamp(x1, 0, ag1.shape[2] - 1)]
    x2 = (xx.to(torch.float32) * 0.25 + 0.125).to(torch.int64)
    y2 = (yy.to(torch.float32) * 0.25 + 0.125).to(torch.int64)
    ag2v = ag2[:, torch.clamp(y2, 0, ag2.shape[1] - 1),
               torch.clamp(x2, 0, ag2.shape[2] - 1)]

    pass0 = cand & (ag0 > th0 * th_factor)
    pass1 = cand & (ag1v > th1 * th_factor)
    pass2 = cand & (ag2v > th2 * th_factor)

    p4 = 4 * pot
    hp = -(-h // p4) * p4
    wp = -(-w // p4) * p4
    nc_y, nc_x = hp // pot, wp // pot
    dirs = device_loop.constant(DIRECTIONS, dev)

    def cell_dirs(idx, rep):
        d = dirs[idx.to(torch.int64)]                   # (L, n_y, n_x, 2)
        d = d.repeat_interleave(rep, 1).repeat_interleave(rep, 2)
        return d[:, :hp, :wp]

    gxp = _pad_to(gx, hp, wp, 0.0)
    gyp = _pad_to(gy, hp, wp, 0.0)

    def dir_score(d):
        return torch.abs(gxp * d[..., 0] + gyp * d[..., 1])

    if select_direction_distribution:
        s0 = dir_score(cell_dirs(dir_idx[0], pot))
        s1 = dir_score(cell_dirs(dir_idx[1], 2 * pot))
        s2 = dir_score(cell_dirs(dir_idx[2], 4 * pot))
    else:
        s0 = _pad_to(ag0, hp, wp, 0.0)
        s1 = _pad_to(ag1v, hp, wp, 0.0)
        s2 = _pad_to(ag2v, hp, wp, 0.0)

    p0 = _pad_to(pass0, hp, wp, False)
    p1 = _pad_to(pass1, hp, wp, False)
    p2 = _pad_to(pass2, hp, wp, False)
    neg = torch.full((), -1.0, dtype=torch.float32, device=dev)

    def blocks_any(sel, k):
        return sel.reshape(L, nc_y // k, k, nc_x // k, k).any(dim=4).any(
            dim=2)

    sc0 = torch.where(p0, s0, neg)
    v1, i1 = _block_reduce_argmax(sc0, pot)
    sel1 = v1 >= 0.0

    cell_has1 = sel1.repeat_interleave(pot, 1).repeat_interleave(pot, 2)
    sc1 = torch.where(p1 & (~cell_has1), s1, neg)
    v2, i2 = _block_reduce_argmax(sc1, 2 * pot)
    sel2 = (v2 >= 0.0) & (~blocks_any(sel1, 2))

    blk2_has = sel2.repeat_interleave(2 * pot, 1).repeat_interleave(2 * pot, 2)
    sc2 = torch.where(p2 & (~cell_has1) & (~blk2_has), s2, neg)
    v3, i3 = _block_reduce_argmax(sc2, 4 * pot)
    blk4_has2 = sel2.reshape(L, nc_y // 4, 2, nc_x // 4, 2).any(dim=4).any(
        dim=2)
    sel3 = (v3 >= 0.0) & (~blocks_any(sel1, 4)) & (~blk4_has2)

    counts = torch.stack([sel1.sum(dim=(1, 2)), sel2.sum(dim=(1, 2)),
                          sel3.sum(dim=(1, 2))], -1)
    winners = [(sel1, i1, 1), (sel2, i2, 2), (sel3, i3, 4)]
    return winners, counts, (hp, wp)


SELECT_STATICS = ("pot", "cap", "select_direction_distribution")
# the selection's per-lane tensor arguments, in select_compact's order
SELECT_LANE_ARGS = ("dI0", "ag0", "ag1", "ag2", "cand_mask", "depth_map",
                    "px_u_map", "px_v_map", "dir_idx")


def select_compact(dI0, ag0, ag1, ag2, cand_mask, depth_map, px_u_map,
                   px_v_map, dir_idx, th_factor=1.0, min_grad_hist_cut=0.5,
                   min_grad_hist_add=3.0, grad_downweight_per_level=0.75, *,
                   pot: int, cap: int,
                   select_direction_distribution: bool = True):
    """`_select_compact_impl` of the JAX package: the whole selection
    stage with compacted output (makeHists + cascade +
    per-candidate pattern data, Shi-Tomasi score and LiDAR depth), lane 0
    of `select_compact_lanes`. Returns a dict of (cap,)-shaped rows in
    row-major pixel order, `valid` marking real rows, and `counts` for the
    density feedback."""
    out = select_compact_lanes(
        *(x[None] for x in (dI0, ag0, ag1, ag2, cand_mask, depth_map,
                            px_u_map, px_v_map)),
        tuple(d[None] for d in dir_idx), th_factor, min_grad_hist_cut,
        min_grad_hist_add, grad_downweight_per_level, pot=pot, cap=cap,
        select_direction_distribution=select_direction_distribution)
    return {k: x[0] for k, x in out.items()}


def select_compact_lanes(dI0, ag0, ag1, ag2, cand_mask, depth_map,
                         px_u_map, px_v_map, dir_idx, th_factor=1.0,
                         min_grad_hist_cut=0.5, min_grad_hist_add=3.0,
                         grad_downweight_per_level=0.75, *, pot: int,
                         cap: int, select_direction_distribution: bool = True):
    """`select_compact` of L lanes (the JAX package's
    `select_compact_batch`): every tensor carries a leading L, each lane
    with its own direction draws; the statics and the float settings are
    the lanes' common ones. Returns select_compact's dict with a leading
    L. One stage program (`device_loop.program`, "select"): a key per
    lanes, image shape, pot bucket (the direction grids' shapes) and
    cap."""
    L, h, w = ag0.shape
    x = dict(dI0=dI0, ag0=ag0, ag1=ag1, ag2=ag2, cand_mask=cand_mask,
             depth_map=depth_map, px_u_map=px_u_map, px_v_map=px_v_map,
             dir_idx=tuple(dir_idx))
    return device_loop.program("select", _select_program, x, dict(
        pot=int(pot), cap=int(cap),
        select_direction_distribution=bool(select_direction_distribution),
        th_factor=float(th_factor),
        min_grad_hist_cut=float(min_grad_hist_cut),
        min_grad_hist_add=float(min_grad_hist_add),
        grad_downweight_per_level=float(grad_downweight_per_level),
        h=int(h), w=int(w)))


def _select_program(x, pot, cap, select_direction_distribution, th_factor,
                    min_grad_hist_cut, min_grad_hist_add,
                    grad_downweight_per_level, h, w):
    from sdv_loam_tpu_torch.ops.distmap import shi_tomasi
    from sdv_loam_tpu_torch.ops.trace import pattern_colors

    dI0, ag0, depth_map, px_u_map, px_v_map = (x[k] for k in (
        "dI0", "ag0", "depth_map", "px_u_map", "px_v_map"))
    L = ag0.shape[0]
    ar = torch.arange(L, device=ag0.device)[:, None]
    ths = grad_hist_thresholds(ag0, min_grad_hist_cut, min_grad_hist_add)
    winners, counts, (hp, wp) = _cascade_winners(
        dI0, ag0, x["ag1"], x["ag2"], ths, x["cand_mask"], x["dir_idx"], pot,
        th_factor, grad_downweight_per_level, select_direction_distribution)
    widx = torch.cat([torch.where(s, i, torch.full_like(i, hp * wp))
                      .reshape(L, -1) for s, i, _ in winners], 1)
    wvalid = widx < hp * wp
    skey = torch.where(wvalid, widx, torch.full_like(widx, 2 ** 30))
    take = torch.sort(skey, dim=1)[0][:, :cap]
    valid = take < hp * wp
    idx_c = torch.where(valid, take, torch.zeros_like(take))
    n_sel = wvalid.sum(-1)
    vs_i = idx_c // wp
    us_i = idx_c % wp
    valid = valid & (us_i < w) & (vs_i < h)
    vs = vs_i.to(torch.float32)
    us = us_i.to(torch.float32)
    vcl = torch.clamp(vs_i, max=h - 1)
    ucl = torch.clamp(us_i, max=w - 1)
    z = depth_map[ar, vcl, ucl]
    fu = px_u_map[ar, vcl, ucl]
    fv = px_v_map[ar, vcl, ucl]
    use_f = (z > 0) & (fu >= 0) & (fv >= 0)
    us = torch.where(use_f, fu, us)
    vs = torch.where(use_f, fv, vs)
    col, wgt, gradH, finite, gcen = pattern_colors(dI0, us, vs)
    score = shi_tomasi(dI0, us, vs)
    return dict(u=us, v=vs, valid=valid, counts=counts, n_sel=n_sel,
                color=col, weights=wgt, gradH=gradH,
                finite=finite & valid, gcen=gcen, score=score, z=z)


# pot ladder (see the JAX package): the selectable cell sizes
_POT_LADDER = (1, 2, 3, 4, 6, 8, 12, 16)


def _pot_bucket(pot) -> int:
    """Largest ladder value <= pot."""
    p = max(1, int(pot))
    out = _POT_LADDER[0]
    for v in _POT_LADDER:
        if v <= p:
            out = v
    return out


def make_maps_compact_steps(dI0, abs_grads, cand_mask, depth_map,
                            px_u_map, px_v_map, density, draw_dirs,
                            pot_state: dict, settings: Settings, cap: int,
                            th_factor: float = 1.0, sub_seed: int = 0):
    """Generator form of the density-feedback selection (makeMaps /
    makeMapsFromLidar): at most one re-run with an adjusted pot, then numpy
    keep sub-sampling toward the density. Each attempt draws its direction
    grids (`draw_dirs(pot)`) and yields a request dict(args, statics) for
    `select_compact`; the caller sends back that call's outputs as host
    numpy arrays, so a fleet can run several sequences' attempts as
    lanes of one `select_compact_lanes` call. Returns (out dict of host
    numpy arrays, keep (cap,) bool)."""
    pot = _pot_bucket(pot_state.get("pot", 3))
    for recursion in range(2):
        out = yield dict(
            args=dict(dI0=dI0, ag0=abs_grads[0], ag1=abs_grads[1],
                      ag2=abs_grads[2], cand_mask=cand_mask,
                      depth_map=depth_map, px_u_map=px_u_map,
                      px_v_map=px_v_map, dir_idx=draw_dirs(pot)),
            statics=dict(
                pot=pot, cap=cap, th_factor=float(th_factor),
                min_grad_hist_cut=float(settings.min_grad_hist_cut),
                min_grad_hist_add=float(settings.min_grad_hist_add),
                grad_downweight_per_level=float(
                    settings.grad_downweight_per_level),
                select_direction_distribution=bool(
                    settings.select_direction_distribution)))
        num_have = float(out["counts"].sum())
        quotia = density / max(num_have, 1.0)
        K = num_have * (pot + 1) * (pot + 1)
        ideal_pot = max(1, int(np.sqrt(K / max(density, 1.0)) - 1))
        if recursion == 0 and quotia > 1.25 and pot > 1:
            pot = _pot_bucket(min(ideal_pot, pot - 1))
            continue
        if recursion == 0 and quotia < 0.25:
            pot = _pot_bucket(max(ideal_pot, pot + 1))
            continue
        break
    pot_state["pot"] = _pot_bucket(ideal_pot)

    keep = np.asarray(out["valid"]).copy()
    if quotia < 0.95:
        rng = np.random.default_rng(sub_seed)
        keep &= rng.random(keep.shape) < quotia
    return out, keep


def run_select(req, fetch):
    """One selection request of `make_maps_compact_steps`, alone -> its
    outputs as host numpy arrays, each read back by `fetch` (a system's
    readback, `FullSystem._np`)."""
    out = select_compact(*(req["args"][k] for k in SELECT_LANE_ARGS),
                         **req["statics"])
    return {k: fetch(v) for k, v in out.items()}


def drive_steps(gen, run):
    """Drive a request generator to its return value, `run(request)`
    answering each request."""
    reply = None
    while True:
        try:
            req = gen.send(reply)
        except StopIteration as stop:
            return stop.value
        reply = run(req)


def make_maps_compact(*args, fetch, **kw):
    """`make_maps_compact_steps` of one sequence, each attempt run alone
    (its outputs read back by `fetch`, as `run_select`'s). Returns (out
    dict of host numpy arrays, keep (cap,) bool)."""
    return drive_steps(make_maps_compact_steps(*args, **kw),
                       lambda req: run_select(req, fetch))


def select_cascade(dI0, ag0, ag1, ag2, ths_smoothed, cand_mask, dir_idx,
                   pot: int, th_factor: float = 1.0,
                   grad_downweight_per_level: float = 0.75,
                   select_direction_distribution: bool = True):
    """The 3-scale selection cascade of one image as the dense status
    image (the JAX package's `select_cascade`): (status (H, W) int8 in
    {0, 1, 2, 4}, counts (3,)). One stage program (`device_loop.program`,
    "select_map"): a key per image shape and pot."""
    x = dict(dI0=dI0, ag0=ag0, ag1=ag1, ag2=ag2, ths=ths_smoothed,
             cand_mask=cand_mask, dir_idx=tuple(dir_idx))
    return device_loop.program("select_map", _select_map_program, x, dict(
        pot=int(pot), th_factor=float(th_factor),
        grad_downweight_per_level=float(grad_downweight_per_level),
        select_direction_distribution=bool(select_direction_distribution)))


def _select_map_program(x, pot, th_factor, grad_downweight_per_level,
                        select_direction_distribution):
    h, w = x["ag0"].shape
    winners, counts, (hp, wp) = _cascade_winners(
        *(x[k][None] for k in ("dI0", "ag0", "ag1", "ag2", "ths",
                               "cand_mask")),
        tuple(d[None] for d in x["dir_idx"]), pot, th_factor,
        grad_downweight_per_level, select_direction_distribution)
    status = torch.zeros(hp * wp, dtype=torch.int64, device=x["ag0"].device)
    for sel, idx, code in winners[::-1]:
        status.scatter_reduce_(
            0, torch.where(sel, idx, torch.full_like(idx, hp * wp - 1))
            .reshape(-1), (sel.to(torch.int64) * code).reshape(-1),
            reduce="amax")
    return status.reshape(hp, wp)[:h, :w].to(torch.int8), counts[0]


def make_maps(dI0, abs_grads, cand_mask, density, draw_dirs, draw_keep,
              pot_state: dict, settings: Settings, th_factor: float = 1.0):
    """Host-driven density feedback around `select_cascade` (makeMaps /
    makeMapsFromLidar, PixelSelector2.cpp:108-207 & 354-457; the JAX
    package's status-map `make_maps`): at most one re-run with an adjusted
    pot, then random subsampling of the status map toward the density.

    The two random draws are arguments: `draw_dirs(pot)` gives the three
    direction grids of an attempt and `draw_keep(shape)` the (H, W)
    uniform [0, 1) draws of the keep mask, so a caller can feed the JAX
    package's draws. `pot_state`: mutable {"pot": int} carried across calls
    (the reference's currentPotential).

    Returns (status (H, W) int8 numpy array, n_selected int)."""
    ths = grad_hist_thresholds(abs_grads[0], settings.min_grad_hist_cut,
                               settings.min_grad_hist_add)
    pot = max(1, int(pot_state.get("pot", 3)))
    for recursion in range(2):  # initial + up to 1 re-run (recursionsLeft=1)
        status, counts = select_cascade(
            dI0, abs_grads[0], abs_grads[1], abs_grads[2], ths, cand_mask,
            draw_dirs(pot), pot, th_factor,
            settings.grad_downweight_per_level,
            settings.select_direction_distribution)
        num_have = float(counts.sum())
        quotia = density / max(num_have, 1.0)
        K = num_have * (pot + 1) * (pot + 1)
        ideal_pot = max(1, int(np.sqrt(K / max(density, 1.0)) - 1))
        if recursion == 0 and quotia > 1.25 and pot > 1:
            pot = min(ideal_pot, pot - 1)
            continue
        if recursion == 0 and quotia < 0.25:
            pot = max(ideal_pot, pot + 1)
            continue
        break

    status_np = status.cpu().numpy()
    n_have = int((status_np != 0).sum())
    if quotia < 0.95 and n_have > 0:
        keep = np.asarray(draw_keep(status_np.shape)) < quotia
        status_np = np.where(keep, status_np, 0).astype(np.int8)
        n_have = int((status_np != 0).sum())
    pot_state["pot"] = ideal_pot
    return status_np, n_have
