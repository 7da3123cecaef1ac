"""Gradient-based pixel selection — the PixelSelector stage.

Counterpart of `sdv_loam_tpu/ops/select.py` (reference PixelSelector2.cpp:
makeHists :47-106, select :209-352, makeMaps :108-207, the LiDAR variants
:354-622). The random draws are arguments: `cascade_direction_draws` draws
the three per-cell direction-index grids from a `torch.Generator`, and the
selection functions take those grids, so a test can feed the JAX draws.
The keep sub-sampling uses numpy's `default_rng(sub_seed)` as in the JAX
package, so it is identical in both.
"""

from __future__ import annotations

import numpy as np
import torch

from sdv_loam_tpu_torch.config import Settings

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
    (h//32, w//32)."""
    h, w = abs_grad0.shape
    h32, w32 = h // 32, w // 32
    dev = abs_grad0.device
    g = torch.sqrt(abs_grad0[:h32 * 32, :w32 * 32])
    gi = torch.clamp(g.to(torch.int64), 0, 48)
    yy = torch.arange(h32 * 32, device=dev)[:, None]
    xx = torch.arange(w32 * 32, device=dev)[None, :]
    inb = (xx >= 1) & (xx <= w - 2) & (yy >= 1) & (yy <= h - 2)
    blocks = gi.reshape(h32, 32, w32, 32).permute(0, 2, 1, 3).reshape(
        h32, w32, -1)
    binb = inb.reshape(h32, 32, w32, 32).permute(0, 2, 1, 3).reshape(
        h32, w32, -1)
    bid = torch.arange(h32 * w32, device=dev).reshape(h32, w32, 1) * 49
    hist = torch.zeros(h32 * w32 * 49, dtype=torch.int64, device=dev)
    hist.index_put_(((bid + blocks).reshape(-1),),
                    binb.reshape(-1).to(torch.int64), accumulate=True)
    hist = hist.reshape(h32, w32, 49)
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
    ssum = sum(pad[1 + dy:1 + dy + h32, 1 + dx:1 + dx + w32]
               for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    scnt = sum(cnt[1 + dy:1 + dy + h32, 1 + dx:1 + dx + w32]
               for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    sm = ssum / scnt
    return sm * sm


def _block_reduce_argmax(score, block):
    """Blockwise max and the smallest flat pixel index attaining it."""
    h, w = score.shape
    nby, nbx = h // block, w // block
    v = score.reshape(nby, block, nbx, block).amax(dim=(1, 3))
    vb = v.repeat_interleave(block, 0).repeat_interleave(block, 1)
    flat = (torch.arange(h, device=score.device)[:, None] * w
            + torch.arange(w, device=score.device)[None, :])
    first = torch.where(score == vb, flat, torch.full_like(flat, h * w))
    idx = first.reshape(nby, block, nbx, block).amin(dim=(1, 3))
    return v, idx


def _pad_to(img, hp, wp, value):
    h, w = img.shape
    out = torch.full((hp, wp), value, dtype=img.dtype, device=img.device)
    out[:h, :w] = img
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
    """The 3-scale selection cascade; `dir_idx` are the three direction
    grids. Returns ([(sel, idx, code)] x 3, counts (3,), (hp, wp))."""
    h, w = ag0.shape
    dev = ag0.device
    gx = dI0[..., 1]
    gy = dI0[..., 2]
    yy = torch.arange(h, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, device=dev)[None, :].expand(h, w)
    inb = (xx >= 4) & (xx < w - 5) & (yy >= 4) & (yy < h - 4)
    cand = cand_mask & inb

    th0 = ths_smoothed[torch.clamp(yy >> 5, max=ths_smoothed.shape[0] - 1),
                       torch.clamp(xx >> 5, max=ths_smoothed.shape[1] - 1)]
    dw1 = grad_downweight_per_level
    th1 = th0 * dw1
    th2 = th1 * dw1 * dw1

    x1 = (xx.to(torch.float32) * 0.5 + 0.25).to(torch.int64)
    y1 = (yy.to(torch.float32) * 0.5 + 0.25).to(torch.int64)
    ag1v = ag1[torch.clamp(y1, 0, ag1.shape[0] - 1),
               torch.clamp(x1, 0, ag1.shape[1] - 1)]
    x2 = (xx.to(torch.float32) * 0.25 + 0.125).to(torch.int64)
    y2 = (yy.to(torch.float32) * 0.25 + 0.125).to(torch.int64)
    ag2v = ag2[torch.clamp(y2, 0, ag2.shape[0] - 1),
               torch.clamp(x2, 0, ag2.shape[1] - 1)]

    pass0 = cand & (ag0 > th0 * th_factor)
    pass1 = cand & (ag1v > th1 * th_factor)
    pass2 = cand & (ag2v > th2 * th_factor)

    p4 = 4 * pot
    hp = -(-h // p4) * p4
    wp = -(-w // p4) * p4
    nc_y, nc_x = hp // pot, wp // pot
    dirs = torch.as_tensor(DIRECTIONS, device=dev)

    def cell_dirs(idx, rep):
        d = dirs[idx.to(torch.int64)]                     # (n_y, n_x, 2)
        d = d.repeat_interleave(rep, 0).repeat_interleave(rep, 1)
        return d[:hp, :wp]

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

    sc0 = torch.where(p0, s0, neg)
    v1, i1 = _block_reduce_argmax(sc0, pot)
    sel1 = v1 >= 0.0

    cell_has1 = sel1.repeat_interleave(pot, 0).repeat_interleave(pot, 1)
    sc1 = torch.where(p1 & (~cell_has1), s1, neg)
    v2, i2 = _block_reduce_argmax(sc1, 2 * pot)
    blk_has1 = sel1.reshape(nc_y // 2, 2, nc_x // 2, 2).any(dim=3).any(dim=1)
    sel2 = (v2 >= 0.0) & (~blk_has1)

    blk2_has = sel2.repeat_interleave(2 * pot, 0).repeat_interleave(2 * pot, 1)
    sc2 = torch.where(p2 & (~cell_has1) & (~blk2_has), s2, neg)
    v3, i3 = _block_reduce_argmax(sc2, 4 * pot)
    blk4_has1 = sel1.reshape(nc_y // 4, 4, nc_x // 4, 4).any(dim=3).any(dim=1)
    blk4_has2 = sel2.reshape(nc_y // 4, 2, nc_x // 4, 2).any(dim=3).any(dim=1)
    sel3 = (v3 >= 0.0) & (~blk4_has1) & (~blk4_has2)

    counts = torch.stack([sel1.sum(), sel2.sum(), sel3.sum()])
    winners = [(sel1, i1, 1), (sel2, i2, 2), (sel3, i3, 4)]
    return winners, counts, (hp, wp)


def select_compact(dI0, ag0, ag1, ag2, cand_mask, depth_map, px_u_map,
                   px_v_map, dir_idx, th_factor=1.0, min_grad_hist_cut=0.5,
                   min_grad_hist_add=3.0, grad_downweight_per_level=0.75, *,
                   pot: int, cap: int,
                   select_direction_distribution: bool = True):
    """`_select_compact_impl` of the JAX package: the whole selection
    stage with compacted output (makeHists + cascade +
    per-candidate pattern data, Shi-Tomasi score and LiDAR depth).
    Returns a dict of (cap,)-shaped rows in row-major pixel order, `valid`
    marking real rows, and `counts` for the density feedback."""
    from sdv_loam_tpu_torch.ops.distmap import shi_tomasi
    from sdv_loam_tpu_torch.ops.trace import pattern_colors

    h, w = ag0.shape
    ths = grad_hist_thresholds(ag0, min_grad_hist_cut, min_grad_hist_add)
    winners, counts, (hp, wp) = _cascade_winners(
        dI0, ag0, ag1, ag2, ths, cand_mask, dir_idx, pot, th_factor,
        grad_downweight_per_level, select_direction_distribution)
    widx = torch.cat([torch.where(s, i, torch.full_like(i, hp * wp))
                      .reshape(-1) for s, i, _ in winners])
    wvalid = widx < hp * wp
    skey = torch.where(wvalid, widx, torch.full_like(widx, 2 ** 30))
    take = torch.sort(skey)[0][:cap]
    valid = take < hp * wp
    idx_c = torch.where(valid, take, torch.zeros_like(take))
    n_sel = wvalid.sum()
    vs_i = idx_c // wp
    us_i = idx_c % wp
    valid = valid & (us_i < w) & (vs_i < h)
    vs = vs_i.to(torch.float32)
    us = us_i.to(torch.float32)
    vcl = torch.clamp(vs_i, max=h - 1)
    ucl = torch.clamp(us_i, max=w - 1)
    z = depth_map[vcl, ucl]
    fu = px_u_map[vcl, ucl]
    fv = px_v_map[vcl, ucl]
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


def make_maps_compact(dI0, abs_grads, cand_mask, depth_map, px_u_map,
                      px_v_map, density, draw_dirs, pot_state: dict,
                      settings: Settings, cap: int, th_factor: float = 1.0,
                      sub_seed: int = 0):
    """Density-feedback selection (makeMaps / makeMapsFromLidar): at most
    one re-run with an adjusted pot, then numpy keep sub-sampling toward the
    density. `draw_dirs(pot)` returns the three direction grids for a pot
    (one call per attempt, as the JAX package draws one key per call).
    Returns (out dict of host numpy arrays, keep (cap,) bool)."""
    pot = _pot_bucket(pot_state.get("pot", 3))
    dirs = None
    for recursion in range(2):
        if dirs is None:
            dirs = draw_dirs(pot)
        out = select_compact(
            dI0, abs_grads[0], abs_grads[1], abs_grads[2], cand_mask,
            depth_map, px_u_map, px_v_map, dirs, th_factor,
            settings.min_grad_hist_cut, settings.min_grad_hist_add,
            settings.grad_downweight_per_level, pot=pot, cap=cap,
            select_direction_distribution=settings
            .select_direction_distribution)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        num_have = float(out["counts"].sum())
        quotia = density / max(num_have, 1.0)
        K = num_have * (pot + 1) * (pot + 1)
        ideal_pot = max(1, int(np.sqrt(K / max(density, 1.0)) - 1))
        if recursion == 0 and quotia > 1.25 and pot > 1:
            pot = _pot_bucket(min(ideal_pot, pot - 1))
            dirs = None
            continue
        if recursion == 0 and quotia < 0.25:
            pot = _pot_bucket(max(ideal_pot, pot + 1))
            dirs = None
            continue
        break
    pot_state["pot"] = _pot_bucket(ideal_pot)

    keep = np.asarray(out["valid"]).copy()
    if quotia < 0.95:
        rng = np.random.default_rng(sub_seed)
        keep &= rng.random(keep.shape) < quotia
    return out, keep
