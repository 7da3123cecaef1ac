"""Monocular coarse initializer — the camera-only bootstrap.

Counterpart of `sdv_loam_tpu/ops/mono_init.py` (reference
src/FullSystem/CoarseInitializer.cpp):
  * setFirst (:687-764): per-level point selection (PixelSelector at level
    0, gradient-quantile selection above), idepth = 1 everywhere, 10-NN
    neighbour graph + coarser-level parent links (makeNN :998-1075, here
    ops/knn);
  * trackFrame (:50-230): coarse-to-fine LM over (SE3 pose, affine a/b)
    with per-point idepth solved by Schur complement (calcResAndGS
    :281-525), the translation-prior "alpha" energy pushing idepths to 1
    until enough parallax accumulates ("snapped"), then a coupling term
    toward the neighbour-regularized iR (optReg :552-589, calcEC
    :533-551);
  * propagateUp/Down (:590-686), resetPoints (:890-917), doStep/applyStep
    (:918-996) between levels and iterations.

`FullSystem` starts it when the first frame arrives without a cloud, so the
pipeline runs camera-only (monocular, scale-free).

Each level's LM (`_level_lm`) is one stage program (`utils/device_loop.
program`, "mono_lm": the JAX package compiles one program per level), a
key per level shape, point cap and `max_iters`: the initial calcResAndGS,
the loop and the rmse. The loop (`device_loop.run`, "mono") is the JAX
package's `lax.while_loop`: its stop test `(fails >= 2) | done` is a
carry, and an iteration after the stop changes no carry; the accept /
reject state is selected on the device by `torch.where`, float32
throughout. The 8x8 Schur solve is one `torch.linalg.solve_ex` call. The pattern
samples come from `ops/trace.pattern_colors` and the quad-packed sampler
(`ops/warp.pack_bilinear`, `ops/warp.quad_bilinear`). Between-level
propagation runs on host numpy, as in the JAX package.

Deviations (as in the JAX package):
  * level-0 selection reuses ops/select.make_maps (the reference's
    PixelSelector with thFactor=2); its two random draws come from a
    `torch.Generator` seeded 7 (the JAX package's PRNGKey(7)) unless the
    caller passes them; upper levels select by a gradient quantile toward
    the density target;
  * point counts are padded to a power-of-two cap per level (masked lanes).
"""

from __future__ import annotations

import numpy as np
import torch

from sdv_loam_tpu_torch.config import PATTERN_P, Settings
from sdv_loam_tpu_torch.ops.knn import knn, nearest_cross
from sdv_loam_tpu_torch.ops.select import cascade_direction_draws, make_maps
from sdv_loam_tpu_torch.ops.trace import pattern_colors
from sdv_loam_tpu_torch.ops.warp import pack_bilinear, quad_bilinear
from sdv_loam_tpu_torch.utils import device_loop, se3

# trackFrame constants (CoarseInitializer.cpp:58-62)
ALPHA_K = 2.5 * 2.5
ALPHA_W = 150.0 * 150.0
REG_WEIGHT = 0.8
COUPLING_WEIGHT = 1.0
MAX_ITERS = (5, 5, 10, 30, 50)          # per level, fine->coarse
# wM preconditioner (CoarseInitializer.cpp:33-36; SCALE_* in NumType.h)
SCALE_XI_ROT = 1.0
SCALE_XI_TRANS = 0.5
SCALE_A = 10.0
SCALE_B = 1000.0
W_M = np.array([SCALE_XI_ROT] * 3 + [SCALE_XI_TRANS] * 3
               + [SCALE_A, SCALE_B], np.float32)
# the seed of the level-0 selection draws (the JAX package's PRNGKey(7))
SELECT_SEED = 7
# the level pools' fields that the LM updates
LM_FIELDS = ("idepth", "iR", "is_good", "energy", "energy_a", "last_hessian")


def _median_masked(vals, ok):
    """Per-row median of masked values — nth_element(nnn/2) semantics
    (optReg, CoarseInitializer.cpp:575): invalid entries sort to +inf and
    the median index is nnn // 2."""
    inf = torch.full((), float("inf"), dtype=vals.dtype, device=vals.device)
    v = torch.sort(torch.where(ok, vals, inf), dim=-1)[0]
    nnn = ok.sum(-1)
    med = torch.take_along_dim(v, (nnn // 2)[:, None], dim=-1)[:, 0]
    return med, nnn


def _level_lm(T_init, aff_init, pt, nbr_idx, nbr_ok, quad_new, ref_color,
              K, snapped_in, w: int, h: int, max_iters: int,
              huber_th: float = 9.0):
    """One pyramid level of trackFrame.

    pt: dict(u, v, valid, idepth, iR, is_good, energy, energy_a,
        last_hessian) — (N,) pools (padded; is_good False on padding).
    quad_new: (h*w, 12) quad-packed target level (intensity + grads).
    ref_color: (N, 8) pattern intensities of the first frame.
    snapped_in: () bool tensor. Returns a dict with the updated pose, affine
    and pools, `snapped`, `rmse` and `iters` (device tensors). One stage
    program (`device_loop.program`, "mono_lm")."""
    x = dict(T=T_init, aff=aff_init, pt=dict(pt), nbr_idx=nbr_idx,
             nbr_ok=nbr_ok, quad_new=quad_new, ref_color=ref_color, K=K,
             snapped=snapped_in)
    return device_loop.program("mono_lm", _level_lm_program, x, dict(
        w=int(w), h=int(h), max_iters=int(max_iters),
        huber_th=float(huber_th)))


def _calc_res_gs(x, T, aff, idepth, is_good, energy, energy_a, w, h,
                 huber_th):
    """calcResAndGS: per-point pattern residuals -> (H, b, Hsc, bsc, Jb,
    E, alphaEnergy, isGood_new, maxstep). `x`: the level's fixed inputs
    (`_level_lm_program`)."""
    f32 = torch.float32
    dev = idepth.device
    fx, fy, cx, cy = x["K"][0], x["K"][1], x["K"][2], x["K"][3]
    ref_color = x["ref_color"]
    npts = x["npts"]
    zero = torch.zeros((), dtype=f32, device=dev)
    outlier_th = 8 * 12 * 12
    R = T[:3, :3]
    t = T[:3, 3]
    ptp = torch.einsum("ij,npj->npi", R, x["Kinv_r"]) \
        + (t[None, :] * idepth[:, None])[:, None, :]
    u = ptp[..., 0] / ptp[..., 2]
    v = ptp[..., 1] / ptp[..., 2]
    Ku = fx * u + cx
    Kv = fy * v + cy
    new_id = idepth[:, None] / ptp[..., 2]
    inb = (Ku > 1) & (Kv > 1) & (Ku < w - 2) & (Kv < h - 2) & (new_id > 0)
    Kuc = torch.clamp(Ku, 0.0, w - 1.01)
    Kvc = torch.clamp(Kv, 0.0, h - 1.01)
    hit = quad_bilinear(x["quad_new"], x["base0"], x["wv"], Kuc,
                         Kvc)                                   # (N, 8, 3)
    a_exp = torch.exp(aff[0])
    res = hit[..., 0] - a_exp * ref_color - aff[1]
    ok_fin = torch.isfinite(res)
    absr = torch.abs(res)
    hw = torch.where(absr < huber_th, torch.ones_like(absr),
                     huber_th / torch.clamp(absr, min=1e-12))
    e_pat = hw * res * res * (2.0 - hw)
    good_pat = inb & ok_fin
    all_ok = good_pat.all(-1) & is_good
    energy_pt = torch.where(good_pat, e_pat, zero).sum(-1)
    good_new = all_ok & (energy_pt <= outlier_th * 20)

    # Jacobian rows (:371-400)
    hws = torch.where(hw < 1.0, torch.sqrt(hw), hw)
    dxdd = (t[0] - t[2] * u) / ptp[..., 2]
    dydd = (t[1] - t[2] * v) / ptp[..., 2]
    dxi = hws * hit[..., 1] * fx
    dyi = hws * hit[..., 2] * fy
    dp = torch.stack([
        new_id * dxi,
        new_id * dyi,
        -new_id * (u * dxi + v * dyi),
        -u * v * dxi - (1 + v * v) * dyi,
        (1 + u * u) * dxi + u * v * dyi,
        -v * dxi + u * dyi,
        -hws * a_exp * ref_color,
        -hws * torch.ones_like(u),
    ], dim=-1)                                             # (N, 8, 8)
    dd = dxi * dxdd + dyi * dydd                           # (N, 8)
    rw = hws * res
    maxstep = torch.where(
        good_pat, 1.0 / torch.clamp(torch.hypot(dxdd * fx, dydd * fy),
                                    min=1e-12),
        torch.full((), 1e10, dtype=f32, device=dev)).amin(-1)

    gsel = good_new[:, None]
    dp_m = torch.where(gsel[..., None], dp, zero)
    dd_m = torch.where(gsel, dd, zero)
    r_m = torch.where(gsel, rw, zero)
    Hm = torch.einsum("npi,npj->ij", dp_m, dp_m)
    bm = torch.einsum("npi,np->i", dp_m, r_m)
    Jb = torch.cat([
        torch.einsum("npi,np->ni", dp_m, dd_m),            # 0..7
        (r_m * dd_m).sum(-1)[:, None],                     # 8
        (dd_m * dd_m).sum(-1)[:, None],                    # 9
    ], dim=-1)

    # energies: failed points contribute their OLD energy (:315,:425)
    valid = x["valid"]
    E_phot = torch.where(good_new, energy_pt,
                         torch.where(valid, energy, zero)).sum()
    ea_new = (idepth - 1.0) ** 2
    E_alpha_pts = torch.where(good_new, ea_new,
                              torch.where(valid, energy_a, zero)).sum()
    alpha_energy = ALPHA_W * (E_alpha_pts + torch.sum(t * t) * npts)
    capped = alpha_energy > ALPHA_K * npts
    alpha_energy = torch.minimum(alpha_energy, ALPHA_K * npts)
    alpha_opt = torch.where(capped, zero, zero + ALPHA_W)

    # Schur terms with alpha / coupling priors (:481-520); the coupling
    # pulls toward the level's input iR
    Jb8 = Jb[:, 8] + alpha_opt * (idepth - 1.0) \
        + torch.where(capped, COUPLING_WEIGHT * (idepth - x["iR0"]), zero)
    Jb9 = Jb[:, 9] + alpha_opt + torch.where(capped,
                                             zero + COUPLING_WEIGHT, zero)
    Jb9i = torch.where(good_new, 1.0 / (1.0 + Jb9), zero)
    Hsc = torch.einsum("ni,nj,n->ij", Jb[:, :8], Jb[:, :8], Jb9i)
    bsc = torch.einsum("ni,n->i", Jb[:, :8], Jb8 * Jb9i)
    Hm = Hm + torch.diag(torch.cat([(alpha_opt * npts).expand(3),
                                    torch.zeros(5, dtype=f32, device=dev)]))
    tlog = se3.se3_log(T)[:3]
    bm = bm + torch.cat([tlog * alpha_opt * npts,
                         torch.zeros(5, dtype=f32, device=dev)])

    Jb_out = torch.cat([Jb[:, :8], Jb8[:, None], Jb9i[:, None]], dim=-1)
    return dict(H=Hm, b=bm, Hsc=Hsc, bsc=bsc, Jb=Jb_out,
                E_phot=E_phot, alpha_energy=alpha_energy,
                capped=capped, good_new=good_new,
                energy_pt=torch.where(good_new, energy_pt, energy),
                energy_a=torch.where(good_new, ea_new, energy_a),
                hess=Jb[:, 9], maxstep=maxstep)


def _opt_reg(x, idepth, iR, is_good, snapped):
    """optReg: iR <- 0.2 id + 0.8 median(neighbour iR) (:552-589)."""
    nbr_c = x["nbr_c"]
    med, nnn = _median_masked(iR[nbr_c], x["nbr_ok"] & is_good[nbr_c])
    use = is_good & (nnn > 2) & torch.isfinite(med)
    iR_new = torch.where(use, (1 - REG_WEIGHT) * idepth
                         + REG_WEIGHT * med, iR)
    return torch.where(snapped, iR_new, torch.ones_like(iR))


def _mono_body(x, c, w, h, huber_th):
    """One LM iteration (trackFrame's inner loop, :101-205); every carry
    frozen once `stop` holds."""
    f32 = torch.float32
    dev = c["lam"].device
    eye8 = torch.eye(8, dtype=f32, device=dev)
    wm = device_loop.constant(W_M, dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    s_scale = 0.01 / (w * h)
    lam = c["lam"]
    Hl = c["H"] * (1.0 + lam * eye8) - c["Hsc"] / (1.0 + lam)
    bl = c["b"] - c["bsc"] / (1.0 + lam)
    Hl = wm[:, None] * Hl * wm[None, :] * s_scale
    bl = wm * bl * s_scale
    inc = -(wm * torch.linalg.solve_ex(Hl + eye8 * 1e-12, bl)[0])
    inc = torch.where(torch.isfinite(inc), inc, zero)
    T_new = se3.se3_exp(inc[:6]) @ c["T"]
    aff_new = c["aff"] + inc[6:8]

    # doStep (:918-945): per-point idepth back-substitution
    bstep = c["Jb"][:, 8] + c["Jb"][:, :8] @ inc
    step = -bstep * c["Jb"][:, 9] / (1.0 + lam)
    mstep = torch.clamp(0.25 * c["maxstep"], max=1e10)
    step = torch.maximum(torch.minimum(step, mstep), -mstep)
    id_new = torch.clamp(c["idepth"] + step, 1e-3, 50.0)
    id_new = torch.where(c["is_good"], id_new, c["idepth"])

    st = _calc_res_gs(x, T_new, aff_new, id_new, c["is_good"], c["energy"],
                      c["energy_a"], w, h, huber_th)
    # calcEC (:533-551): coupling energy old/new (zero pre-snap)
    snapped = c["snapped"]
    ec_ok = st["good_new"]
    ec_old = torch.where(ec_ok, (c["idepth"] - c["iR"]) ** 2, zero).sum()
    ec_new = torch.where(ec_ok, (id_new - c["iR"]) ** 2, zero).sum()
    ec_old = torch.where(snapped, COUPLING_WEIGHT * ec_old, zero)
    ec_new = torch.where(snapped, COUPLING_WEIGHT * ec_new, zero)

    e_new = st["E_phot"] + st["alpha_energy"] + ec_new
    e_old = c["E_phot"] + c["alpha_energy"] + ec_old
    accept = e_old > e_new
    snapped = snapped | (accept & st["capped"])

    new = dict(T=T_new, aff=aff_new, idepth=id_new,
               iR=_opt_reg(x, id_new, c["iR"], st["good_new"], snapped),
               is_good=st["good_new"], energy=st["energy_pt"],
               energy_a=st["energy_a"], last_hessian=st["hess"],
               H=st["H"], b=st["b"], Hsc=st["Hsc"], bsc=st["bsc"],
               Jb=st["Jb"], maxstep=st["maxstep"],
               E_phot=st["E_phot"], alpha_energy=st["alpha_energy"],
               lam=torch.clamp(lam * 0.5, min=1e-4),
               fails=torch.zeros_like(c["fails"]))
    rej = dict(lam=torch.clamp(lam * 4.0, max=1e4), fails=c["fails"] + 1)
    nxt = {k: torch.where(accept, new[k], rej.get(k, c[k])) for k in new}
    done = torch.linalg.vector_norm(inc) <= 1e-4
    nxt.update(snapped=snapped, it=c["it"] + 1,
               stop=(nxt["fails"] >= 2) | done)
    out = {k: torch.where(c["stop"], c[k], nxt[k]) for k in c}
    return out, ~out["stop"]


def _level_lm_program(x, w, h, max_iters, huber_th):
    f32 = torch.float32
    pt = {k: (v.to(f32) if v.is_floating_point() else v)
          for k, v in x["pt"].items()}
    K = x["K"].to(f32)
    dev = pt["u"].device
    N = pt["u"].shape[0]
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    pat = device_loop.constant(PATTERN_P, dev)
    xs = dict(
        K=K, ref_color=x["ref_color"].to(f32), quad_new=x["quad_new"].to(f32),
        valid=pt["valid"], iR0=pt["iR"],
        npts=pt["is_good"].sum().to(f32) + 1e-6,
        wv=torch.full((N, 1), w, dtype=torch.int64, device=dev),
        base0=torch.zeros((N, 1), dtype=torch.int64, device=dev),
        nbr_c=torch.clamp(x["nbr_idx"], 0, N - 1), nbr_ok=x["nbr_ok"],
        Kinv_r=torch.stack([(pt["u"][:, None] + pat[None, :, 0] - cx) / fx,
                            (pt["v"][:, None] + pat[None, :, 1] - cy) / fy,
                            torch.ones((N, 8), dtype=f32, device=dev)],
                           dim=-1))                              # (N, 8, 3)
    n_total = torch.clamp(pt["valid"].sum().to(f32), min=1.0)
    T_init = x["T"].to(f32)
    aff_init = x["aff"].to(f32)
    st0 = _calc_res_gs(xs, T_init, aff_init, pt["idepth"], pt["is_good"],
                       pt["energy"], pt["energy_a"], w, h, huber_th)
    # applyStep after the initial calcRes (:99): energies/hessians adopt
    c = dict(T=T_init, aff=aff_init, idepth=pt["idepth"], iR=pt["iR"],
             is_good=st0["good_new"], energy=st0["energy_pt"],
             energy_a=st0["energy_a"], last_hessian=st0["hess"],
             H=st0["H"], b=st0["b"], Hsc=st0["Hsc"], bsc=st0["bsc"],
             Jb=st0["Jb"], maxstep=st0["maxstep"],
             E_phot=st0["E_phot"], alpha_energy=st0["alpha_energy"],
             lam=torch.full((), 0.1, dtype=f32, device=dev),
             fails=torch.zeros((), dtype=torch.int64, device=dev),
             snapped=x["snapped"].to(dev),
             it=torch.zeros((), dtype=torch.int64, device=dev),
             stop=torch.zeros((), dtype=torch.bool, device=dev))
    c = device_loop.run("mono", _mono_body, xs, c, max_iters,
                        dict(w=w, h=h, huber_th=huber_th))
    rmse = torch.sqrt(c["E_phot"] / torch.clamp(n_total * 8.0, min=1.0))
    return dict(T=c["T"], aff=c["aff"], idepth=c["idepth"], iR=c["iR"],
                is_good=c["is_good"], energy=c["energy"],
                energy_a=c["energy_a"], last_hessian=c["last_hessian"],
                snapped=c["snapped"], rmse=rmse, iters=c["it"])


class MonoInitializer:
    """Host driver: per-level pools + the reference's frame protocol, on
    the device of the pyramids it is given.

    Usage: `set_first(dI, abs_grads)` on the first camera frame, then
    `track_frame(dI)` per frame until it returns True (snapped and settled
    for 5 more frames, trackFrame:224-229). `select_draws`: optional
    (draw_dirs, draw_keep) of the level-0 selection (see
    `ops/select.make_maps`); by default both draw from a `torch.Generator`
    seeded SELECT_SEED."""

    def __init__(self, calib, settings: Settings | None = None,
                 select_draws=None):
        self.calib = calib                  # PyramidCalib (utils/camera.py)
        self.s = settings or Settings()
        self.levels = calib.levels
        self.select_draws = select_draws
        self.snapped = False
        self.snapped_at = 0
        self.frame_id = 0
        self.T = np.eye(4, dtype=np.float32)          # thisToNext
        self.aff = np.zeros(2, np.float32)
        self.pts: list[dict] = []
        # per tracked frame, each level LM's iterations (coarse to fine)
        self.lm_iters: list[list[int]] = []

    # ------------------------------------------------------------- setup
    def _draws(self, h, w, device):
        if self.select_draws is not None:
            return self.select_draws
        gen = torch.Generator().manual_seed(SELECT_SEED)
        return (lambda pot: cascade_direction_draws(h, w, pot, gen, device),
                lambda shape: torch.rand(shape, generator=gen).numpy())

    def _select_level(self, dI_l, ag_l, lvl, density):
        """Level-0: the PixelSelector cascade (thFactor=2, setFirst:705);
        above: gradient-quantile selection toward the density target
        (deviation from makePixelStatus's threshold loop, module doc)."""
        h, w = ag_l.shape
        pad = 3  # patternPadding + 1
        if lvl == 0:
            status, _ = make_maps(
                dI_l, (ag_l, ag_l, ag_l),
                torch.ones((h, w), dtype=torch.bool, device=ag_l.device),
                density, *self._draws(h, w, ag_l.device), {"pot": 3},
                self.s, th_factor=2.0)
            mask = status != 0
        else:
            g = ag_l.detach().cpu().numpy()
            q = max(0.0, 1.0 - density / (g.size + 1e-9))
            mask = g > np.quantile(g, q)
        mask[:pad + 1] = mask[-pad - 2:] = False
        mask[:, :pad + 1] = mask[:, -pad - 2:] = False
        v, u = np.nonzero(mask)
        return u.astype(np.float32) + 0.1, v.astype(np.float32) + 0.1

    def set_first(self, dI, abs_grads):
        """setFirst (:687-764): select, init idepth=1, build NN graph."""
        w0, h0 = self.calib.w[0], self.calib.h[0]
        dev = dI[0].device
        densities = [0.03, 0.05, 0.15, 0.5, 1.0]
        self.pts = []
        for lvl in range(self.levels):
            u, v = self._select_level(
                dI[lvl], abs_grads[lvl], lvl,
                densities[min(lvl, 4)] * w0 * h0)
            n = len(u)
            cap = max(64, int(2 ** np.ceil(np.log2(max(n, 1)))))
            valid = np.zeros(cap, bool)
            valid[:n] = True
            up = np.zeros(cap, np.float32)
            vp = np.zeros(cap, np.float32)
            up[:n], vp[:n] = u, v
            tu = torch.as_tensor(up, device=dev)
            tv = torch.as_tensor(vp, device=dev)
            color, _, _, finite, _ = pattern_colors(dI[lvl], tu, tv)
            valid &= finite.cpu().numpy()
            idx, d2 = knn(torch.stack([tu, tv], -1),
                          torch.as_tensor(valid, device=dev), k=10)
            self.pts.append(dict(
                u=up, v=vp, valid=valid,
                idepth=np.ones(cap, np.float32),
                iR=np.ones(cap, np.float32),
                is_good=valid.copy(),
                energy=np.zeros(cap, np.float32),
                energy_a=np.zeros(cap, np.float32),
                last_hessian=np.zeros(cap, np.float32),
                ref_color=color.cpu().numpy(),
                nbr_idx=idx.cpu().numpy(),
                nbr_ok=torch.isfinite(d2).cpu().numpy(),
                parent=np.full(cap, -1, np.int64)))
        for lvl in range(self.levels - 1):
            p = self.pts[lvl]
            q = self.pts[lvl + 1]
            pi, _ = nearest_cross(
                torch.as_tensor(np.stack([p["u"] * 0.5 - 0.25,
                                          p["v"] * 0.5 - 0.25], -1),
                                device=dev),
                torch.as_tensor(p["valid"], device=dev),
                torch.as_tensor(np.stack([q["u"], q["v"]], -1), device=dev),
                torch.as_tensor(q["valid"], device=dev))
            p["parent"] = pi.cpu().numpy()
        self.snapped = False
        self.snapped_at = 0
        self.frame_id = 0
        self.T = np.eye(4, dtype=np.float32)
        self.aff = np.zeros(2, np.float32)

    # ---------------------------------------------------- per-frame track
    def _reset_points(self, lvl):
        """resetPoints (:890-917): top level revives bad points from the
        neighbour mean."""
        p = self.pts[lvl]
        if lvl != self.levels - 1:
            return
        bad = p["valid"] & ~p["is_good"]
        if not bad.any():
            return
        nb = p["nbr_idx"]
        ok = p["nbr_ok"] & p["is_good"][np.clip(nb, 0, len(p["u"]) - 1)]
        s = (p["iR"][np.clip(nb, 0, len(p["u"]) - 1)] * ok).sum(-1)
        c = ok.sum(-1)
        revive = bad & (c > 0)
        mean = s / np.maximum(c, 1)
        for f in ("iR", "idepth"):
            p[f] = np.where(revive, mean, p[f]).astype(np.float32)
        p["is_good"] = p["is_good"] | revive

    def _propagate_down(self, src):
        """propagateDown (:631-662): fine level adopts parent iR."""
        p = self.pts[src - 1]
        q = self.pts[src]
        par = np.clip(p["parent"], 0, len(q["u"]) - 1)
        pgood = q["is_good"][par] & (q["last_hessian"][par] >= 0.1)
        piR = q["iR"][par]
        ph = q["last_hessian"][par]
        new_bad = p["valid"] & ~p["is_good"] & pgood
        wsum = p["last_hessian"] * 2 + ph
        blend = np.where(wsum > 0,
                         (p["iR"] * p["last_hessian"] * 2 + piR * ph)
                         / np.maximum(wsum, 1e-12), p["iR"])
        upd_good = p["is_good"] & pgood
        iR = np.where(new_bad, piR, np.where(upd_good, blend, p["iR"]))
        p["iR"] = iR.astype(np.float32)
        p["idepth"] = np.where(new_bad | upd_good, iR,
                               p["idepth"]).astype(np.float32)
        p["is_good"] = p["is_good"] | new_bad
        p["last_hessian"] = np.where(new_bad, 0.0,
                                     p["last_hessian"]).astype(np.float32)

    def _propagate_up(self, src):
        """propagateUp (:590-629): coarse iR from hessian-weighted fine."""
        p = self.pts[src]
        q = self.pts[src + 1]
        par = np.clip(p["parent"], 0, len(q["u"]) - 1)
        wgt = np.where(p["is_good"], p["last_hessian"], 0.0)
        sw = np.zeros(len(q["u"]), np.float64)
        sv = np.zeros(len(q["u"]), np.float64)
        np.add.at(sw, par, wgt)
        np.add.at(sv, par, wgt * p["iR"])
        upd = sw > 0
        val = (sv / np.maximum(sw, 1e-12)).astype(np.float32)
        q["iR"] = np.where(upd, val, q["iR"]).astype(np.float32)
        q["idepth"] = np.where(upd, val, q["idepth"]).astype(np.float32)
        q["is_good"] = q["is_good"] | upd

    def track_frame(self, dI_new) -> bool:
        """trackFrame (:50-230). Returns True when initialization is
        ready (snapped for > 5 frames)."""
        dev = dI_new[0].device
        if not self.snapped:
            self.T[:3, 3] = 0.0
            for p in self.pts:
                p["iR"] = p["idepth"].copy()
                p["last_hessian"][:] = 0.0

        def t(x):
            return torch.as_tensor(x, device=dev)

        T = t(self.T)
        aff = t(self.aff)
        snapped = t(self.snapped)
        iters = []
        for lvl in range(self.levels - 1, -1, -1):
            if lvl < self.levels - 1:
                self._propagate_down(lvl + 1)
            self._reset_points(lvl)
            p = self.pts[lvl]
            out = _level_lm(
                T, aff,
                {k: t(p[k]) for k in ("u", "v", "valid") + LM_FIELDS},
                t(p["nbr_idx"]), t(p["nbr_ok"]), pack_bilinear(dI_new[lvl]),
                t(p["ref_color"]),
                torch.as_tensor(self.calib.intrinsics_vec(lvl),
                                dtype=torch.float32, device=dev),
                snapped, w=self.calib.w[lvl], h=self.calib.h[lvl],
                max_iters=MAX_ITERS[min(lvl, len(MAX_ITERS) - 1)])
            T, aff, snapped = out["T"], out["aff"], out["snapped"]
            for f in LM_FIELDS:
                p[f] = out[f].cpu().numpy()
            iters.append(int(out["iters"]))

        self.T = T.cpu().numpy()
        self.aff = aff.cpu().numpy()
        self.snapped = bool(snapped)
        self.lm_iters.append(iters)
        for lvl in range(self.levels - 1):
            self._propagate_up(lvl)
        self.frame_id += 1
        if not self.snapped:
            self.snapped_at = 0
        elif self.snapped_at == 0:
            self.snapped_at = self.frame_id
        return self.snapped and self.frame_id > self.snapped_at + 5

    # ---------------------------------------------------------- results
    def level0_points(self):
        """(u, v, idepth, scale) of good level-0 points, gauge-normalized
        to mean inverse depth 1 — the monocular gauge fix of DSO's
        initializeFromInitializer. The caller must scale the relative
        translation by the SAME factor: T.translation *= scale."""
        p = self.pts[0]
        m = p["valid"] & p["is_good"] & (p["iR"] > 0)
        fac = float(np.mean(p["iR"][m])) if m.any() else 1.0
        fac = max(fac, 1e-6)
        return p["u"][m], p["v"][m], p["iR"][m] / fac, fac
