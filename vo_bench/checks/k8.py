"""K8 (`ba_accumulate`, in the keyframe program's windowed BA: each
system build and point marginalization): every accumulation against a
plain reference of its documented arithmetic (`csrc/ba_accumulate.cu`,
the plain version `models/backend._accumulate_plain` with `_stitch`,
copied here): per pair the 10 x 10 block and 10-vector of its residuals'
calibration and pose terms, their transport to the absolute (4 + 6 F)
system by the pairs' adjoints, per point the depth terms (Hdd with its
prior, bd, HdiF) and its row of the Schur complement (Vpt), and the Schur
complement over the points the call names.

The reference sums in float64 (the kernel in float32, in a fixed order:
against an exact sum its order moves nothing that float64 can see); the
control's variant in float32 with TF32 products, the nearest precision
below the configuration's. The terms' magnitudes are the same arithmetic
on the inputs' absolute values, in float64.

`k8_rel_err`: the largest gap of an element of H_top, b_top, H_sc, b_sc,
Hdd, bd, HdiF or Vpt over its terms' magnitude (two NaNs agree, NaN
against a number reads inf, a zero magnitude admits no gap);
`k8_counts_differ`: the points whose count of active residuals (n_act)
differs."""

import inspect

import torch

PROGRAMS = {"kf_opt": "next"}
TAPS = (("sdv_loam_tpu_torch.models.backend", "_accumulate", "K8"),)
NUMBERS = ("k8_rel_err", "k8_counts_differ")
CPARS = 4


def _take(x, idx):
    """x (L, P, ...) at per-lane indices idx (L, ...)."""
    ar = torch.arange(x.shape[0], device=x.device).reshape(
        (-1,) + (1,) * (idx.dim() - 1))
    return x[ar, idx]


def _one_hot(idx, n, dtype):
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _stitch(Hpair, bpair, adH, adT, F):
    """Per-pair (10 x 10, 10) blocks [calib(4), relpose(6)] of L windows
    (Hpair (L, F F, 10, 10), pair = host F + target) transported to the
    absolute (4 + 6 F) systems."""
    L = Hpair.shape[0]
    dtype, dev = Hpair.dtype, Hpair.device
    D = CPARS + 6 * F
    Hcx, Hxx = Hpair[:, :, :4, 4:], Hpair[:, :, 4:, 4:]
    bx = bpair[:, :, 4:]
    H = torch.zeros((L, D, D), dtype=dtype, device=dev)
    b = torch.zeros((L, D), dtype=dtype, device=dev)
    H[:, :4, :4] += Hpair[:, :, :4, :4].sum(1)
    b[:, :4] += bpair[:, :, :4].sum(1)
    AH_Hxx, AT_Hxx = adH @ Hxx, adT @ Hxx
    hh = AH_Hxx @ adH.transpose(-1, -2)
    tt = AT_Hxx @ adT.transpose(-1, -2)
    ht = AH_Hxx @ adT.transpose(-1, -2)
    hc = adH @ Hcx.transpose(-1, -2)
    tc = adT @ Hcx.transpose(-1, -2)
    bh = torch.einsum("lpij,lpj->lpi", adH, bx)
    bt = torch.einsum("lpij,lpj->lpi", adT, bx)

    def grid(x):
        return x.reshape((L, F, F) + x.shape[2:])

    eye_f = torch.eye(F, dtype=dtype, device=dev)
    Hdiag = eye_f[:, :, None, None] * (grid(hh).sum(2)
                                       + grid(tt).sum(1))[:, :, None]
    Mfc = grid(hc).sum(2) + grid(tc).sum(1)
    bf = grid(bh).sum(2) + grid(bt).sum(1)
    Hd = Hdiag.permute(0, 1, 3, 2, 4).reshape(L, 6 * F, 6 * F)
    Mo = grid(ht).permute(0, 1, 3, 2, 4).reshape(L, 6 * F, 6 * F)
    H[:, 4:, 4:] += Hd + Mo + Mo.transpose(1, 2)
    H[:, 4:, :4] += Mfc.reshape(L, 6 * F, 4)
    H[:, :4, 4:] += Mfc.reshape(L, 6 * F, 4).transpose(1, 2)
    b[:, 4:] += bf.reshape(L, 6 * F)
    return H, b


def accumulate(Jc, Jxi, Jd, resF, active, pt_host, pt_is_sensor, pt_prior,
               sc_mask, pairs, F, acc=torch.float64):
    """`backend._accumulate`'s results (H_top, b_top, H_sc, b_sc, Hdd,
    bd, HdiF, Vpt, n_act) from its arguments, in `acc`."""
    Jc, Jxi, Jd, resF, pt_prior = (x.to(acc) for x in
                                   (Jc, Jxi, Jd, resF, pt_prior))
    adH, adT = pairs["adH"].to(acc), pairs["adT"].to(acc)
    L, N = resF.shape[:2]
    dev = resF.device
    host = pt_host.long()
    pair_idx = (host[..., None] * F + torch.arange(F, device=dev)).reshape(
        L, N * F)
    Jgeo = torch.cat([Jc, Jxi], dim=-1).reshape(L, N * F, 2, 10)
    outer = torch.einsum("lrai,lraj->lrij", Jgeo, Jgeo).reshape(
        L, N * F, 100)
    onehot_t = _one_hot(pair_idx, F * F, acc).transpose(1, 2)
    Hpair = (onehot_t @ outer).reshape(L, F * F, 10, 10)
    bpair = onehot_t @ torch.einsum("lrai,lra->lri", Jgeo,
                                    resF.reshape(L, N * F, 2))
    H_top, b_top = _stitch(Hpair, bpair, adH, adT, F)

    Hdd = torch.einsum("lnfa,lnfa->ln", Jd, Jd) + pt_prior
    bd = torch.einsum("lnfa,lnfa->ln", Jd, resF)
    Hcd = torch.einsum("lnfai,lnfa->lni", Jc, Jd)
    JpJd = torch.einsum("lnfai,lnfa->lnfi", Jxi, Jd)
    n_act = active.sum(-1)
    HdiF = torch.where(n_act > 0, 1.0 / torch.clamp(Hdd, min=1e-10),
                       torch.zeros_like(Hdd))
    vh = torch.einsum("lnfij,lnfj->lnfi",
                      _take(adH.reshape(L, F, F, 6, 6), host), JpJd)
    vt = torch.einsum("lnfij,lnfj->lnfi",
                      _take(adT.reshape(L, F, F, 6, 6), host), JpJd)
    Vframes = vt + _one_hot(host, F, acc)[..., None] * \
        vh.sum(dim=2)[:, :, None, :]
    Vpt = torch.cat([Hcd, Vframes.reshape(L, N, 6 * F)], dim=-1)
    sc_ok = sc_mask & (~pt_is_sensor) & (n_act > 0)
    wsc = torch.where(sc_ok, HdiF, torch.zeros_like(HdiF))
    H_sc = (Vpt * wsc[..., None]).transpose(1, 2) @ Vpt
    b_sc = torch.einsum("lnd,ln->ld", Vpt, wsc * bd)
    return H_top, b_top, H_sc, b_sc, Hdd, bd, HdiF, Vpt, n_act


_SIG = inspect.signature(accumulate)


def magnitudes(a):
    """Each output's sum of its terms' magnitudes: `accumulate` on the
    absolute values of the float inputs, in float64."""
    def absd(t):
        return t.abs().double() if isinstance(t, torch.Tensor) and \
            t.is_floating_point() else t
    b = {k: absd(v) for k, v in a.items() if k != "pairs"}
    b["pairs"] = {k: absd(v) for k, v in a["pairs"].items()}
    return accumulate(**dict(b, acc=torch.float64))


def reference(kernel, args, kwargs, out, low=False):
    """(the outputs, their terms' magnitudes) in float64; the control's
    variant: the outputs alone in float32 (TF32 products where the caller
    allows them), in the kernel's place."""
    a = _SIG.bind(*args, **kwargs).arguments
    if low:
        return accumulate(**dict(a, acc=torch.float32))
    return accumulate(**a), magnitudes(a)


def numbers(compared):
    num = dict(k8_rel_err=0.0, k8_counts_differ=0)
    for _, _, _, out, (want, mag) in compared:
        for g, r, m in zip(out[:-1], want[:-1], mag[:-1]):
            g = g.double()
            gap = (g - r).abs()
            gap = torch.where(torch.isnan(g) & torch.isnan(r),
                              torch.zeros_like(gap), gap)
            gap = torch.nan_to_num(gap, nan=float("inf"))
            q = torch.where(gap > 0, gap / m, torch.zeros_like(gap))
            q = torch.nan_to_num(q, nan=float("inf"))
            if q.numel():
                num["k8_rel_err"] = max(num["k8_rel_err"], float(q.max()))
        num["k8_counts_differ"] += int((out[-1].long() != want[-1].long())
                                       .sum())
    return num
