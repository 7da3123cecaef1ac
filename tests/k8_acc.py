"""K8's arithmetic and reduction order (csrc/ba_accumulate.cu) emulated on
the CPU in float32 tensor operations: per point its sums over its
residuals, Vpt; per tile of TILE points its pair and Schur sums, point
after point; the lanes' totals tile after tile; the transport to the
absolute system. Every product and sum is a separate float32 operation,
rounded on its own, as the kernel's intrinsics are, so on the same inputs
the kernels give these bits.

Used by tests/test_torch_ba_kernels.py's CPU tests (against the plain
version) and its card tests (the kernels against this emulation), so it
imports neither JAX nor the card.
"""

import torch


TILE = 128          # points a tile sums (kTile)
PAIR_TERMS = 65     # a pair's 55 upper-triangle H entries, then its 10 b

f32 = torch.float32
_IU10 = torch.triu_indices(10, 10)


def _tri10(i, j):
    i, j = min(i, j), max(i, j)
    return i * 10 - i * (i - 1) // 2 + (j - i)


def _pair_terms(J, r):
    """A residual's 55 upper-triangle J^T J entries and its 10 J^T r:
    J (..., 2, 10), r (..., 2) -> (..., 65)."""
    i, j = _IU10
    H = J[..., 0, i] * J[..., 0, j] + J[..., 1, i] * J[..., 1, j]
    b = J[..., 0, :] * r[..., 0:1] + J[..., 1, :] * r[..., 1:2]
    return torch.cat([H, b], -1)


def accumulate(Jc, Jxi, Jd, resF, active, pt_host, pt_is_sensor, pt_prior,
               sc_mask, adH, adT, F):
    """`hopper_kernels.ba_accumulate`'s results (H_top, b_top, H_sc, b_sc,
    Hdd, bd, HdiF, Vpt, n_act) from the same arguments, on the CPU."""
    L, N = resF.shape[:2]
    D = 4 + 6 * F
    FF = F * F
    J = torch.cat([Jc, Jxi], -1).to(f32)                  # (L, N, F, 2, 10)
    r = resF.to(f32)
    jd = Jd.to(f32)
    host = pt_host.long().clamp(0, F - 1)
    lane = torch.arange(L)[:, None]
    adHd, adTd = adH.to(f32), adT.to(f32)
    sc = sc_mask

    # per point: its sums over its residuals (target order, rows in order)
    jpjd = J[..., 0, 4:] * jd[..., 0:1] + J[..., 1, 4:] * jd[..., 1:2]
    sums = [torch.zeros((L, N), dtype=f32) for _ in range(6)]
    for f in range(F):
        for a in range(2):
            d = jd[:, :, f, a]
            sums[0] = sums[0] + d * d
            sums[1] = sums[1] + r[:, :, f, a] * d
            for q in range(4):
                sums[2 + q] = sums[2 + q] + J[:, :, f, a, q] * d
    Hdd = sums[0] + pt_prior.to(f32)
    bd = sums[1]
    Hcd = torch.stack(sums[2:], -1)
    n_act = active.sum(-1)
    one = torch.ones((), dtype=torch.float32)
    clamped = torch.where(torch.isnan(Hdd), Hdd, torch.clamp(Hdd, min=1e-10))
    HdiF = torch.where(n_act > 0, one / clamped, torch.zeros_like(Hdd))
    wsc = torch.where(sc & ~pt_is_sensor & (n_act > 0), HdiF,
                      torch.zeros_like(HdiF))

    def ad_at(ad, f):
        """(L, N, 6, 6): each point's adjoint of the pair (host, f)."""
        return ad[lane, host * F + f]

    vhs = torch.zeros((L, N, 6), dtype=f32)
    for f in range(F):
        A = ad_at(adHd, f)
        vh = torch.zeros((L, N, 6), dtype=f32)
        for j in range(6):
            vh = vh + A[..., j] * jpjd[:, :, f, j:j + 1]
        vhs = vhs + vh
    frames = []
    for f in range(F):
        A = ad_at(adTd, f)
        vt = torch.zeros((L, N, 6), dtype=f32)
        for j in range(6):
            vt = vt + A[..., j] * jpjd[:, :, f, j:j + 1]
        at_host = (host == f)[..., None]
        frames.append(vt + torch.where(at_host, vhs, 0.0 * vhs))
    Vpt = torch.cat([Hcd, torch.cat(frames, -1)], -1)

    # the tiles' sums, point after point, then the totals tile after tile
    T = (N + TILE - 1) // TILE
    tri = D * (D + 1) // 2
    iu = torch.triu_indices(D, D)
    acc = torch.zeros((L, T, F, F, PAIR_TERMS), dtype=f32)
    sacc = torch.zeros((L, T, tri + D), dtype=f32)
    terms = _pair_terms(J, r)                             # (L, N, F, 65)
    Vd, wd, bdd = Vpt, wsc, bd
    hosts = torch.arange(F)
    for q in range(TILE):
        pts = torch.arange(T) * TILE + q
        ok = pts < N
        pts = pts.clamp(max=N - 1)
        onehot = (host[:, pts, None] == hosts) & ok[None, :, None]
        acc = torch.where(onehot[..., None, None],
                          acc + terms[:, pts, None], acc)
        v, w = Vd[:, pts], wd[:, pts, None]
        Hs = ((v * w)[..., :, None] * v[..., None, :])[..., iu[0], iu[1]]
        bs = v * (w * bdd[:, pts, None])
        sacc = torch.where(ok[None, :, None],
                           sacc + torch.cat([Hs, bs], -1), sacc)
    tot_p = torch.zeros((L, F, F, PAIR_TERMS), dtype=f32)
    tot_s = torch.zeros((L, tri + D), dtype=f32)
    for t in range(T):
        tot_p = tot_p + acc[:, t]
        tot_s = tot_s + sacc[:, t]
    tot_p = tot_p.reshape(L, FF, PAIR_TERMS)

    # the transport (stitchDouble)
    idx = torch.tensor([[_tri10(i, j) for j in range(10)] for i in range(10)])
    HP = tot_p[..., idx]                                  # (L, FF, 10, 10)
    bP = tot_p[..., 55:]                                  # (L, FF, 10)
    Hxx, Hcx = HP[..., 4:, 4:], HP[..., :4, 4:]
    AH = torch.zeros((L, FF, 6, 6), dtype=f32)
    AT = torch.zeros((L, FF, 6, 6), dtype=f32)
    for k in range(6):
        AH = AH + adHd[..., :, k:k + 1] * Hxx[..., k:k + 1, :]
        AT = AT + adTd[..., :, k:k + 1] * Hxx[..., k:k + 1, :]

    def mprod(X, Y):
        """(X Y^T)[p][x][y] = sum over m in order of X[x][m] Y[y][m]."""
        out = torch.zeros((L, FF, 6, 6), dtype=f32)
        for m in range(6):
            out = out + X[..., :, m:m + 1] * Y[..., None, :, m]
        return out

    hh, tt, ht = mprod(AH, adHd), mprod(AT, adTd), mprod(AH, adTd)

    def vprod(A, X):
        """(A X^T)[p][i][c] = sum over k in order of A[i][k] X[c][k]."""
        out = torch.zeros(A.shape[:-1] + X.shape[-2:-1], dtype=f32)
        for k in range(6):
            out = out + A[..., :, k:k + 1] * X[..., None, :, k]
        return out

    hc, tc = vprod(adHd, Hcx), vprod(adTd, Hcx)           # (L, FF, 6, 4)
    bx = bP[..., 4:]
    bh = torch.zeros((L, FF, 6), dtype=f32)
    bt = torch.zeros((L, FF, 6), dtype=f32)
    for k in range(6):
        bh = bh + adHd[..., k] * bx[..., k:k + 1]
        bt = bt + adTd[..., k] * bx[..., k:k + 1]

    def by_host(x, f):
        """sum over targets t in order of x[(f, t)]."""
        s = torch.zeros_like(x[:, 0])
        for t in range(F):
            s = s + x[:, f * F + t]
        return s

    def by_target(x, f):
        """sum over hosts h in order of x[(h, f)]."""
        s = torch.zeros_like(x[:, 0])
        for hh_ in range(F):
            s = s + x[:, hh_ * F + f]
        return s

    H = torch.zeros((L, D, D), dtype=f32)
    b = torch.zeros((L, D), dtype=f32)
    Hcc = torch.zeros((L, 4, 4), dtype=f32)
    bc = torch.zeros((L, 4), dtype=f32)
    for p in range(FF):
        Hcc = Hcc + HP[:, p, :4, :4]
        bc = bc + bP[:, p, :4]
    H[:, :4, :4] = Hcc
    b[:, :4] = bc
    for f in range(F):
        rs = slice(4 + 6 * f, 10 + 6 * f)
        Mfc = by_host(hc, f) + by_target(tc, f)           # (L, 6, 4)
        H[:, rs, :4] = Mfc
        H[:, :4, rs] = Mfc.transpose(1, 2)
        b[:, rs] = by_host(bh, f) + by_target(bt, f)
        for g in range(f, F):
            cs = slice(4 + 6 * g, 10 + 6 * g)
            if f == g:
                d = by_host(hh, f) + by_target(tt, f)
                blk = (d + ht[:, f * F + f]) + ht[:, f * F + f].transpose(1, 2)
                # the upper triangle, mirrored
                up = torch.triu(torch.ones(6, 6, dtype=torch.bool))
                blk = torch.where(up, blk, blk.transpose(1, 2))
            else:
                blk = (0.0 + ht[:, f * F + g]) + \
                    ht[:, g * F + f].transpose(1, 2)
            H[:, rs, cs] = blk
            H[:, cs, rs] = blk.transpose(1, 2)

    H_sc = torch.zeros((L, D, D), dtype=f32)
    H_sc[:, iu[0], iu[1]] = tot_s[:, :tri]
    H_sc[:, iu[1], iu[0]] = tot_s[:, :tri]
    b_sc = tot_s[:, tri:]
    return H, b, H_sc, b_sc, Hdd, bd, HdiF, Vpt, n_act


# the comparison against the plain version (its tolerance is stated in
# sdv_loam_tpu_torch/eval/kernel_timing.py)
from sdv_loam_tpu_torch.eval.kernel_timing import (  # noqa: E402
    BA_ACC_NAMES as NAMES, BA_ACC_REL as REL, ba_acc_gap as gap,
    ba_acc_magnitudes as magnitudes)

__all__ = ["accumulate", "NAMES", "REL", "gap", "magnitudes"]
