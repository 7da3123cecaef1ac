"""K3's arithmetic and reduction orders (csrc/track_res_gs.cu) emulated on
the CPU in tensor operations: the per-point terms, the kernel's order
(`order_cluster`) and the previous one-block-per-row order
(`order_block`), and the outputs rounded to float32 once.

Shared by tests/test_torch_track_kernels.py (CPU) and
tests/test_torch_cuda.py (the kernel on the card against this emulation),
so it imports neither JAX nor the card.
"""

import torch

from sdv_loam_tpu_torch.ops import hopper_kernels as hk

CLUSTER, TILE, SLICES = 8, 256, 3      # the kernel's order
THREADS, WARPS = 256, 8                # the one-block-per-row order
STEP_SCALE = torch.tensor(hk.STEP_SCALE)


def terms(pool, packed, K, T, aff_rel, ref_b, cutoff, huber, lane, h, w):
    """K3's per-point arithmetic in tensor operations: the per-point
    quantities in float32, each operation rounded on its own, the products
    of the projection and the bilinear weights summed left to right; a
    point's H and b terms (exact float64 products) kept when it is an
    inlier or one of its J or r is not finite, +0 otherwise. Returns (the
    76 terms of every point (B, n, 76) in float64, the counts (terms,
    saturated, inliers, flow slots) (B, 4))."""
    lane = lane.long()
    B, n = T.shape[0], pool["u"].shape[-1]
    g = {k: pool[k][lane] for k in ("u", "v", "idepth", "color", "valid")}
    Kb = K[lane]
    fx, fy, cx, cy = (Kb[:, i:i + 1] for i in range(4))
    R, t = T[:, :3, :3], T[:, :3, 3]
    u0, v0, idp, color, valid = (g[k] for k in ("u", "v", "idepth", "color",
                                                "valid"))
    xn, yn = (u0 - cx) / fx, (v0 - cy) / fy
    pr = [(xn * R[:, k, 0:1] + yn * R[:, k, 1:2]) + R[:, k, 2:3]
          for k in range(3)]
    pt = [pr[k] + t[:, k:k + 1] * idp for k in range(3)]
    u, v = pt[0] / pt[2], pt[1] / pt[2]
    Ku, Kv = fx * u + cx, fy * v + cy
    nid = idp / pt[2]
    inb = valid & (Ku > 2) & (Kv > 2) & (Ku < w - 3) & (Kv < h - 3) & \
        (nid > 0)
    x0f, y0f = torch.floor(Ku), torch.floor(Kv)
    hit_ok = (x0f >= 0) & (x0f <= w - 2) & (y0f >= 0) & (y0f <= h - 2)
    ax, ay = Ku - x0f, Kv - y0f
    wc = [(1 - ax) * (1 - ay), ax * (1 - ay), (1 - ax) * ay, ax * ay]
    idx = lane[:, None] * h * w + torch.where(hit_ok, y0f * w + x0f,
                                              torch.zeros_like(x0f)).long()
    q = packed[idx.reshape(-1)].reshape(B, n, 12)
    hit = []
    for c in range(3):
        s = q[..., c] * wc[0]
        for k in range(1, 4):
            s = s + q[..., 3 * k + c] * wc[k]
        hit.append(torch.where(hit_ok, s, torch.zeros_like(s)))
    inb = inb & hit_ok & torch.isfinite(hit[0])
    r = hit[0] - (aff_rel[:, 0:1] * color + aff_rel[:, 1:2])
    absr = torch.abs(r)
    # a tensor divided by a tensor: `float / tensor` is a reciprocal and a
    # product in torch, two roundings where the kernel divides once
    hw = torch.where(absr < huber, torch.ones_like(absr),
                     torch.full_like(absr, huber)
                     / torch.clamp(absr, min=1e-12))
    sat = inb & (absr > cutoff[:, None])
    inl = inb & (absr <= cutoff[:, None])
    max_e = (2.0 * huber) * cutoff[:, None] - huber * huber
    dxf, dyf, uv = hit[1] * fx, hit[2] * fy, u * v
    J = [nid * dxf, nid * dyf, -nid * (u * dxf + v * dyf),
         -(uv * dxf + (1 + v * v) * dyf), uv * dyf + (1 + u * u) * dxf,
         u * dyf - v * dxf, aff_rel[:, 0:1] * (ref_b[:, None] - color),
         -torch.ones_like(u)]
    finite = torch.isfinite(r)
    for j in J:
        finite = finite & torch.isfinite(j)
    add = inl | ~finite
    wgt = torch.where(inl, hw, torch.zeros_like(hw))
    Jw = [(j * wgt).double() for j in J]
    Jd, rd = [j.double() for j in J], r.double()
    z = torch.zeros_like(rd)
    terms = [torch.where(add, Jd[p] * Jw[qq], z)
             for p in range(8) for qq in range(8)]
    terms += [torch.where(add, Jw[p] * rd, z) for p in range(8)]
    terms.append(torch.where(inl, (((hw * r) * r) * (2 - hw)).double(), z))
    terms.append(torch.where(sat, max_e.expand_as(r).double(), z))
    slot = torch.arange(n)[None, :]
    m = valid & (slot % 32 == 0)
    ti = [t[:, k:k + 1] * idp for k in range(3)]
    p0 = [xn, yn, torch.ones_like(xn)]

    def pix(q0, q1, q2):
        du = (fx * (q0 / q2) + cx) - u0
        dv = (fy * (q1 / q2) + cy) - v0
        return du * du + dv * dv
    ft = pix(*(p0[k] + ti[k] for k in range(3))) + \
        pix(*(p0[k] - ti[k] for k in range(3)))
    frt = pix(*pt) + pix(*(pr[k] - ti[k] for k in range(3)))
    terms += [torch.where(m, ft.double(), z), torch.where(m, frt.double(), z)]
    counts = torch.stack([inb.sum(-1), sat.sum(-1), inl.sum(-1), m.sum(-1)],
                         -1)
    return torch.stack(terms, -1), counts


def order_block(X):
    """The one-block-per-row order: thread t sums points t, t + 256,
    ... in order, each warp sums its lanes by shuffles down at offsets
    16..1, the warps' sums add in warp order. X (B, n, 76) -> (B, 76)."""
    B, n = X.shape[:2]
    pad = (-n) % THREADS
    X = torch.cat([X, torch.zeros(B, pad, X.shape[-1],
                                  dtype=torch.float64)], 1)
    X = X.reshape(B, -1, THREADS, X.shape[-1])
    acc = torch.zeros(B, THREADS, X.shape[-1], dtype=torch.float64)
    for k in range(X.shape[1]):          # each thread's points in order
        acc = acc + X[:, k]
    x = acc.reshape(B, WARPS, 32, -1)
    off = 16
    while off:                           # lane 0's shuffle-down tree
        x = x[:, :, :off] + x[:, :, off:2 * off]
        off //= 2
    x = x[:, :, 0]
    tot = x[:, 0]
    for k in range(1, WARPS):            # warps in order
        tot = tot + x[:, k]
    return tot


def order_cluster(X):
    """The kernel's order: per row CLUSTER contiguous ranges of
    ceil(n / CLUSTER) points, one per block; a block's range in tiles of
    TILE points, a tile of m points in SLICES contiguous slices of
    ceil(m / SLICES); per sum and slice one float64 accumulator adds its
    points in order, tile after tile; a block's partial is its slices in
    order; the row's total the blocks' partials in rank order. X (B, n,
    76) -> (B, 76). (+0 terms pad the ragged slices: adding +0 leaves an
    accumulator started at +0 unchanged.)"""
    B, n, S = X.shape
    span = -(-n // CLUSTER)
    zero = torch.zeros(B, S, dtype=torch.float64)
    parts = []
    for c in range(CLUSTER):
        beg, end = min(n, c * span), min(n, c * span + span)
        acc = [zero] * SLICES
        for t0 in range(beg, end, TILE):
            m = min(TILE, end - t0)
            per = -(-m // SLICES)
            for j in range(SLICES):
                lo, hi = min(m, j * per), min(m, j * per + per)
                for p in range(t0 + lo, t0 + hi):
                    acc[j] = acc[j] + X[:, p]
        part = acc[0]
        for j in range(1, SLICES):
            part = part + acc[j]
        parts.append(part)
    tot = parts[0]
    for c in range(1, CLUSTER):
        tot = tot + parts[c]
    return tot


def outputs(tot, counts):
    """K3's outputs from the row sums (B, 76) and counts (B, 4), each
    rounded to float32 once."""
    B = tot.shape[0]
    n_terms, n_sat, n_in, n_flow = counts.unbind(-1)
    n_in_d = torch.clamp(n_in, min=1).double()
    S = STEP_SCALE.double()
    Hm = ((tot[:, :64].reshape(B, 8, 8) / n_in_d[:, None, None])
          * S[:, None]) * S[None, :]
    bv = (tot[:, 64:72] / n_in_d[:, None]) * S
    num = (n_flow.float() * 2.0 + 0.1).double()
    return dict(E=(tot[:, 72] + tot[:, 73]).float(), n=n_terms,
                sat_frac=n_sat.float() / torch.clamp(n_terms, min=1).float(),
                H=Hm.float(), b=bv.float(),
                flow_t=(tot[:, 74] / num).float(),
                flow_rt=(tot[:, 75] / num).float())


def emulate(pool, packed, K, T, aff_rel, ref_b, cutoff, huber, lane, h, w,
            order=order_cluster):
    """K3 in tensor operations in the kernel's arithmetic and `order` (the
    kernel's, or the one-block-per-row `order_block`): its outputs."""
    X, counts = terms(pool, packed, K, T, aff_rel, ref_b, cutoff, huber,
                      lane, h, w)
    return outputs(order(X), counts)
