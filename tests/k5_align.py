"""The arithmetic of csrc/align_batch.cu (K5, the patch alignment, with
K6, the patch warp, as its prologue) emulated on the CPU in tensor
operations: the float64 LU inverses, K6's patch warp, and K5's alignment
with its float64 sums in the kernel's warp order (each lane's two pixels,
then the five butterfly stages), every row run in lockstep (each row's
arithmetic is its own, so the bits are those of the row's own warp).

Shared by tests/test_torch_align_kernels.py (CPU) and
tests/test_torch_cuda.py (the kernels on the card against this emulation),
so it imports neither JAX nor the card.
"""

import torch

from sdv_loam_tpu_torch.ops import hopper_kernels as hk

F32, F64 = torch.float32, torch.float64
NAN = float("nan")


def bits_differ(a, b):
    """How many elements of a and b (float32, any device) differ in their
    bits, NaN against NaN counted equal: the card's arithmetic makes NaN
    payloads of its own."""
    a, b = a.cpu().float(), b.cpu().float()
    same = (a.view(torch.int32) == b.view(torch.int32)) | \
        (torch.isnan(a) & torch.isnan(b))
    return int((~same).sum())


def inverse_lu(A):
    """inv of (M, n, n) float32 matrices as the kernels take it: float64 LU
    with partial pivoting (the first row of strictly largest |a| at or
    below the diagonal; a NaN never wins), then the solves against the
    identity; each entry rounded to float32, non-finite entries 0."""
    a = A.to(F64).clone()
    M, n, _ = a.shape
    perm = torch.arange(n).expand(M, n).clone()
    for k in range(n):
        p = torch.full((M,), k)
        best = a[:, k, k].abs()
        for i in range(k + 1, n):
            better = a[:, i, k].abs() > best
            best = torch.where(better, a[:, i, k].abs(), best)
            p = torch.where(better, torch.full_like(p, i), p)
        for i in range(k + 1, n):
            sw = p == i
            rk, ri = a[:, k].clone(), a[:, i].clone()
            a[:, k] = torch.where(sw[:, None], ri, rk)
            a[:, i] = torch.where(sw[:, None], rk, ri)
            pk, pi = perm[:, k].clone(), perm[:, i].clone()
            perm[:, k] = torch.where(sw, pi, pk)
            perm[:, i] = torch.where(sw, pk, pi)
        for i in range(k + 1, n):
            lk = a[:, i, k] / a[:, k, k]
            a[:, i, k] = lk
            for j in range(k + 1, n):
                a[:, i, j] = a[:, i, j] - lk * a[:, k, j]
    inv = torch.empty((M, n, n), dtype=F64)
    for c in range(n):
        y = []
        for i in range(n):
            yi = (perm[:, i] == c).to(F64)
            for j in range(i):
                yi = yi - a[:, i, j] * y[j]
            y.append(yi)
        for i in reversed(range(n)):
            yi = y[i]
            for j in range(i + 1, n):
                yi = yi - a[:, i, j] * y[j]
            y[i] = yi / a[:, i, i]
        for i in range(n):
            inv[:, i, c] = y[i]
    f = inv.to(F32)
    return torch.where(torch.isfinite(f), f, torch.zeros_like(f))


def _sample(quad, idx, ax, ay):
    """The kernels' bilinear sample of quad rows `idx` (NaN outside the
    pack): ((q0 w0 + q1 w1) + q2 w2) + q3 w3, each product and sum
    rounded."""
    ok = (idx >= 0) & (idx < quad.shape[0])
    q = quad[torch.where(ok, idx, torch.zeros_like(idx))]
    bx, by = 1.0 - ax, 1.0 - ay
    val = ((q[..., 0] * (bx * by) + q[..., 1] * (ax * by))
           + q[..., 2] * (bx * ay)) + q[..., 3] * (ax * ay)
    return torch.where(ok, val, torch.full_like(val, NAN))


def warp_patches(quad, host_idx, px_ref, A, level, h, w):
    """K6: (M, 10, 10) patches (see csrc/align_batch.cu, warp_patch_issue
    and warp_patch_finish)."""
    inv = inverse_lu(A)
    p = torch.arange(hk.BORDER_PATCH ** 2)
    scale = torch.pow(2.0, level.to(F32))[:, None]
    ox = ((p % hk.BORDER_PATCH) - (hk.HALF_PATCH + 1)).to(F32) * scale
    oy = ((p // hk.BORDER_PATCH) - (hk.HALF_PATCH + 1)).to(F32) * scale
    x = (inv[:, 0, 0:1] * ox + inv[:, 0, 1:2] * oy) + px_ref[:, 0:1]
    y = (inv[:, 1, 0:1] * ox + inv[:, 1, 1:2] * oy) + px_ref[:, 1:2]
    ok = (x >= 0) & (y >= 0) & (x < w - 1) & (y < h - 1)
    xc = torch.clamp(x, 0.0, w - 1.001)
    yc = torch.clamp(y, 0.0, h - 1.001)
    x0, y0 = torch.floor(xc), torch.floor(yc)
    idx = host_idx[:, None] * (h * w) + y0.long() * w + x0.long()
    val = _sample(quad, idx, xc - x0, yc - y0)
    val = torch.where(ok, val, torch.zeros_like(val))
    return val.reshape(-1, hk.BORDER_PATCH, hk.BORDER_PATCH)


def warp_sum(terms):
    """Sum (M, 64) float64 terms in K5's order: lane l adds its pixels l
    and l + 32 to a zero, then five butterfly stages (lane distance 16, 8,
    4, 2, 1). Returns (M,) (every lane's value; lane 0's)."""
    v = (torch.zeros_like(terms[:, :32]) + terms[:, :32]) + terms[:, 32:]
    lane = torch.arange(32)
    for m in (16, 8, 4, 2, 1):
        v = v + v[:, lane ^ m]
    return v[:, 0]


def setup(border, direction, is_edge, aff_a, aff_b):
    """K5's per-row setup: J (3 tensors (M, 64)), target (M, 64), Hinv
    (M, 3, 3)."""
    p = torch.arange(hk.PATCH ** 2)
    x, y = p % hk.PATCH, p // hk.PATCH
    c = border[:, y + 1, x + 1]
    dx = 0.5 * (border[:, y + 1, x + 2] - border[:, y + 1, x])
    dy = 0.5 * (border[:, y + 2, x + 1] - border[:, y, x + 1])
    e = is_edge[:, None]
    dgrad = direction[:, 0:1] * dx + direction[:, 1:2] * dy
    one, zero = torch.ones_like(dx), torch.zeros_like(dx)
    J = (torch.where(e, dgrad, dx), torch.where(e, one, dy),
         torch.where(e, zero, one))
    target = aff_a[:, None] * c + aff_b[:, None]
    H = torch.empty((border.shape[0], 3, 3), dtype=F32)
    for i in range(3):
        for j in range(i, 3):
            s = warp_sum(J[i].to(F64) * J[j].to(F64)).to(F32)
            H[:, i, j] = H[:, j, i] = s
    H = H + torch.eye(3) * 1e-9
    return J, target, inverse_lu(H)


def align_batch(quad, offsets, widths, heights, level, border, px0,
                direction, is_edge, aff_a, aff_b, valid, n_iter=10):
    """K5: (px (M, 2), conv & valid (M,), failure masks (M, 2)) (see
    csrc/align_batch.cu)."""
    J, target, Hinv = setup(border, direction, is_edge, aff_a, aff_b)
    base, wv = offsets[level], widths[level]
    wm = (wv - hk.HALF_PATCH).to(F32)
    hm = (heights[level] - hk.HALF_PATCH).to(F32)
    p = torch.arange(hk.PATCH ** 2)
    ox = ((p % hk.PATCH) - hk.HALF_PATCH).to(F32)
    oy = ((p // hk.PATCH) - hk.HALF_PATCH).to(F32)
    u, v = px0[:, 0].clone(), px0[:, 1].clone()
    md = torch.zeros_like(u)
    conv = torch.zeros_like(valid)
    alive = valid.clone()
    running = valid & (n_iter > 0)
    thr = torch.tensor(hk.MIN_UPDATE_SQ, dtype=F32)
    for _ in range(n_iter):
        ur, vr = torch.floor(u), torch.floor(v)
        inb = (ur >= hk.HALF_PATCH) & (vr >= hk.HALF_PATCH) & (ur < wm) & \
            (vr < hm)
        alive = torch.where(running & ~inb, torch.zeros_like(alive), alive)
        act = running & inb
        xs = torch.minimum(torch.clamp(u, min=hk.HALF_PATCH), wm)[:, None] \
            + ox
        ys = torch.minimum(torch.clamp(v, min=hk.HALF_PATCH), hm)[:, None] \
            + oy
        x0, y0 = torch.floor(xs), torch.floor(ys)
        idx = base[:, None] + y0.long() * wv[:, None] + x0.long()
        cur = _sample(quad, idx, xs - x0, ys - y0)
        res = (cur - target) + md[:, None]
        Jres = [-warp_sum(res.to(F64) * J[i].to(F64)).to(F32)
                for i in range(3)]
        upd = []
        for i in range(3):
            s = Hinv[:, i, 0].to(F64) * Jres[0].to(F64)
            s = s + Hinv[:, i, 1].to(F64) * Jres[1].to(F64)
            s = s + Hinv[:, i, 2].to(F64) * Jres[2].to(F64)
            upd.append(s.to(F32))
        du = torch.where(is_edge, upd[0] * direction[:, 0], upd[0])
        dv = torch.where(is_edge, upd[0] * direction[:, 1], upd[1])
        dmd = torch.where(is_edge, upd[1], upd[2])
        u = torch.where(act, u + du, u)
        v = torch.where(act, v + dv, v)
        md = torch.where(act, md + dmd, md)
        c = act & ((upd[0] * upd[0] + upd[1] * upd[1]) < thr)
        conv = conv | c
        running = act & ~c
    fails = torch.stack([valid & ~conv & ~alive, valid & ~conv & alive], -1)
    return torch.stack([u, v], -1), conv & valid, fails


def warp_align(quad_stack, host_idx, px_ref, A, warp_level, h, w, quad,
               offsets, widths, heights, level, px0, direction, is_edge,
               aff_a, aff_b, valid, n_iter=10):
    """The fused call (MODE_FUSED): K6's patches, then K5 on them."""
    border = warp_patches(quad_stack, host_idx, px_ref, A, warp_level, h, w)
    return align_batch(quad, offsets, widths, heights, level, border, px0,
                       direction, is_edge, aff_a, aff_b, valid, n_iter)
