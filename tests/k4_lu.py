"""K4's solve (csrc/track_lm_update.cu) emulated on the CPU: the damped
float32 system solved in float64 by LU with partial pivoting, each
multiply-subtract fused (one rounding, as the card's DFMA), the step
rounded to float32; and the kernel's pivot choice, an argmax across the
lanes of a warp, beside the serial scan it reproduces.

Shared by tests/test_torch_track_kernels.py (CPU) and
tests/test_torch_cuda.py (the kernel on the card against this emulation),
so it imports neither JAX nor the card.
"""

import math
from fractions import Fraction

import numpy as np
import torch

LAMBDA_LIMIT = np.float32(1e-3)


def fma(a, b, c):
    """a * b + c in float64 with one rounding (an exact rational sum,
    rounded once: int / int division rounds correctly); plain float
    arithmetic where an operand is not finite."""
    a, b, c = float(a), float(b), float(c)
    if not all(math.isfinite(v) for v in (a, b, c)):
        return a * b + c
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def pivot_serial(col, k):
    """The serial scan down column k from row k: the first row of strictly
    largest magnitude (a NaN never wins; a NaN at row k keeps k, since no
    comparison with it is true)."""
    p, best = k, abs(float(col[k]))
    for i in range(k + 1, 8):
        if abs(float(col[i])) > best:
            best, p = abs(float(col[i])), i
    return p


def pivot_lanes(col, k):
    """The kernel's pivot in torch float64, lane by lane: lane i holds key
    -2 above row k, -1 for a NaN magnitude, else |col[i]|; three butterfly
    steps (xor 1, 2, 4) keep the larger key, on a tie the lower row; then
    row k when |col[k]| is NaN. Every lane must end with the same row."""
    mag = torch.as_tensor(np.asarray(col, np.float64)).abs()
    i = torch.arange(8)
    key = torch.where(i < k, torch.full_like(mag, -2.0),
                      torch.where(torch.isnan(mag),
                                  torch.full_like(mag, -1.0), mag))
    p = i.clone()
    for off in (1, 2, 4):
        ok, op = key[i ^ off], p[i ^ off]
        take = (ok > key) | ((ok == key) & (op < p))
        key, p = torch.where(take, ok, key), torch.where(take, op, p)
    assert bool((p == p[0]).all()), p
    return k if bool(torch.isnan(mag[k])) else int(p[0])


def lu_solve(A, y, pivot=pivot_serial, fused=True):
    """A x = y in float64 (A (8, 8), y (8,)): LU with partial pivoting by
    `pivot`, elimination below the pivot row, back substitution with the
    terms in column order; each multiply-subtract one rounding (`fused`)
    or two. Returns x in float64."""
    A = np.array(A, np.float64)
    x = np.array(y, np.float64)

    def msub(acc, a, b):      # acc - a * b
        return fma(-a, b, acc) if fused else acc - a * b
    with np.errstate(all="ignore"):
        for k in range(8):
            p = pivot(A[:, k], k)
            if p != k:
                A[[k, p]] = A[[p, k]]
                x[[k, p]] = x[[p, k]]
            for i in range(k + 1, 8):
                lk = A[i, k] / A[k, k]
                for j in range(k + 1, 8):
                    A[i, j] = msub(A[i, j], lk, A[k, j])
                x[i] = msub(x[i], lk, x[k])
        for i in range(7, -1, -1):
            s = x[i]
            for j in range(i + 1, 8):
                s = msub(s, A[i, j], x[j])
            x[i] = s / A[i, i]
    return x


def damped(H, lam):
    """The damped system H + diag(H) lam + 1e-12 I, formed in float32 as
    the kernel and the plain version form it."""
    H = np.asarray(H, np.float32)
    lam = np.float32(lam)
    with np.errstate(all="ignore"):
        A = H + np.float32(0.0) * lam
        d = np.diag(H)
        A[np.arange(8), np.arange(8)] = (d + d * lam) + np.float32(1e-12)
    return A


def step_inc(H, b, lam, fused=True):
    """K4's step (before STEP_SCALE) of one row in float32: the damped
    solve, the extrapolation factor, non-finite entries zeroed."""
    lam = np.float32(lam)
    x = lu_solve(damped(H, lam), -np.asarray(b, np.float32), fused=fused)
    ext = np.sqrt(np.sqrt(LAMBDA_LIMIT / max(lam, np.float32(1e-12)))) \
        if lam < LAMBDA_LIMIT else np.float32(1.0)
    with np.errstate(all="ignore"):
        s = x.astype(np.float32) * np.float32(ext)
    return np.where(np.isfinite(s), s, np.float32(0.0)).astype(np.float32)
