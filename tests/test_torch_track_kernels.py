"""The tracking LM's kernels on the CPU: K3 (`track_res_gs`, the residual
and 8x8 system) and K4 (`lm_update_step` / `lm_update_accept`, the rest of
an LM iteration) through their plain versions, against the JAX package's
`calc_res_gs` and tracking LM; a torch emulation of K3's arithmetic and
reduction order (csrc/track_res_gs.cu) and of K4's LU solve against the
plain versions; and the CPU dispatch, which never loads the kernels'
library.

Inputs: two lanes of a 96x320 scene (pools of 1024 points, three image
channels), made from a seeded numpy generator and handed to both packages
as float32.

Tolerances:
  * counts (n, saturated points), `done`, `n_it` and lambda: exact;
  * E, H, b and the flows: |port - reference| <= REL x the row's largest
    magnitude of that output, REL = 1e-4, the card's tolerance: float32
    sums taken in other orders (XLA's dot, torch's bmm) and the kernel's
    float64 sums differ by at most 9e-7 of that magnitude here (1024
    terms) and by 1.3e-5 on the card at 6144 terms, where cancellation
    leaves a sum small against its terms;
  * poses after the LM: 1e-4 m and 1e-4 rad, affine 1e-4 (relative): the
    same sums feed a damped 8x8 solve over a few iterations;
  * the kernel's float64 LU against torch.linalg.solve_ex's float32 one:
    SOLVE_REL = 1e-3 of the step's norm, the card's tolerance (the
    difference is the float32 solve's own error, which grows with the
    damped system's condition: ~200 here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdv_loam_tpu.ops import photometric as jph
from sdv_loam_tpu.utils import se3 as jse3
from sdv_loam_tpu_torch.eval import kernel_timing as kt
from sdv_loam_tpu_torch.ops import hopper_kernels as hk
from sdv_loam_tpu_torch.ops import photometric as tph

H_IMG, W_IMG, N, LANES, ROWS = 96, 320, 1024, 2, 3
HUBER = 9.0
REL = 1e-4
POSE_M, POSE_RAD, AFF_REL = 1e-4, 1e-4, 1e-4
SOLVE_REL = 1e-3


def _scene(seed, poison=False):
    """Two lanes of ROWS pose rows each (`kernel_timing.track_scene`):
    some points leave the image, some saturate."""
    return kt.track_scene(seed, H_IMG, W_IMG, N, LANES, ROWS, poison=poison)


def _port_lanes(sc):
    """The port's inputs: pool fields (L, N), images, their pack, K."""
    x = kt.track_inputs(sc, "cpu")
    return x["pool"], x["dI"], x["packed"], x["K"]


def _jax_row(sc, b, T=None, aff_rel=None):
    ln = int(sc["lane"][b])
    pool = {k: jnp.asarray(v) for k, v in sc["pools"][ln].items()}
    T = sc["T"][b] if T is None else T
    aff_rel = sc["aff_rel"][b] if aff_rel is None else aff_rel
    out = jph.calc_res_gs(pool, jnp.asarray(sc["imgs"][ln]),
                          jnp.asarray(sc["Ks"][ln]), jnp.asarray(T),
                          jnp.asarray(aff_rel), jnp.float32(sc["ref_b"][b]),
                          float(sc["cutoff"][b]), HUBER)
    return {k: np.asarray(v) for k, v in out.items()}


def _port_rows(sc, T=None):
    pool, dI, packed, K = _port_lanes(sc)
    out = hk.calc_res_gs_plain(
        pool, dI, K, torch.from_numpy(sc["T"] if T is None else T),
        torch.from_numpy(sc["aff_rel"]), torch.from_numpy(sc["ref_b"]),
        torch.from_numpy(sc["cutoff"]), HUBER, packed=packed,
        lane=torch.from_numpy(sc["lane"]))
    return {k: v.numpy() for k, v in out.items()}


def _close_rows(got, ref, what, rel=REL):
    """Per row: counts exact, float outputs within rel x the row's largest
    magnitude of that output (finite entries; the non-finite ones must
    sit at the same places)."""
    for k in ("E", "H", "b", "flow_t", "flow_rt", "sat_frac"):
        g = np.asarray(got[k], np.float64)
        r = np.asarray(ref[k], np.float64)
        assert np.array_equal(np.isfinite(g), np.isfinite(r)), (what, k)
        f = np.isfinite(r)
        scale = max(float(np.abs(r[f]).max()) if f.any() else 0.0, 1e-30)
        err = float(np.abs(g[f] - r[f]).max()) if f.any() else 0.0
        assert err <= rel * scale, (what, k, err, scale)
    assert int(got["n"]) == int(ref["n"]), what
    n = max(int(ref["n"]), 1)
    assert round(float(got["sat_frac"]) * n) == \
        round(float(ref["sat_frac"]) * n), what


def _row(d, b):
    return {k: v[b] for k, v in d.items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_res_gs_plain_matches_jax(seed):
    """(a) K3's plain version, B rows over two lanes, against the JAX
    package's calc_res_gs run row by row on each row's lane."""
    sc = _scene(seed)
    got = _port_rows(sc)
    n_sat = 0
    for b in range(LANES * ROWS):
        ref = _jax_row(sc, b)
        _close_rows(_row(got, b), ref, f"row {b}")
        n_sat += round(float(ref["sat_frac"]) * int(ref["n"]))
    # the inputs reach every branch: saturated points, and points out of
    # bounds (fewer terms than valid slots)
    assert n_sat > 0
    assert all(got["n"][b] < sc["pools"][sc["lane"][b]]["valid"].sum()
               for b in range(LANES * ROWS))


@pytest.mark.parametrize("case", ["depth_zero", "image_inf"])
def test_non_finite_point_matches_jax(case):
    """(c) A point whose J or r is not finite poisons H and b in both
    packages (J (J w) over every point, 0 x inf = NaN): the non-finite
    outputs sit at the same places, the finite ones agree."""
    sc = _scene(3)
    if case == "depth_zero":
        # T = [I | (0.01, 0, -0.5)], idepth 2: the point's depth is 0
        sc["T"][0] = np.eye(4, dtype=np.float32)
        sc["T"][0, :3, 3] = (0.01, 0.0, -0.5)
        sc["pools"][0]["idepth"][5] = 2.0
    else:
        # a patch of lane 1's image, under some of its points' supports
        p = sc["pools"][1]
        u, v = int(p["u"][7]), int(p["v"][7])
        sc["imgs"][1, max(v - 8, 0):v + 8, max(u - 8, 0):u + 8, :] = np.inf
    got = _port_rows(sc)
    poisoned = 0
    for b in range(LANES * ROWS):
        ref = _jax_row(sc, b)
        _close_rows(_row(got, b), ref, f"{case} row {b}")
        poisoned += not np.isfinite(ref["H"]).all()
    assert poisoned >= 1


def _jax_lm(sc, b, exposures, ref_aff, aff0, n_iter):
    """The JAX package's LM body (photometric.py:310-328) on one row, run
    until the row is done or n_iter iterations: (T, aff, lam, done,
    n_it)."""
    ln = int(sc["lane"][b])
    pool = {k: jnp.asarray(v) for k, v in sc["pools"][ln].items()}
    dI, K = jnp.asarray(sc["imgs"][ln]), jnp.asarray(sc["Ks"][ln])
    ex, ra = jnp.asarray(exposures[b]), jnp.asarray(ref_aff[b])
    cutoff = float(sc["cutoff"][b])

    def res(T, aff):
        ar = jph.aff_transfer(ex[0], ex[1], ra, aff)
        return jph.calc_res_gs(pool, dI, K, T, ar, ra[1], cutoff, HUBER)

    T, aff = jnp.asarray(sc["T"][b]), jnp.asarray(aff0[b])
    lam, done, it = jnp.float32(0.01), False, 0
    r = res(T, aff)
    while it < n_iter and not done:
        inc = jph._solve_scaled(r["H"], r["b"], lam)
        inc_s = inc * jph.STEP_SCALE
        T_new = jse3.mul(jse3.se3_exp(inc_s[:6]), T)
        aff_new = aff + inc_s[6:]
        r_new = res(T_new, aff_new)
        accept = bool(r_new["E"] / jnp.maximum(r_new["n"], 1)
                      < r["E"] / jnp.maximum(r["n"], 1))
        if accept:
            T, aff, r = T_new, aff_new, r_new
        lam = lam * 0.5 if accept else jnp.maximum(
            lam * 4.0, jph.LAMBDA_EXTRAPOLATION_LIMIT)
        done = not bool(jnp.linalg.norm(inc) > 1e-3)
        it += 1
    return (np.asarray(T), np.asarray(aff), float(lam), done, it)


def _lm_inputs(sc, seed):
    rng = np.random.default_rng(seed + 100)
    B = LANES * ROWS
    exposures = np.stack([rng.uniform(0.8, 1.2, B),
                          rng.uniform(0.8, 1.2, B)], -1).astype(np.float32)
    ref_aff = np.stack([rng.normal(0, 0.05, B),
                        rng.normal(0, 2, B)], -1).astype(np.float32)
    aff0 = np.stack([rng.normal(0, 0.02, B),
                     rng.normal(0, 1, B)], -1).astype(np.float32)
    return exposures, ref_aff, aff0


def _pose_err(A, B):
    """(m, rad) between two poses; the angle from atan2 (arccos of the
    trace loses ~1e-4 rad to float32 rotations near the identity)."""
    d = np.linalg.inv(A.astype(np.float64)) @ B.astype(np.float64)
    R = d[:3, :3]
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    ang = np.arctan2(0.5 * np.linalg.norm(w), 0.5 * (np.trace(R) - 1.0))
    return float(np.linalg.norm(d[:3, 3])), float(ang)


@pytest.mark.parametrize("seed", [0, 2])
def test_lm_update_plain_matches_jax_lm(seed):
    """(b) K4's plain halves around K3's plain version, 8 iterations from
    the same carry over B rows of two lanes, against the JAX package's LM
    body row by row: T, aff, lambda, done and n_it."""
    sc = _scene(seed)
    n_iter = 8
    exposures, ref_aff, aff0 = _lm_inputs(sc, seed)
    pool, dI, packed, K = _port_lanes(sc)
    lane = torch.from_numpy(sc["lane"])
    ex_t, ra_t = torch.from_numpy(exposures), torch.from_numpy(ref_aff)
    cutoff = torch.from_numpy(sc["cutoff"])
    B = LANES * ROWS

    def res(T, aff_rel):
        return hk.calc_res_gs_plain(pool, dI, K, T, aff_rel, ra_t[:, 1],
                                    cutoff, HUBER, packed=packed, lane=lane)

    T = torch.from_numpy(sc["T"])
    aff = torch.from_numpy(aff0)
    r = res(T, hk.aff_transfer(ex_t[:, 0], ex_t[:, 1], ra_t, aff))
    lam = torch.full((B,), 0.01)
    done = torch.zeros(B, dtype=torch.bool)
    n_it = torch.zeros(B, dtype=torch.int64)
    for _ in range(n_iter):
        T_new, aff_new, aff_rel, inc = hk.lm_update_step_plain(
            r["H"], r["b"], lam, T, aff, ex_t, ra_t)
        o = hk.lm_update_accept_plain(r, res(T_new, aff_rel), T, T_new, aff,
                                      aff_new, lam, done, n_it, inc)
        r, T, aff, lam, done, n_it = (o[k] for k in ("r", "T", "aff", "lam",
                                                     "done", "n_it"))
    iters = []
    for b in range(B):
        jT, jaff, jlam, jdone, jit = _jax_lm(sc, b, exposures, ref_aff, aff0,
                                             n_iter)
        dt, dr = _pose_err(jT, T[b].numpy())
        assert dt <= POSE_M and dr <= POSE_RAD, (b, dt, dr)
        np.testing.assert_allclose(aff[b].numpy(), jaff, rtol=AFF_REL,
                                   atol=AFF_REL)
        assert float(lam[b]) == jlam and bool(done[b]) == jdone, b
        assert int(n_it[b]) == jit, b
        iters.append(jit)
    # the rows stop at different iterations (the freeze is exercised)
    assert len(set(iters)) > 1 or min(iters) < n_iter


def test_track_level_matches_jax():
    """(b) The port's track_level (the cutoff pre-loop and the LM through
    device_loop, K3 and K4 by their plain versions) on B rows of two lanes
    against the JAX package's track_level row by row: T, aff, n_iters."""
    sc = _scene(4)
    exposures, ref_aff, aff0 = _lm_inputs(sc, 4)
    pool, dI, packed, K = _port_lanes(sc)
    cut = 20.0
    T, aff, r, rep = tph.track_level(
        pool, dI, K, torch.from_numpy(sc["T"]), torch.from_numpy(aff0),
        torch.from_numpy(ref_aff), torch.from_numpy(exposures), cut, HUBER,
        10, packed=packed, lane=torch.from_numpy(sc["lane"]))
    jit = jax.jit(jph.track_level, static_argnames=("max_iters",))
    for b in range(LANES * ROWS):
        ln = int(sc["lane"][b])
        jT, jaff, jr, jrep = jit(
            {k: jnp.asarray(v) for k, v in sc["pools"][ln].items()},
            jnp.asarray(sc["imgs"][ln]), jnp.asarray(sc["Ks"][ln]),
            jnp.asarray(sc["T"][b]), jnp.asarray(aff0[b]),
            jnp.asarray(ref_aff[b]), jnp.asarray(exposures[b]), cut, HUBER,
            max_iters=10)
        dt, dr = _pose_err(np.asarray(jT), T[b].numpy())
        assert dt <= POSE_M and dr <= POSE_RAD, (b, dt, dr)
        np.testing.assert_allclose(aff[b].numpy(), np.asarray(jaff),
                                   rtol=AFF_REL, atol=AFF_REL)
        assert int(r["n_iters"][b]) == int(jr["n_iters"]), b
        assert float(rep[b]) == float(jrep), b


# ---------------------------------------------------------------------------
# K3's arithmetic and reduction order (csrc/track_res_gs.cu), emulated
# ---------------------------------------------------------------------------

THREADS, WARPS = 256, 8
STEP_SCALE = torch.tensor(hk.STEP_SCALE)


def _emulate_k3(pool, packed, K, T, aff_rel, ref_b, cutoff, huber, lane, h,
                w):
    """K3 in tensor operations in the kernel's order: the per-point
    quantities in float32, each operation rounded on its own, the products
    of the projection and the bilinear weights summed left to right; a
    point's H and b terms (exact float64 products) added when it is an
    inlier or one of its J or r is not finite; every sum in float64: per
    row, thread t sums points t, t + 256, ... in order, each warp sums its
    lanes by shuffles down at offsets 16..1, the warps' sums add in warp
    order; each output rounded to float32 once."""
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
    hw = torch.where(absr < huber, torch.ones_like(absr),
                     huber / torch.clamp(absr, min=1e-12))
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
    X = torch.stack(terms, -1)                              # (B, n, 76)
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
    n_terms, n_sat, n_in = inb.sum(-1), sat.sum(-1), inl.sum(-1)
    n_in_d = torch.clamp(n_in, min=1).double()
    S = STEP_SCALE.double()
    Hm = ((tot[:, :64].reshape(B, 8, 8) / n_in_d[:, None, None])
          * S[:, None]) * S[None, :]
    bv = (tot[:, 64:72] / n_in_d[:, None]) * S
    num = (m.sum(-1).float() * 2.0 + 0.1).double()
    return dict(E=(tot[:, 72] + tot[:, 73]).float(), n=n_terms,
                sat_frac=n_sat.float() / torch.clamp(n_terms, min=1).float(),
                H=Hm.float(), b=bv.float(),
                flow_t=(tot[:, 74] / num).float(),
                flow_rt=(tot[:, 75] / num).float())


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_k3_emulation_within_tolerance_of_plain(seed):
    """(d) K3's arithmetic and order (the emulation above) against the
    plain version, row by row, at the tolerance the card's checks use
    (REL)."""
    sc = _scene(seed, poison=seed == 5)     # seed 5: poisoned rows too
    pool, dI, packed, K = _port_lanes(sc)
    emu = _emulate_k3(pool, packed, K, torch.from_numpy(sc["T"]),
                      torch.from_numpy(sc["aff_rel"]),
                      torch.from_numpy(sc["ref_b"]),
                      torch.from_numpy(sc["cutoff"]), HUBER,
                      torch.from_numpy(sc["lane"]), H_IMG, W_IMG)
    ref = _port_rows(sc)
    for b in range(LANES * ROWS):
        _close_rows({k: v[b].numpy() for k, v in emu.items()},
                    _row(ref, b), f"row {b}")


def _lu_solve(A, y):
    """K4's solve: the float32 system solved in float64 by LU with partial
    pivoting (the first row of largest magnitude), elimination below the
    pivot and back substitution; the step rounded to float32."""
    A, x = A.astype(np.float64), y.astype(np.float64)
    for k in range(8):
        p = k + int(np.argmax(np.abs(A[k:, k])))
        if p != k:
            A[[k, p]] = A[[p, k]]
            x[[k, p]] = x[[p, k]]
        for i in range(k + 1, 8):
            l = A[i, k] / A[k, k]
            A[i, k + 1:] = A[i, k + 1:] - l * A[k, k + 1:]
            x[i] = x[i] - l * x[k]
    for i in range(7, -1, -1):
        x[i] = (x[i] - np.dot(A[i, i + 1:], x[i + 1:])) / A[i, i]
    return x.astype(np.float32)


def test_k4_lu_within_tolerance_of_plain_solve():
    """(d) K4's LU order against the plain version's solve_ex on the
    damped systems of the scene's rows, at lambda 0.01 and 1e-4, within
    SOLVE_REL of the step's norm."""
    sc = _scene(0)
    r = _port_rows(sc)
    for lam in (0.01, 1e-4):
        for b in range(LANES * ROWS):
            H = torch.from_numpy(r["H"][b:b + 1])
            bb = torch.from_numpy(r["b"][b:b + 1])
            ref = hk._solve_scaled(H, bb, torch.tensor([lam]))[0].numpy()
            d = np.diag(r["H"][b])
            A = r["H"][b] + np.diag(d * np.float32(lam)) + \
                np.eye(8, dtype=np.float32) * np.float32(1e-12)
            ext = np.sqrt(np.sqrt(np.float32(1e-3) / np.float32(lam))) \
                if lam < 1e-3 else np.float32(1.0)
            got = _lu_solve(A, -r["b"][b]) * np.float32(ext)
            err = np.abs(got - ref).max()
            assert err <= SOLVE_REL * np.linalg.norm(ref), (lam, b, err)


def test_cpu_dispatch_never_loads_the_library(monkeypatch):
    """(e) On the CPU every wrapper takes its plain version: K3 through
    calc_res_gs, K4 through the tracking LM (track_level), with the
    library's loader made to raise; no launch is counted."""
    def refuse():
        raise AssertionError("the kernels' library was loaded on the CPU")
    monkeypatch.setattr(hk, "_load", refuse)
    hk.reset_launch_counts()
    sc = _scene(0)
    pool, dI, packed, K = _port_lanes(sc)
    lane = torch.from_numpy(sc["lane"])
    got = tph.calc_res_gs(pool, dI, K, torch.from_numpy(sc["T"]),
                          torch.from_numpy(sc["aff_rel"]),
                          torch.from_numpy(sc["ref_b"]),
                          torch.from_numpy(sc["cutoff"]), HUBER,
                          packed=packed, lane=lane)
    ref = _port_rows(sc)
    assert all(np.array_equal(got[k].numpy(), ref[k], equal_nan=True)
               for k in ref)
    exposures, ref_aff, aff0 = _lm_inputs(sc, 0)
    T, aff, r, _ = tph.track_level(
        pool, dI, K, torch.from_numpy(sc["T"]), torch.from_numpy(aff0),
        torch.from_numpy(ref_aff), torch.from_numpy(exposures), 20.0, HUBER,
        5, packed=packed, lane=lane)
    assert torch.isfinite(T).all() and int(r["n_iters"].max()) >= 1
    assert hk.launch_counts() == {"dilate_pyramid": 0,
                                  "distance_transform": 0,
                                  "track_res_gs": 0, "track_lm_update": 0}
