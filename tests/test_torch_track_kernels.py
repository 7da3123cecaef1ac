"""The tracking LM's kernels on the CPU: K3 (`track_res_gs`, the residual
and 8x8 system) and K4 (`lm_update_step` / `lm_update_accept_step`, the
rest of the LM) through their plain versions, against the JAX package's
`calc_res_gs` and tracking LM; the LM loop with the step as a carry
against the three-launch body (step, K3, accept), bit for bit; a torch
emulation of K3's arithmetic and reduction order (tests/k3_order.py, the
cluster order of csrc/track_res_gs.cu) against the plain version, and
against the previous one-block-per-row order (within one float32 ulp,
with the count of outputs that differ);
K4's LU (tests/k4_lu.py) against the plain solve, and its warp-parallel
pivot choice against the serial scan; and the CPU dispatch, which never
loads the kernels' library.

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
    damped system's condition: ~200 here);
  * K3's order against the one-block-per-row order: one float32 ulp
    (both sum exact float64 products; only the order of the float64
    additions differs);
  * the LM loop against the three-launch body, the warp pivot against the
    serial scan: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k3_order
import k4_lu
from sdv_loam_tpu.ops import photometric as jph
from sdv_loam_tpu.utils import se3 as jse3
from sdv_loam_tpu_torch.eval import kernel_timing as kt
from sdv_loam_tpu_torch.ops import align as talign
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


def _three_launch_lm_body(x, st, h, w, huber_th, lanes):
    """The three-launch LM body: the step, K3 at the stepped pose, the
    accept (three launches on the card; here the plain versions)."""
    r = {k: st["r_" + k] for k in hk.RES_KEYS}
    T_new, aff_new, aff_rel, inc = hk.lm_update_step_plain(
        r["H"], r["b"], st["lam"], st["T"], st["aff"], x["exposures"],
        x["ref_aff"])
    r_new = hk.calc_res_gs_plain(
        {k: x["pool_" + k] for k in tph._POOL_FIELDS}, None, x["K"], T_new,
        aff_rel, x["ref_aff"][..., 1], x["cutoff"], huber_th,
        packed=x["packed"], lane=x["lane"] if lanes else None, hw=(h, w))
    o = hk.lm_update_accept_plain(r, r_new, st["T"], T_new, st["aff"],
                                  aff_new, st["lam"], st["done"], st["n_it"],
                                  inc)
    out = dict({"r_" + k: v for k, v in o["r"].items()},
               **{k: o[k] for k in ("T", "aff", "lam", "done", "n_it")})
    return out, o["active"]


@pytest.mark.parametrize("max_iters", [1, 3, 10])
def test_lm_loop_matches_three_launch_body(max_iters):
    """(b) The LM loop with the step as a carry (the step before the loop,
    then K3 and the accept-step per iteration) against the three-launch
    body (step, K3, accept per iteration), the early-exit loop of each on
    the same rows: the same iterations per row and every carry bit for
    bit."""
    from sdv_loam_tpu_torch.utils import device_loop as dl

    sc = _scene(4)
    exposures, ref_aff, aff0 = _lm_inputs(sc, 4)
    pool, dI, packed, K = _port_lanes(sc)
    B = LANES * ROWS
    x = {"pool_" + k: pool[k] for k in tph._POOL_FIELDS}
    x.update(K=K, packed=packed, lane=torch.from_numpy(sc["lane"]),
             exposures=torch.from_numpy(exposures),
             ref_aff=torch.from_numpy(ref_aff),
             cutoff=torch.from_numpy(sc["cutoff"]))
    static = dict(h=H_IMG, w=W_IMG, huber_th=HUBER, lanes=True)
    T0, a0 = torch.from_numpy(sc["T"]), torch.from_numpy(aff0)
    r0 = tph._level_res(x, T0, a0, x["cutoff"], **static)
    lam = torch.full((B,), 0.01)
    st = dict({"r_" + k: v for k, v in r0.items()}, T=T0, aff=a0, lam=lam,
              done=torch.zeros(B, dtype=torch.bool),
              n_it=torch.zeros(B, dtype=torch.int64))
    ref = dl.eager_loop("lm", _three_launch_lm_body, x, st, max_iters, static)
    step = hk.lm_update_step(r0["H"], r0["b"], lam, T0, a0, x["exposures"],
                             x["ref_aff"])
    got = dl.eager_loop("lm", tph._lm_body, x,
                        dict(st, **dict(zip(hk.STEP_KEYS, step))),
                        max_iters, static)
    for k in ref:
        assert dl.same_bits(got[k], ref[k]), k
    assert int(got["n_it"].max()) == min(max_iters, int(ref["n_it"].max()))
    if max_iters == 10:
        assert len(set(got["n_it"].tolist())) > 1   # rows stop apart


# ---------------------------------------------------------------------------
# K3's arithmetic and reduction order (csrc/track_res_gs.cu), emulated in
# tests/k3_order.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_k3_emulation_within_tolerance_of_plain(seed):
    """(d) K3's arithmetic and order (`k3_order.emulate`) against the
    plain version, row by row, at the tolerance the card's checks use
    (REL)."""
    sc = _scene(seed, poison=seed == 5)     # seed 5: poisoned rows too
    pool, dI, packed, K = _port_lanes(sc)
    emu = k3_order.emulate(pool, packed, K, torch.from_numpy(sc["T"]),
                           torch.from_numpy(sc["aff_rel"]),
                           torch.from_numpy(sc["ref_b"]),
                           torch.from_numpy(sc["cutoff"]), HUBER,
                           torch.from_numpy(sc["lane"]), H_IMG, W_IMG)
    ref = _port_rows(sc)
    for b in range(LANES * ROWS):
        _close_rows({k: v[b].numpy() for k, v in emu.items()},
                    _row(ref, b), f"row {b}")


# scenes for the two orders: (seed, h, w, points, lanes, rows, poison);
# the poisoned one has a point at depth 0 and an image patch of inf, and
# level 0 the refinement's 6144 points at 1200x360
ORDER_SCENES = {"seed0": (0, H_IMG, W_IMG, N, LANES, ROWS, False),
                "seed1": (1, H_IMG, W_IMG, N, LANES, ROWS, False),
                "poisoned": (5, H_IMG, W_IMG, N, LANES, ROWS, True),
                "level0": (101, 360, 1200, 6144, 2, 3, True)}


def _f32_ulps(a, b):
    """Float32 ulps between a and b, element by element (0 for two NaNs;
    the sign of a zero ignored)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    d = np.abs(ia - ib)
    return np.where(np.isnan(a) & np.isnan(b), 0, d)


@pytest.mark.parametrize("scene", list(ORDER_SCENES))
def test_k3_order_against_block_order(scene):
    """(d) K3's reduction order against the one-block-per-row order
    (`k3_order.order_block`) on the same per-point terms: every float32
    output within one float32 ulp of the other order's, NaN where the
    other is NaN, the counts equal. Prints how many outputs differ at all
    (0 says the two orders' outputs are the same bits here)."""
    seed, h, w, n, lanes, rows, poison = ORDER_SCENES[scene]
    sc = kt.track_scene(seed, h, w, n, lanes, rows, poison=poison)
    x = kt.track_inputs(sc, "cpu")
    X, counts = k3_order.terms(x["pool"], x["packed"], x["K"], x["T"],
                               x["aff_rel"], x["ref_b"], x["cutoff"], HUBER,
                               x["lane"], h, w)
    new = k3_order.outputs(k3_order.order_cluster(X), counts)
    old = k3_order.outputs(k3_order.order_block(X), counts)
    assert torch.equal(new["n"], old["n"])
    differ = total = 0
    for k in ("E", "sat_frac", "H", "b", "flow_t", "flow_rt"):
        a, b = new[k].numpy(), old[k].numpy()
        assert np.array_equal(np.isnan(a), np.isnan(b)), (scene, k)
        u = _f32_ulps(a, b)
        assert u.max() <= 1, (scene, k, int(u.max()))
        differ += int((u != 0).sum())
        total += u.size
    print(f"K3 order against the one-block order, {scene}: {differ} of "
          f"{total} float32 outputs differ (each by one ulp)")
    if scene == "poisoned":
        assert not torch.isfinite(new["H"]).all()


def test_k4_lu_within_tolerance_of_plain_solve():
    """(d) K4's LU (tests/k4_lu.py: the kernel's order, each
    multiply-subtract fused) against the plain version's solve_ex on the
    damped systems of the scene's rows, at lambda 0.01 and 1e-4, within
    SOLVE_REL of the step's norm."""
    sc = _scene(0)
    r = _port_rows(sc)
    for lam in (0.01, 1e-4):
        for b in range(LANES * ROWS):
            H = torch.from_numpy(r["H"][b:b + 1])
            bb = torch.from_numpy(r["b"][b:b + 1])
            ref = hk._solve_scaled(H, bb, torch.tensor([lam]))[0].numpy()
            got = k4_lu.step_inc(r["H"][b], r["b"][b], lam)
            err = np.abs(got - ref).max()
            assert err <= SOLVE_REL * np.linalg.norm(ref), (lam, b, err)


def _pivot_systems(case, n=12):
    """8x8 float64 systems whose columns test the pivot rule: `random`;
    `tied` (small integers: equal magnitudes of either sign, zeros, and an
    inf); `nan_diagonal` (a NaN on the diagonal); `nan_below` (NaNs below
    the diagonal)."""
    rng = np.random.default_rng({"random": 0, "tied": 1, "nan_diagonal": 2,
                                 "nan_below": 3}[case])
    out = []
    for t in range(n):
        if case == "random":
            A = rng.normal(size=(8, 8)) * 10.0 ** rng.integers(-3, 4, (8, 8))
        else:
            A = rng.integers(-3, 4, (8, 8)).astype(np.float64)
        if case == "tied" and t % 3 == 0:
            A[rng.integers(8), rng.integers(8)] = np.inf
        if case == "nan_diagonal":
            k = rng.integers(8)
            A[k, k] = np.nan
        if case == "nan_below":
            for _ in range(3):
                k = rng.integers(7)
                A[rng.integers(k + 1, 8), k] = np.nan
        out.append(A)
    return out


@pytest.mark.parametrize("case", ["random", "tied", "nan_diagonal",
                                  "nan_below"])
def test_k4_warp_pivot_equals_serial_scan(case):
    """(d) K4's pivot, an argmax across a warp's lanes with ties to the
    lower row and a NaN as the serial scan treats it (`k4_lu.pivot_lanes`),
    picks the one-thread serial scan's row (`pivot_serial`) in every
    column of the systems, and the whole solve with either rule gives the
    same bits."""
    rng = np.random.default_rng(7)
    for A in _pivot_systems(case):
        for k in range(8):
            assert k4_lu.pivot_lanes(A[:, k], k) == \
                k4_lu.pivot_serial(A[:, k], k), (case, k, A[:, k])
        y = rng.normal(size=8)
        got = k4_lu.lu_solve(A, y, pivot=k4_lu.pivot_lanes)
        ref = k4_lu.lu_solve(A, y, pivot=k4_lu.pivot_serial)
        assert np.array_equal(got, ref, equal_nan=True), case


def test_cpu_dispatch_never_loads_the_library(monkeypatch):
    """(e) On the CPU every wrapper takes its plain version: K3 through
    calc_res_gs, K4 through the tracking LM (track_level), K6 and K5
    through the matcher's `warp_affine_patches` and `align_batch`, with the
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
    wsc = kt.warp_scene(1, H_IMG, W_IMG, 16, LANES)
    args, kw = kt.warp_args(wsc, "cpu")
    assert torch.equal(talign.warp_affine_patches(*args, **kw),
                       hk.warp_affine_patches_plain(*args, **kw))
    asc = kt.align_scene(2, H_IMG, W_IMG, 16, LANES, levels=3)
    got = talign.align_batch(*kt.align_args(asc, "cpu"), n_lanes=LANES)
    ref = hk.align_batch_plain(*kt.align_args(asc, "cpu"), n_lanes=LANES)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert hk.launch_counts() == {"dilate_pyramid": 0,
                                  "distance_transform": 0,
                                  "track_res_gs": 0, "track_lm_update": 0,
                                  "align_batch": 0, "warp_patches": 0,
                                  "ba_linearize": 0, "ba_accumulate": 0}
