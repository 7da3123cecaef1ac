"""The reference's parts on tiny inputs, against the port's plain
versions (the arithmetic the kernels are specified by)."""

import numpy as np
import pytest
import torch

from vo_bench import cells, check, reference as ref

hk = pytest.importorskip("sdv_loam_tpu_torch.ops.hopper_kernels")
k3, k4, k5, k7, k8 = (cells.check(n) for n in ("k3", "k4", "k5", "k7", "k8"))


def _maps(rng, shape, frac=0.05):
    idp = np.where(rng.random(shape) < frac, rng.uniform(0.01, 1.0, shape),
                   0.0).astype(np.float32)
    wt = np.where(idp > 0, rng.uniform(0.5, 2.0, shape), 0.0).astype(
        np.float32)
    return torch.from_numpy(idp), torch.from_numpy(wt)


@pytest.mark.parametrize("shape", [(48, 160), (2, 36, 120)])
def test_dilate_pyramid_bit_for_bit(shape):
    idp, wt = _maps(np.random.default_rng(1), shape)
    got = ref.dilate_pyramid(idp, wt, 4)
    want = hk.dilate_pyramid_plain(idp, wt, 4)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert check.same_bits(a, b)


def test_distance_transform_bit_for_bit():
    rng = np.random.default_rng(2)
    seed = torch.from_numpy(np.where(rng.random((2, 30, 50)) < 0.02, 0.0,
                                     1000.0).astype(np.float32))
    assert check.same_bits(ref.distance_transform(seed, 16),
                           hk.distance_transform_plain(seed, 16))


def _track_inputs(rng, L=2, rows_per_lane=3, n=256, h=40, w=60):
    B = L * rows_per_lane

    def f32(a):
        return torch.tensor(a, dtype=torch.float32)
    pool = dict(u=f32(rng.uniform(5, w - 6, (L, n))),
                v=f32(rng.uniform(5, h - 6, (L, n))),
                idepth=f32(rng.uniform(0.05, 0.5, (L, n))),
                color=f32(rng.uniform(20, 230, (L, n))),
                valid=torch.tensor(rng.random((L, n)) < 0.9))
    img = f32(rng.uniform(0, 255, (L, h, w, 3)))
    img[..., 1:] = f32(rng.normal(0, 20, (L, h, w, 2)))
    K = torch.tensor([[50.0, 50.0, w / 2, h / 2]] * L)
    xi = torch.tensor(rng.normal(0, 0.01, (B, 6)), dtype=torch.float32)
    T = ref.se3_exp(xi.double()).float()
    aff = f32(np.c_[rng.uniform(0.9, 1.1, B), rng.uniform(-3, 3, B)])
    lane = torch.arange(L).repeat_interleave(rows_per_lane)
    return pool, img, K, T, aff, lane


def test_track_res_gs_against_the_plain_version():
    pool, img, K, T, aff, lane = _track_inputs(np.random.default_rng(3))
    args = (pool, img, K, T, aff, 0.5, 30.0, 9.0)
    want = ref.track_res_gs(*args, lane=lane)
    got = hk.calc_res_gs_plain(*args, lane=lane)
    assert torch.equal(got["n"], want["n"])
    assert float(k3.rows_err(got, want).max()) < 1e-5
    low = ref.track_res_gs(*args, lane=lane, acc=torch.float32)
    assert float(k3.rows_err(low, want).max()) < 1e-5


def test_lm_step_and_accept_against_the_plain_version():
    rng = np.random.default_rng(4)
    B = 5
    J = torch.tensor(rng.normal(0, 1, (B, 40, 8)), dtype=torch.float32)
    H = J.transpose(1, 2) @ J
    b = torch.tensor(rng.normal(0, 1, (B, 8)), dtype=torch.float32)
    lam = torch.tensor([0.01, 0.1, 1e-5, 1.0, 0.0005], dtype=torch.float32)
    T = ref.se3_exp(torch.tensor(rng.normal(0, 0.1, (B, 6)))).float()
    aff = torch.tensor(rng.normal(0, 0.1, (B, 2)), dtype=torch.float32)
    expo = torch.ones(2)
    ref_aff = torch.zeros(2)
    want = ref.lm_step(H, b, lam, T, aff, expo, ref_aff)
    got = hk.lm_update_step_plain(H, b, lam, T, aff, expo, ref_aff)
    assert k4.step_rel(got, want) < 1e-3
    r = dict(E=torch.tensor(rng.uniform(1, 2, B), dtype=torch.float32),
             n=torch.full((B,), 100), sat_frac=torch.zeros(B), H=H, b=b,
             flow_t=torch.zeros(B), flow_rt=torch.zeros(B))
    r_new = dict(r, E=torch.tensor(rng.uniform(1, 2, B), dtype=torch.float32))
    done = torch.tensor([False, True, False, False, False])
    n_it = torch.zeros(B, dtype=torch.int64)
    args = (r, r_new, T, got[0], aff, got[1], lam, done, n_it, got[3], expo,
            ref_aff)
    w = ref.lm_accept_step(*args)
    g = hk.lm_update_accept_step_plain(*args)
    for k in ("done", "n_it", "lam"):
        assert torch.equal(w[k], g[k])


def test_ate_of_a_rigidly_moved_path_is_zero():
    from vo_bench import scene
    gt = scene.make_trajectory(20, 0.7, 0.004)
    M = ref.se3_exp(torch.tensor([1.0, -2.0, 0.5, 0.1, -0.2, 0.3],
                                 dtype=torch.float64)).numpy()
    assert ref.ate_rmse(M @ gt, gt) < 1e-9
    assert abs(ref.path_length(gt) - 0.7 * 19) < 1e-9


def test_k3_near_cutoff_sides(monkeypatch):
    """A point taken to the other side of the cutoff makes its row wrong;
    tried on both sides, the row agrees again."""
    pool, img, K, T, aff, lane = _track_inputs(np.random.default_rng(5))
    args = (pool, img, K, T, aff, 0.5, 30.0, 9.0)
    kw = dict(lane=lane)
    # every in-bound point within ~10 % of the cutoff counts as near
    monkeypatch.setattr(ref, "NEAR_ULPS", 3e6)
    want = ref.track_res_gs(*args, **kw)
    near = want["near"]
    r0 = int(torch.nonzero(near.any(-1))[0, 0])
    flip = torch.zeros_like(near)
    flip[r0, int(torch.nonzero(near[r0])[0, 0])] = True
    got = ref.track_res_gs(*args, **kw, flip=flip)
    rows = k3.rows_err(got, want)
    assert float(rows[r0]) > 1e-4
    rows, n_near = k3.near_sides(args, kw, got, want, rows)
    assert float(rows.max()) < 1e-12 and n_near == int(near.any(-1).sum())
    monkeypatch.setattr(ref, "NEAR_ULPS", 8.0)
    assert int(ref.track_res_gs(*args, **kw)["near"].sum()) < int(near.sum())


def _texture(x, y):
    return 128 + 60 * torch.sin(0.3 * x + 0.2 * y) \
        + 40 * torch.cos(0.17 * x - 0.23 * y)


def _align_inputs(rng, L=2, F=2, M=24, h=48, w=80, levels=3):
    """The matcher's warp-and-align call on analytic textures: L lanes of
    F host frames and a target pyramid each, M candidates a lane."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64),
                            torch.arange(w, dtype=torch.float64),
                            indexing="ij")
    stack = torch.stack([torch.stack([_texture(xs + 3 * f, ys - f),
                                      torch.zeros_like(xs),
                                      torch.zeros_like(xs)], -1)
                         for f in range(L * F)]).float()
    quads, offs, wid, hei, off = [], [], [], [], 0
    for ln in range(L):
        for k in range(levels):
            hk_, wk = h >> k, w >> k
            yy, xx = torch.meshgrid(torch.arange(hk_, dtype=torch.float64),
                                    torch.arange(wk, dtype=torch.float64),
                                    indexing="ij")
            s = 2.0 ** k
            lvl = _texture((xx + 0.5) * s - 0.5 + 0.6 + 3 * ln * F,
                           (yy + 0.5) * s - 0.5 - 0.4 - ln * F).float()
            quads.append(ref.quad_pack(lvl))
            if ln == 0:
                offs.append(off)
                wid.append(wk)
                hei.append(hk_)
            off += hk_ * wk
    T_flat = off // L
    offsets = (torch.tensor(offs)[None] + (torch.arange(L) * T_flat)[:, None]
               ).reshape(-1)
    widths, heights = torch.tensor(wid).repeat(L), torch.tensor(hei).repeat(L)
    n = L * M
    lvl = torch.tensor(rng.integers(0, 2, n))
    rl = torch.arange(L).repeat_interleave(M)
    px_ref = torch.tensor(np.c_[rng.uniform(16, w - 16, n),
                                rng.uniform(14, h - 14, n)],
                          dtype=torch.float32)
    A = torch.tensor(np.eye(2)[None] + rng.normal(0, 0.03, (n, 2, 2)),
                     dtype=torch.float32)
    scale = 2.0 ** lvl.float()
    px_init = ((px_ref + torch.tensor(rng.normal(0, 0.7, (n, 2)),
                                      dtype=torch.float32))
               - 0.5 * (scale[:, None] - 1)) / scale[:, None]
    d = torch.tensor(rng.normal(0, 1, (n, 2)), dtype=torch.float32)
    d = d / d.norm(dim=-1, keepdim=True)
    host = rl * F + torch.tensor(rng.integers(0, F, n))
    return (stack, host, px_ref, A, lvl, torch.cat(quads), offsets, widths,
            heights, rl * levels + lvl, px_init, d,
            torch.tensor(rng.random(n) < 0.3),
            torch.tensor(rng.uniform(0.9, 1.1, n), dtype=torch.float32),
            torch.tensor(rng.uniform(-2, 2, n), dtype=torch.float32),
            torch.tensor(rng.random(n) < 0.9)), L


def test_warp_align_against_the_plain_version():
    a, L = _align_inputs(np.random.default_rng(6))
    px, conv, fails, iters = ref.warp_align(*a, n_iter=10, n_lanes=L)
    p_px, p_conv, p_fails = hk.warp_align_plain(*a, n_iter=10, n_lanes=L)
    assert int(conv.sum()) > 10 and int(iters.max()) > 1
    assert torch.equal(conv, p_conv) and torch.equal(fails, p_fails)
    flags, gap = k5.call_numbers((p_px, p_conv, p_fails),
                                 (px, conv, fails, iters))
    assert flags == 0 and gap < 1e-3
    # the patches alone against the plain warp
    patches = ref.warp_patches(*a[:5])
    assert float((patches - hk.warp_affine_patches_plain(*a[:5])).abs()
                 .max()) < 1e-3


def test_k5_numbers_see_a_flag_and_a_position():
    a, L = _align_inputs(np.random.default_rng(7))
    want = ref.warp_align(*a, n_iter=10, n_lanes=L)
    px, conv, fails = (x.clone() for x in want[:3])
    j = int(torch.nonzero(conv)[0, 0])
    px[j, 1] += 0.01
    assert k5.call_numbers((px, conv, fails), want) == (0, pytest.approx(
        0.01, rel=1e-3))
    conv[j] = False
    assert k5.call_numbers((px, conv, fails), want)[0] == 1


def _ba_window(seed, resf_at_fej=True, L=2, N=384, F=5, w=320, h=96):
    """A BA window (`eval/kernel_timing.ba_scene`) as the K7 dispatcher's
    arguments, and its plain linearization."""
    from sdv_loam_tpu_torch.eval import kernel_timing as kt
    from sdv_loam_tpu_torch.models import backend

    x = kt.ba_scene(seed, L, N, F, w, h)
    args = kt.ba_lin_args(x, F)
    kw = dict(w=w, h=h, gate=x["gate"], resf_at_fej=resf_at_fej)
    return x, args, kw, backend.linearize_residuals_lanes_plain(*args, **kw)


@pytest.mark.parametrize("fej", [True, False])
def test_ba_linearize_against_the_plain_version(fej):
    """K7's reference and the plain version (library products: another
    rounding) agree but for residuals at a bounds threshold or near the
    target's camera plane; a focal length a ten-thousandth off is seen."""
    from sdv_loam_tpu_torch.eval import kernel_timing as kt

    x, args, kw, plain = _ba_window(11, fej)
    want = k7.reference("K7", args, kw, plain)
    flags, rows = k7.gaps(plain, want)
    near = kt.ba_lin_near(plain, x, kw["w"], kw["h"])
    diff = (plain["new_state"] != want["new_state"]) | \
        (plain["proj_ok"] != want["proj_ok"])
    assert not bool((diff & ~near).any())
    assert float(rows.max()) < 1e-6
    assert int((want["new_state"] == 0).sum()) > 100
    # each term's magnitude bounds the value
    for k in k7.OUTPUTS:
        r = want[k]
        assert bool((r.v.double().abs() <= r.m * (1 + 1e-6) + 1e-30).all())
    # the same call's numbers with the focal length off
    bad = list(args)
    bad[13] = bad[13].clone()
    bad[13][:, 0] *= 1.0 + 1e-4
    from sdv_loam_tpu_torch.models import backend
    out = backend.linearize_residuals_lanes_plain(*bad, **kw)
    num = k7.numbers([("K7", args, kw, out, want)])
    assert num["k7_rel_err"] > 1e-5 or num["k7_flags_differ"] > 0


def test_ba_accumulate_against_the_plain_version():
    """K8's reference (float64) against the plain version (float32): every
    output within 1e-5 of its terms' magnitude, the counts equal; the
    control's float32 variant too (no TF32 on the CPU); a system entry a
    ten-thousandth off is seen."""
    from sdv_loam_tpu_torch.eval import kernel_timing as kt
    from sdv_loam_tpu_torch.models import backend

    x, _, _, lin = _ba_window(12)
    args = kt.ba_acc_args(lin, x, 5)
    plain = backend._accumulate_plain(*args)
    want = k8.reference("K8", args, {}, plain)
    num = k8.numbers([("K8", args, {}, plain, want)])
    assert num["k8_counts_differ"] == 0 and 0 < num["k8_rel_err"] < 1e-5
    low = k8.reference("K8", args, {}, plain, low=True)
    assert k8.numbers([("K8", args, {}, low, want)])["k8_rel_err"] < 1e-5
    bad = list(plain)
    bad[0] = bad[0].clone()
    bad[0][:, 4, 4] *= 1.0 + 1e-4
    assert k8.numbers([("K8", args, {}, bad, want)])["k8_rel_err"] > 1e-5
