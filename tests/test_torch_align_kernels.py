"""The matcher's kernels on the CPU: K5 (`align_batch`, the patch
alignment) and K6 (`warp_affine_patches`, the patch warp) through their
plain versions, against the JAX package's `align_batch` and
`warp_affine_patches`; each row's loop run alone to its own stop against
the batched loop, bit for bit (the whole-loop kernel's design changes no
result); a torch emulation of the kernels' arithmetic (tests/k5_align.py:
float64 sums in K5's warp order, the float64 LU inverse of both) against
the plain versions.

Inputs (`kernel_timing.align_scene`, `warp_scene`, seeded numpy): two lanes
of a 96x320 three-level pyramid (the port's levels at that size), 96
candidate rows each (a quarter edgelets, some invalid, some starting at
the level's edge, one at NaN and one with a NaN in its patch), and 96 warp
rows per lane over three host frames (scaled rotations, some 2-6x: every
search level; one NaN warp, one singular, one host slot past the stack).

Tolerances:
  * converged flags (conv & valid): they differ on at most one row plus
    1 - FLAG_SHARE = 0.1 % of the rows: the loop stops at |step| < 0.03
    px, and a row whose last step sits at that threshold converges on one
    side only when its sums round otherwise (float32 sums in XLA's and
    torch's orders, or K5's float64 ones); read: 0 rows of 192 here, and
    for K5 against the plain loop on an H100 0 of chip_smoke.py phase 3's
    39,280 and 1 of 720 in eval/kernel_timing.py --align;
  * px where both converge: within PX_TOL = 0.01 px, a third of a
    converging step (read: <= 1.6e-5 px here, <= 0.0038 px for K5 against
    the plain loop on the card, whose float32 sums take cuBLAS's order). A
    fault that moves px by less, such as one iteration too few, is caught
    on the card by the bit-for-bit comparison with tests/k5_align.py;
  * failure masks: equal on every row whose flag agrees;
  * patches: the same zero pattern (the in-image test) and NaN pattern,
    values within PATCH_TOL = 0.02 (a 0-255 intensity scale): the inverse
    warp's entries differ by a few float32 ulps between LU orders
    (float32 LAPACK, XLA, the kernels' float64), which moves a sample point
    at up to ~40 px of offset by ~1e-5 px, times the image gradient (<= 60
    per px here);
  * the per-row loop against the batched loop: bit for bit.
Run with `-s` to see how many rows and values differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k5_align
from sdv_loam_tpu.ops import align as jalign
from sdv_loam_tpu_torch.eval import kernel_timing as kt
from sdv_loam_tpu_torch.ops import hopper_kernels as hk
from sdv_loam_tpu_torch.utils import device_loop as dl

H_IMG, W_IMG, ROWS, LANES, LEVELS = 96, 320, 96, 2, 3
FLAG_SHARE = 0.999
PX_TOL = 0.01
PATCH_TOL = 0.02
SEEDS = (3, 11)


def _align_scene(seed):
    return kt.align_scene(seed, H_IMG, W_IMG, ROWS, LANES, levels=LEVELS,
                          poison=True)


def _warp_scene(seed):
    return kt.warp_scene(seed, H_IMG, W_IMG, ROWS, LANES, poison=True)


def _plain_align(sc, n_lanes=0):
    return hk.align_batch_plain(*kt.align_args(sc, "cpu"), n_lanes=n_lanes)


def _hold_align(what, got, ref, valid):
    """Flags, px and failure masks of two alignments under the module's
    tolerances; prints how many rows differ. got/ref: (px, conv, fails
    masks (M, 2)) as numpy."""
    px_g, c_g, f_g = got
    px_r, c_r, f_r = ref
    agree = c_g == c_r
    both = c_g & c_r
    d = np.abs(px_g - px_r)[both]
    print(f"{what}: {int((~agree).sum())} of {agree.size} flags differ "
          f"({int(valid.sum())} valid, {int(c_r.sum())} converged), px "
          f"largest difference {float(d.max()) if d.size else 0.0} px over "
          f"{int(both.sum())} rows, failure masks differ on "
          f"{int((f_g != f_r).any(-1)[agree].sum())} agreeing rows")
    assert (~agree).sum() <= 1 + (1 - FLAG_SHARE) * agree.size, agree.mean()
    assert d.size == 0 or d.max() <= PX_TOL, d.max()
    assert np.array_equal(f_g[agree], f_r[agree])


def _masks(px, conv, sc):
    """Failure masks of a (px, conv) result that reports only counts: the
    rows still in the level's bounds at px are out of iterations (the
    JAX package's split)."""
    valid = sc["valid"]
    lvl = sc["search_level"]
    u, v = np.floor(px[:, 0]), np.floor(px[:, 1])
    inb = ((u >= 4) & (v >= 4) & (u < sc["widths"][lvl] - 4)
           & (v < sc["heights"][lvl] - 4))
    return np.stack([valid & ~conv & ~inb, valid & ~conv & inb], -1)


@pytest.mark.parametrize("seed", SEEDS)
def test_plain_align_matches_jax(seed):
    """align_batch_plain against the JAX package's align_batch: flags,
    px, and the failure counts (the plain's per-lane counts summed)."""
    sc = _align_scene(seed)
    jargs = [jnp.asarray(sc[k].astype(np.int32) if sc[k].dtype == np.int64
                         else sc[k]) for k in kt.ALIGN_ARGS]
    jpx, jconv, jfails = jalign.align_batch(*jargs, n_iter=10)
    px, conv, fails = _plain_align(sc, n_lanes=LANES)
    jpx, jconv = np.asarray(jpx), np.asarray(jconv)
    _hold_align(f"plain vs JAX, seed {seed}",
                (px.numpy(), conv.numpy(), _masks(px.numpy(),
                                                  conv.numpy(), sc)),
                (jpx, jconv, _masks(jpx, jconv, sc)), sc["valid"])
    assert fails.shape == (LANES, 2)
    assert abs(int(fails.sum()) - int(np.asarray(jfails).sum())) <= \
        (1 - FLAG_SHARE) * sc["valid"].size
    # the poisoned rows: the NaN start and the NaN patch walk out
    assert not conv[:2].any() and np.isnan(px[0].numpy()).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_plain_warp_matches_jax(seed):
    """warp_affine_patches_plain against the JAX package's
    warp_affine_patches (rows whose host slot lies in the stack), and the
    row past the stack reads NaN inside the image."""
    sc = _warp_scene(seed)
    args, kw = kt.warp_args(sc, "cpu")
    got = hk.warp_affine_patches_plain(*args, **kw).numpy()
    assert np.array_equal(got, hk.warp_affine_patches_plain(*args).numpy(),
                          equal_nan=True)
    keep = sc["host_idx"] < sc["stack"].shape[0]
    ref = np.asarray(jalign.warp_affine_patches(
        jnp.asarray(sc["stack"]), jnp.asarray(sc["host_idx"][keep],
                                              jnp.int32),
        jnp.asarray(sc["px_ref"][keep]), jnp.asarray(sc["A_cur_ref"][keep]),
        jnp.asarray(sc["search_level"][keep], jnp.int32)))
    _hold_patches(f"plain vs JAX, seed {seed}", got[keep], ref)
    bad = got[~keep]
    assert np.isnan(bad[bad != 0]).all() and np.isnan(bad).any()


def _hold_patches(what, got, ref):
    zero_g, zero_r = got == 0, ref == 0
    nan_g, nan_r = np.isnan(got), np.isnan(ref)
    d = np.abs(got - ref)[~(nan_g | nan_r)]
    print(f"{what}: {int((d > 0).sum())} of {d.size} values differ, "
          f"largest {float(d.max())}, zero pattern equal "
          f"{np.array_equal(zero_g, zero_r)}")
    assert np.array_equal(zero_g, zero_r) and np.array_equal(nan_g, nan_r)
    assert d.max() <= PATCH_TOL, d.max()


def _row(d, i):
    return {k: (v[i:i + 1] if isinstance(v, torch.Tensor) and v.dim()
                and k != "quad_pyr" else v) for k, v in d.items()}


@pytest.mark.parametrize("seed", SEEDS)
def test_rows_alone_equal_the_batched_loop(seed):
    """Each row's loop run alone to its own stop (the plain body on that
    row only, until it stops or runs n_iter iterations) gives the batched
    loop's outputs bit for bit: the whole-loop kernel's per-row early exit
    is the batched loop."""
    sc = _align_scene(seed)
    args = kt.align_args(sc, "cpu")
    x, st = hk.align_setup(*args)
    with dl.reference():
        batched = dl.run("align", hk.align_body, x, st, 10)
    iters = []
    for i in range(sc["valid"].size):
        xi, si = _row(x, i), _row(st, i)
        n = 0
        while n < 10 and bool((si["alive"] & xi["valid"] & ~si["conv"])
                              .any()):
            si, _ = hk.align_body(xi, si)
            n += 1
        iters.append(n)
        for k in si:
            assert dl.same_bits(si[k], batched[k][i:i + 1]), (i, k)
    print(f"seed {seed}: rows alone ran {sum(iters)} iterations in all, "
          f"at most {max(iters)}; the batched loop runs every row to the "
          "last row's stop")
    assert max(iters) >= 3 and min(iters) == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_k5_emulation_against_plain(seed):
    """K5's arithmetic (float64 sums in its warp order, the float64 LU
    inverse) against align_batch_plain, under the module's tolerances."""
    sc = _align_scene(seed)
    args = kt.align_args(sc, "cpu")
    px, conv, fails = k5_align.align_batch(*args)
    ppx, pconv, pfails = _plain_align(sc, n_lanes=LANES)
    x, st = hk.align_setup(*args)
    out = dl.run("align", hk.align_body, x, st, 10)
    pmasks = torch.stack([x["valid"] & ~out["conv"] & ~out["alive"],
                          x["valid"] & ~out["conv"] & out["alive"]], -1)
    _hold_align(f"K5 emulation vs plain, seed {seed}",
                (px.numpy(), conv.numpy(), fails.numpy()),
                (ppx.numpy(), pconv.numpy(), pmasks.numpy()), sc["valid"])
    assert torch.equal(hk._lane_fails(pmasks, LANES), pfails)
    # the setup's inverse against inv_ex: H's float64 sums and LU move each
    # entry by a few float32 ulps of the row's largest
    J, _, Hinv = k5_align.setup(*(args[i] for i in (5, 7, 8, 9, 10)))
    rel = ((Hinv - x["Hinv"]).abs().amax((1, 2))
           / x["Hinv"].abs().amax((1, 2)).clamp(min=1e-30))
    print(f"seed {seed}: Hinv largest relative difference {float(rel.max())}")
    assert float(rel.max()) <= 1e-4


@pytest.mark.parametrize("seed", SEEDS)
def test_k6_emulation_against_plain(seed):
    """K6's arithmetic (the float64 LU inverse, then float32) against
    warp_affine_patches_plain, under the module's tolerances; the NaN and
    the singular warp give zero inverses in both."""
    sc = _warp_scene(seed)
    args, kw = kt.warp_args(sc, "cpu")
    got = k5_align.warp_patches(kw["quad_stack"], args[1], args[2], args[3],
                                args[4], H_IMG, W_IMG)
    ref = hk.warp_affine_patches_plain(*args, **kw)
    _hold_patches(f"K6 emulation vs plain, seed {seed}", got.numpy(),
                  ref.numpy())
    inv = k5_align.inverse_lu(args[3])
    plain = torch.linalg.inv_ex(args[3])[0]
    plain = torch.where(torch.isfinite(plain), plain, torch.zeros_like(plain))
    assert not inv[:2].any() and not plain[:2].any()
    rel = (inv - plain).abs().amax((1, 2)) / \
        plain.abs().amax((1, 2)).clamp(min=1e-30)
    print(f"seed {seed}: Ainv largest relative difference {float(rel.max())}")
    assert float(rel.max()) <= 1e-6


def _fused_scene(seed, cases=False):
    sc = kt.warp_align_scene(seed, H_IMG, W_IMG, ROWS, LANES, levels=LEVELS,
                             poison=True)
    return kt.edge_cases(sc, seed, levels=LEVELS) if cases else sc


def _jax_args(sc, keys):
    return [jnp.asarray(sc[k].astype(np.int32) if sc[k].dtype == np.int64
                        else sc[k]) for k in keys]


@pytest.mark.parametrize("seed", SEEDS)
def test_fused_plain_matches_jax(seed):
    """warp_align_plain (the fused call's plain version) is bit for bit
    warp_affine_patches_plain then align_batch_plain, and agrees with the
    JAX package's warp_affine_patches then align_batch under the module's
    tolerances (the JAX warp on the rows whose host slot lies in the
    stack; the row past it keeps the plain version's NaN patch)."""
    sc = _fused_scene(seed)
    args, kw = kt.warp_align_args(sc, "cpu")
    got = hk.warp_align_plain(*args, n_lanes=LANES, **kw)
    (wargs, wkw), align_args = kt.split_warp_align(args, kw)
    patches = hk.warp_affine_patches_plain(*wargs, **wkw)
    two = hk.align_batch_plain(*align_args(patches), n_lanes=LANES)
    assert all(dl.same_bits(a, b) for a, b in zip(got, two))
    assert torch.equal(got[2], hk.warp_align(*args, n_lanes=LANES, **kw)[2])
    keep = sc["host_idx"] < sc["stack"].shape[0]
    jp = np.array(patches.numpy())
    jp[keep] = np.asarray(jalign.warp_affine_patches(
        *_jax_args({k: v[keep] if k != "stack" else v for k, v in sc.items()
                    if k in ("stack", "host_idx", "px_ref", "A_cur_ref",
                             "warp_level")},
                   ("stack", "host_idx", "px_ref", "A_cur_ref",
                    "warp_level"))))
    _hold_patches(f"fused plain's patches vs JAX, seed {seed}",
                  patches.numpy()[keep], jp[keep])
    jargs = _jax_args(dict(sc, border_patch=jp), kt.ALIGN_ARGS)
    jpx, jconv, jfails = jalign.align_batch(*jargs, n_iter=10)
    jpx, jconv = np.asarray(jpx), np.asarray(jconv)
    px, conv = got[0].numpy(), got[1].numpy()
    _hold_align(f"fused plain vs JAX, seed {seed}",
                (px, conv, _masks(px, conv, sc)),
                (jpx, jconv, _masks(jpx, jconv, sc)), sc["valid"])
    assert abs(int(got[2].sum()) - int(np.asarray(jfails).sum())) <= \
        1 + (1 - FLAG_SHARE) * sc["valid"].size
    # the poisoned rows: the NaN start and the NaN patch do not converge
    assert not conv[:2].any() and np.isnan(px[0]).all()


@pytest.mark.parametrize("n_iter", [1, 10])
@pytest.mark.parametrize("seed", SEEDS)
def test_k5_emulation_on_edge_cases(seed, n_iter):
    """K5's arithmetic against align_batch_plain, under the module's
    tolerances, on `kernel_timing.edge_cases`' rows: rows that start at a
    level's right and bottom edges (their samples clamp there, or they
    walk out of the level), rows that start 5-7 px from their true point
    and walk far, and rows on a level the pack cuts short (their samples
    read NaN); after one iteration (each row's samples at its start) and
    at the cap of 10."""
    sc = kt.edge_cases(_align_scene(seed), seed, levels=LEVELS)
    args = kt.align_args(sc, "cpu")
    px, conv, masks = k5_align.align_batch(*args, n_iter=n_iter)
    x, st = hk.align_setup(*args)
    out = dl.run("align", hk.align_body, x, st, n_iter)
    pmasks = torch.stack([x["valid"] & ~out["conv"] & ~out["alive"],
                          x["valid"] & ~out["conv"] & out["alive"]], -1)
    ppx = torch.stack([out["u"], out["v"]], -1)
    _hold_align(f"K5 emulation vs plain on the edge cases, seed {seed}, "
                f"n_iter {n_iter}", (px.numpy(), conv.numpy(),
                                     masks.numpy()),
                (ppx.numpy(), (out["conv"] & x["valid"]).numpy(),
                 pmasks.numpy()), sc["valid"])
    assert torch.equal(hk._lane_fails(pmasks, LANES), hk.align_batch_plain(
        *args, n_iter=n_iter, n_lanes=LANES)[2])
    cut = (args[4] == args[1].numel() - 1) & args[11]
    moved = (px - args[6]).abs().amax(-1)
    far = moved[20:30][conv[20:30]]
    nan_px = torch.isnan(px).any(-1)
    print(f"seed {seed}, n_iter {n_iter}: edge rows walked out "
          f"{int(masks[10:20, 0].sum())} of 10, far rows converged "
          f"{far.numel()} of 10 (moved up to "
          f"{float(far.max()) if far.numel() else 0.0} px), cut-level rows "
          f"with a NaN px {int(nan_px[cut].sum())} of {int(cut.sum())}")
    assert bool(nan_px[cut].any())
    assert torch.equal(nan_px, torch.isnan(ppx).any(-1))
    if n_iter == 1:
        # no row converges in one step here: every row's first step
        d = (px - ppx).abs()[~nan_px]
        assert float(d.max()) <= PX_TOL, float(d.max())
    else:
        assert bool(masks[10:20, 0].any()) and float(far.max()) >= 4.0


@pytest.mark.parametrize("seed", SEEDS)
def test_fused_emulation_against_plain(seed):
    """The fused kernel's arithmetic (K6's patches, then K5 on them)
    against warp_align_plain, under the module's tolerances, on the edge
    cases too."""
    sc = _fused_scene(seed, cases=True)
    args, kw = kt.warp_align_args(sc, "cpu")
    h, w = args[0].shape[1:3]
    got = k5_align.warp_align(kw["quad_stack"], *args[1:5], h, w,
                              *args[5:])
    ref = hk.warp_align_plain(*args, **kw)
    (wargs, wkw), align_args = kt.split_warp_align(args, kw)
    x, st = hk.align_setup(*align_args(hk.warp_affine_patches_plain(
        *wargs, **wkw)))
    out = dl.run("align", hk.align_body, x, st, 10)
    masks = torch.stack([x["valid"] & ~out["conv"] & ~out["alive"],
                         x["valid"] & ~out["conv"] & out["alive"]], -1)
    _hold_align(f"fused emulation vs plain, seed {seed}",
                (got[0].numpy(), got[1].numpy(), got[2].numpy()),
                (ref[0].numpy(), ref[1].numpy(), masks.numpy()), sc["valid"])
    assert torch.equal(hk._lane_fails(masks, 0), ref[2])
