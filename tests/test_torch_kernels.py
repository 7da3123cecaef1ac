"""Parity of the port's Hopper kernels' plain versions with the TPU kernels.

`dilate_depth_plain` / `dilate_pyramid_plain` / `distance_transform_plain`
(sdv_loam_tpu_torch/ops/hopper_kernels.py) against the Pallas kernel
bodies of sdv_loam_tpu/ops/pallas_kernels.py run in interpret mode on the
CPU, and against the JAX package's jnp paths; the lane dimension against
single calls; and a torch emulation of the K2 kernel's separable sweep and
tiling against the plain version; the build's ptxas report, kept beside
the library and read back when the library is found built (with nvcc
stood in for by a script). The CUDA kernels themselves are compared with
the plain versions on the card in tests/test_torch_cuda.py.
"""

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from sdv_loam_tpu.ops.distmap import _relax_jnp
from sdv_loam_tpu.ops.pallas_kernels import _dilate_kernel, _distmap_kernel
from sdv_loam_tpu.ops.photometric import _dilate_once
from sdv_loam_tpu.ops.photometric import _sum_pool2 as _jnp_sum_pool2
from sdv_loam_tpu_torch.ops import hopper_kernels as hk

SHAPES = [(24, 40), (45, 70), (37, 91), (90, 300)]


def _splat(h, w, seed, frac=0.05):
    rng = np.random.default_rng(seed)
    wt = np.zeros((h, w), np.float32)
    idp = np.zeros((h, w), np.float32)
    m = rng.random((h, w)) < frac
    wt[m] = rng.uniform(1.0, 300.0, m.sum()).astype(np.float32)
    idp[m] = wt[m] * rng.uniform(0.01, 0.5, m.sum()).astype(np.float32)
    return idp, wt


def _seeds(h, w, seed, n=60):
    rng = np.random.default_rng(seed)
    s = np.full((h, w), 1000.0, np.float32)
    s.reshape(-1)[rng.choice(h * w, n, replace=False)] = 0.0
    return s


def _pallas_dilate(idp, wt, diagonal):
    shape = jax.ShapeDtypeStruct(idp.shape, jnp.float32)
    oi, ow = pl.pallas_call(partial(_dilate_kernel, diagonal=diagonal),
                            out_shape=(shape, shape), interpret=True)(
        jnp.asarray(idp), jnp.asarray(wt))
    return np.asarray(oi), np.asarray(ow)


def _pallas_distmap(seed, iters=32):
    return np.asarray(pl.pallas_call(
        partial(_distmap_kernel, iters=iters),
        out_shape=jax.ShapeDtypeStruct(seed.shape, jnp.float32),
        interpret=True)(jnp.asarray(seed)))


@pytest.mark.parametrize("diagonal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_dilate_plain_matches_pallas_kernel(shape, diagonal):
    idp, wt = _splat(*shape, seed=shape[0] + shape[1])
    ki, kw = _pallas_dilate(idp, wt, diagonal)
    pi, pw = hk.dilate_depth_plain(torch.from_numpy(idp),
                                   torch.from_numpy(wt), diagonal)
    # bit-exact, border included: same neighbour order and zero fill
    np.testing.assert_array_equal(pi.numpy(), ki)
    np.testing.assert_array_equal(pw.numpy(), kw)


@pytest.mark.parametrize("diagonal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_dilate_plain_matches_jnp_interior(shape, diagonal):
    idp, wt = _splat(*shape, seed=7 * shape[0] + shape[1])
    ji, jw = (np.asarray(a) for a in _dilate_once(
        jnp.asarray(idp), jnp.asarray(wt), diagonal))
    pi, pw = hk.dilate_depth_plain(torch.from_numpy(idp),
                                   torch.from_numpy(wt), diagonal)
    sl = (slice(1, -1), slice(1, -1))   # the jnp path wraps at the border
    if diagonal:
        # the diagonal pass sums in the same order: exact
        np.testing.assert_array_equal(pi.numpy()[sl], ji[sl])
        np.testing.assert_array_equal(pw.numpy()[sl], jw[sl])
    else:
        # the cross pass sums (r, l, d, u) vs the jnp path's (l, r, u, d)
        # order: float32 reassociation, <= 1e-6 relative
        np.testing.assert_allclose(pi.numpy()[sl], ji[sl], rtol=1e-6)
        np.testing.assert_allclose(pw.numpy()[sl], jw[sl], rtol=1e-6)


@pytest.mark.parametrize("shape", SHAPES + [(160, 212)])
def test_distance_transform_plain_matches_pallas_and_jnp(shape):
    seed = _seeds(*shape, seed=shape[1])
    ref_k = _pallas_distmap(seed)
    ref_j = np.asarray(_relax_jnp(jnp.asarray(seed), 32))
    out = hk.distance_transform_plain(torch.from_numpy(seed), 32).numpy()
    # exact: min-plus over small integers
    np.testing.assert_array_equal(out, ref_k)
    np.testing.assert_array_equal(out, ref_j)


@pytest.mark.parametrize("iters", [0, 1, 40, 64])
def test_distance_transform_plain_matches_pallas_any_iters(iters):
    """K2 takes any number of sweeps, as distance_transform_pallas does."""
    seed = _seeds(45, 70, seed=iters + 3, n=1)
    out = hk.distance_transform_plain(torch.from_numpy(seed), iters).numpy()
    np.testing.assert_array_equal(out, _pallas_distmap(seed, iters))
    # one seed: cells more than 32 away from it need the later sweeps
    if iters == 64:
        assert not np.array_equal(out, _pallas_distmap(seed, 32))


def _np_sum_pool2(x):
    """The port's pool order, (x00 + x01) + (x10 + x11), in numpy."""
    h, w = x.shape
    x = x[: (h // 2) * 2, : (w // 2) * 2]
    return (x[0::2, 0::2] + x[0::2, 1::2]) + (x[1::2, 0::2] + x[1::2, 1::2])


PYRAMID_SHAPES = [(45, 70), (90, 300), (320, 424)]


@pytest.mark.parametrize("shape", PYRAMID_SHAPES)
def test_dilate_pyramid_plain_matches_pallas_chain(shape):
    """Four levels of build_track_ref's chain: bit for bit the TPU kernel
    in interpret mode with the port's pool order between the levels."""
    idp, wt = _splat(*shape, seed=shape[0] * 3 + shape[1])
    got = hk.dilate_pyramid_plain(torch.from_numpy(idp),
                                  torch.from_numpy(wt), 4)
    assert len(got) == 4
    ki, kw = idp, wt
    for lvl, (pi, pw) in enumerate(got):
        if lvl > 0:
            ki, kw = _np_sum_pool2(ki), _np_sum_pool2(kw)
        ki, kw = _pallas_dilate(ki, kw, diagonal=lvl < 2)
        assert pi.shape == ki.shape
        np.testing.assert_array_equal(pi.numpy(), ki)
        np.testing.assert_array_equal(pw.numpy(), kw)


@pytest.mark.parametrize("shape", PYRAMID_SHAPES)
def test_dilate_pyramid_plain_matches_jnp_chain_interior(shape):
    """The JAX package's own chain (jnp `_dilate_once`, XLA's pool): equal
    on the interior to float32 reassociation (its cross pass sums l, r, u,
    d; the port r, l, d, u). Its border differs by design: the jnp pass
    wraps around, the kernel zero-fills."""
    idp, wt = _splat(*shape, seed=shape[0] + 5 * shape[1])
    got = hk.dilate_pyramid_plain(torch.from_numpy(idp),
                                  torch.from_numpy(wt), 4)
    ji, jw = jnp.asarray(idp), jnp.asarray(wt)
    for lvl, (pi, pw) in enumerate(got):
        if lvl > 0:
            ji, jw = _jnp_sum_pool2(ji), _jnp_sum_pool2(jw)
        ji, jw = _dilate_once(ji, jw, lvl < 2)
        sl = (slice(2, -2), slice(2, -2))
        np.testing.assert_allclose(pi.numpy()[sl], np.asarray(ji)[sl],
                                   rtol=1e-6)
        np.testing.assert_allclose(pw.numpy()[sl], np.asarray(jw)[sl],
                                   rtol=1e-6)


def test_plain_versions_take_lanes():
    """(L, H, W) equals L single calls, for both plain versions."""
    maps = [_splat(45, 70, seed=s) for s in range(3)]
    idp = torch.from_numpy(np.stack([m[0] for m in maps]))
    wt = torch.from_numpy(np.stack([m[1] for m in maps]))
    stacked = hk.dilate_pyramid_plain(idp, wt, 4)
    for b in range(3):
        single = hk.dilate_pyramid_plain(idp[b], wt[b], 4)
        for (si, sw), (li, lw) in zip(single, stacked):
            assert torch.equal(si, li[b]) and torch.equal(sw, lw[b])
    seeds = torch.from_numpy(np.stack([_seeds(37, 91, s) for s in range(3)]))
    lanes = hk.distance_transform_plain(seeds, 40)
    for b in range(3):
        assert torch.equal(lanes[b], hk.distance_transform_plain(seeds[b], 40))


def _float_map(h, w, seed):
    """Non-integer values, large values and +inf, not only 0/1000."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.0, 50.0, (h, w)).astype(np.float32)
    d[rng.random((h, w)) < 0.05] = 3.0e38
    d[rng.random((h, w)) < 0.05] = np.inf
    d[rng.random((h, w)) < 0.02] = rng.uniform(-5.0, -1.0)
    return d


def _separable_sweep(d, pinned):
    """One sweep as csrc/distance_transform.cu computes it: min(d, fl(M + 1))
    with M the 3x3 minimum, centre included (along the row, then along the
    column); `pinned` cells keep their value; a missing neighbour at the
    map's edge is the cell itself."""
    p = torch.nn.functional.pad(d[None], (1, 1, 1, 1), mode="replicate")[0]
    row = torch.minimum(torch.minimum(p[:, :-2], p[:, 1:-1]), p[:, 2:])
    m = torch.minimum(torch.minimum(row[:-2], row[1:-1]), row[2:])
    return torch.where(pinned, d, torch.minimum(d, m + 1.0))


def _emulate_k2(seed, iters, tile, halo=16):
    """The kernel's blocking in torch: per tile, its region with a `halo`
    band (1000 outside the image, pinned), `halo` sweeps per chunk, the
    tile written back; each chunk starts from the previous one's output."""
    h, w = seed.shape
    src = seed
    for c in range(0, iters, halo):
        n = min(halo, iters - c)
        big = torch.full((h + 2 * halo, w + 2 * halo), 1000.0)
        big[halo:halo + h, halo:halo + w] = src
        inside = torch.zeros_like(big, dtype=torch.bool)
        inside[halo:halo + h, halo:halo + w] = True
        dst = torch.empty_like(src)
        for y0 in range(0, h, tile):
            for x0 in range(0, w, tile):
                reg = big[y0:y0 + tile + 2 * halo, x0:x0 + tile + 2 * halo]
                pin = ~inside[y0:y0 + tile + 2 * halo,
                              x0:x0 + tile + 2 * halo]
                for _ in range(n):
                    reg = _separable_sweep(reg, pin)
                th, tw = min(tile, h - y0), min(tile, w - x0)
                dst[y0:y0 + th, x0:x0 + tw] = reg[halo:halo + th,
                                                  halo:halo + tw]
        src = dst
    return src


@pytest.mark.parametrize("shape,iters", [((37, 91), 32), ((70, 45), 40)])
def test_separable_sweep_identity(shape, iters):
    """min(d, min_nb(d_nb + 1)) == min(d, fl(M3x3(d) + 1)) bit for bit on
    random float maps, and the kernel's tiling with a 16-cell halo and
    chunks of 16 sweeps gives the plain version's result."""
    d = torch.from_numpy(_float_map(*shape, seed=shape[1]))
    pad = torch.nn.functional.pad(d[None], (1, 1, 1, 1), value=1000.0)[0]
    inside = torch.zeros_like(pad, dtype=torch.bool)
    inside[1:-1, 1:-1] = True
    p = pad
    for _ in range(iters):
        p = _separable_sweep(p, ~inside)
    ref = hk.distance_transform_plain(d, iters)
    assert torch.equal(p[1:-1, 1:-1], ref)
    # 1-sweep identity on its own (the loop above could hide a compensation)
    assert torch.equal(_separable_sweep(pad, ~inside)[1:-1, 1:-1],
                       hk.distance_transform_plain(d, 1))
    for tile in (32, 64):
        assert torch.equal(_emulate_k2(d, iters, tile), ref)


def test_wrappers_take_plain_path_on_cpu_and_count_no_launch():
    idp, wt = _splat(24, 40, seed=3)
    hk.reset_launch_counts()
    got = hk.dilate_pyramid(torch.from_numpy(idp), torch.from_numpy(wt), 3)
    ref = hk.dilate_pyramid_plain(torch.from_numpy(idp),
                                  torch.from_numpy(wt), 3)
    assert all(torch.equal(a, b) for (ga, gb), (ra, rb) in zip(got, ref)
               for a, b in ((ga, ra), (gb, rb)))
    d = hk.distance_transform(torch.from_numpy(_seeds(24, 40, 1)), 40)
    assert torch.equal(d, hk.distance_transform_plain(
        torch.from_numpy(_seeds(24, 40, 1)), 40))
    assert hk.LAUNCHES == {"dilate_pyramid": 0, "distance_transform": 0}


def test_wrappers_reject_bad_inputs():
    x = torch.zeros((8, 8), dtype=torch.float64)
    with pytest.raises(TypeError):
        hk.dilate_pyramid(x, x, 4)
    y = torch.zeros((8, 16))[:, ::2]
    with pytest.raises(ValueError):
        hk.distance_transform(y, 32)
    z = torch.zeros((8, 8))
    with pytest.raises(ValueError):
        hk.dilate_pyramid(z, z, 0)
    with pytest.raises(ValueError):
        hk.distance_transform(z, -1)
    with pytest.raises(ValueError):
        hk.distance_transform(torch.zeros((2, 2, 8, 8)), 32)


_FAKE_NVCC = r"""#!/bin/sh
# stands in for nvcc: writes the -o file, prints a ptxas -v report,
# counts its calls
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
echo x > "$out"
echo run >> "$(dirname "$0")/calls"
cat >&2 <<'REPORT'
ptxas info    : Compiling entry function '_Z19track_res_gs_kernel' for 'sm_90a'
ptxas info    : Function properties for _Z19track_res_gs_kernel
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, 48404 bytes smem, 400 bytes cmem[0]
REPORT
"""


def test_build_keeps_the_ptxas_report_beside_the_library(monkeypatch,
                                                         tmp_path):
    """The compiler's report is written beside the library and read back
    when the library is found built, without compiling again."""
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    (bindir / "nvcc").write_text(_FAKE_NVCC)
    (bindir / "nvcc").chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(hk, "BUILD_DIR", str(tmp_path / "build"))
    assert "-Xptxas=-v" in hk.NVCC_FLAGS
    path = hk.build_library()
    assert hk.build_library() == path
    assert (bindir / "calls").read_text().count("run") == 1
    usage = hk.ptxas_usage(hk.build_report())
    assert usage == {"_Z19track_res_gs_kernel": {
        "stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 72,
        "smem": 48404}}
    assert hk.build_report(path) == hk.build_report()
    assert sorted(os.listdir(tmp_path / "build")) == sorted(
        [os.path.basename(path),
         os.path.basename(path)[:-3] + ".ptxas.txt"])
