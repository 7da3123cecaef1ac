"""Parity of the port's Hopper kernels' plain versions with the TPU kernels.

`dilate_depth_plain` / `distance_transform_plain` (sdv_loam_tpu_torch/ops/
hopper_kernels.py) against the Pallas kernel bodies of
sdv_loam_tpu/ops/pallas_kernels.py run in interpret mode on the CPU, and
against the JAX package's jnp paths. The CUDA kernels themselves are
compared with the plain versions on the card in tests/test_torch_cuda.py.
"""

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


def test_wrappers_take_plain_path_on_cpu_and_count_no_launch():
    idp, wt = _splat(24, 40, seed=3)
    hk.reset_launch_counts()
    oi, ow = hk.dilate_depth(torch.from_numpy(idp), torch.from_numpy(wt),
                             True)
    pi, pw = hk.dilate_depth_plain(torch.from_numpy(idp),
                                   torch.from_numpy(wt), True)
    assert torch.equal(oi, pi) and torch.equal(ow, pw)
    d = hk.distance_transform(torch.from_numpy(_seeds(24, 40, 1)), 32)
    assert torch.equal(d, hk.distance_transform_plain(
        torch.from_numpy(_seeds(24, 40, 1)), 32))
    assert hk.LAUNCHES == {"dilate_depth": 0, "distance_transform": 0}


def test_wrappers_reject_bad_inputs():
    x = torch.zeros((8, 8), dtype=torch.float64)
    with pytest.raises(TypeError):
        hk.dilate_depth(x, x, True)
    y = torch.zeros((8, 16))[:, ::2]
    with pytest.raises(ValueError):
        hk.distance_transform(y, 32)
