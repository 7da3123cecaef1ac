"""Parity of the port's photometric tracker with the JAX package.

splat_idepth, build_track_ref (through the K1 plain version on the CPU) and
track_pyramid on the inputs of `__graft_entry__.entry` (256x128,
3 levels), inputs made from a seed with numpy and cast to float32 on both
sides.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import __graft_entry__
from sdv_loam_tpu.ops import photometric as jph
from sdv_loam_tpu.ops.pallas_kernels import _dilate_kernel
from sdv_loam_tpu.ops.pyramid import make_images as j_make_images
from sdv_loam_tpu.utils import se3 as jse3
from sdv_loam_tpu_torch.ops import photometric as tph
from sdv_loam_tpu_torch.ops.pyramid import make_images as t_make_images
from sdv_loam_tpu_torch.utils import se3 as tse3


def _entry_inputs():
    """The exact inputs __graft_entry__.entry() builds (same seed/order)."""
    w, h, levels = 256, 128, 3
    rng = np.random.default_rng(0)
    img = (rng.random((h, w)).astype(np.float32) * 255)
    n = 512
    us = rng.integers(8, w - 8, n)
    vs = rng.integers(8, h - 8, n)
    idp = (1.0 / rng.uniform(5, 40, n)).astype(np.float32)
    return w, h, levels, img, us, vs, idp


def _scene(h, w, seed, n):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = (128 + 60 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
           + 20 * rng.standard_normal((h, w))).astype(np.float32)
    u = rng.integers(0, w, n)
    v = rng.integers(0, h, n)
    u[: n // 4] = u[n // 4: n // 2]      # duplicated cells: multi-point sums
    v[: n // 4] = v[n // 4: n // 2]
    idp = rng.uniform(0.02, 0.5, n).astype(np.float32)
    wt = rng.uniform(1.0, 300.0, n).astype(np.float32)
    valid = rng.random(n) < 0.9
    return img, u, v, idp, wt, valid


@pytest.mark.parametrize("shape", [(96, 320), (128, 256)])
def test_make_images_matches(shape):
    h, w = shape
    img, *_ = _scene(h, w, seed=3, n=1)
    jdI, jag = j_make_images(jnp.asarray(img), 3)
    tdI, tag = t_make_images(torch.from_numpy(img), 3)
    # 2x2 means differ by an ulp where XLA's fusion-dependent sum order
    # differs; central differences of them by ~1e-4 absolute, and their
    # squares (abs_grad) by <= 2e-5 relative
    for a, b in zip(jdI, tdI):
        np.testing.assert_allclose(b.numpy(), np.asarray(a, np.float32),
                                   rtol=1e-6, atol=1e-4)
    for a, b in zip(jag, tag):
        np.testing.assert_allclose(b.numpy(), np.asarray(a, np.float32),
                                   rtol=2e-5, atol=1e-3)


@pytest.mark.parametrize("shape", [(96, 320), (120, 160)])
def test_splat_idepth_matches(shape):
    h, w = shape
    _, u, v, idp, wt, valid = _scene(h, w, seed=1, n=3000)
    ji, jw = jph.splat_idepth(jnp.asarray(u), jnp.asarray(v),
                              jnp.asarray(idp), jnp.asarray(wt),
                              jnp.asarray(valid), w, h)
    ti, tw = tph.splat_idepth(torch.from_numpy(u), torch.from_numpy(v),
                              torch.from_numpy(idp), torch.from_numpy(wt),
                              torch.from_numpy(valid), w, h)
    # exact: both accumulate serially in point order on the CPU
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji, np.float32))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw, np.float32))


def _pallas_dilate_once(idepth, weight, diagonal):
    """The TPU kernel body in interpret mode, as the JAX package's
    build_track_ref runs it on a TPU."""
    shape = jax.ShapeDtypeStruct(idepth.shape, jnp.float32)
    return pl.pallas_call(partial(_dilate_kernel, diagonal=diagonal),
                          out_shape=(shape, shape), interpret=True)(
        idepth.astype(jnp.float32), weight.astype(jnp.float32))


@pytest.mark.parametrize("dilation", ["pallas", "jnp"])
@pytest.mark.parametrize("shape,levels,cap", [
    ((96, 320), 3, (6144, 4096, 2048, 1024)),
    ((128, 256), 3, 256),          # overflow: stride subsampling
])
def test_build_track_ref_matches(shape, levels, cap, dilation, monkeypatch):
    h, w = shape
    img, u, v, idp, wt, valid = _scene(h, w, seed=2, n=2500)
    jdI, _ = j_make_images(jnp.asarray(img), levels)
    ji, jw = jph.splat_idepth(jnp.asarray(u), jnp.asarray(v),
                              jnp.asarray(idp), jnp.asarray(wt),
                              jnp.asarray(valid), w, h)
    jax.clear_caches()
    if dilation == "pallas":
        monkeypatch.setattr(jph, "_dilate_once", _pallas_dilate_once)
    jpools = jph.build_track_ref(jdI, ji, jw, levels, cap=cap)
    jax.clear_caches()
    # the same pyramid on both sides (the pyramid is compared on its own)
    tdI = tuple(torch.from_numpy(np.asarray(d, np.float32)) for d in jdI)
    ti, tw = tph.splat_idepth(torch.from_numpy(u), torch.from_numpy(v),
                              torch.from_numpy(idp), torch.from_numpy(wt),
                              torch.from_numpy(valid), w, h)
    tpools = tph.build_track_ref(tdI, ti, tw, levels, cap=cap)
    for jp, tp in zip(jpools, tpools):
        valid_j = np.asarray(jp["valid"])
        np.testing.assert_array_equal(tp["valid"].numpy(), valid_j)
        assert int(tp["n"]) == int(jp["n"])
        # valid lanes: u, v, color exact. idepth <= 1e-6 relative (a few
        # ulp): XLA sums the 2x2 pooling window in an order that depends on
        # its fusion of the program, and the jnp dilation sums the cross
        # pass (levels >= 2) in another order than the TPU kernel. Padding
        # lanes hold cell w*h-1, whose value depends on the border rule,
        # so they are masked out.
        for k in ("u", "v", "color"):
            np.testing.assert_array_equal(
                tp[k].numpy()[valid_j],
                np.asarray(jp[k], np.float32)[valid_j], err_msg=k)
        np.testing.assert_allclose(
            tp["idepth"].numpy()[valid_j],
            np.asarray(jp["idepth"], np.float32)[valid_j], rtol=1e-6)


def test_track_pyramid_entry_matches():
    w, h, levels, img, us, vs, idp = _entry_inputs()
    fn, (T0, aff0, _) = __graft_entry__.entry()
    # a perturbed start pose and a shifted image so the LM has work to do
    xi = np.array([0.01, -0.005, 0.02, 0.004, -0.003, 0.002], np.float32)
    T_init = np.array(jse3.se3_exp(jnp.asarray(xi)), np.float32)
    new_img = np.roll(img, 1, axis=1)
    T_j, res_j = fn(jnp.asarray(T_init), aff0, jnp.asarray(new_img))
    T_j = np.asarray(T_j, np.float64)

    tdI, _ = t_make_images(torch.from_numpy(img), levels)
    id0, w0 = tph.splat_idepth(torch.from_numpy(us), torch.from_numpy(vs),
                               torch.from_numpy(idp), torch.ones(512),
                               torch.ones(512, dtype=torch.bool), w, h)
    pools = tph.build_track_ref(tdI, id0, w0, levels, cap=1024)
    Ks = tuple(torch.tensor([0.6 * w / 2 ** l, 0.6 * w / 2 ** l,
                             ((w - 1) / 2 + 0.5) / 2 ** l - 0.5,
                             ((h - 1) / 2 + 0.5) / 2 ** l - 0.5])
               for l in range(levels))
    ndI, _ = t_make_images(torch.from_numpy(new_img), levels)
    out = tph.track_pyramid(pools, ndI, Ks, torch.from_numpy(T_init),
                            torch.zeros(2), torch.zeros(2), torch.ones(2),
                            torch.full((5,), float("inf")), 20.0, 6.0,
                            coarsest_lvl=levels - 1)
    T_t = out["T"].double().numpy()
    dT = np.linalg.inv(T_j) @ T_t
    rot = np.arccos(np.clip((np.trace(dT[:3, :3]) - 1) / 2, -1, 1))
    # float32 LM on different kernels: pose within 1e-4 (translation
    # units) and 1e-4 rad, per-level rmse within 1e-3 relative
    assert np.linalg.norm(dT[:3, 3]) < 1e-4, dT
    assert rot < 1e-4, rot
    res_j = np.asarray(res_j)
    ran = np.isfinite(res_j)
    np.testing.assert_allclose(out["res"].numpy()[ran], res_j[ran],
                               rtol=1e-3)


def test_se3_matches():
    rng = np.random.default_rng(4)
    xi = (rng.standard_normal((16, 6)) * 0.3).astype(np.float32)
    xi[0, 3:] = 0.0                       # small-angle branch
    Tj = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    Tt = tse3.se3_exp(torch.from_numpy(xi)).numpy()
    np.testing.assert_allclose(Tt, Tj, atol=1e-6)       # float32 Rodrigues
    np.testing.assert_allclose(
        tse3.se3_log(torch.from_numpy(Tt)).numpy(),
        np.asarray(jse3.se3_log(jnp.asarray(Tj))), atol=1e-5)
    np.testing.assert_allclose(
        tse3.adjoint(torch.from_numpy(Tt)).numpy(),
        np.asarray(jse3.adjoint(jnp.asarray(Tj))), atol=1e-6)
