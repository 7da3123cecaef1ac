"""The Hopper kernels against their plain PyTorch versions on the card.

Marked `cuda`: skipped without a GPU. On a GPU machine (`--noconftest`
skips tests/conftest.py, which sets up JAX; these tests need none):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from sdv_loam_tpu_torch.ops import hopper_kernels as hk


def _splat(h, w, seed, frac=0.04):
    rng = np.random.default_rng(seed)
    wt = np.zeros((h, w), np.float32)
    idp = np.zeros((h, w), np.float32)
    m = rng.random((h, w)) < frac
    wt[m] = rng.uniform(1.0, 300.0, m.sum()).astype(np.float32)
    idp[m] = wt[m] * rng.uniform(0.01, 0.5, m.sum()).astype(np.float32)
    return idp, wt


def _seeds(h, w, seed, n=200):
    rng = np.random.default_rng(seed)
    s = np.full((h, w), 1000.0, np.float32)
    s.reshape(-1)[rng.choice(h * w, n, replace=False)] = 0.0
    return s


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(360, 1200), (180, 600), (45, 70)])
def test_dilate_depth_kernel_matches_plain(cuda, shape):
    idp, wt = _splat(*shape, seed=11)
    ti, tw = torch.from_numpy(idp).to(cuda), torch.from_numpy(wt).to(cuda)
    before = hk.LAUNCHES["dilate_depth"]
    for diag in (True, False):
        ki, kw = hk.dilate_depth(ti, tw, diag)
        pi, pw = hk.dilate_depth_plain(ti, tw, diag)
        assert torch.equal(ki, pi) and torch.equal(kw, pw)   # exact
    assert hk.LAUNCHES["dilate_depth"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(180, 600), (160, 212), (37, 91)])
def test_distance_transform_kernel_matches_plain(cuda, shape):
    s = torch.from_numpy(_seeds(*shape, seed=5)).to(cuda)
    before = hk.LAUNCHES["distance_transform"]
    assert torch.equal(hk.distance_transform(s, 32),
                       hk.distance_transform_plain(s, 32))     # exact
    assert hk.LAUNCHES["distance_transform"] == before + 1


@pytest.mark.cuda
def test_kernel_wrappers_raise_on_bad_input(cuda):
    x = torch.zeros((8, 8), device=cuda)
    with pytest.raises(ValueError):
        hk.distance_transform(x, 33)            # beyond the kernel's halo
    with pytest.raises(ValueError):
        hk.dilate_depth(x, torch.zeros((8, 9), device=cuda), True)
