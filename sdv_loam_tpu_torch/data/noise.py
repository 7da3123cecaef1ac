"""Benchmark noise injection — the reference's fault-injection knobs.

Reference: Undistort::applyNoise / applyBlurNoise (Undistort.cpp:361-469)
driven by `benchmark_varNoise`, `benchmark_varBlurNoise`,
`benchmark_noiseGridsize` (settings.cpp:148-151).

The reference's applyNoise is GEOMETRIC: a smooth displacement field in
[-varNoise, +varNoise] px jitters the remap *sampling coordinates* (sub-pixel
warp of the undistortion lookup), not the intensities (Undistort.cpp:383-396).
`apply_photometric_noise` reproduces that as a bilinear resample of the
(already undistorted) image at smoothly displaced positions.

applyBlurNoise applies a separable variable-sigma gaussian whose sigma field
is varBlur * U(0,1) per smooth-grid node, with kernel support scaling with
sigma (Undistort.cpp:440-520); reproduced here by blending gaussian-filtered
variants over a sigma level table derived from var_blur.

Counterpart of `sdv_loam_tpu/data/noise.py` (a copy: numpy and
scipy.ndimage, the same outputs for the same seeds).
"""

from __future__ import annotations

import numpy as np


def _smooth_grid(rng, h, w, grid_size, lo, hi):
    """Random grid upsampled smoothly to (h, w) — the equivalent of the
    reference's getInterpolatedElement11BiCub over a (grid+8)^2 noise map."""
    g = rng.uniform(lo, hi, (grid_size + 2, grid_size + 2))
    ys = np.linspace(0, grid_size, h)
    xs = np.linspace(0, grid_size, w)
    y0 = np.clip(ys.astype(int), 0, grid_size)
    x0 = np.clip(xs.astype(int), 0, grid_size)
    ay = (ys - y0)[:, None]
    ax = (xs - x0)[None, :]
    out = (g[y0][:, x0] * (1 - ay) * (1 - ax)
           + g[y0][:, x0 + 1] * (1 - ay) * ax
           + g[y0 + 1][:, x0] * ay * (1 - ax)
           + g[y0 + 1][:, x0 + 1] * ay * ax)
    return out


def _bilinear(img, x, y):
    h, w = img.shape
    x = np.clip(x, 0.01, w - 1.01)
    y = np.clip(y, 0.01, h - 1.01)
    x0 = x.astype(np.int32)
    y0 = y.astype(np.int32)
    ax = x - x0
    ay = y - y0
    return (img[y0, x0] * (1 - ax) * (1 - ay)
            + img[y0, x0 + 1] * ax * (1 - ay)
            + img[y0 + 1, x0] * (1 - ax) * ay
            + img[y0 + 1, x0 + 1] * ax * ay)


def apply_photometric_noise(img: np.ndarray, var_noise: float,
                            grid_size: int = 3, seed: int = 0) -> np.ndarray:
    """Geometric sampling jitter (applyNoise, Undistort.cpp:383-396): displace
    each output pixel's sampling position by a smooth field in
    [-var_noise, var_noise] px and bilinearly resample."""
    if var_noise <= 0:
        return img
    rng = np.random.default_rng(seed)
    h, w = img.shape
    dx = _smooth_grid(rng, h, w, grid_size, -var_noise, var_noise)
    dy = _smooth_grid(rng, h, w, grid_size, -var_noise, var_noise)
    ys, xs = np.mgrid[0:h, 0:w]
    out = _bilinear(np.asarray(img, np.float32), xs + dx, ys + dy)
    return out.astype(np.float32)


def apply_blur_noise(img: np.ndarray, var_blur: float, grid_size: int = 3,
                     seed: int = 0) -> np.ndarray:
    """Spatially varying separable blur (applyBlurNoise semantics):
    per-pixel gaussian sigma from a smooth field in [0, var_blur]
    (sigma = varBlur * U(0,1) in the reference), x then y pass."""
    if var_blur <= 0:
        return img
    rng = np.random.default_rng(seed)
    h, w = img.shape
    sig_x = _smooth_grid(rng, h, w, grid_size, 0.0, var_blur)
    sig_y = _smooth_grid(rng, h, w, grid_size, 0.0, var_blur)
    out = np.asarray(img, np.float32)
    # quantize sigma to a var_blur-scaled level table and blend
    # gaussian-filtered variants (the reference's kernel support scales with
    # the sampled sigma, so large var_blur must produce large blurs)
    from scipy.ndimage import gaussian_filter1d
    top = max(float(var_blur), 0.02)
    levels = np.geomspace(max(0.01, top / 32.0), top, 5)

    def _pass(src, sig, axis):
        blurred = [gaussian_filter1d(src, s, axis=axis, mode="nearest")
                   for s in levels]
        ss = np.clip(sig, levels[0], levels[-1])
        idx = np.clip(np.searchsorted(levels, ss) - 1, 0, len(levels) - 2)
        t = (ss - levels[idx]) / (levels[idx + 1] - levels[idx])
        acc = np.zeros_like(src)
        for k in range(len(levels) - 1):
            m = idx == k
            acc[m] = blurred[k][m] * (1 - t[m]) + blurred[k + 1][m] * t[m]
        return acc

    out = _pass(out, sig_x, axis=1)
    out = _pass(out, sig_y, axis=0)
    return out.astype(np.float32)


class NoisySequence:
    """Reader wrapper injecting benchmark noise into images."""

    def __init__(self, reader, var_noise: float = 0.0, var_blur: float = 0.0,
                 grid_size: int = 3, seed: int = 0):
        self.reader = reader
        self.var_noise = var_noise
        self.var_blur = var_blur
        self.grid_size = grid_size
        self.seed = seed
        self.calib = reader.calib
        self.sensor = reader.sensor

    def __len__(self):
        return len(self.reader)

    def get(self, i):
        img, cloud, ts = self.reader.get(i)
        img = apply_photometric_noise(img, self.var_noise, self.grid_size,
                                      self.seed + i)
        img = apply_blur_noise(img, self.var_blur, self.grid_size,
                               self.seed + i)
        return img, cloud, ts
