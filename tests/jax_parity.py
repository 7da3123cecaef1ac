"""Helpers of the port's parity tests that hand the JAX package's state to
the port: the JAX selection draws for the port's selector, scans moved off
the LiDAR ring edges, a JAX checkpoint load that restores everything the
keyframe optimization reads, and the pose difference the tests bound."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sdv_loam_tpu.config import ANG_RES_Y
from sdv_loam_tpu.system import checkpoint as jcheckpoint
from sdv_loam_tpu_torch.ops.select import cascade_grid_shapes


def mid_bin(cloud):
    """Move every point half a ring up, keeping its range and azimuth: the
    synthetic scans sit exactly on ring edges, where the last-ulp
    difference between XLA's and torch's atan2 flips the ring (and with it
    which points the selection sees)."""
    c = cloud.astype(np.float64)
    r = np.linalg.norm(c, axis=1)
    el = np.arcsin(c[:, 2] / r) + np.deg2rad(0.5 * ANG_RES_Y)
    az = np.arctan2(c[:, 0], c[:, 1])
    hd = r * np.cos(el)
    return np.stack([hd * np.sin(az), hd * np.cos(az), r * np.sin(el)],
                    -1).astype(np.float32)


def mid_binned(frames):
    """(image, cloud, timestamp) frames with every cloud mid-binned."""
    return [(img, None if cloud is None else mid_bin(cloud), ts)
            for img, cloud, ts in frames]


def jax_dir_source(key, h, w, x64=True):
    """A port system's selection draws taken from the JAX system's key
    chain: one key per selection call (`FullSystem._next_key`), its three
    direction grids drawn as the JAX package's cascade draws them, for
    each attempt's pot. Assign it to the port system's `_dir_source`.

    `jax.random.randint` draws other bits with x64 on than off, so the
    draws are made in the float mode the JAX run had: `x64` (on, as
    tests/conftest.py sets it, unless the JAX run turned it off)."""
    state = {"key": key}

    def source():
        state["key"], k = jax.random.split(state["key"])

        def draw(pot):
            with jax.enable_x64(x64):
                ks = jax.random.split(k, 3)
                return tuple(torch.from_numpy(np.array(
                    jax.random.randint(kk, shape, 0, 16)))
                    for kk, shape in zip(ks, cascade_grid_shapes(h, w,
                                                                 pot)))
        return draw
    return source


def checkpoint_key(path):
    """The JAX key chain stored in a checkpoint file (`rng_key`)."""
    return jax.random.wrap_key_data(np.load(path)["rng_key"])


def load_jax(path, calib, sensor, settings):
    """`sdv_loam_tpu.system.checkpoint.load`, plus the stack of the
    window's flattened pyramids (`_flat_stack`) that it leaves unset. The
    JAX keyframe optimization's second matcher pass reads its older
    targets from that stack, so a loaded system would match its newest
    points against zero images there: the first quantity in which a
    hand-over departs (`match_diag_p2`, then the residual set and `E0`)."""
    fs = jcheckpoint.load(path, calib, sensor, settings)
    flats = [f[0] if f is not None else None for f in fs.flat_slots]
    ref = next(f for f in flats if f is not None)
    fs._flat_stack = jnp.stack([jnp.zeros_like(ref) if f is None else f
                                for f in flats])
    return fs


def pose_diff(A, B):
    """(translation m, rotation rad) between two poses. The angle is
    atan2(|skew|, (trace - 1) / 2): arccos((trace - 1) / 2) cannot resolve
    angles under ~3e-4 rad between float32 rotation matrices (their trace
    is off by an ulp)."""
    d = np.linalg.inv(A) @ B
    R = d[:3, :3]
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return (float(np.linalg.norm(d[:3, 3])),
            float(np.arctan2(0.5 * np.linalg.norm(w),
                             0.5 * (np.trace(R) - 1.0))))
