"""A batch of sequences laid out over devices (counterpart of
`sdv_loam_tpu/parallel/mesh.py`).

The reference is one process tracking one sequence (SURVEY.md section
2.6); the scaling axis is the batch: independent sequences, each on one
card. The odometry needs no collective, so one process drives every card:
the batch is cut into contiguous blocks of B / n lanes, block j on
`mesh[j]` (the layout the JAX package's `NamedSharding(mesh, P("batch"))`
gives), and each block runs on its device. No `torch.distributed`.

SCOPE, as in the JAX package: `_single_step` is a REDUCED combined step
(pyramid -> splat -> tracking reference (K1) -> track -> one windowed-BA
solve) that checks the layout cheaply. The production paths over several
cards are `parallel/dryrun.py` (the production programs' lane forms over
the mesh, and `InterleavedFleet` with one pinned system per device) and
`system/multi.py`. Do not extend this step.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from sdv_loam_tpu_torch.models import backend
from sdv_loam_tpu_torch.ops.photometric import (build_track_ref,
                                                splat_idepth, track_pyramid)
from sdv_loam_tpu_torch.ops.pyramid import make_images
from sdv_loam_tpu_torch.utils import device_loop, se3


def make_batch_mesh(devices=None) -> tuple:
    """The devices of the batch axis: `devices` as given, or by default
    every visible CUDA device (`cuda:0` ... `cuda:n-1`, by ordinal)."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise RuntimeError("no device for the batch mesh: no CUDA device is "
                           "visible and none was given")
    return mesh


def on_device(device, cache=None):
    """Context that makes `device` current (CUDA) and `cache` the thread's
    graph cache (`device_loop.use`; one LoopCache holds one device's
    graphs)."""
    stack = contextlib.ExitStack()
    if torch.device(device).type == "cuda":
        stack.enter_context(torch.cuda.device(device))
    if cache is not None:
        stack.enter_context(device_loop.use(cache))
    return stack


def as_tensors(tree, device):
    """numpy arrays (or tensors) of a dict / list as tensors on `device`:
    float arrays as float32, int32 as int64 (the port's index type), other
    dtypes kept."""
    if isinstance(tree, dict):
        return {k: as_tensors(v, device) for k, v in tree.items()}
    t = torch.as_tensor(np.asarray(tree) if not isinstance(
        tree, torch.Tensor) else tree)
    if t.is_floating_point():
        t = t.to(torch.float32)
    elif t.dtype == torch.int32:
        t = t.to(torch.int64)
    return t.to(device)


def _single_step(state, image, K, levels: int, w: int, h: int, F: int):
    """One combined tracking + BA step for a single sequence (unbatched):
    `state` a dict of one lane's tensors (`make_example_batch`'s fields),
    `image` (h, w), `K` (4,). Returns (new state, dict(track_res, energy))."""
    dev = image.device
    dI, _ = make_images(image, levels)

    # --- tracking: splat the window's sensor depths, build ref, track ---
    id0, w0 = splat_idepth(state["pt_u"].to(torch.int64),
                           state["pt_v"].to(torch.int64),
                           state["pt_idepth"],
                           torch.ones_like(state["pt_idepth"]),
                           state["pt_valid"], w, h)
    pools = build_track_ref(dI, id0, w0, levels, cap=2048)
    Ks = tuple(torch.stack([K[0] / 2 ** l, K[1] / 2 ** l,
                            (K[2] + 0.5) / 2 ** l - 0.5,
                            (K[3] + 0.5) / 2 ** l - 0.5])
               for l in range(levels))
    zeros2 = torch.zeros(2, dtype=torch.float32, device=dev)
    tr = track_pyramid(pools, dI, Ks, state["T_init"], zeros2, zeros2,
                       torch.ones(2, dtype=torch.float32, device=dev),
                       torch.full((5,), float("inf"), dtype=torch.float32,
                                  device=dev),
                       20.0, 6.0, coarsest_lvl=levels - 1)

    # --- BA: linearize, assemble, solve, update ---
    T_cw = se3.se3_exp(state["eps"]) @ state["T_cw_fej"]
    pairs = backend.make_pairs(T_cw, state["T_cw_fej"], state["aff"],
                               state["exposure"], K)
    lin = backend.linearize_residuals(
        state["pt_u"], state["pt_v"], state["pt_idepth"], state["pt_host"],
        state["pt_color"], state["pt_weights"], state["res_active"],
        state["res_state"], state["matcher_px"], state["matcher_valid"],
        pairs, state["dI0_stack"], state["fe_th"], K, w=w, h=h)
    frame_delta = state["eps"] * state["frame_valid"][:, None]
    c_delta = torch.zeros(4, dtype=torch.float32, device=dev)
    sys_ = backend.build_system(lin, state["pt_host"], state["pt_is_sensor"],
                                state["pt_prior"], pairs, frame_delta,
                                c_delta, n_frames=F)
    ns = backend.make_nullspaces(state["T_cw_fej"],
                                 state["frame_valid"].to(torch.float32))
    sol = backend.solve_system(
        sys_, state["HM"], state["bM"],
        backend.stitched_delta(c_delta[None], state["eps"][None],
                               state["frame_valid"][None])[0],
        torch.full((4,), 2e6, dtype=torch.float32, device=dev), c_delta,
        state["frame_prior"], frame_delta, state["frame_valid"], ns, 0.1,
        state["pt_host"], state["pt_is_sensor"], pairs, n_frames=F)

    new_state = dict(state)
    new_state["eps"] = state["eps"] + sol["dframes"]
    new_state["pt_idepth"] = torch.where(
        state["pt_is_sensor"], state["pt_idepth"],
        state["pt_idepth"] + sol["didepth"])
    new_state["T_init"] = tr["T"]
    return new_state, dict(track_res=tr["res"], energy=sys_["e_quad"])


def make_batched_step(mesh, levels: int, w: int, h: int, F: int):
    """The batched step over `mesh` (`make_batch_mesh`): returns
    (step, gather).

    `step(states, images, Ks)` takes B lanes (numpy arrays or tensors with
    a leading B, B a multiple of len(mesh)), places block j (lanes
    j*B/n .. (j+1)*B/n - 1) on mesh[j] and runs `_single_step` there
    lane by lane, so each lane is bit for bit `_single_step` run alone on
    its device. Returns one (device, new states, diagnostics) per block,
    each field stacked over the block's lanes on its device. Each device's
    graphs live in a LoopCache of its own.

    `gather(blocks)` copies them to the host in lane order: (states,
    diagnostics) as dicts of numpy arrays with a leading B."""
    mesh = tuple(torch.device(d) for d in mesh)
    caches = {d: device_loop.LoopCache() for d in mesh}

    def step(states, images, Ks):
        B = len(images)
        n = len(mesh)
        if B % n:
            raise ValueError(f"{B} lanes do not divide over {n} devices")
        per = B // n
        blocks = []
        for j, dev in enumerate(mesh):
            lanes = range(j * per, (j + 1) * per)
            with on_device(dev, caches[dev]):
                outs = [_single_step(
                    as_tensors({k: v[i] for k, v in states.items()}, dev),
                    as_tensors(images[i], dev), as_tensors(Ks[i], dev),
                    levels, w, h, F) for i in lanes]
                new = {k: torch.stack([o[0][k] for o in outs])
                       for k in outs[0][0]}
                diag = {k: torch.stack([o[1][k] for o in outs])
                        for k in outs[0][1]}
            blocks.append((dev, new, diag))
        return blocks

    def gather(blocks):
        return tuple({k: np.concatenate([b[m][k].cpu().numpy()
                                         for b in blocks])
                      for k in blocks[0][m]} for m in (1, 2))

    return step, gather


def make_example_batch(n: int, w: int = 128, h: int = 64, F: int = 4,
                       n_pts: int = 256, seed: int = 0):
    """Tiny synthetic batch of window states for the multi-device dry-run
    (numpy only; the JAX package's function, copied as it is, so both
    packages' tests feed it the same arrays)."""
    rng = np.random.default_rng(seed)
    D = 4 + 6 * F

    def one(i):
        img = rng.random((h, w)).astype(np.float32) * 255
        u = rng.uniform(8, w - 8, n_pts).astype(np.float32)
        v = rng.uniform(8, h - 8, n_pts).astype(np.float32)
        z = rng.uniform(5, 40, n_pts).astype(np.float32)
        host = (rng.integers(0, F - 1, n_pts)).astype(np.int32)
        res_active = np.zeros((n_pts, F), bool)
        res_active[np.arange(n_pts), (host + 1) % F] = True
        state = dict(
            T_cw_fej=np.tile(np.eye(4, dtype=np.float32), (F, 1, 1)),
            eps=np.zeros((F, 6), np.float32),
            aff=np.zeros((F, 2), np.float32),
            exposure=np.ones(F, np.float32),
            frame_valid=np.ones(F, bool),
            frame_prior=np.zeros((F, 6), np.float32),
            # generous photometric gate: example colors are not sampled
            # from the example images, so keep residuals active
            fe_th=np.full(F, 1e7, np.float32),
            HM=np.zeros((D, D), np.float32), bM=np.zeros(D, np.float32),
            pt_u=u, pt_v=v, pt_idepth=1.0 / z, pt_host=host,
            pt_color=rng.random((n_pts, 8)).astype(np.float32) * 255,
            pt_weights=np.ones((n_pts, 8), np.float32),
            pt_is_sensor=np.ones(n_pts, bool),
            pt_prior=np.zeros(n_pts, np.float32),
            pt_valid=np.ones(n_pts, bool),
            res_active=res_active,
            res_state=np.zeros((n_pts, F), np.int8),
            matcher_px=np.stack([np.tile(u[:, None], (1, F)),
                                 np.tile(v[:, None], (1, F))], -1
                                ).astype(np.float32)
            + rng.standard_normal((n_pts, F, 2)).astype(np.float32),
            matcher_valid=res_active.copy(),
            # textured window images (nonzero gradients keep the BA's
            # wJI2 gradient-mass outlier gate open)
            dI0_stack=rng.random((F, h, w, 3)).astype(np.float32) * 50,
            T_init=np.eye(4, dtype=np.float32),
        )
        K = np.array([0.6 * w, 0.6 * w, (w - 1) / 2, (h - 1) / 2], np.float32)
        return state, img, K

    states, imgs, Ks = [], [], []
    for i in range(n):
        st, im, K = one(i)
        states.append(st)
        imgs.append(im)
        Ks.append(K)
    batch_state = {k: np.stack([s[k] for s in states]) for k in states[0]}
    return batch_state, np.stack(imgs), np.stack(Ks)
