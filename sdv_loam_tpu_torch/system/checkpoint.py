"""Checkpoint / resume of the full odometry state.

Counterpart of `sdv_loam_tpu/system/checkpoint.py`, in the same `.npz`
format (every pool, the window slots, the marginalization prior, the shell
trajectory, and a `meta_json` record), so a checkpoint written by either
package loads into the other.

The JAX package stores its `jax.random` key as `rng_key`. The port cannot
reproduce jax.random bits from it: `load` reads the field and replaces it
with a `torch.Generator` seeded from `Settings.seed`, so the selection
draws after a resume differ from the JAX run's (the keep sub-sampling,
which is numpy-seeded, does not). `save` writes `rng_key` as the seed so
that the file stays readable by the JAX package.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from sdv_loam_tpu_torch.config import Settings
from sdv_loam_tpu_torch.ops.align import flatten_pyramid
from sdv_loam_tpu_torch.ops.pyramid import make_images
from sdv_loam_tpu_torch.system.full_system import FullSystem

_SCALARS = ("first_coarse_rmse", "current_min_act_dist", "ignore_kf",
            "initialized", "is_lost", "init_failed", "track_ref_slot")

_ARRAYS = ("slot_used", "T_cw_fej", "eps", "aff", "exposure", "fe_th",
           "frame_prior", "frame_kf_id", "frame_shell_idx", "slot_flagged",
           "slot_stats_out", "pt_valid", "res_active", "res_state",
           "res_is_new", "matcher_px", "matcher_valid", "centers",
           "im_valid", "HM", "bM", "K0", "last_coarse_rmse",
           "track_ref_aff")


def save(fs: FullSystem, path: str) -> None:
    fs.flush()               # finish any pipelined in-flight frame
    with fs._on_stream():
        fs._sync_immature()
        fs._sync_pool_mirrors()
        dI0 = fs.dI0_stack[..., 0].cpu().numpy()
    data = {name: getattr(fs, name) for name in _ARRAYS}
    data["order"] = np.array(fs.order, np.int64)
    data["dI0_stack"] = dI0
    data["rng_key"] = np.array([0, fs.s.seed], np.uint32)
    for k, v in fs.pt.items():
        data[f"pt_{k}"] = v
    for k, v in fs.im.items():
        data[f"im_{k}"] = v
    meta = dict(
        shells=[{k: (v.tolist() if isinstance(v, np.ndarray) else v)
                 for k, v in sh.items()} for sh in fs.shells],
        kf_shells=fs.kf_shells,
        pot=fs.pot_state.get("pot", 3),
        scalars={k: (float(getattr(fs, k))
                     if not isinstance(getattr(fs, k), bool)
                     else bool(getattr(fs, k))) for k in _SCALARS},
        track_step_hist=[float(x) for x in fs._track_step_hist],
    )
    data["meta_json"] = np.frombuffer(json.dumps(meta).encode(),
                                      dtype=np.uint8)
    np.savez_compressed(path, **data)


def load(path: str, calib, sensor, settings: Settings | None = None,
         device="cuda") -> FullSystem:
    """Rebuild a port FullSystem on `device` from a checkpoint file; the
    per-slot pyramids and the tracking reference are re-derived on the
    device (the reference through the K1 kernel on a CUDA device)."""
    z = np.load(path, allow_pickle=False)
    fs = FullSystem(calib, sensor, settings, device=device)
    meta = json.loads(bytes(z["meta_json"]).decode())

    fs.order = [int(x) for x in z["order"]]
    for name in _ARRAYS:
        setattr(fs, name, np.array(z[name]))
    for k in fs.pt:
        fs.pt[k] = np.array(z[f"pt_{k}"])
    for k in fs.im:
        fs.im[k] = np.array(z[f"im_{k}"])

    fs.shells = [{k: (np.array(v) if isinstance(v, list) else v)
                  for k, v in sh.items()} for sh in meta["shells"]]
    fs.kf_shells = list(meta["kf_shells"])
    fs.pot_state = {"pot": meta["pot"]}
    fs._track_step_hist = [float(x) for x in meta.get("track_step_hist", [])]
    sc = meta["scalars"]
    fs.first_coarse_rmse = sc["first_coarse_rmse"]
    fs.current_min_act_dist = sc["current_min_act_dist"]
    fs.ignore_kf = bool(sc["ignore_kf"])
    fs.initialized = bool(sc["initialized"])
    fs.is_lost = bool(sc["is_lost"])
    fs.init_failed = bool(sc["init_failed"])
    fs.track_ref_slot = int(sc["track_ref_slot"])
    # rng_key holds JAX key data: replaced by the seeded generator
    fs._gen = torch.Generator().manual_seed(int(fs.s.seed))

    intens = z["dI0_stack"]
    with fs._on_stream():
        for slot in fs.order:
            dI, _ = make_images(fs._t(intens[slot]), fs.levels)
            fs.pyr_slots[slot] = dI
            fs.set_flat_slot(slot, flatten_pyramid(dI)[0])
            fs.dI0_stack[slot] = dI[0]

        if fs.order and fs.track_ref_slot >= 0 and \
                fs.pyr_slots[fs.track_ref_slot] is not None:
            fs._set_coarse_tracking_ref(fs.track_ref_slot)
    return fs
