"""Dry-run of the PRODUCTION programs and fleets over several devices
(counterpart of `sdv_loam_tpu/parallel/dryrun.py`).

  * `dryrun_production`: the lane forms of the production entry points
    (`ops.lidar.preprocess_scan_batch`, `ops.frame_step.
    track_frame_step_batch`, `system.kf_ops.kf_opt_step_lanes`) over a
    device mesh, one block of lanes per device. Their inputs are recorded
    from a short single-sequence run (`record_production_calls`: the only
    sure way to make production-shaped inputs, whose window state, pools,
    matcher grids and flags all depend on each other), tiled over the
    lanes and placed block by block (`run_batched_call`);
  * `dryrun_fleet_batch`: a real lockstep `MultiSystem`, whose batched
    track and keyframe programs must fire;
  * `dryrun_pinned_fleet`: an `InterleavedFleet` of one pipelined
    `FullSystem(device=d)` per device, each system's state held on its
    device and its trajectory bit for bit its run alone there. By default
    on the 320x96 scene; a caller may give its own scenes (chip_smoke.py
    phase 9 (b) runs two systems on one card at the default preset).

Run on every visible card (`python -m sdv_loam_tpu_torch.parallel.dryrun`)
it drives the pinned fleet and the production programs over
`mesh.make_batch_mesh()`.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from sdv_loam_tpu_torch.config import Settings
from sdv_loam_tpu_torch.ops import hopper_kernels
from sdv_loam_tpu_torch.parallel.mesh import make_batch_mesh, on_device
from sdv_loam_tpu_torch.utils import device_loop
from sdv_loam_tpu_torch.utils.hbm import device_storages

# the recording run and the fleets' scenes: the JAX package's (320x96)
REC_FRAMES = 8
PINNED_FRAMES = 6
W, H = 320, 96
# lanes of the recorded sequence on each device in `dryrun_production`: a
# block of two is a real lane form
LANES_PER_DEVICE = 2


def _host(x):
    """Every tensor of a nested structure copied to the host."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True)
                    if isinstance(t, torch.Tensor) else t, x)


def _production():
    from sdv_loam_tpu_torch.ops import frame_step, lidar
    from sdv_loam_tpu_torch.system import kf_ops
    return {"lidar": (lidar, "preprocess_scan_batch"),
            "track": (frame_step, "track_frame_step_batch"),
            "kf": (kf_ops, "kf_opt_step_lanes")}


def _sequences(n, n_frames):
    """n 320x96 scenes, each as (sequence, its frames)."""
    from sdv_loam_tpu_torch.data.synthetic import make_sequence
    seqs = [make_sequence(n_frames=n_frames, w=W, h=H,
                          yaw_rate=0.002 * (i - n // 2), seed=11 + i)
            for i in range(n)]
    return [(q, [q.get(i) for i in range(n_frames)]) for q in seqs]


def _endpoint_errs(systems, seqs, n_frames):
    return [float(np.linalg.norm(f.get_trajectory()[-1][:3, 3]
                                 - s.poses_wc[n_frames - 1][:3, 3]))
            for f, s in zip(systems, seqs)]


def record_production_calls(n_frames: int = REC_FRAMES, device="cuda"):
    """Run one FullSystem on the 320x96 scene, recording the (args, kwargs)
    of every call of the production entry points' lane forms (one lane
    each, as a single sequence calls them), tensors copied to the host.
    Returns {"lidar": [...], "track": [...], "kf": [...]}."""
    from sdv_loam_tpu_torch.data.synthetic import make_sequence
    from sdv_loam_tpu_torch.system.full_system import FullSystem

    rec = {name: [] for name in _production()}
    origs = {name: getattr(*at) for name, at in _production().items()}

    def wrap(name):
        def f(*a, **k):
            rec[name].append((_host(a), _host(k)))
            return origs[name](*a, **k)
        return f
    for name, at in _production().items():
        setattr(*at, wrap(name))
    try:
        seq = make_sequence(n_frames=n_frames, w=W, h=H)
        system = FullSystem(seq.calib, seq.sensor, device=device)
        for i in range(n_frames):
            system.add_active_frame(*seq.get(i))
        if system.is_lost:
            raise RuntimeError("the recording run lost tracking")
    finally:
        for name, at in _production().items():
            setattr(*at, origs[name])
    if not all(len(rec[k]) >= 2 for k in rec):
        raise RuntimeError(f"the recording run made too few calls: "
                           f"{ {k: len(v) for k, v in rec.items()} }")
    return rec


def _tile(x, n: int):
    """The lanes of a one-lane argument repeated n times: tensors along
    their leading (lane) dimension, lists (per-lane host values and lane
    dicts) by repetition, tuples entry by entry."""
    if isinstance(x, torch.Tensor):
        return x.repeat(n, *([1] * (x.dim() - 1)))
    if isinstance(x, list):
        return x * n
    if isinstance(x, tuple):
        return tuple(_tile(v, n) for v in x)
    return x


def run_batched_call(fn, args, kwargs, mesh, B: int):
    """`fn` (a lane form) on B lanes tiled from one recorded one-lane call:
    block j of B / len(mesh) lanes placed on mesh[j] and run there in one
    call (in a LoopCache of its own: one cache holds one device's graphs).
    The level tables (`kf_ops.KF_SHARED_ARGS`) are shared, not tiled.
    Returns (host outputs in lane order, as numpy arrays with a leading B;
    the set of devices that held the outputs)."""
    from sdv_loam_tpu_torch.system.kf_ops import KF_SHARED_ARGS

    n = len(mesh)
    if B % n:
        raise ValueError(f"{B} lanes do not divide over {n} devices")
    per = B // n
    leaves, devices, spec = [], set(), None
    for dev in mesh:
        with on_device(dev, device_loop.LoopCache()):
            a, k = tree_map(
                lambda t, d=dev: t.to(d) if isinstance(t, torch.Tensor)
                else t,
                (_tile(args, per),
                 {name: v if name in KF_SHARED_ARGS else _tile(v, per)
                  for name, v in kwargs.items()}))
            out = fn(*a, **k)
            flat, spec = tree_flatten(out)
            devices |= {t.device for t in flat}
            leaves.append([t.cpu().numpy() for t in flat])
    host = [np.concatenate(ls) for ls in zip(*leaves)]
    return tree_unflatten(host, spec), devices


def dryrun_production(mesh, rec=None, verbose: bool = True):
    """Two LiDAR, two track (an early-window and a steady call) and two
    keyframe cycles (matcher refresh, windowed BA, marginalization, K1)
    of the production lane forms over `mesh`, LANES_PER_DEVICE lanes of
    the recorded sequence on each device: every output finite, every
    device of the mesh holding a block. `rec` is
    `record_production_calls`'s; without it the recording runs here, on
    mesh[0] (a caller that counts the lane forms' launches records
    first). The lane forms launch K1 and K3-K6, not K2 (the distance map
    is the activation program's). Returns the keyframe energies of both
    cycles, per lane."""
    mesh = tuple(torch.device(d) for d in mesh)
    B = LANES_PER_DEVICE * len(mesh)
    if rec is None:
        rec = record_production_calls(device=mesh[0])
    if verbose:
        print(f"recorded calls: { {k: len(v) for k, v in rec.items()} }",
              flush=True)
    fns = {name: getattr(*at) for name, at in _production().items()}

    def run(name, call, finite):
        out, devs = run_batched_call(fns[name], *call, mesh, B)
        for k in finite:
            if not np.isfinite(out[k]).all():
                raise AssertionError(f"{name}: non-finite {k}")
            if out[k].shape[0] != B:
                raise AssertionError(f"{name}: {k} has {out[k].shape[0]} "
                                     f"lanes, not {B}")
        if devs != set(mesh):
            raise AssertionError(f"{name}: outputs on {devs}, mesh {mesh}")
        return out
    for call in rec["lidar"][-2:]:
        run("lidar", call, ("depth_map",))
    for call in (rec["track"][1], rec["track"][-1]):
        run("track", call, ("T_wc",))
    energies = []
    for call in (rec["kf"][1], rec["kf"][-1]):
        out = run("kf", call, ("energy", "eps", "HM"))
        energies.append(out["energy"])
    if verbose:
        print(f"dryrun_production: OK on {[str(d) for d in mesh]}, {B} "
              f"lanes; keyframe energies per lane {energies[-1]}",
              flush=True)
    return energies


def dryrun_fleet_batch(n_lanes: int, device="cuda", verbose: bool = True):
    """A lockstep `MultiSystem` of n_lanes 320x96 sequences on `device`:
    its batched track program (`track_frame_step_batch` from the fleet)
    and batched keyframe program (`kf_opt_step_lanes` of two lanes or
    more) must fire at least n_frames - 2 and 2 times, no lane lost, each
    endpoint within 0.5 m. Returns the hits."""
    from sdv_loam_tpu_torch.system import kf_ops, multi
    from sdv_loam_tpu_torch.system.full_system import FullSystem

    hits = {"track_batch": 0, "kf_batch": 0}
    track0, kf0 = multi.track_frame_step_batch, kf_ops.kf_opt_step_lanes

    def track(*a, **k):
        hits["track_batch"] += 1
        return track0(*a, **k)

    def kf(*a, **k):
        hits["kf_batch"] += k["pt_u"].shape[0] >= 2
        return kf0(*a, **k)
    multi.track_frame_step_batch, kf_ops.kf_opt_step_lanes = track, kf
    n_frames = REC_FRAMES
    try:
        scenes = _sequences(n_lanes, n_frames)
        ms = multi.MultiSystem([FullSystem(q.calib, q.sensor, device=device)
                                for q, _ in scenes])
        for i in range(n_frames):
            ms.add_frames([frames[i] for _, frames in scenes])
    finally:
        multi.track_frame_step_batch, kf_ops.kf_opt_step_lanes = track0, kf0
    errs = _endpoint_errs(ms.systems, [q for q, _ in scenes], n_frames)
    if ms.any_lost or hits["track_batch"] < n_frames - 2 or \
            hits["kf_batch"] < 2 or not max(errs) < 0.5:
        raise AssertionError(f"fleet dry-run: lost {ms.any_lost}, batched "
                             f"programs {hits}, endpoint errors {errs}")
    if verbose:
        print(f"dryrun_fleet_batch: OK with {n_lanes} lanes; batched "
              f"programs {hits}; endpoint errors {np.round(errs, 4)}",
              flush=True)
    return hits


def placement(fs) -> dict:
    """{device: storages} over every tensor a system holds (its attributes,
    its LoopCache with its programs' static buffers)."""
    return {str(d): len(st) for d, st in device_storages(vars(fs)).items()}


def dryrun_pinned_fleet(devices, scenes=None, n_frames: int = PINNED_FRAMES,
                        verbose: bool = True):
    """An `InterleavedFleet` of one pipelined `FullSystem(device=d)` per
    entry of `devices` (one worker thread per system when there are
    several), n_frames of its own scene each (`scenes`: one (sequence,
    frames) per device; by default 320x96 ones): no system lost, every
    tensor each system holds (pyramid slots, window stacks, pools, its
    LoopCache's static buffers) on that system's device, and each
    trajectory bit for bit that of the same system run alone on its
    device afterwards. Returns dict(placement: one {device: storages} per
    system, launches: `hopper_kernels.launch_counts()` read when the
    fleet has flushed, before the runs alone)."""
    from sdv_loam_tpu_torch.system.full_system import FullSystem
    from sdv_loam_tpu_torch.system.multi import InterleavedFleet

    devices = [device_loop.full_device(d) for d in devices]
    n = len(devices)
    s = Settings(pipelined_frames=True)
    scenes = _sequences(n, n_frames) if scenes is None else scenes

    def system(seq, dev):
        return FullSystem(seq.calib, seq.sensor, s, device=dev)
    fleet = InterleavedFleet([system(q, d) for (q, _), d
                              in zip(scenes, devices)],
                             workers=n if n > 1 else 0)
    for i in range(n_frames):
        fleet.add_frames([frames[i] for _, frames in scenes])
    fleet.flush()
    launches = hopper_kernels.launch_counts()
    if fleet.any_lost:
        raise AssertionError("pinned fleet lost tracking")
    placed = [placement(fs) for fs in fleet.systems]
    for fs, dev, p in zip(fleet.systems, devices, placed):
        if set(p) != {str(fs.device)} or fs.device != dev:
            raise AssertionError(f"system pinned to {dev} holds tensors on "
                                 f"{p}")
    for fs, (q, frames), dev in zip(fleet.systems, scenes, devices):
        alone = system(q, dev)
        for i in range(n_frames):
            alone.add_active_frame(*frames[i])
        if not np.array_equal(alone.get_trajectory(), fs.get_trajectory()):
            raise AssertionError(f"the fleet's system on {dev} departs "
                                 "from its run alone")
    errs = _endpoint_errs(fleet.systems, [q for q, _ in scenes], n_frames)
    if not max(errs) < 0.5:
        raise AssertionError(f"pinned fleet endpoint errors {errs}")
    if verbose:
        print(f"dryrun_pinned_fleet: OK, {n} systems on "
              f"{[str(d) for d in devices]}, placement {placed}, each bit "
              f"for bit its run alone; endpoint errors {np.round(errs, 4)}",
              flush=True)
    return dict(placement=placed, launches=launches)


def main():
    """The pinned fleet and the production programs over every visible
    CUDA device."""
    mesh = make_batch_mesh()
    print(json.dumps({"mesh": [str(d) for d in mesh],
                      "cards": [torch.cuda.get_device_name(d)
                                for d in mesh]}), flush=True)
    dryrun_pinned_fleet(mesh)
    dryrun_production(mesh)


if __name__ == "__main__":
    main()
