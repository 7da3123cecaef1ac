"""Fleets: B sequences on one card.

Counterpart of `sdv_loam_tpu/system/multi.py` (the reference is a
single-sequence, single-process system, SURVEY.md §2.6; the port's
throughput axis is B independent sequences sharing one device):

  * `InterleavedFleet` runs B pipelined systems side by side. Each system
    runs all its work on its own CUDA stream, so one system's track step
    overlaps another's host staging and keyframe readbacks; with
    `workers` > 0 each system is advanced on a thread of its own;
  * `MultiSystem` runs B sequential systems in stage lockstep over the
    FullSystem phase split and batches the pyramid, the LiDAR
    preprocessing and the first track attempt of the aligned sequences
    into one launch stream each (`make_images_batch`,
    `preprocess_scan_batch`, `track_frame_step_batch`). Host retry
    attempts and every keyframe stage run per sequence (the JAX lockstep's
    own fallback for requests it does not batch), as do requests whose
    shapes or statics differ.

Per-sequence results do not depend on the composition: systems share
only the device, never state.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib

import numpy as np
import torch

from sdv_loam_tpu_torch.ops.frame_step import track_frame_step_batch
from sdv_loam_tpu_torch.ops.lidar import preprocess_scan_batch
from sdv_loam_tpu_torch.ops.pyramid import make_images_batch
from sdv_loam_tpu_torch.system.full_system import TRACK_KEYS


def _run_all(pool, fns):
    """Run the callables serially (pool None) or on the pool; with a pool,
    every task is waited for before the first error is raised, so no task
    is still changing its system while the caller unwinds."""
    if pool is None:
        return [fn() for fn in fns]
    futs = [pool.submit(fn) for fn in fns]
    cf.wait(futs)
    return [f.result() for f in futs]


def _shape_key(x):
    """Shapes, dtypes and plain values of a nested argument structure."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, x.device)
    if isinstance(x, dict):
        return tuple((k, _shape_key(v)) for k, v in sorted(x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_shape_key(v) for v in x)
    return x


class MultiSystem:
    """Drive B sequential FullSystem instances in stage lockstep."""

    def __init__(self, systems, batch_track: bool = True,
                 host_workers: int | None = None):
        self.systems = list(systems)
        self.batch_track = batch_track
        if any(fs.s.pipelined_frames for fs in self.systems):
            raise ValueError("MultiSystem drives sequential systems; "
                             "pipelined systems go into InterleavedFleet")
        devices = {fs.device for fs in self.systems}
        if len(devices) > 1:
            raise ValueError(f"systems on several devices: {devices}")
        # one thread, one stream: the systems move onto the stream current
        # now, so batched and per-sequence work share one queue
        self._stream = None
        if self.systems and self.systems[0].device.type == "cuda":
            self._stream = torch.cuda.current_stream(self.systems[0].device)
            for fs in self.systems:
                fs._use_stream(self._stream)
        # per-sequence host work between the lockstep rounds is
        # independent across systems; host_workers > 1 runs it on threads,
        # 0 forces the serial loop. None: threads on the CPU (torch ops
        # release the GIL while they compute), serial on CUDA, where an op
        # is a launch of a few microseconds and handing the GIL between
        # threads at every op costs more than it overlaps (PERF.md: 3x
        # slower on the H100 with 4 threads)
        if host_workers is None:
            host_workers = 0 if self._stream is not None \
                else min(8, len(self.systems))
        self._pool = None
        if host_workers > 1 and len(self.systems) > 1:
            self._pool = cf.ThreadPoolExecutor(max_workers=host_workers)

    def __len__(self):
        return len(self.systems)

    def _each(self, ids, fn):
        """fn(i, system) for every id, each on the system's stream."""
        def task(i):
            fs = self.systems[i]
            with fs._on_stream():
                return fn(i, fs)
        return dict(zip(ids, _run_all(
            self._pool, [lambda i=i: task(i) for i in ids])))

    def _stages(self, ids, name):
        """Enter telemetry stage `name` of every listed system around one
        batched call (each system's stage table then holds the batch)."""
        stack = contextlib.ExitStack()
        for i in ids:
            stack.enter_context(self.systems[i].telemetry.stage(name))
        return stack

    def add_frames(self, frames):
        """Process one frame per sequence.

        frames: list of (image, cloud, timestamp) or None (sequence done),
        one per system."""
        ctx = torch.cuda.stream(self._stream) if self._stream is not None \
            else contextlib.nullcontext()
        with ctx:
            self._round(frames)

    def _round(self, frames):
        live = [i for i, fr in enumerate(frames) if fr is not None]
        for i in live:
            if frames[i][1] is None:
                raise NotImplementedError(
                    "camera-only frames (ops/mono_init) are not ported yet")

        # 1. pyramids: one batch over the systems that will stage one
        pyr = {}
        todo = [i for i in live if not self.systems[i].is_lost]
        if self.batch_track and len(todo) >= 2 and self._same(
                [(np.shape(frames[i][0]), self.systems[i].levels)
                 for i in todo]):
            fs0 = self.systems[todo[0]]
            with self._stages(todo, "pyramid"):
                imgs = fs0._upload_image(np.stack(
                    [np.asarray(frames[i][0], np.float32) for i in todo]))
                pyr = dict(zip(todo, make_images_batch(imgs, fs0.levels)))
        staged = {i: f for i, f in self._each(
            live, lambda i, fs: fs._stage(*frames[i], pyr=pyr.get(i))
        ).items() if f is not None}
        ids = sorted(staged)

        # 2. LiDAR: one batch, clouds padded to the fleet's largest bucket
        scans = {}
        if self.batch_track and len(ids) >= 2 and self._same(
                [(fs.w, fs.h) for fs in (self.systems[i] for i in ids)]):
            cap = max(self.systems[i]._bucket_cloud(staged[i]["cloud"])[2]
                      for i in ids)
            with self._stages(ids, "lidar"):
                lanes = [self.systems[i]._lidar_args(staged[i]["cloud"], cap)
                         for i in ids]
                out = preprocess_scan_batch(
                    *(torch.stack(a) for a in zip(*lanes)),
                    w=self.systems[ids[0]].w, h=self.systems[ids[0]].h)
                scans = {i: {k: v[j] for k, v in out.items()}
                         for j, i in enumerate(ids)}
        self._each(ids, lambda i, fs: fs._lidar(staged[i], scans.get(i)))

        # 3. track requests, and the first attempts as one batch
        reqs = self._each(ids, lambda i, fs: fs._track_inputs(staged[i]))
        first = self._batch_track(reqs) if self.batch_track else {}

        # 4-5. per sequence: retries, veto, keyframe decision and tail
        def finish(i, fs):
            with fs.telemetry.stage("track"):
                ok = fs._track_result(staged[i], reqs[i], first.get(i))
            fs._finish(staged[i], ok)
        self._each(ids, finish)

    @staticmethod
    def _same(keys):
        return all(k == keys[0] for k in keys[1:])

    def _batch_track(self, reqs):
        """One batched first track attempt over the aligned requests ->
        {id: host outputs}; empty when fewer than two align."""
        ids = list(reqs)
        if len(ids) < 2:
            return {}

        def key(r):
            args = {k: v for k, v in r["args"].items()
                    if k not in ("cutoff_th", "huber_th")}
            return (_shape_key(args), r["statics"], r["args"]["cutoff_th"],
                    r["args"]["huber_th"], _shape_key(r["quad_stack"]))
        if not self._same([key(reqs[i]) for i in ids]):
            return {}
        fs0 = self.systems[ids[0]]
        with self._stages(ids, "track.batch"):
            out = track_frame_step_batch(
                [dict(reqs[i]["args"], try_exclude=fs0._t(
                    reqs[i]["exclude"], torch.bool)) for i in ids],
                [reqs[i]["etol"] for i in ids], [reqs[i]["mdt"] for i in ids],
                **reqs[ids[0]]["statics"],
                quad_stacks=[reqs[i]["quad_stack"] for i in ids])
            host = {k: fs0._np(out[k]) for k in TRACK_KEYS}
        return {i: {k: v[j] for k, v in host.items()}
                for j, i in enumerate(ids)}

    @property
    def any_lost(self):
        return any(fs.is_lost for fs in self.systems)


class InterleavedFleet:
    """B independent pipelined FullSystems advanced frame round by frame
    round.

    The alternative fleet composition to MultiSystem's lockstep: each
    sequence keeps its own single-sequence launch stream on its own CUDA
    stream, and the overlap comes from `Settings.pipelined_frames`: while
    system b's track step runs on the card, the other systems stage their
    frames and drain their keyframe tails. No system ever waits for a
    lockstep peer, and each loop runs its own iteration count.

    Reference analog: one odometry process per sequence sharing a machine
    (SURVEY.md §2.6); here they share one card.
    """

    def __init__(self, systems, workers: int = 0):
        self.systems = list(systems)
        # workers > 0: advance each system on its own thread so one
        # system's blocking readback does not stall the others' host work.
        # Each system is only touched by its own per-round task, so its
        # frame order, and therefore its trajectory, is unchanged.
        self._pool = None
        if workers > 0 and len(self.systems) > 1:
            self._pool = cf.ThreadPoolExecutor(
                max_workers=min(workers, len(self.systems)))

    def __len__(self):
        return len(self.systems)

    def add_frames(self, frames):
        """One frame round: frames[b] -> systems[b] ((img, cloud, ts) or
        None to skip a sequence this round)."""
        _run_all(self._pool, [lambda fs=fs, fr=fr: fs.add_active_frame(*fr)
                              for fs, fr in zip(self.systems, frames)
                              if fr is not None])

    def flush(self):
        _run_all(self._pool, [fs.flush for fs in self.systems])

    @property
    def any_lost(self):
        return any(fs.is_lost for fs in self.systems)
