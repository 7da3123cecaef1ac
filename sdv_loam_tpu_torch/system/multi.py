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
    `preprocess_scan_batch`, `track_frame_step_batch`), then, past every
    system's keyframe decision, the trace of every system, and the
    selection rounds, the activation and the keyframe optimization of the
    systems that take a keyframe (`trace_points_lanes`,
    `select_compact_lanes`, `activate_full_lanes`, `kf_opt_step_lanes`;
    K2 and K1 then run once per batched round, over all its lanes).
    Requests whose shapes or statics differ (lane caps widened to the
    fleet's widest), host retry attempts, the BA veto's damped retry and
    the host bookkeeping between the stages run per sequence. A lane
    whose frame has no cloud stays out of the LiDAR batch and takes the
    null scan; a lane still in the camera-only bootstrap ends its round
    at staging.

Per-sequence results do not depend on the composition: systems share
only the device, never state.

A lockstep round is a partition of fleet-level spans (`io/telemetry.spans`:
entered once, recorded in every system's table with the round phase's full
time): `round.pyramid`, `round.stage`, `round.lidar`, `round.track_inputs`,
`round.track`, `round.decide`, `round.trace`, and with keyframes
`round.kf_insert`, `round.select`, `round.activate`, `round.commit`,
`round.kf_request`, `round.kf_opt` (`round.finish` without a batched
track). Inside them the batched stages, the host steps (`host.stack`:
lanes stacked and caps widened; `host.upload`, `host.lidar_args`,
`host.select_step` and the per-lane `host.*_result` steps), the stage-end
waits and the readbacks are spans of their own.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import threading

import numpy as np
import torch

from sdv_loam_tpu_torch.ops.frame_step import track_frame_step_batch
from sdv_loam_tpu_torch.ops.lidar import preprocess_scan_batch
from sdv_loam_tpu_torch.ops.pyramid import make_images_batch
from sdv_loam_tpu_torch.ops.select import (SELECT_LANE_ARGS, run_select,
                                           select_compact_lanes)
from sdv_loam_tpu_torch.io.telemetry import spans
from sdv_loam_tpu_torch.ops.trace import trace_points, trace_points_lanes
from sdv_loam_tpu_torch.system import kf_ops
from sdv_loam_tpu_torch.system.full_system import ACT_PULL_KEYS, TRACK_KEYS
from sdv_loam_tpu_torch.utils import device_loop


def _worker_pool(n, systems):
    """A pool of `n` host threads for the systems, each thread started and
    its libraries' handles made on every CUDA device of the systems before
    the pool is handed out (`device_loop.prepare_thread`): a thread
    creating its first cuBLAS or cuSOLVER handle on a device while another
    thread captures a loop graph there breaks that capture, and a thread
    may advance a system of any of the devices. A thread whose preparation
    fails breaks the barrier, so the others stop waiting and the failure
    is raised here."""
    pool = cf.ThreadPoolExecutor(max_workers=n)
    devices = sorted({fs.device for fs in systems if fs.device.type == "cuda"},
                     key=str)
    if devices:
        barrier = threading.Barrier(n)

        def start():
            try:
                for d in devices:
                    device_loop.prepare_thread(d)
            except BaseException:
                barrier.abort()
                raise
            barrier.wait()
        futs = [pool.submit(start) for _ in range(n)]
        cf.wait(futs)
        errors = [f.exception() for f in futs if f.exception() is not None]
        if errors:
            pool.shutdown()
            # the failure itself, not another thread's broken barrier
            raise next((e for e in errors if not isinstance(
                e, threading.BrokenBarrierError)), errors[0])
    return pool


def _run_all(pool, fns):
    """Run the callables serially (pool None) or on the pool; with a pool,
    every task is waited for before the first error is raised, so no task
    is still changing its system while the caller unwinds."""
    if pool is None:
        return [fn() for fn in fns]
    futs = [pool.submit(fn) for fn in fns]
    cf.wait(futs)
    return [f.result() for f in futs]


def _tensor_key(x):
    """Shapes, dtypes and devices of the tensors of a nested structure
    (its host values may differ between lanes)."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, x.device)
    if isinstance(x, dict):
        return tuple((k, _tensor_key(v)) for k, v in sorted(x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_tensor_key(v) for v in x)
    return None


def _groups(reqs, key):
    """The ids of `reqs` ({id: request}) grouped by key(request), in id
    order; a group of two or more runs as lanes of one call."""
    out = {}
    for i in sorted(reqs):
        out.setdefault(key(reqs[i]), []).append(i)
    return list(out.values())


def _stack(xs):
    """The lanes of one argument: tensors stacked, dicts and tuples
    stacked entry by entry."""
    if isinstance(xs[0], dict):
        return {k: _stack([x[k] for x in xs]) for k in xs[0]}
    if isinstance(xs[0], (list, tuple)):
        return tuple(_stack(list(v)) for v in zip(*xs))
    return xs[0][None] if len(xs) == 1 else torch.stack(xs)


def _widen(statics, caps):
    """The statics the lanes share, each cap the lanes' widest: a wider
    compaction cap only adds invalid rows."""
    out = dict(statics[0])
    for c in caps:
        out[c] = max(st[c] for st in statics)
    return out


def _statics_key(statics, caps=()):
    return tuple(sorted((k, v) for k, v in statics.items() if k not in caps))


# per-lane host values of the lane forms (the other arguments are tensors)
TRACE_FLOATS = ("max_pix_search_frac", "huber_th")
ACT_HOST_ARGS = ("newest_slot", "min_act_dist", "min_trace_quality",
                 "min_idepth_h_act")


def _select_key(req):
    return _tensor_key(req["args"]), _statics_key(req["statics"])


def _activate_key(req):
    return (_tensor_key({k: v for k, v in req["args"].items()
                         if k not in ACT_HOST_ARGS}),
            _statics_key(req["statics"], ("a_cap",)))


def _kf_opt_key(req):
    """The tensors' shapes (the flat pyramids' shapes follow from
    `dI_newest_pyr`'s), the statics but the widened caps; a cap of 0 (the
    pool-fraction default) only batches with 0."""
    a, st = req["args"], req["statics"]
    return (_tensor_key({k: a[k] for k in kf_ops.KF_TENSOR_ARGS}),
            _tensor_key(tuple(a["dI_newest_pyr"])),
            _statics_key(st, ("p1_cap", "p2_cap")),
            st["p1_cap"] == 0, st["p2_cap"] == 0)


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
        # the batched stages' loop graphs (a system's own are its own)
        self.loops = device_loop.LoopCache()
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
            self._pool = _worker_pool(host_workers, self.systems)

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

    def _span(self, name, ids=None, sync=False):
        """Span `name` over the listed systems (every system by default):
        timed once and recorded in each system's table with its full time;
        `sync`: a stage, ending with one wait for the fleet's stream."""
        systems = self.systems if ids is None else \
            [self.systems[i] for i in ids]
        return spans([fs.telemetry for fs in systems], name, sync)

    def _stages(self, ids, name):
        """Stage `name` of every listed system around one batched call
        (each system's stage table then holds the batch)."""
        return self._span(name, ids, sync=True)

    def add_frames(self, frames):
        """Process one frame per sequence.

        frames: list of (image, cloud, timestamp) or None (sequence done),
        one per system."""
        with contextlib.ExitStack() as ctx:
            if self._stream is not None:
                ctx.enter_context(torch.cuda.stream(self._stream))
                ctx.enter_context(device_loop.use(self.loops))
            self._round(frames)

    def _round(self, frames):
        live = [i for i, fr in enumerate(frames) if fr is not None]

        # 1. pyramids: one batch over the systems that will stage one
        with self._span("round.pyramid"):
            pyr = {}
            todo = [i for i in live if not self.systems[i].is_lost]
            if self.batch_track and len(todo) >= 2 and self._same(
                    [(np.shape(frames[i][0]), self.systems[i].levels)
                     for i in todo]):
                fs0 = self.systems[todo[0]]
                with self._stages(todo, "pyramid"):
                    with self._span("host.stack", todo):
                        imgs = np.stack([np.asarray(frames[i][0], np.float32)
                                         for i in todo])
                    with self._span("host.upload", todo):
                        imgs = fs0._upload_image(imgs)
                    pyr = dict(zip(todo, make_images_batch(imgs, fs0.levels)))
        with self._span("round.stage"):
            staged = {i: f for i, f in self._each(
                live, lambda i, fs: fs._stage(*frames[i], pyr=pyr.get(i))
            ).items() if f is not None}
            ids = sorted(staged)

        # 2. LiDAR: one batch, clouds padded to the fleet's largest bucket;
        # camera-only frames stay out of it and take the null scan
        with self._span("round.lidar"):
            scans = {}
            lid = [i for i in ids if staged[i]["cloud"] is not None]
            if self.batch_track and len(lid) >= 2 and self._same(
                    [(fs.w, fs.h) for fs in (self.systems[i] for i in lid)]):
                cap = max(self.systems[i]._bucket_cloud(staged[i]["cloud"])[2]
                          for i in lid)
                with self._stages(lid, "lidar"):
                    with self._span("host.lidar_args", lid):
                        lanes = [self.systems[i]._lidar_args(
                            staged[i]["cloud"], cap) for i in lid]
                    with self._span("host.stack", lid):
                        lanes = [torch.stack(a) for a in zip(*lanes)]
                    out = preprocess_scan_batch(
                        *lanes, w=self.systems[lid[0]].w,
                        h=self.systems[lid[0]].h)
                    scans = {i: {k: v[j] for k, v in out.items()}
                             for j, i in enumerate(lid)}
            self._each(ids, lambda i, fs: fs._lidar(staged[i], scans.get(i)))

        # 3. track requests, and the first attempts as one batch
        with self._span("round.track_inputs"):
            reqs = self._each(ids, lambda i, fs: fs._track_inputs(staged[i]))
        if not self.batch_track:
            # per sequence: retries, veto, keyframe decision and tail
            def finish(i, fs):
                with fs.telemetry.stage("track"):
                    ok = fs._track_result(staged[i], reqs[i])
                fs._finish(staged[i], ok)
            with self._span("round.finish"):
                self._each(ids, finish)
            return
        with self._span("round.track"):
            first = self._batch_track(reqs)

        # 4. per sequence: retries, veto and the keyframe decision
        def decide(i, fs):
            with fs.telemetry.stage("track"):
                ok = fs._track_result(staged[i], reqs[i], first.get(i))
            return fs._decide(staged[i], ok)
        with self._span("round.decide"):
            kinds = {i: k for i, k in self._each(ids, decide).items()
                     if k is not None}
        # 5. the trace of every system, keyframe or not
        with self._span("round.trace"):
            self._trace_phase(staged, sorted(kinds))
        # 6. the keyframe tails: selection, activation, optimization
        kfs = [i for i in sorted(kinds) if kinds[i]]
        if kfs:
            self._keyframe_phase(staged, kfs)
        for i in sorted(kinds):
            self.systems[i].telemetry.frame_done(kinds[i])

    def _trace_phase(self, staged, ids):
        reqs = {i: r for i, r in self._each(
            ids, lambda i, fs: fs._trace_request(staged[i])).items()
            if r is not None}
        for grp in _groups(reqs, _tensor_key):
            fs0 = self.systems[grp[0]]
            if len(grp) == 1:
                with fs0._on_stream(), fs0.telemetry.stage("trace"):
                    fs0._trace_result(trace_points(**reqs[grp[0]],
                                                   w=fs0.w, h=fs0.h))
                continue
            rs = [reqs[i] for i in grp]
            with self._stages(grp, "trace.batch"):
                with self._span("host.stack", grp):
                    lanes = {k: _stack([r[k] for r in rs]) for k in rs[0]
                             if k not in TRACE_FLOATS}
                out = trace_points_lanes(
                    **lanes, **{k: [r[k] for r in rs] for k in TRACE_FLOATS},
                    w=fs0.w, h=fs0.h)
                for j, i in enumerate(grp):
                    fs = self.systems[i]
                    with fs.telemetry.span("host.trace_result"):
                        fs._trace_result({k: v[j] for k, v in out.items()})

    def _keyframe_phase(self, staged, kfs):
        """The keyframe tails of the systems `kfs`: their host steps per
        sequence, their device stages as lanes of one call per group of
        aligned requests."""
        with self._span("round.kf_insert"):
            slots = self._each(kfs, lambda i, fs: fs._kf_insert(staged[i]))

        def insert(i, fs):
            with fs.telemetry.stage("kf.select"):
                fs._new_traces_result(staged[i], slots[i], sels[i])
            fs._insert_residuals(slots[i])
        with self._span("round.select"):
            sels = self._select_phase(staged, slots)
            self._each(kfs, insert)

        with self._span("round.activate"):
            areqs = self._each(kfs, lambda i, fs: fs._activate_request(
                staged[i], slots[i]))
            for grp in _groups(areqs, _activate_key):
                self._activate_group(grp, areqs)
        with self._span("round.commit"):
            self._each(kfs, lambda i, fs: fs._commit_pool_dev(slots[i]))

        with self._span("round.kf_request"):
            kreqs = self._each(kfs, lambda i, fs: fs._kf_opt_request(
                staged[i], slots[i]))
        with self._span("round.kf_opt"):
            for grp in _groups(kreqs, _kf_opt_key):
                self._kf_opt_group(grp, kreqs)

    def _select_phase(self, staged, slots):
        """Drive every keyframe's selection (`FullSystem._select_steps`)
        in rounds: each round's aligned attempts (same statics and shapes)
        run as lanes of one `select_compact_lanes` call. Each system draws
        its directions from its own generator, in its own order.
        Returns {id: selection}."""
        gens = {i: self.systems[i]._select_steps(staged[i], slots[i])
                for i in slots}
        done, pending = {}, {}

        def step(i, reply):
            try:
                pending[i] = gens[i].send(reply)
            except StopIteration as stop:
                done[i] = stop.value

        def steps(replies):
            for i in sorted(replies):
                fs = self.systems[i]
                with fs._on_stream(), fs.telemetry.span("host.select_step"):
                    step(i, replies[i])

        steps(dict.fromkeys(gens))
        while pending:
            reqs, replies = dict(pending), {}
            pending.clear()
            for grp in _groups(reqs, _select_key):
                fs0 = self.systems[grp[0]]
                if len(grp) == 1:
                    with fs0._on_stream(), fs0.telemetry.stage("kf.select"):
                        replies[grp[0]] = run_select(reqs[grp[0]], fs0._np)
                    continue
                rs = [reqs[i] for i in grp]
                with self._stages(grp, "kf.select.batch"):
                    with self._span("host.stack", grp):
                        lanes = [_stack([r["args"][k] for r in rs])
                                 for k in SELECT_LANE_ARGS]
                    out = select_compact_lanes(*lanes, **rs[0]["statics"])
                    host = {k: fs0._np(v) for k, v in out.items()}
                for j, i in enumerate(grp):
                    replies[i] = {k: v[j] for k, v in host.items()}
            steps(replies)
        return done

    def _activate_group(self, grp, areqs):
        if len(grp) == 1:
            fs = self.systems[grp[0]]
            req = areqs[grp[0]]
            with fs._on_stream(), fs.telemetry.stage("kf.activate"):
                dev = kf_ops.activate_full(**req["args"], **req["statics"])
                fs._activate_result(dev, {k: fs._np(dev[k])
                                          for k in ACT_PULL_KEYS})
            return
        rs = [areqs[i] for i in grp]
        with self._stages(grp, "kf.activate.batch"):
            with self._span("host.stack", grp):
                lanes = {k: _stack([r["args"][k] for r in rs])
                         for k in rs[0]["args"] if k not in ACT_HOST_ARGS}
                lanes.update({k: [r["args"][k] for r in rs]
                              for k in ACT_HOST_ARGS})
                statics = _widen([r["statics"] for r in rs], ("a_cap",))
            dev = kf_ops.activate_full_lanes(**lanes, **statics)
            host = {k: self.systems[grp[0]]._np(dev[k])
                    for k in ACT_PULL_KEYS}
        for j, i in enumerate(grp):
            fs = self.systems[i]
            with fs.telemetry.stage("kf.activate"), \
                    fs.telemetry.span("host.activate_result"):
                fs._activate_result(
                    {k: dev[k][j] for k in ("im_valid", "im_status")},
                    {k: v[j] for k, v in host.items()})

    def _kf_opt_group(self, grp, kreqs):
        if len(grp) == 1:
            fs = self.systems[grp[0]]
            req = kreqs[grp[0]]
            with fs._on_stream(), fs.telemetry.stage("kf.opt"):
                fs._kf_opt_result(req, fs._run_kf_opt(req, req["iters"]))
            return
        rs = [kreqs[i] for i in grp]
        with self._stages(grp, "kf.opt.batch"):
            with self._span("host.stack", grp):
                lanes = {k: _stack([r["args"][k] for r in rs])
                         for k in kf_ops.KF_TENSOR_ARGS}
                lanes.update({k: [r["args"][k] for r in rs]
                              for k in kf_ops.KF_HOST_ARGS})
                lanes.update({k: rs[0]["args"][k]
                              for k in kf_ops.KF_SHARED_ARGS})
                lanes["dI_newest_pyr"] = _stack(
                    [tuple(r["args"]["dI_newest_pyr"]) for r in rs])
                statics = _widen([r["statics"] for r in rs],
                                 ("p1_cap", "p2_cap"))
            out = kf_ops.kf_opt_step_lanes(**lanes, **statics)
            keys = dict.fromkeys(k for i in grp
                                 for k in self.systems[i].kf_pull_keys())
            host = {k: self.systems[grp[0]]._np(out[k]) for k in keys}
        # the windowed LM ran every lane to the group's largest count
        fleet_iters = int(host["lm_iters"].max())
        for j, i in enumerate(grp):
            fs = self.systems[i]
            fs.telemetry.counters["ba_lm_iters_fleet"] += fleet_iters
            with fs.telemetry.stage("kf.opt"), \
                    fs.telemetry.span("host.kf_opt_result"):
                fs._kf_opt_result(kreqs[i], kf_ops.lane_of(out, j),
                                  {k: v[j] for k, v in host.items()})

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
            return (_tensor_key(args), r["statics"], r["args"]["cutoff_th"],
                    r["args"]["huber_th"], _tensor_key(r["quad_stack"]))
        if not self._same([key(reqs[i]) for i in ids]):
            return {}
        fs0 = self.systems[ids[0]]
        with self._stages(ids, "track.batch"):
            with self._span("host.upload", ids):
                args = [dict(reqs[i]["args"], try_exclude=fs0._t(
                    reqs[i]["exclude"], torch.bool)) for i in ids]
            out = track_frame_step_batch(
                args, [reqs[i]["etol"] for i in ids],
                [reqs[i]["mdt"] for i in ids], **reqs[ids[0]]["statics"],
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
            self._pool = _worker_pool(min(workers, len(self.systems)),
                                      self.systems)

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
