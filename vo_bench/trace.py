"""The traced rounds: a torch.profiler window over a few fleet rounds after
the measured window, read into the device's busy time, the host's launch
calls, the kernels' roofline shares and the `breakdown` of the result;
`kernels` keeps each kernel's (name, seconds, grid) for the
metric readers that take a roofline share themselves.

Busy time is the union of the intervals in which a kernel, copy or memset
ran on the card (kernels of several streams overlap, so a sum of their
durations would count some time twice). Each telemetry stage of the port
is also opened as a profiler annotation while the rounds are traced, so an
idle gap of the card is labelled by the stage the host was in.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

import torch

from vo_bench import bounds

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
STAGE = "stage:"
WINDOW = "vo_bench.traced_rounds"


@contextlib.contextmanager
def stage_spans():
    """Every telemetry stage opened as a profiler annotation too."""
    from sdv_loam_tpu_torch.io.telemetry import Telemetry

    orig = Telemetry.stage

    @contextlib.contextmanager
    def stage(self, name):
        with torch.profiler.record_function(STAGE + name), orig(self, name):
            yield

    Telemetry.stage = stage
    try:
        yield
    finally:
        Telemetry.stage = orig


def traced(step, n_rounds, cuda=True):
    """Run `step(k)` for k < n_rounds under the profiler; returns the raw
    record for `summarize`: the profiler's trace events (exported to a
    file in TMPDIR, read back and deleted)."""
    from torch.profiler import ProfilerActivity, profile

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with stage_spans(), profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function(WINDOW):
            for k in range(n_rounds):
                step(k)
            sync()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return dict(events=[e for e in events if e.get("ph") == "X"],
                wall_s=wall)


def _union(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _k3_points(rows, lanes_max, caps):
    """(lanes, points per row) of a K3 launch from its rows: the
    hypothesis ladder runs 32 rows a lane on the coarsest level, the
    struct-pose veto 2 rows a lane on level 1, the refinement 3 rows a
    lane on some level, which the record does not tell: its smallest
    pool is taken, so the bound is a floor."""
    if rows % 32 == 0 and rows // 32 <= lanes_max:
        return rows // 32, caps[-1]
    if rows % 3 == 0:
        return rows // 3, caps[-1]
    return max(rows // 2, 1), caps[1]


def summarize(rec, frames, lanes_max, caps):
    """Numbers of the traced rounds (trace times in microseconds)."""
    evs = rec["events"]
    win = [e for e in evs if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    dev = sorted((e for e in evs if e.get("cat") in DEVICE_ACTIVITIES),
                 key=lambda e: e["ts"])
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    busy_s = sum(b - a for a, b in busy) / 1e6
    if win:
        w0 = win[0]["ts"]
        w1 = w0 + win[0]["dur"]
        window_s = (w1 - w0) / 1e6
    else:
        window_s = rec["wall_s"]
    kernels = [e for e in dev if e.get("cat") == "kernel"]
    launches = sum(1 for e in evs if e.get("name") in LAUNCH_CALLS)

    by_name = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    # idle gaps, labelled by the innermost stage the host had open
    stages = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len(STAGE):])
                    for e in evs if e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith(STAGE))
    gaps = {}
    edges = [w0, *(x for a, b in busy for x in (a, b)), w1] if win else []
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        open_ = [s for s in stages if s[0] <= mid <= s[1]]
        label = max(open_)[2] if open_ else "host outside stages"
        gaps[label] = gaps.get(label, 0.0) + (g1 - g0) / 1e6
    idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]

    # K3 and K4: bound over device time; a K4 launch takes the rows of the
    # K3 launch before it on its stream
    k3_b = k3_t = k4_b = k4_t = 0.0
    k3_n = k4_n = 0
    rows_on = {}
    for e in kernels:
        name, args = e["name"], e.get("args", {})
        stream = args.get("stream", e.get("tid"))
        if "track_res_gs_kernel" in name:
            grid = args.get("grid") or [0, 0, 0]
            rows = int(grid[1]) if len(grid) > 1 else 0
            if rows <= 0:
                continue
            lanes, n = _k3_points(rows, lanes_max, caps)
            rows_on[stream] = rows
            k3_b += bounds.track_res_gs(rows, n, lanes)
            k3_t += e["dur"] / 1e6
            k3_n += 1
        elif "lm_step_kernel" in name or "lm_accept_step_kernel" in name:
            rows = rows_on.get(stream)
            if not rows:
                continue
            k4_b += bounds.lm_update(
                rows, "step" if "lm_step_kernel" in name else "accept_step")
            k4_t += e["dur"] / 1e6
            k4_n += 1
    return dict(
        busy_s=busy_s, window_s=window_s, frames=frames,
        launch_calls_per_frame=launches / frames,
        kernels_per_frame=len(kernels) / frames,
        idle_share=1.0 - busy_s / window_s if window_s > 0 else None,
        k3_roofline_pct=100.0 * k3_b / k3_t if k3_t > 0 else None,
        k4_roofline_pct=100.0 * k4_b / k4_t if k4_t > 0 else None,
        k3_launches=k3_n, k4_launches=k4_n,
        kernels=[(e["name"], e["dur"] / 1e6,
                  tuple(int(g) for g in e.get("args", {}).get("grid") or ()))
                 for e in kernels],
        breakdown=dict(device_ops=[[k, v] for k, v in device_ops],
                       idle_gaps=[[k, v] for k, v in idle_gaps]))
