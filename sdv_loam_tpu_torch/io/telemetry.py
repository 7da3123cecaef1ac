"""Telemetry: per-stage timing, host spans, run summary, and structured
logging.

Reference observability surface (SURVEY.md §5):
  * wall-clock + CPU-clock run summary printed at exit with fps and
    ms/frame (main.cpp:948-963);
  * per-KF log line — window size, residual counts, RMSE
    (FullSystem.cpp:1371-1415, printLogLine);
  * the deep-log streams (calib/coarse-tracking/eigenvalue logs,
    FullSystem.cpp:119-176) — here one structured JSONL stream.

The port adds spans (the reference has none). A span is a named interval
of host time recorded into `stage_time` / `stage_count`; a stage is a span
that, with `device_sync` set, ends by waiting for the device work it
queued, that wait timed as its child span `wait.stage_end`. Host readbacks
are `wait.readback` spans (`FullSystem._np`), a system's uploads from host
arrays `wait.upload` spans (`FullSystem._t`: on CUDA a copy from pageable
memory waits for the stream first). `spans` records one interval
into several systems' tables at once: a lockstep fleet's round phases
(`round.*`) and batched stages. While the autograd profiler records, every
span is also a `record_function("stage:<name>")` annotation on the
profiler's clock (one per call, whatever the number of systems), so an idle
gap of the device trace is labelled by the innermost span open on the
host; otherwise a span reads one flag and makes no profiler call. With a
log path every span is also written as a JSONL record (name, parent, the
frame's shell id, start and end on `time.perf_counter`).
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager

import torch
from torch.autograd import profiler as _profiler

# the annotations' name space (what a profiler trace's reader looks for)
ANNOTATION = "stage:"
WAIT_STAGE_END = "wait.stage_end"
WAIT_READBACK = "wait.readback"
WAIT_UPLOAD = "wait.upload"


def annotation(name: str):
    """`torch.profiler.record_function("stage:<name>")`, entered, while the
    autograd profiler records; else None, and nothing was made or called.
    Pass the result to `end_annotation`."""
    if not _profiler._is_profiler_enabled:
        return None
    rf = torch.profiler.record_function(ANNOTATION + name)
    rf.__enter__()
    return rf


def end_annotation(rf) -> None:
    if rf is not None:
        rf.__exit__(None, None, None)


@contextmanager
def spans(telemetries, name: str, sync: bool = False):
    """One span `name` over the telemetries of several systems, timed once
    and recorded in each with its full time (one annotation). `sync`: a
    stage of each: at exit the first telemetry's `device_sync` runs (the
    systems share its stream), timed as its `wait.stage_end`."""
    rf = annotation(name)
    for t in telemetries:
        t._stack.append(name)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        lead = telemetries[0]
        try:
            if sync and lead.device_sync is not None:
                with spans((lead,), WAIT_STAGE_END):
                    lead.device_sync()
        finally:
            t1 = time.perf_counter()
            for t in telemetries:
                t._record(name, t0, t1)
            end_annotation(rf)


class Telemetry:
    def __init__(self, log_path: str | None = None, quiet: bool = True,
                 device_sync=None):
        self.stage_time = defaultdict(float)
        self.stage_count = defaultdict(int)
        # time spent in nested spans: waits (`wait.*`) and the others
        self.child_time = defaultdict(float)
        self.wait_time = defaultdict(float)
        self._stack = []
        self.n_frames = 0
        self.n_keyframes = 0
        self.counters = defaultdict(int)   # e.g. matcher overflow totals
        self.t_start = time.perf_counter()
        # the first and the last frame_done (summary's fps)
        self.t_first = self.t_last = None
        # the shell id of the frame in progress (span records)
        self.frame_id = None
        self.quiet = quiet
        self._log_f = open(log_path, "w") if log_path else None
        # called at every stage exit so a stage's time includes the device
        # work it queued (a CUDA system's wait on its own stream)
        self.device_sync = device_sync

    def span(self, name: str):
        """Context: host span `name` (no device wait at its end)."""
        return spans((self,), name)

    def stage(self, name: str):
        """Context: stage `name`, a span that ends with `device_sync`."""
        return spans((self,), name, sync=True)

    def _record(self, name, t0, t1):
        dt = t1 - t0
        self.stage_time[name] += dt
        self.stage_count[name] += 1
        self._stack.pop()
        parent = self._stack[-1] if self._stack else None
        if parent is not None:
            (self.wait_time if name.startswith("wait.")
             else self.child_time)[parent] += dt
        if self._log_f:
            self.log_event("span", name=name, parent=parent,
                           frame=self.frame_id, start=t0, end=t1)

    def frame_done(self, is_kf: bool):
        self.t_last = time.perf_counter()
        if self.t_first is None:
            self.t_first = self.t_last
        self.n_frames += 1
        if is_kf:
            self.n_keyframes += 1

    def log_event(self, kind: str, **fields):
        if self._log_f:
            self._log_f.write(json.dumps({"t": time.perf_counter() - self.t_start,
                                          "kind": kind, **fields}) + "\n")

    def kf_line(self, n_window: int, n_points: int, n_residuals: int,
                rmse: float):
        """Per-keyframe log line (printLogLine, FullSystem.cpp:1371-1415)."""
        self.log_event("keyframe", window=n_window, points=n_points,
                       residuals=n_residuals, rmse=rmse)
        if not self.quiet:
            print(f"KF {self.n_keyframes}: window={n_window} "
                  f"pts={n_points} res={n_residuals} rmse={rmse:.3f}")

    def log_hessian(self, kf_id: int, H, b, nullspaces):
        """Deep-log streams of the final BA Hessian (setting_logStuff,
        FullSystem.cpp:1419-1499): eigenvalue spectrum of the assembled
        system (eigenAllLog), of its pose block (eigenPLog), its diagonal
        (DiagonalLog), the TRUE marginal variances diag(H^-1)
        (variancesLog — the reference uses lastHS.inverse().diagonal(),
        :1488), and the nullspace products n·Hn / n·b per gauge+scale
        direction (nullspacesLog, :1493-1497). The reference's eigenALog
        (affine-block spectrum) has no equivalent: this build keeps a,b
        out of the BA state (PARITY.md §2.4 — affine is estimated by the
        tracker and transferred, not bundle-adjusted)."""
        import numpy as np
        H = np.asarray(H, np.float64)
        b = np.asarray(b, np.float64)
        Ns = np.asarray(nullspaces, np.float64)
        Hs = 0.5 * (H + H.T)
        eig = np.linalg.eigvalsh(Hs)
        eig_p = np.linalg.eigvalsh(Hs[4:, 4:])     # pose block (CPARS=4)
        diag = np.diag(H)
        try:
            variances = np.diag(np.linalg.inv(
                Hs + np.eye(Hs.shape[0]) * 1e-12))
        except np.linalg.LinAlgError:
            with np.errstate(divide="ignore"):
                variances = np.where(diag > 0, 1.0 / diag, 0.0)
        hn = np.einsum("dk,dj,jk->k", Ns, Hs, Ns)  # n·Hn (nullspacesLog)
        bn = Ns.T @ b
        self.log_event(
            "hessian", kf=int(kf_id),
            eigen_all=[float(x) for x in np.sort(eig)],
            eigen_pose=[float(x) for x in np.sort(eig_p)],
            diagonal=[float(x) for x in diag],
            variances=[float(x) for x in variances],
            nullspace_H_prods=[float(x) for x in hn],
            nullspace_b_prods=[float(x) for x in bn])

    def track_line(self, frame_id: int, timestamp: float, exposure: float,
                   xi, aff, res0: float, try_iterations: int):
        """Per-frame coarse-tracking stream (coarseTrackingLog,
        FullSystem.cpp:502-512): frame id, timestamp, exposure, camToWorld
        log, affine a/b, achieved level-0 residual, ladder tries."""
        self.log_event(
            "coarse_tracking", frame=int(frame_id), ts=float(timestamp),
            exposure=float(exposure), xi=[float(x) for x in xi],
            aff=[float(aff[0]), float(aff[1])], res0=float(res0),
            tries=int(try_iterations))

    def nums_line(self, kf_id: int, rmse: float, created: int,
                  activated: int, dropped: int, opt_its: int, res_active:
                  int, res_marg: int, aff, window_span: int, window: int):
        """Per-keyframe statistics stream (numsLog,
        FullSystem.cpp:1392-1411). resInL (the reference's always-
        linearized set) has no equivalent: this build re-linearizes every
        active residual each LM step (dense fixed-shape pools)."""
        self.log_event(
            "nums", kf=int(kf_id), rmse=float(rmse), created=int(created),
            activated=int(activated), dropped=int(dropped),
            opt_its=int(opt_its), res_active=int(res_active),
            res_marg=int(res_marg), aff=[float(aff[0]), float(aff[1])],
            window_span=int(window_span), window=int(window))

    def log_lifetimes(self, shells):
        """Frame-lifetime dump (printFrameLifetimes,
        FullSystem.cpp:1501-1532): one record per frame — id,
        keyframe/marginalization bookkeeping, and how far the optimizer
        moved it off its tracked pose (movedByOpt)."""
        import numpy as np
        for sh in shells:
            moved = 0.0
            if "T_wc_tracked" in sh and "T_wc" in sh:
                d = np.linalg.inv(sh["T_wc_tracked"]) @ sh["T_wc"]
                moved = float(np.linalg.norm(d[:3, 3]))
            self.log_event(
                "lifetime", frame=int(sh.get("id", -1)),
                ts=float(sh.get("timestamp", 0.0)),
                is_kf=bool(sh.get("is_kf", False)),
                marginalized_at=int(sh.get("marginalized_at", -1)),
                moved_by_opt=moved,
                n_matched=int(sh.get("n_matched", -1)))

    def summary(self) -> dict:
        """Run summary in the shape of main.cpp:948-963; `fps` and
        `ms_per_frame` over the frames after the first (first to last
        `frame_done`), so set-up and the first frame's work stay out."""
        wall = time.perf_counter() - self.t_start
        n = self.n_frames - 1
        run = self.t_last - self.t_first if n > 0 else 0.0
        out = {
            "frames": self.n_frames,
            "keyframes": self.n_keyframes,
            "wall_s": round(wall, 3),
            "fps": round(n / run, 2) if run > 0 else 0.0,
            "ms_per_frame": round(1000.0 * run / n, 2) if n > 0 else 0.0,
            "stages_ms": {k: round(1000.0 * v / max(self.stage_count[k], 1), 2)
                          for k, v in sorted(self.stage_time.items())},
            "kf_rate": round(self.n_keyframes / max(self.n_frames, 1), 3),
            "counters": dict(self.counters),
        }
        return out

    def stage_table(self) -> str:
        """Human-readable per-span table: total time, call count, and the
        host vs device-wait split. `wait_s` is the span's nested `wait.*`
        spans (stage-end waits and readbacks), `child_s` its other nested
        spans; `host_s` is EXCLUSIVE of both, so a parent stage like
        `keyframe` shows only its own host Python."""
        lines = [f"{'span':<22}{'calls':>7}{'total_s':>10}{'child_s':>10}"
                 f"{'wait_s':>10}{'host_s':>10}"]
        for k in sorted(self.stage_time, key=self.stage_time.get,
                        reverse=True):
            tot = self.stage_time[k]
            chd = self.child_time.get(k, 0.0)
            wt = self.wait_time.get(k, 0.0)
            lines.append(f"{k:<22}{self.stage_count[k]:>7}{tot:>10.2f}"
                         f"{chd:>10.2f}{wt:>10.2f}{tot - chd - wt:>10.2f}")
        return "\n".join(lines)

    def close(self):
        if self._log_f:
            self._log_f.close()
            self._log_f = None
