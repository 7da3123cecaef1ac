"""FullSystem — the odometry orchestrator.

Counterpart of `sdv_loam_tpu/system/full_system.py` (reference
src/FullSystem/FullSystem.cpp + FullSystemOptimize/Marginalize/OptPoint).
Host-side control flow (keyframe policy, window bookkeeping, pool
lifecycle) in numpy drives the torch stages on the system's device:

  frame (addActiveFrame, FullSystem.cpp:822-900):
    pyramid -> LiDAR preprocess -> [init | track step] -> KF decision
    -> makeKeyFrame / makeNonKeyFrame (trace)
  keyframe (makeKeyFrame, FullSystem.cpp:1040-1174):
    trace -> flag marg -> insert frame -> selection (new traces)
    -> residual insertion -> activation -> kf_opt (matcher refresh, BA,
    outliers, tracking reference, point/frame marginalization)

A frame runs as five phases, plain methods that each mode calls in turn:
`_stage` (pyramid, shell; the first frame and the initialization),
`_lidar`, `_track_inputs`, `_track_result` (launch, readback, the host
retry ladder) and `_finish` (keyframe decision, trace or keyframe tail).

  * sequential mode (default, reference parity) calls them in order, every
    value the host needs read back where it is used;
  * pipelined mode (`Settings.pipelined_frames`, the JAX package's analog
    of the reference's tracking/mapping thread overlap) defers the
    readback and `_finish` of frame N to the call of frame N+1, after N+1's
    pyramid is staged: the deferral point is between staging and
    tracking, so the trajectory matches sequential mode; `is_lost` and the
    shell poses lag one frame, and `flush()` (or `get_trajectory`) drains;
  * with `deferred_kf_readback` as well, the keyframe optimization's
    control readback waits for the next drain: the next frame tracks
    against window constants built on the device from its outputs;
  * the lockstep fleet (`system.multi.MultiSystem`) runs the phases of B
    sequential systems side by side and batches the pyramid, LiDAR and
    first track attempt over them, then, past the keyframe decision, the
    keyframe tail's stages: trace, selection, activation and the keyframe
    optimization. Each of those stages is a pair of methods, one that
    builds the device request from the host state and one that applies
    the device result (`_trace_request` / `_trace_result`,
    `_select_steps` / `_new_traces_result`, `_activate_request` /
    `_activate_result`, `_kf_opt_request` / `_kf_opt_result`), so a
    fleet can run the requests of several systems as lanes of one call
    while the host bookkeeping between the stages stays per sequence.

A frame without a cloud is camera-only: the first one starts the
monocular bootstrap (ops/mono_init), whose ready frame becomes the second
keyframe with the initializer's pose; a later one (LiDAR dropout) takes a
null scan, so its keyframe selection runs the monocular branch only.
Observers (io/observer) get every tracked pose and, after each keyframe's
host readback, the window; `Settings.log_stuff` adds the deep-log streams
(track, nums and Hessian lines).

The JAX package's generator/yield protocol (which batches readbacks over a
TPU link) is not ported. On CUDA every public call runs on the system's own
stream, and a stage boundary waits for that stream only, so systems on
other streams keep running.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from sdv_loam_tpu_torch.config import Settings
from sdv_loam_tpu_torch.data.calib import SensorCalib
from sdv_loam_tpu_torch.io.telemetry import Telemetry
from sdv_loam_tpu_torch.models import backend
from sdv_loam_tpu_torch.models.matcher import stack_quads
from sdv_loam_tpu_torch.ops import lidar as lidar_ops
from sdv_loam_tpu_torch.ops import trace as trace_ops
from sdv_loam_tpu_torch.ops.align import flatten_pyramid
from sdv_loam_tpu_torch.ops.frame_step import track_frame_step
from sdv_loam_tpu_torch.ops.mono_init import MonoInitializer
from sdv_loam_tpu_torch.ops.photometric import build_track_ref, splat_idepth
from sdv_loam_tpu_torch.ops.pyramid import make_images
from sdv_loam_tpu_torch.ops.select import (cascade_direction_draws,
                                           drive_steps, make_maps_compact,
                                           make_maps_compact_steps,
                                           run_select)
from sdv_loam_tpu_torch.ops.trace import pattern_colors
from sdv_loam_tpu_torch.system import kf_ops
from sdv_loam_tpu_torch.utils import se3
from sdv_loam_tpu_torch.utils.camera import PyramidCalib

CORNER = 0
EDGELET = 1

# track step outputs the host reads back
TRACK_KEYS = ("T_ref_to_fh", "T_wc", "aff", "res", "flow", "ok", "n_matched",
              "best_try", "lvl_iters")
# keyframe optimization outputs the host reads back
KF_PULL_KEYS = ("eps", "calib", "T_cw_fej", "feth", "energy", "HM", "bM",
                "stats_out", "idepth", "new_state", "pt_valid",
                "num_good_res", "idepth_hessian", "res_active",
                "match_overflow", "match_diag", "match_diag_p2", "res_diag",
                "death_diag", "lm_iters")
# ... and, with Settings.log_stuff, the deep-log exports
KF_LOG_KEYS = ("H_final", "b_final", "nullspaces")
# activation outputs the host reads back
ACT_PULL_KEYS = ("dead", "kill", "drop_oob", "cand_idx", "lane_valid",
                 "success", "idepth", "inlier_targets")


def _rotation_ladder(rot_delta=0.02):
    """The 26 unit-quaternion rotation perturbations of trackNewCoarse
    (FullSystem.cpp:341-398)."""
    out = []
    d = rot_delta
    combos = [(d, 0, 0), (0, d, 0), (0, 0, d), (-d, 0, 0), (0, -d, 0),
              (0, 0, -d), (d, d, 0), (0, d, d), (d, 0, d), (-d, d, 0),
              (0, -d, d), (-d, 0, d), (d, -d, 0), (0, d, -d), (d, 0, -d),
              (-d, -d, 0), (0, -d, -d), (-d, 0, -d), (-d, -d, -d),
              (-d, -d, d), (-d, d, -d), (-d, d, d), (d, -d, -d), (d, -d, d),
              (d, d, -d), (d, d, d)]
    for (x, y, z) in combos:
        q = np.array([1.0, x, y, z])
        q = q / np.linalg.norm(q)
        w, xi, yi, zi = q
        R = np.array([
            [1 - 2 * (yi * yi + zi * zi), 2 * (xi * yi - zi * w),
             2 * (xi * zi + yi * w)],
            [2 * (xi * yi + zi * w), 1 - 2 * (xi * xi + zi * zi),
             2 * (yi * zi - xi * w)],
            [2 * (xi * zi - yi * w), 2 * (yi * zi + xi * w),
             1 - 2 * (xi * xi + yi * yi)]])
        T = np.eye(4)
        T[:3, :3] = R
        out.append(T)
    return out


class FullSystem:
    """The LiDAR-assisted semi-direct visual odometry system on one device
    (CUDA unless the caller asks for the CPU)."""

    N_TRIES_CAP = 64

    def __init__(self, calib: PyramidCalib, sensor: SensorCalib,
                 settings: Settings | None = None, observers=None,
                 telemetry=None, device="cuda"):
        s = settings or Settings()
        self.calib = calib
        self.sensor = sensor
        self.s = s
        self.observers = list(observers or [])
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "FullSystem runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU")
        # every public call runs on this stream (CUDA); a fleet's systems
        # then overlap on the card instead of queueing behind each other
        self.stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self.telemetry = telemetry or Telemetry()
        # a stage ends when the system's own stream has finished it
        # (sequential mode); pipelined mode leaves the device running
        # across stage ends, which is its point
        self.telemetry.device_sync = self._sync_stream \
            if self.stream is not None and not s.pipelined_frames else None
        with self._on_stream():
            self._init_state(calib, s)

    def _init_state(self, calib, s):

        self.w = calib.w[0]
        self.h = calib.h[0]
        self.levels = calib.levels
        self.K0 = np.array(calib.intrinsics_vec(0), np.float32)
        self.Ks = tuple(self._t([calib.fx[l], calib.fy[l], calib.cx[l],
                                 calib.cy[l]]) for l in range(self.levels))

        self.F = s.n_frames_cap
        self.N = s.n_active_cap
        self.M = s.n_immature_cap
        F, N, M = self.F, self.N, self.M
        D = 4 + 6 * F

        self.slot_used = np.zeros(F, bool)
        self.order: list[int] = []
        self.T_cw_fej = np.tile(np.eye(4), (F, 1, 1))
        self.eps = np.zeros((F, 6))
        self.aff = np.zeros((F, 2), np.float32)
        self.exposure = np.ones(F, np.float32)
        self.fe_th = np.full(F, 12.0 * 12.0 * 8.0, np.float32)
        self.frame_prior = np.zeros((F, 6), np.float32)
        self.frame_kf_id = np.full(F, -1, np.int64)
        self.frame_shell_idx = np.full(F, -1, np.int64)
        self.slot_flagged = np.zeros(F, bool)
        self.slot_stats_out = np.zeros(F, np.int64)
        self.dI0_stack = torch.zeros((F, self.h, self.w, 3),
                                     dtype=torch.float32, device=self.device)
        self.pyr_slots: list = [None] * F
        self.flat_slots: list = [None] * F

        self.pt_valid = np.zeros(N, bool)
        self.pt = dict(
            u=np.zeros(N, np.float32), v=np.zeros(N, np.float32),
            idepth=np.zeros(N, np.float32), host=np.zeros(N, np.int32),
            color=np.zeros((N, 8), np.float32),
            weights=np.zeros((N, 8), np.float32),
            is_sensor=np.zeros(N, bool), type=np.zeros(N, np.int32),
            prior=np.zeros(N, np.float32), quality=np.zeros(N, np.float32),
            idepth_hessian=np.zeros(N, np.float32),
            num_good_res=np.zeros(N, np.int64),
        )
        self.res_active = np.zeros((N, F), bool)
        self.res_state = np.zeros((N, F), np.int8)
        self.res_is_new = np.zeros((N, F), bool)
        self.matcher_px = np.zeros((N, F, 2), np.float32)
        self.matcher_valid = np.zeros((N, F), bool)
        self.centers = np.zeros((N, F, 3), np.float32)

        self.im_valid = np.zeros(M, bool)
        self.im = dict(
            u=np.zeros(M, np.float32), v=np.zeros(M, np.float32),
            idepth_min=np.zeros(M, np.float32),
            idepth_max=np.full(M, np.inf, np.float32),
            host=np.zeros(M, np.int32),
            status=np.full(M, trace_ops.IPS_UNINITIALIZED, np.int32),
            quality=np.full(M, 10000.0, np.float32),
            color=np.zeros((M, 8), np.float32),
            weights=np.zeros((M, 8), np.float32),
            gradH=np.zeros((M, 3), np.float32),
            energy_th=np.full(M, 8 * 144.0, np.float32),
            is_sensor=np.zeros(M, bool),
            pixel_interval=np.zeros(M, np.float32),
            my_type=np.ones(M, np.float32),
            type=np.zeros(M, np.int32),
            grad_center=np.zeros(M, np.float32),
        )

        self.HM = np.zeros((D, D))
        self.bM = np.zeros(D)

        self.shells: list[dict] = []
        self.kf_shells: list[int] = []

        self.track_ref = None
        self.track_ref_slot = -1
        self.track_ref_aff = np.zeros(2, np.float32)
        self.first_coarse_rmse = -1.0
        self.last_coarse_rmse = np.full(5, 100.0)
        self.current_min_act_dist = 2.0
        self.pot_state = {"pot": 3}
        self.pot_state_mono = {"pot": 3}
        self.ignore_kf = False

        self._im_pool = None
        self._trace_fresh = False
        self._kf_dev = None
        self._centers_dev = None
        self._track_const = None
        self._last_act = None
        self.track_iters_hist: list = []
        self._track_step_hist: list = []
        self.kf_decision_hist: list = []
        self.flag_hist: list = []
        self.initialized = False
        self.is_lost = False
        self.init_failed = False
        self._mono = None          # camera-only bootstrap (ops/mono_init)
        self._first_frame = None
        # the selection cascade's random direction grids; the keep
        # sub-sampling draws from numpy's default_rng(seed) like the JAX
        # package
        self._gen = torch.Generator().manual_seed(int(s.seed))
        self._lidar_cap = s.n_lidar_cand_cap * 8
        self._pending = None        # pipelined mode: the frame in flight
        self._deferred_kf = None    # deferred keyframe control readback

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _t(self, x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    @staticmethod
    def _np(x):
        return x.detach().cpu().numpy()

    def _on_stream(self):
        """Context that makes the system's stream current (CUDA)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _sync_stream(self):
        self.stream.synchronize()

    def _use_stream(self, stream):
        """Move the system onto `stream` (the lockstep fleet's): the new
        stream first waits for the old one's work, and every tensor the
        system holds is marked as used on the new stream, so the allocator
        does not hand its memory out before the new stream is done."""
        if self.stream is None or stream == self.stream:
            return
        stream.wait_stream(self.stream)
        todo = list(vars(self).values())
        while todo:
            x = todo.pop()
            if isinstance(x, torch.Tensor):
                if x.device.type == "cuda":
                    x.record_stream(stream)
            elif isinstance(x, dict):
                todo.extend(x.values())
            elif isinstance(x, (list, tuple)):
                todo.extend(x)
        self.stream = stream

    def _upload_image(self, image):
        """The frame's image on the device; on CUDA copied from pinned
        memory without blocking, so the upload overlaps queued work."""
        x = torch.from_numpy(np.ascontiguousarray(image, dtype=np.float32))
        if self.device.type != "cuda":
            return x
        return x.pin_memory().to(self.device, non_blocking=True)

    def _to_host_async(self, tensors: dict):
        """Start the device-to-host copies of `tensors` into pinned memory
        and return (host tensors, event) without waiting (CUDA); on the CPU
        the tensors are their own host copies."""
        if self.device.type != "cuda":
            return tensors, None
        host = {}
        for k, v in tensors.items():
            hv = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            hv.copy_(v, non_blocking=True)
            host[k] = hv
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return host, ev

    def _from_host(self, pending):
        """Wait for a `_to_host_async` copy; returns numpy arrays."""
        host, ev = pending
        if ev is not None:
            ev.synchronize()
        return {k: self._np(v) for k, v in host.items()}

    @property
    def T_cw(self) -> np.ndarray:
        """(F, 4, 4) current worldToCam per slot: exp(eps) * T_fej."""
        return se3.se3_exp_np(self.eps) @ self.T_cw_fej

    def _draw_dirs(self, pot):
        return cascade_direction_draws(self.h, self.w, pot, self._gen,
                                       self.device)

    def _dir_source(self):
        """The direction draws of one selection call (`draw_dirs(pot)` per
        attempt): the system's own generator, in the order the system
        draws."""
        return self._draw_dirs

    def _bucket_cloud(self, cloud: np.ndarray, cap: int | None = None):
        """Pad a raw cloud to a capacity bucket. `cap` overrides the
        per-cloud choice: the lockstep fleet pads its sequences' clouds to
        one shared bucket so their scans run as lanes of one batch."""
        if cap is None:
            cap = self._lidar_cap
            for b in (self._lidar_cap // 4, self._lidar_cap // 2):
                if cloud.shape[0] <= b:
                    cap = b
                    break
        buf = np.zeros((cap, 3), np.float32)
        n = min(cloud.shape[0], cap)
        buf[:n] = cloud[:n]
        mask = np.zeros(cap, bool)
        mask[:n] = True
        return buf, mask, cap

    def _lidar_args(self, cloud: np.ndarray, cap: int | None = None):
        """One lane of `lidar_ops.preprocess_scan_batch`: (cloud, mask,
        R_cl, t_cl, K) with the current (BA-refined) intrinsics."""
        buf, mask, _ = self._bucket_cloud(cloud, cap)
        return (self._t(buf), self._t(mask, torch.bool),
                self._t(self.sensor.R_cl), self._t(self.sensor.t_cl),
                self._t(self.K0))

    def _preprocess(self, cloud: np.ndarray):
        out = lidar_ops.preprocess_scan_batch(
            *(a[None] for a in self._lidar_args(cloud)), self.w, self.h)
        return {k: v[0] for k, v in out.items()}

    def _free_pt_rows(self, n):
        return np.nonzero(~self.pt_valid)[0][:n]

    def _free_im_rows(self, n):
        return np.nonzero(~self.im_valid)[0][:n]

    def _pair_transforms(self):
        """(F*F) host->target R/t/affine for used slot pairs."""
        T_cw_f = self.T_cw
        F = self.F
        R_pair = np.tile(np.eye(3, dtype=np.float32), (F * F, 1, 1))
        t_pair = np.zeros((F * F, 3), np.float32)
        aff_pair = np.tile(np.array([1.0, 0.0], np.float32), (F * F, 1))
        for hslot in range(F):
            if not self.slot_used[hslot]:
                continue
            T_wc_h = np.linalg.inv(T_cw_f[hslot])
            for tslot in range(F):
                if not self.slot_used[tslot]:
                    continue
                p = hslot * F + tslot
                T_ht = T_cw_f[tslot] @ T_wc_h
                R_pair[p] = T_ht[:3, :3]
                t_pair[p] = T_ht[:3, 3]
                a = np.exp(self.aff[tslot][0] - self.aff[hslot][0])
                aff_pair[p] = [a, self.aff[tslot][1] - a * self.aff[hslot][1]]
        return R_pair, t_pair, aff_pair

    def _kf_dev_pool(self):
        """Device active-point pool, built once from the host arrays and
        then chained through the keyframe stages."""
        if self._kf_dev is None:
            pt, t = self.pt, self._t
            self._kf_dev = dict(
                u=t(pt["u"]), v=t(pt["v"]), idepth=t(pt["idepth"]),
                host=t(pt["host"], torch.int64),
                color=t(pt["color"]), weights=t(pt["weights"]),
                is_sensor=t(pt["is_sensor"], torch.bool),
                prior=t(pt["prior"]), type=t(pt["type"], torch.int64),
                quality=t(pt["quality"]),
                num_good_res=t(pt["num_good_res"], torch.int64),
                idepth_hessian=t(pt["idepth_hessian"]),
                pt_valid=t(self.pt_valid, torch.bool),
                res_active=t(self.res_active, torch.bool),
                res_state=t(self.res_state, torch.int8),
                res_is_new=t(self.res_is_new, torch.bool),
                matcher_px=t(self.matcher_px),
                matcher_valid=t(self.matcher_valid, torch.bool))
        return self._kf_dev

    _IM_DTYPES = dict(host=torch.int64, status=torch.int64,
                      is_sensor=torch.bool)

    def _im_pool_dev(self):
        """Device immature pool (IM_FIELDS + im_valid); invalid rows carry
        status OOB so traces skip them."""
        if self._im_pool is None:
            p = {f: self._t(self.im[f], self._IM_DTYPES.get(f, torch.float32))
                 for f in kf_ops.IM_FIELDS}
            p["status"] = self._t(np.where(self.im_valid, self.im["status"],
                                           trace_ops.IPS_OOB), torch.int64)
            p["im_valid"] = self._t(self.im_valid, torch.bool)
            self._im_pool = p
        return self._im_pool

    def _sync_pool_mirrors(self):
        """Pull the device matcher store and residual centers back to the
        host mirrors (checkpoint only)."""
        if self._kf_dev is None:
            return
        self.matcher_px = self._np(self._kf_dev["matcher_px"]).astype(
            np.float32)
        self.matcher_valid = self._np(self._kf_dev["matcher_valid"])
        if self._centers_dev is not None:
            self.centers = self._np(self._centers_dev).astype(np.float32)

    def _sync_immature(self):
        """Pull the device trace state back into the host pool."""
        if not self._trace_fresh or self._im_pool is None:
            return
        im = self.im
        upd = self.im_valid & (~im["is_sensor"])
        for k in ("idepth_min", "idepth_max", "quality", "pixel_interval"):
            im[k][upd] = self._np(self._im_pool[k])[upd]
        im["status"][upd] = self._np(self._im_pool["status"])[upd]
        self._trace_fresh = False

    # ------------------------------------------------------------------
    # main entry (addActiveFrame)
    # ------------------------------------------------------------------

    def add_active_frame(self, image: np.ndarray, cloud: np.ndarray | None,
                         timestamp: float, exposure: float = 1.0):
        """Process one frame (image (H, W) intensities, cloud (N, 3)
        LiDAR-frame points, or None for a camera-only frame). In pipelined
        mode the frame's readback and keyframe work happen in the next call
        (or `flush`)."""
        with self._on_stream():
            if self.s.pipelined_frames and self.initialized \
                    and not self.is_lost and len(self.shells) >= 2:
                self._add_pipelined(image, cloud, timestamp, exposure)
                return
            self._drain_pending()
            frame = self._stage(image, cloud, timestamp, exposure)
            if frame is None:
                return
            self._lidar(frame)
            with self.telemetry.stage("track"):
                ok = self._track_result(frame, self._track_inputs(frame))
            self._finish(frame, ok)

    def _add_pipelined(self, image, cloud, timestamp, exposure):
        """Pipelined frame (the JAX package's `_add_active_frame`): stage
        this frame, then finish the previous one (its track result has had
        this frame's staging time to arrive), then launch this frame's
        track and leave it in flight."""
        frame = self._stage(image, cloud, timestamp, exposure)
        self._drain_pending()
        if self.is_lost:
            # the drained frame lost tracking: this frame takes the lost
            # semantics (keep recording shells with the last pose)
            self.shells[-1]["T_wc"] = self.shells[-2]["T_wc"].copy()
            self.telemetry.frame_done(False)
            return
        self._lidar(frame)
        with self.telemetry.stage("track"):
            req = self._track_inputs(frame)
            out = self._dispatch_track(req, req["exclude"])
            launched = self._to_host_async({k: out[k] for k in TRACK_KEYS})
        self._pending = (frame, req, launched)

    def _drain_pending(self):
        """Finish the pipelined frame in flight (track readback, keyframe
        decision, trace or keyframe tail). A deferred keyframe readback
        from the previous drain resolves first: the host mirrors must be
        fresh before this frame's keyframe work. Idempotent."""
        self._resolve_deferred_kf()
        if self._pending is None:
            return
        frame, req, launched = self._pending
        self._pending = None
        with self.telemetry.stage("track.finish"):
            ok = self._track_result(frame, req, first=self._from_host(launched))
        self._finish(frame, ok)

    def flush(self):
        """Finish any pipelined in-flight frame (call at sequence end)."""
        with self._on_stream():
            self._drain_pending()
            # the drained frame may itself have been a keyframe that
            # deferred its control readback
            self._resolve_deferred_kf()

    def _stage(self, image, cloud, timestamp, exposure=1.0, pyr=None):
        """Phase 1: the pyramid (or `pyr`, one the lockstep fleet built in
        a batch) and the frame's shell; the first frame and the
        initialization. Returns the frame to track, or None when the frame
        ends here."""
        if self.is_lost:
            # keep recording shells with the last pose so the trajectory
            # stays dense (reference stops processing, FullSystem.cpp:824)
            last = self.shells[-1]["T_wc"] if self.shells else np.eye(4)
            self.shells.append(dict(id=len(self.shells), timestamp=timestamp,
                                    T_wc=last.copy(), aff=np.zeros(2),
                                    is_kf=False))
            return None
        if pyr is None:
            with self.telemetry.stage("pyramid"):
                pyr = make_images(self._upload_image(image), self.levels)
        dI, abs_grad = pyr
        shell = dict(id=len(self.shells), timestamp=timestamp,
                     T_wc=np.eye(4), aff=np.zeros(2), is_kf=False)
        self.shells.append(shell)
        frame = dict(dI=dI, abs_grad=abs_grad, shell=shell, cloud=cloud,
                     exposure=float(exposure), flat=flatten_pyramid(dI))

        if not self.initialized:
            if self._mono is not None:
                self._bootstrap_frame(frame)
                return None
            if cloud is None:
                # no LiDAR on the first frame: start the camera-only
                # bootstrap (the reference's setFirst path)
                self._mono = MonoInitializer(self.calib, self.s)
                self._mono.set_first(dI, abs_grad)
                frame.pop("cloud")
                self._first_frame = frame
                self.telemetry.frame_done(False)
                return None
            self._lidar(frame)
            self._first_frame = frame
            self.initialized = True
            self.telemetry.frame_done(False)
            return None

        if len(self.shells) == 2:
            self._initialize()
        return frame

    def _bootstrap_frame(self, frame):
        """A frame of the camera-only bootstrap: feed the mono initializer
        until it snaps and settles (trackFrame, CoarseInitializer.cpp:
        50-230); the ready frame becomes the second keyframe with the
        initializer's pose (initializeFromInitializer), without
        photometric tracking."""
        frame.pop("cloud")
        if not self._mono.track_frame(frame["dI"]):
            self.telemetry.frame_done(False)
            return
        self._initialize_mono(frame)
        frame["scan"] = self._null_scan()
        frame["flow"] = np.zeros(3)
        frame["track_rmse"] = 0.0
        with self.telemetry.stage("keyframe"):
            self._make_key_frame(frame)
        self.telemetry.frame_done(True)

    def _lidar(self, frame, scan=None):
        """Phase 2: LiDAR preprocessing (or `scan`, a lane of the lockstep
        fleet's batch); a camera-only frame takes the null scan. Not
        staging: the projection uses the BA-refined intrinsics, which the
        previous frame's keyframe may change."""
        cloud = frame.pop("cloud")
        if scan is None and cloud is None:
            frame["scan"] = self._null_scan()
            return
        with self.telemetry.stage("lidar"):
            frame["scan"] = scan if scan is not None \
                else self._preprocess(cloud)

    def _finish(self, frame, ok):
        """Phase 5: keyframe decision, then the keyframe tail or the
        trace."""
        is_kf = self._decide(frame, ok)
        if is_kf is None:
            return
        if is_kf:
            with self.telemetry.stage("keyframe"):
                self._make_key_frame(frame)
        else:
            with self.telemetry.stage("trace"):
                self._trace(frame)
        self.telemetry.frame_done(is_kf)

    def _decide(self, frame, ok):
        """The keyframe decision of a tracked frame: True / False, or None
        when tracking was lost."""
        if not ok:
            print("Initial tracking failed: LOST!")
            self.is_lost = True
            return None
        sh = frame["shell"]
        for ob in self.observers:
            ob.publish_cam_pose(sh["id"], sh["timestamp"], sh["T_wc"])
        return self._keyframe_decision(frame) or len(self.kf_shells) < 2

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------

    def _initialize(self):
        """KF0 = the first frame with LiDAR-depth active points
        (setFirstFromLidar + initializeFromInitializer)."""
        fr = self._first_frame
        scan = fr["scan"]
        lidar_area = float(scan["bbox_area"])
        density = 0.03 * lidar_area
        cand = scan["depth_map"] > 0
        out, keep = make_maps_compact(
            fr["dI"][0], fr["abs_grad"], cand, scan["depth_map"],
            scan["px_u_map"], scan["px_v_map"], density, self._draw_dirs,
            {"pot": 3}, self.s, cap=self.s.n_select_cap,
            sub_seed=self.s.seed)
        n_have = int(keep.sum())
        keep_p = min(1.0, self.s.desired_point_density / max(n_have, 1))
        rng = np.random.default_rng(self.s.seed)
        keep &= rng.random(keep.shape) <= keep_p

        slot = self._insert_frame_slot(fr, kf_id=0)
        self.frame_prior[slot] = np.array([1e10] * 3 + [1e11] * 3)

        good = keep & out["finite"] & (out["z"] > 0)
        if good.sum() < 50:
            self.init_failed = True
        rows = self._free_pt_rows(int(good.sum()))
        sel = np.nonzero(good)[0][:len(rows)]
        self.pt_valid[rows] = True
        self.pt["u"][rows] = out["u"][sel]
        self.pt["v"][rows] = out["v"][sel]
        self.pt["idepth"][rows] = 1.0 / out["z"][sel]
        self.pt["host"][rows] = slot
        self.pt["color"][rows] = out["color"][sel]
        self.pt["weights"][rows] = out["weights"][sel]
        self.pt["is_sensor"][rows] = True
        self.pt["type"][rows] = CORNER
        self.pt["prior"][rows] = self.s.idepth_fix_prior
        self.pt["quality"][rows] = out["gcen"][sel]
        self.res_active[rows, :] = False
        self.matcher_valid[rows, :] = False

        fr["shell"]["is_kf"] = True
        self.kf_shells.append(fr["shell"]["id"])
        self._build_track_ref_first_frame(slot)

    def _null_scan(self):
        """The scan of a camera-only frame, on the system's device: an empty
        depth map (no LiDAR candidates), the full-image bbox, and
        add_feature_point set, so selection runs the monocular branch."""
        z = torch.zeros((self.h, self.w), dtype=torch.float32,
                        device=self.device)
        return dict(depth_map=z, px_u_map=z, px_v_map=z,
                    bbox_area=self._t(float(self.w * self.h)),
                    add_feature_point=self._t(True, torch.bool))

    def _initialize_mono(self, frame):
        """initializeFromInitializer for the camera-only bootstrap: KF0 =
        the stashed first frame with the mono initializer's gauge-fixed
        points (is_sensor False: BA owns their depths); `frame`'s pose
        comes from the initializer, its translation rescaled by the same
        gauge factor (MonoInitializer.level0_points)."""
        fr = self._first_frame
        slot = self._insert_frame_slot(fr, kf_id=0)
        self.frame_prior[slot] = np.array([1e10] * 3 + [1e11] * 3)

        u, v, idep, fac = self._mono.level0_points()
        color, weights, _, finite, gcen = (self._np(x) for x in
                                           pattern_colors(fr["dI"][0],
                                                          self._t(u),
                                                          self._t(v)))
        good = finite & np.isfinite(idep) & (idep > 0)
        if good.sum() < 50:
            self.init_failed = True
        rows = self._free_pt_rows(int(good.sum()))
        sel = np.nonzero(good)[0][:len(rows)]
        self.pt_valid[rows] = True
        self.pt["u"][rows] = u[sel]
        self.pt["v"][rows] = v[sel]
        self.pt["idepth"][rows] = idep[sel]
        self.pt["host"][rows] = slot
        self.pt["color"][rows] = color[sel]
        self.pt["weights"][rows] = weights[sel]
        self.pt["is_sensor"][rows] = False      # monocular: BA owns depth
        self.pt["type"][rows] = CORNER
        self.pt["prior"][rows] = 0.0            # no depth prior
        self.pt["quality"][rows] = gcen[sel]
        self.res_active[rows, :] = False
        self.matcher_valid[rows, :] = False

        fr["shell"]["is_kf"] = True
        self.kf_shells.append(fr["shell"]["id"])
        self._build_track_ref_first_frame(slot)

        # first -> new from the initializer, translation in the point
        # gauge; world == first frame
        T_fn = np.asarray(self._mono.T, np.float64).copy()
        T_fn[:3, 3] *= fac
        frame["shell"]["T_wc"] = np.linalg.inv(T_fn)
        frame["shell"]["aff"] = np.asarray(self._mono.aff, np.float64)
        self.initialized = True
        self._mono = None

    def _splat_and_build(self, slot, u, v, idp, weight, ok):
        t = self._t
        id0, w0 = splat_idepth(t(u, torch.int64), t(v, torch.int64), t(idp),
                               t(weight), t(ok, torch.bool), self.w, self.h)
        self.track_ref = build_track_ref(self.pyr_slots[slot], id0, w0,
                                         self.levels,
                                         cap=self.s.track_ref_caps)
        self.track_ref_slot = slot
        self.track_ref_aff = self.aff[slot].copy()
        self.first_coarse_rmse = -1.0

    def _build_track_ref_first_frame(self, slot):
        m = self.pt_valid & (self.pt["host"] == slot)
        u = np.round(self.pt["u"][m] + 0.5).astype(np.int64)
        v = np.round(self.pt["v"][m] + 0.5).astype(np.int64)
        weight = np.full(m.sum(), np.sqrt(1e-3 / 1e-12), np.float32)
        self._splat_and_build(slot, u, v, self.pt["idepth"][m], weight,
                              np.ones(m.sum(), bool))

    # ------------------------------------------------------------------
    # tracking
    # ------------------------------------------------------------------

    def _motion_hypotheses(self):
        """Pose-initialization try list (trackNewCoarse:341-398)."""
        ref_shell = self.shells[self.frame_shell_idx[self.track_ref_slot]]
        tries = []
        if len(self.shells) == 2:
            tries.append(np.eye(4))
            for rd in (0.02, 0.04):
                for R in _rotation_ladder(rd):
                    tries.append(R)
            return tries
        slast = self.shells[-2]
        sprelast = self.shells[-3]

        def inv(T):
            if not np.isfinite(T).all():
                return np.eye(4)
            try:
                return np.linalg.inv(T)
            except np.linalg.LinAlgError:
                return np.eye(4)

        T_s2sp = inv(sprelast["T_wc"]) @ slast["T_wc"]
        T_lastF2s = inv(slast["T_wc"]) @ ref_shell["T_wc"]
        fh_2_slast = T_s2sp
        tries.append(inv(fh_2_slast) @ T_lastF2s)
        tries.append(inv(fh_2_slast) @ inv(fh_2_slast) @ T_lastF2s)
        half = se3.se3_exp_np(se3.se3_log_np(fh_2_slast) * 0.5)
        tries.append(inv(half) @ T_lastF2s)
        tries.append(T_lastF2s)
        tries.append(np.eye(4))
        for R in _rotation_ladder(0.02):
            tries.append(inv(fh_2_slast) @ T_lastF2s @ R)
        return tries

    def _build_track_consts(self, ref_T_wc, T_wc_stack, K0):
        """Per-keyframe-constant device arguments of the track step."""
        t = self._t
        pool = self._kf_dev_pool()
        ridx = torch.full_like(pool["host"], self.order[0]) \
            if len(self.order) == 2 else pool["host"]
        return dict(
            ref_aff=t(self.track_ref_aff),
            inf5=torch.full((5,), float("inf"), device=self.device),
            ref_T_wc=ref_T_wc, T_wc_stack=T_wc_stack,
            aff=t(self.aff), exposure=t(self.exposure),
            slot_used=t(self.slot_used, torch.bool),
            K0=K0, ref_idx=ridx, quad_stack=stack_quads(self.dI0_stack))

    def _track_consts(self, ref_shell):
        """The track constants, built from the host mirrors after each
        keyframe (unless a deferred keyframe built them on the device)."""
        if self._track_const is None:
            self._track_const = self._build_track_consts(
                self._t(ref_shell["T_wc"]), self._t(np.linalg.inv(self.T_cw)),
                self._t(self.K0))
        return self._track_const

    def _window_track_consts(self, out, slot):
        """Track constants built ON THE DEVICE from the keyframe
        optimization's outputs (deferred readback, the JAX package's
        `_window_track_consts`): the next frame tracks against the post-BA
        window without the host reading it back first."""
        T_cw = se3.se3_exp(out["eps"].to(torch.float32)) @ out["T_cw_fej"]
        T_wc = torch.linalg.inv_ex(T_cw)[0]
        return self._build_track_consts(T_wc[slot], T_wc, out["calib"])

    def _track_inputs(self, frame):
        """Phase 3: the track request for `frame` — the motion hypotheses,
        the device arguments of `track_frame_step` (`args`, `statics`) and
        the host state its result is checked against, captured now (in
        pipelined mode the next frame's shell exists by the time the
        result is read)."""
        tries = self._motion_hypotheses()
        aff_last = self.shells[-2]["aff"].copy() if len(self.shells) >= 2 \
            else np.zeros(2)
        B = 32 if len(tries) <= 32 else self.N_TRIES_CAP
        T_batch = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
        nt = min(len(tries), B)
        stackt = np.stack(tries[:nt])
        bad = ~np.isfinite(stackt).all(axis=(1, 2))
        stackt[bad] = np.eye(4)
        T_batch[:nt] = stackt.astype(np.float32)
        exclude = np.zeros(B, bool)
        exclude[nt:] = True

        ref_shell = self.shells[self.frame_shell_idx[self.track_ref_slot]]
        flat, offs, ws, hs = frame["flat"]
        pool = self._kf_dev_pool()
        tc = self._track_consts(ref_shell)
        s = self.s
        args = dict(
            pools=self.track_ref, dI_new_pyr=frame["dI"], flat_new=flat,
            offsets=offs, widths=ws, heights=hs, Ks=self.Ks,
            T_tries=self._t(T_batch), aff_last=self._t(aff_last),
            ref_aff=tc["ref_aff"],
            exposures=self._t([self.exposure[self.track_ref_slot],
                               frame["exposure"]]),
            min_res_for_abort=tc["inf5"], ref_T_wc=tc["ref_T_wc"],
            pt_u=pool["u"], pt_v=pool["v"], pt_idepth=pool["idepth"],
            pt_host=pool["host"], pt_type=pool["type"],
            pt_valid=pool["pt_valid"], pt_quality=pool["quality"],
            pt_is_sensor=pool["is_sensor"], T_wc_stack=tc["T_wc_stack"],
            aff_stack=tc["aff"], exposure_stack=tc["exposure"],
            dI0_stack=self.dI0_stack, ref_idx_per_point=tc["ref_idx"],
            frame_valid=tc["slot_used"], K0=tc["K0"],
            cutoff_th=s.coarse_cutoff_th, huber_th=s.huber_th)
        statics = dict(
            coarsest_lvl=self.levels - 1, w=self.w, h=self.h,
            max_level=self.levels - 1, n_refine=s.track_refine_candidates,
            use_struct_pose=s.use_struct_pose,
            struct_pose_mad=s.struct_pose_mad,
            closest_view=s.closest_view_track,
            closest_view_margin=float(s.closest_view_margin),
            closest_view_sensor_only=bool(s.closest_view_track_sensor_only),
            align_max_iters=s.align_max_iters)
        return dict(tries=tries, T_batch=T_batch, nt=nt, exclude=exclude,
                    aff_last=aff_last, ref_shell=ref_shell,
                    prev_shell=self.shells[-2], args=args, statics=statics,
                    quad_stack=tc["quad_stack"],
                    etol=s.struct_pose_e_tol, mdt=s.struct_pose_max_dt)

    def _dispatch_track(self, req, exclude):
        """Launch one track attempt; returns its device outputs."""
        return track_frame_step(
            **req["args"], try_exclude=self._t(exclude, torch.bool),
            **req["statics"], struct_pose_e_tol=req["etol"],
            struct_pose_max_dt=req["mdt"], quad_stack=req["quad_stack"])

    def _track_result(self, frame, req, first=None):
        """Phase 4: the track attempts — `first`, the host values of the
        first attempt when pipelined mode or a fleet launched it, and
        the host retry ladder for invalid results — then the
        tracked-step sanity veto and the shell update. Returns ok."""
        s = self.s
        tries, T_batch, nt = req["tries"], req["T_batch"], req["nt"]
        aff_last, ref_shell = req["aff_last"], req["ref_shell"]
        prev_shell = req["prev_shell"]
        exclude = req["exclude"].copy()
        best_out, best_res0 = None, np.inf
        for attempt in range(3):
            if attempt == 0 and first is not None:
                out = first
            else:
                dev = self._dispatch_track(req, exclude)
                out = {k: self._np(dev[k]) for k in TRACK_KEYS}
            r0 = float(out["res"][0])
            o = bool(out["ok"]) and np.isfinite(r0) and \
                np.isfinite(out["T_wc"]).all()
            if o and r0 < best_res0:
                best_out, best_res0 = out, r0
            if o:
                break
            exclude[int(out["best_try"])] = True
            if exclude[:nt].all():
                break
        out = best_out if best_out is not None else out
        self.track_iters_hist.append(np.concatenate(
            [out["lvl_iters"], [attempt + 1]]))

        res = np.asarray(out["res"], np.float64)
        flow = np.asarray(out["flow"], np.float64)
        ok = best_out is not None
        if not ok:
            res = np.where(np.isfinite(res), res, 100.0)
            flow = np.zeros(3)
            T_ref2fh = tries[0]
            ok_T = np.isfinite(T_ref2fh).all() and \
                np.isfinite(ref_shell["T_wc"]).all() and \
                abs(np.linalg.det(T_ref2fh)) > 1e-12
            T_wc = (ref_shell["T_wc"] @ np.linalg.inv(T_ref2fh)) if ok_T \
                else np.full((4, 4), np.nan)
            aff_fh = aff_last
        else:
            T_ref2fh = np.asarray(out["T_ref_to_fh"], np.float64)
            T_wc = np.asarray(out["T_wc"], np.float64)
            aff_fh = np.asarray(out["aff"], np.float64)

        # tracked-step sanity veto (robustness deviation)
        if (ok and s.track_step_veto_m > 0
                and np.isfinite(prev_shell["T_wc"]).all()
                and np.isfinite(T_wc).all()):
            step = float(np.linalg.norm(
                T_wc[:3, 3] - prev_shell["T_wc"][:3, 3]))
            hist = self._track_step_hist
            med = float(np.median(hist[-20:])) if len(hist) >= 5 else 0.0
            lim = max(s.track_step_veto_x * med, s.track_step_veto_m)
            if step > lim:
                T_cv = np.asarray(T_batch[0], np.float64)
                if abs(np.linalg.det(T_cv)) > 1e-12 and \
                        np.isfinite(ref_shell["T_wc"]).all():
                    self.telemetry.counters["track_step_veto"] += 1
                    T_ref2fh = T_cv
                    T_wc = ref_shell["T_wc"] @ np.linalg.inv(T_cv)
                    aff_fh = np.asarray(aff_last, np.float64)
        if np.isfinite(T_wc).all() \
                and np.isfinite(prev_shell["T_wc"]).all():
            self._track_step_hist.append(float(np.linalg.norm(
                T_wc[:3, 3] - prev_shell["T_wc"][:3, 3])))
            del self._track_step_hist[:-64]

        self.last_coarse_rmse = np.where(np.isfinite(res), res, 100.0)
        shell = frame["shell"]
        shell["aff"] = np.asarray(aff_fh)
        shell["T_wc"] = T_wc
        shell["T_wc_tracked"] = np.array(T_wc)
        shell["tracking_ref"] = ref_shell["id"]
        shell["n_matched"] = int(out["n_matched"]) if ok else 0
        shell["T_wc_photo"] = (ref_shell["T_wc"] @ np.linalg.inv(
            np.asarray(T_ref2fh, np.float64))) if ok else np.array(T_wc)

        if self.first_coarse_rmse < 0:
            self.first_coarse_rmse = res[0]
        frame["flow"] = flow
        frame["track_rmse"] = res[0]
        if s.log_stuff:
            self.telemetry.track_line(
                shell["id"], shell["timestamp"], 1.0,
                se3.se3_log_np(np.asarray(T_wc, np.float64)), aff_fh,
                res[0], int(out["best_try"]))
        return bool(np.isfinite(flow).all() and np.isfinite(res[0]))

    def _keyframe_decision(self, frame) -> bool:
        s = self.s
        flow = frame["flow"]
        aff_fh = frame["shell"]["aff"]
        a_rel = np.exp(aff_fh[0] - self.track_ref_aff[0])
        wsum = (s.kf_global_weight * s.max_shift_weight_t
                * np.sqrt(max(flow[0], 0)) / (self.w + self.h)
                + s.kf_global_weight * s.max_shift_weight_r
                * np.sqrt(max(flow[1], 0)) / (self.w + self.h)
                + s.kf_global_weight * s.max_shift_weight_rt
                * np.sqrt(max(flow[2], 0)) / (self.w + self.h)
                + s.kf_global_weight * s.max_affine_weight
                * abs(np.log(max(a_rel, 1e-9))))
        need = wsum > 1.0 or \
            2 * self.first_coarse_rmse < frame["track_rmse"]
        if self.ignore_kf and self.kf_shells:
            last_kf_t = self.shells[self.kf_shells[-1]]["timestamp"]
            if frame["shell"]["timestamp"] - last_kf_t <= 0.15:
                need = False
        self.kf_decision_hist.append(
            (float(wsum), float(np.sqrt(max(flow[0], 0))),
             float(np.sqrt(max(flow[2], 0))), bool(need)))
        del self.kf_decision_hist[:-512]
        return bool(need)

    # ------------------------------------------------------------------
    # immature-point trace (every frame after tracking)
    # ------------------------------------------------------------------

    def _trace(self, frame):
        """Trace all immature points into the new frame (traceNewCoarse);
        the trace state stays in the device pool."""
        req = self._trace_request(frame)
        if req is not None:
            self._trace_result(trace_ops.trace_points(**req, w=self.w,
                                                      h=self.h))

    def _trace_request(self, frame):
        """The trace's device arguments (trace_points' keywords but w, h),
        or None when the pool holds no immature point."""
        if not self.im_valid.any():
            return None
        Km = np.eye(3)
        Km[0, 0], Km[1, 1] = self.K0[0], self.K0[1]
        Km[0, 2], Km[1, 2] = self.K0[2], self.K0[3]
        Kim = np.linalg.inv(Km)
        T_cw = self.T_cw
        T_new_cw = np.linalg.inv(frame["shell"]["T_wc"])
        KRKi = np.zeros((self.F, 3, 3), np.float32)
        Kt = np.zeros((self.F, 3), np.float32)
        affp = np.tile(np.array([1.0, 0.0], np.float32), (self.F, 1))
        for slot in self.order:
            T_h2n = T_new_cw @ np.linalg.inv(T_cw[slot])
            KRKi[slot] = Km @ T_h2n[:3, :3] @ Kim
            Kt[slot] = Km @ T_h2n[:3, 3]
            a = np.exp(frame["shell"]["aff"][0] - self.aff[slot][0])
            affp[slot] = [a, frame["shell"]["aff"][1] - a * self.aff[slot][1]]
        pool = self._im_pool_dev()
        return dict(
            u=pool["u"], v=pool["v"], idepth_min=pool["idepth_min"],
            idepth_max=pool["idepth_max"], status=pool["status"],
            quality=pool["quality"], color=pool["color"],
            weights=pool["weights"], gradH=pool["gradH"],
            energy_th=pool["energy_th"], host_idx=pool["host"],
            KRKi_stack=self._t(KRKi), Kt_stack=self._t(Kt),
            aff_stack=self._t(affp), dI_target0=frame["dI"][0],
            max_pix_search_frac=self.s.max_pix_search,
            huber_th=self.s.huber_th)

    def _trace_result(self, out):
        """Chain a trace's outputs into the device immature pool."""
        self._im_pool = dict(self._im_pool_dev(),
                             idepth_min=out["idepth_min"],
                             idepth_max=out["idepth_max"],
                             status=out["status"], quality=out["quality"],
                             pixel_interval=out["pixel_interval"])
        self._trace_fresh = True

    # ------------------------------------------------------------------
    # keyframe pipeline
    # ------------------------------------------------------------------

    def _insert_frame_slot(self, frame, kf_id):
        free = np.nonzero(~self.slot_used)[0]
        if free.size == 0:
            raise RuntimeError("window slots exhausted")
        slot = int(free[0])
        self.slot_used[slot] = True
        self.order.append(slot)
        self.T_cw_fej[slot] = np.linalg.inv(frame["shell"]["T_wc"])
        self.eps[slot] = 0.0
        self.aff[slot] = frame["shell"]["aff"]
        self.exposure[slot] = frame.get("exposure", 1.0)
        # weak pose prior anchoring eps to the tracked insertion pose
        # (robustness deviation of the JAX package, PARITY.md delta 11;
        # 0 = off, the default)
        self.frame_prior[slot] = np.array(
            [self.s.frame_pose_prior_t] * 3
            + [self.s.frame_pose_prior_r] * 3, np.float32)
        self.frame_kf_id[slot] = kf_id
        self.frame_shell_idx[slot] = frame["shell"]["id"]
        self.slot_flagged[slot] = False
        self.slot_stats_out[slot] = 0
        self.pyr_slots[slot] = frame["dI"]
        self.flat_slots[slot] = frame.get("flat") or \
            flatten_pyramid(frame["dI"])
        self.dI0_stack[slot] = frame["dI"][0]
        self.fe_th[slot] = self.fe_th[self.order[-2]] \
            if len(self.order) > 1 else 12.0 * 12.0 * 8.0
        return slot

    def _make_key_frame(self, frame):
        self._trace(frame)
        slot = self._kf_insert(frame)
        with self.telemetry.stage("kf.select"):
            self._make_new_traces(frame, slot)
        self._insert_residuals(slot)
        with self.telemetry.stage("kf.activate"):
            self._activate(frame, slot)
        self._commit_pool_dev(slot)
        with self.telemetry.stage("kf.opt"):
            self._kf_opt(frame, slot)

    def _kf_insert(self, frame):
        """The keyframe's host steps after its trace: the marginalization
        flags, the speed test, the window slot. Returns the slot."""
        frame["bbox_area"] = float(frame["scan"]["bbox_area"])
        frame["add_feat"] = bool(frame["scan"]["add_feature_point"])
        self._flag_frames_for_marginalization()

        if len(self.kf_shells) >= 2:
            s1 = self.shells[self.kf_shells[-1]]
            s2 = self.shells[self.kf_shells[-2]]
            dt = s1["timestamp"] - s2["timestamp"]
            if dt > 0:
                speed = np.linalg.norm(s1["T_wc"][:3, 3]
                                       - s2["T_wc"][:3, 3]) / dt
                self.ignore_kf = speed < 10.0
        kf_id = len(self.kf_shells)
        slot = self._insert_frame_slot(frame, kf_id)
        frame["shell"]["is_kf"] = True
        self.kf_shells.append(frame["shell"]["id"])
        return slot

    def _insert_residuals(self, slot):
        """Residuals of every other valid point toward the new slot."""
        pts_m = self.pt_valid & (self.pt["host"] != slot)
        self.res_active[:, slot] = pts_m
        self.res_state[:, slot] = backend.RES_IN
        self.res_is_new[:, slot] = pts_m
        self.matcher_valid[:, slot] = False

    def _commit_pool_dev(self, slot):
        """Mirror residual insertion + activation-row inserts into the
        device active pool."""
        pool = self._kf_dev_pool()
        rows = np.asarray(self._last_act if self._last_act is not None
                          else [], np.int64)
        t = self._t
        vals = {}
        for f in kf_ops.POOL_FIELDS:
            v = self.pt[f][rows]
            if f in ("host", "type"):
                vals[f] = t(v, torch.int64)
            elif f == "is_sensor":
                vals[f] = t(v, torch.bool)
            else:
                vals[f] = t(v)
        self._kf_dev = kf_ops.commit_pool_kf(
            pool, slot, t(rows, torch.int64), vals,
            t(self.res_active[rows], torch.bool))

    def _kf_opt(self, frame, slot):
        """Matcher refresh + windowed BA + outliers + tracking reference +
        point/frame marginalization on the device, then the host readback
        and the BA step sanity veto — now, or at the next drain with
        `deferred_kf_readback`."""
        req = self._kf_opt_request(frame, slot)
        self._kf_opt_result(req, self._run_kf_opt(req, req["iters"]))

    def _kf_opt_request(self, frame, slot):
        """The keyframe optimization's request: dict(args, statics) of
        `kf_ops.kf_opt_step`, the slot and the iteration budget."""
        s = self.s
        F = self.F
        iters = s.max_opt_iterations
        if len(self.order) < 3:
            iters = 100
        elif len(self.order) < 4:
            iters = 75

        n_window = len(self.order)
        ref_idx_newest = self.pt["host"].copy()
        if n_window == 2:
            ref_idx_newest[:] = self.order[0]
        ref_idx_multi = np.tile(self.pt["host"][None, :], (F, 1))
        multi_mask = np.zeros(F, bool)
        for sl in self.order[:-1]:
            multi_mask[sl] = True
        if n_window == 2:
            a, b = self.order[0], self.order[1]
            for si in range(F):
                ref_idx_multi[si, :] = b if si == a else a

        flat_newest, offs, ws, hs = frame["flat"]
        flat_slots = [fs[0] if fs is not None else None
                      for fs in self.flat_slots]
        prior_marg = np.where(self.pt["prior"] > 0,
                              self.pt["prior"] * s.idepth_fix_prior_marg_fac,
                              0.0).astype(np.float32)
        pool = self._kf_dev_pool()
        nf_live = int((self.pt_valid & (self.pt["host"] == slot)).sum())
        p2_cap = next((c for c in (512, 1024, 2048) if nf_live <= c), self.N)
        t = self._t

        args = dict(
            T_cw_fej=t(self.T_cw_fej), eps=t(self.eps), calib=t(self.K0),
            calib_zero=t(self.K0), frame_valid=t(self.slot_used, torch.bool),
            frame_prior=t(self.frame_prior),
            c_prior=t(np.full(4, s.initial_calib_hessian / 2500.0)),
            aff=t(self.aff), exposure=t(self.exposure), HM=t(self.HM),
            bM=t(self.bM), newest=int(slot), frame_energy_th=t(self.fe_th),
            slot_flagged=t(self.slot_flagged, torch.bool),
            flagged_slots=[int(x) for x in np.nonzero(self.slot_flagged)[0]],
            pt_u=pool["u"], pt_v=pool["v"], pt_idepth=pool["idepth"],
            pt_host=pool["host"], pt_color=pool["color"],
            pt_weights=pool["weights"], pt_is_sensor=pool["is_sensor"],
            pt_prior=pool["prior"], pt_valid=pool["pt_valid"],
            pt_type=pool["type"], pt_quality=pool["quality"],
            pt_idepth_hessian=pool["idepth_hessian"],
            num_good_res=pool["num_good_res"],
            res_active=pool["res_active"], res_state=pool["res_state"],
            res_is_new=pool["res_is_new"], matcher_px=pool["matcher_px"],
            matcher_valid=pool["matcher_valid"], dI0_stack=self.dI0_stack,
            flat_newest=flat_newest, offs=offs, widths=ws, heights=hs,
            flat_slots=flat_slots,
            ref_idx_newest=t(ref_idx_newest, torch.int64),
            ref_idx_multi=t(ref_idx_multi, torch.int64),
            multi_target_mask=[bool(x) for x in multi_mask],
            dI_newest_pyr=frame["dI"],
            max_iters=iters, min_opt_iterations=s.min_opt_iterations,
            th_opt_iterations=s.th_opt_iterations,
            force_accept=s.force_accept_step, prior_marg=t(prior_marg))
        statics = dict(
            lm_diag_floor=s.ba_lm_diag_floor,
            marg_weight_fac=s.marg_weight_fac,
            min_good_active_res_for_marg=s.min_good_active_res_for_marg,
            min_good_res_for_marg=s.min_good_res_for_marg,
            min_idepth_h_marg=s.min_idepth_h_marg,
            n_frames=F, w=self.w, h=self.h, max_level=self.levels - 1,
            levels=self.levels, track_ref_cap=s.track_ref_caps,
            gate_refresh=s.ba_gate_refresh, resf_at_fej=s.ba_resf_at_fej,
            p1_cap=0, p2_cap=p2_cap, closest_view=s.closest_view_ref,
            closest_view_margin=float(s.closest_view_margin),
            closest_view_sensor_only=bool(s.closest_view_sensor_only),
            align_max_iters=s.align_max_iters,
            solve_dtype=s.solve_dtype)
        return dict(args=args, statics=statics, slot=slot, iters=iters)

    def _run_kf_opt(self, req, iters, floor=None):
        """One keyframe optimization of this system alone (`floor`: the
        damped retry's LM diagonal floor)."""
        statics = req["statics"]
        if floor is not None:
            statics = dict(statics, lm_diag_floor=floor)
        return kf_ops.kf_opt_step(**dict(req["args"], max_iters=iters),
                                  **statics)

    def _kf_opt_result(self, req, out, small=None):
        """Apply a keyframe optimization's device outputs `out`: chain the
        device pools, then the host readback (`small`, its KF_PULL_KEYS as
        numpy when a fleet read them back with its lanes') and the veto —
        now, or at the next drain with `deferred_kf_readback`."""
        s = self.s
        slot = req["slot"]
        self._apply_kf_device_chain(out, slot)
        ctx = dict(slot=slot, iters=req["iters"],
                   run=lambda iters_, floor_=None: self._run_kf_opt(
                       req, iters_, floor_))
        if s.pipelined_frames and s.deferred_kf_readback:
            # deferred control readback (the reference's mapping-thread
            # overlap): the next frame tracks against constants built on
            # the device from this optimization; the host applies mirrors,
            # veto and telemetry at the next drain, from a copy started now
            self._track_const = self._window_track_consts(out, slot)
            self._deferred_kf = (self._to_host_async(
                {k: out[k] for k in self.kf_pull_keys()}), ctx)
            return
        if small is None:
            small = {k: self._np(out[k]) for k in self.kf_pull_keys()}
        self._resolve_kf_readback(small, ctx)

    def kf_pull_keys(self):
        """The keyframe optimization outputs the host reads back."""
        return KF_PULL_KEYS + (KF_LOG_KEYS if self.s.log_stuff else ())

    def _resolve_deferred_kf(self):
        """Apply a deferred keyframe control readback (host mirrors, veto,
        telemetry); its copy was started when the optimization ran."""
        if self._deferred_kf is None:
            return
        pending, ctx = self._deferred_kf
        self._deferred_kf = None
        with self.telemetry.stage("kf.resolve"):
            self._resolve_kf_readback(self._from_host(pending), ctx)

    def _resolve_kf_readback(self, small, ctx):
        """The keyframe optimization's host side: the BA step sanity veto
        (with the optional damped retry), then the host mirrors, shells and
        frame marginalization."""
        s = self.s
        slot, run = ctx["slot"], ctx["run"]

        def pull(out_):
            return {k: self._np(out_[k]) for k in self.kf_pull_keys()}

        def step_insane(sm):
            worst_t = worst_r = np.inf
            try:
                T_cw_new = se3.se3_exp_np(np.array(sm["eps"], np.float64)) \
                    @ np.array(sm["T_cw_fej"], np.float64)
                T_wc_new = np.linalg.inv(T_cw_new)
                if np.isfinite(T_wc_new).all():
                    worst_t = worst_r = 0.0
                    for sl in self.order:
                        pre = self.shells[self.frame_shell_idx[sl]]["T_wc"]
                        dT = np.linalg.inv(pre) @ T_wc_new[sl]
                        worst_t = max(worst_t,
                                      float(np.linalg.norm(dT[:3, 3])))
                        c = (np.trace(dT[:3, :3]) - 1.0) / 2.0
                        worst_r = max(worst_r,
                                      float(np.arccos(np.clip(c, -1, 1))))
            except np.linalg.LinAlgError:
                pass
            return (worst_t > s.ba_step_veto_m
                    or worst_r > s.ba_step_veto_rad
                    or not np.isfinite(sm["energy"]))

        if s.ba_step_veto_m > 0 and len(self.order) >= 4 \
                and step_insane(small):
            self.telemetry.counters["ba_step_veto"] += 1
            out = None
            if s.ba_veto_damped_retry > 0:
                # trust-region retry: re-run BA heavily damped instead of
                # disabling it; the binary veto stays the fail-safe (per
                # sequence, in a fleet too)
                out = run(ctx["iters"], s.ba_veto_damped_retry)
                small = pull(out)
                if step_insane(small):
                    self.telemetry.counters["ba_step_veto_hard"] += 1
                    out = None
            if out is None:
                out = run(0)
                small = pull(out)
            # the veto replaces the BA output: re-chain the device pools
            # and (deferred mode) the tracking constants; in deferred mode
            # the one frame already in flight tracked against the vetoed
            # chain, as in the JAX package
            self._apply_kf_device_chain(out, slot)
            if s.pipelined_frames and s.deferred_kf_readback:
                self._track_const = self._window_track_consts(out, slot)

        if s.log_stuff:
            self.telemetry.log_hessian(len(self.kf_shells) - 1,
                                       small["H_final"], small["b_final"],
                                       small["nullspaces"])

        if not np.isfinite(small["energy"]):
            print("KF Tracking failed: LOST!")
            self.is_lost = True
            return

        ovf = small["match_overflow"]
        self.telemetry.counters["ba_lm_iters"] += int(small["lm_iters"])
        self.telemetry.counters["match_overflow_p1"] += int(ovf[0])
        self.telemetry.counters["match_overflow_p2"] += int(ovf[1])
        self.last_match_diag = small["match_diag"]
        self.last_match_diag_p2 = small["match_diag_p2"]
        self.last_res_diag = small["res_diag"]
        self.last_death_diag = small["death_diag"]

        self.T_cw_fej = np.array(small["T_cw_fej"], np.float64)
        self.eps = np.array(small["eps"], np.float64)
        self.K0 = np.array(small["calib"], np.float32)
        self.fe_th = np.array(small["feth"], np.float32)
        self.HM = np.array(small["HM"], np.float64)
        self.bM = np.array(small["bM"], np.float64)
        self.slot_stats_out += np.array(small["stats_out"], np.int64)
        self.pt["idepth"] = np.array(small["idepth"], np.float32)
        self.res_state = np.array(small["new_state"])
        self.pt_valid = np.array(small["pt_valid"])
        self.pt["num_good_res"] = np.array(small["num_good_res"])
        self.pt["idepth_hessian"] = np.array(small["idepth_hessian"],
                                             np.float32)
        self.res_active = np.array(small["res_active"])
        self.res_is_new[:] = False

        T_wc = np.linalg.inv(self.T_cw)
        self.last_ba_window_deltas = {
            int(self.frame_kf_id[sl]): float(np.linalg.norm(
                T_wc[sl][:3, 3]
                - self.shells[self.frame_shell_idx[sl]]["T_wc"][:3, 3]))
            for sl in self.order}
        for sl in self.order:
            self.shells[self.frame_shell_idx[sl]]["T_wc"] = T_wc[sl]
            self.shells[self.frame_shell_idx[sl]]["aff"] = self.aff[sl]

        if any(self.slot_flagged[x] for x in self.order):
            self._im_pool = kf_ops.im_clear_slots(
                self._im_pool_dev(), self._t(self.slot_flagged, torch.bool))
        for sl in [x for x in self.order if self.slot_flagged[x]]:
            imh = self.im_valid & (self.im["host"] == sl)
            self.im_valid[imh] = False
            self.shells[self.frame_shell_idx[sl]]["marginalized_at"] = \
                len(self.kf_shells)
            self.slot_used[sl] = False
            self.slot_flagged[sl] = False
            self.order.remove(sl)
            self.pyr_slots[sl] = None
            self.flat_slots[sl] = None
            self.eps[sl] = 0.0
            self.frame_prior[sl] = 0.0
        self._kf_publish()

    def _kf_publish(self):
        """Per-keyframe telemetry line, deep-log nums line and observer
        publication, after the keyframe optimization's readback has reached
        the host mirrors (in deferred-readback mode one frame later)."""
        self.telemetry.kf_line(len(self.order), int(self.pt_valid.sum()),
                               int(self.res_active.sum()),
                               float(self.last_coarse_rmse[0]))
        if self.s.log_stuff and self.order:
            # numsLog stream (FullSystem.cpp:1392-1411)
            newest_sh = self.shells[self.frame_shell_idx[self.order[-1]]]
            span = newest_sh["id"] - \
                self.shells[self.frame_shell_idx[self.order[0]]]["id"]
            self.telemetry.nums_line(
                len(self.kf_shells) - 1, float(self.last_coarse_rmse[0]),
                int(getattr(self, "last_new_traces", 0)),
                int(np.size(self._last_act)),
                int(self.slot_stats_out.sum()),
                int(self.s.max_opt_iterations),
                int((self.res_active & self.pt_valid[:, None]).sum()),
                int(self.telemetry.counters.get("res_marginalized", 0)),
                newest_sh["aff"], span, len(self.order))
        if not self.observers:
            return
        m = self.pt_valid
        xn = (self.pt["u"][m] - self.K0[2]) / self.K0[0]
        yn = (self.pt["v"][m] - self.K0[3]) / self.K0[1]
        pr = np.stack([xn, yn, np.ones(m.sum())], -1) / \
            np.maximum(self.pt["idepth"][m], 1e-9)[:, None]
        T_wc = np.linalg.inv(self.T_cw)
        Th = T_wc[self.pt["host"][m]]
        pw = np.einsum("nij,nj->ni", Th[:, :3, :3], pr) + Th[:, :3, 3]
        # a full-state observer reads the immature pool's host mirror
        self._sync_immature()
        for ob in self.observers:
            ob.publish_keyframes([self.frame_kf_id[sl] for sl in self.order],
                                 T_wc[self.order], pw, self.pt["host"][m])
            ob.on_keyframe(self)

    def _apply_kf_device_chain(self, out, slot):
        """Chain the kf_opt outputs that later device stages consume."""
        self._kf_dev = dict(
            self._kf_dev, idepth=out["idepth"], res_state=out["new_state"],
            pt_valid=out["pt_valid"], num_good_res=out["num_good_res"],
            idepth_hessian=out["idepth_hessian"],
            res_active=out["res_active"], matcher_px=out["matcher_px"],
            matcher_valid=out["matcher_valid"])
        self._centers_dev = out["center"]
        self.track_ref = out["track_ref"]
        self.track_ref_slot = slot
        self.track_ref_aff = self.aff[slot].copy()
        self.first_coarse_rmse = -1.0
        self._track_const = None

    def _flag_frames_for_marginalization(self):
        """flagFramesForMarginalization (FullSystemMarginalize.cpp:25-94)."""
        s = self.s
        n_window = len(self.order)
        flagged = 0
        for slot in self.order:
            n_in = int((self.pt_valid & (self.pt["host"] == slot)).sum()
                       + (self.im_valid & (self.im["host"] == slot)).sum())
            n_out = int(self.slot_stats_out[slot])
            a_rel = np.exp(self.aff[self.order[-1]][0] - self.aff[slot][0])
            depleted = n_in < s.min_points_remaining * (n_in + n_out)
            if ((depleted or abs(np.log(max(a_rel, 1e-9)))
                 > s.max_log_aff_fac_in_window)
                    and n_window - flagged > s.min_frames):
                self.slot_flagged[slot] = True
                flagged += 1
                self.flag_hist.append((
                    int(self.frame_kf_id[self.order[-1]]
                        - self.frame_kf_id[slot]),
                    "depleted" if depleted else "affine", n_in, n_out))
                del self.flag_hist[:-256]
        if n_window - flagged >= s.max_frames:
            latest_id = self.frame_kf_id[self.order[-1]]
            T_cw = self.T_cw
            best_score, best_slot = 1.0, None
            for slot in self.order:
                fid = self.frame_kf_id[slot]
                if fid > latest_id - s.min_frame_age or fid == 0:
                    continue
                dist_score = 0.0
                for slot2 in self.order:
                    fid2 = self.frame_kf_id[slot2]
                    if fid2 > latest_id - s.min_frame_age + 1 \
                            or slot2 == slot:
                        continue
                    d = np.linalg.norm(T_cw[slot][:3, 3] - T_cw[slot2][:3, 3])
                    dist_score += 1.0 / (1e-5 + d)
                d_latest = np.linalg.norm(
                    T_cw[slot][:3, 3] - T_cw[self.order[-1]][:3, 3])
                dist_score *= -np.sqrt(d_latest)
                if dist_score < best_score:
                    best_score, best_slot = dist_score, slot
            if best_slot is not None:
                self.slot_flagged[best_slot] = True
                self.flag_hist.append((
                    int(self.frame_kf_id[self.order[-1]]
                        - self.frame_kf_id[best_slot]), "distance", -1, -1))
                del self.flag_hist[:-256]

    def _make_new_traces(self, frame, slot):
        """Point selection + immature point creation (makeNewTraces)."""
        self._new_traces_result(frame, slot, drive_steps(
            self._select_steps(frame, slot), run_select))

    def _select_steps(self, frame, slot):
        """The keyframe's selection as requests (a generator, see
        `make_maps_compact_steps`): the LiDAR candidates, then the
        camera-only candidates when the scan asks for them. Returns
        ((out, keep), (mout, mkeep) or None)."""
        scan = frame["scan"]
        img_area = self.w * self.h
        density = (frame["bbox_area"] / img_area) * \
            self.s.desired_immature_density
        cand = scan["depth_map"] > 0
        lidar = yield from make_maps_compact_steps(
            frame["dI"][0], frame["abs_grad"], cand, scan["depth_map"],
            scan["px_u_map"], scan["px_v_map"], density, self._dir_source(),
            self.pot_state, self.s, cap=self.s.n_select_cap,
            sub_seed=self.s.seed + frame["shell"]["id"] + 1)
        mono = None
        if frame["add_feat"]:
            mono = yield from make_maps_compact_steps(
                frame["dI"][0], frame["abs_grad"],
                torch.ones((self.h, self.w), dtype=torch.bool,
                           device=self.device), scan["depth_map"],
                scan["px_u_map"], scan["px_v_map"],
                self.s.desired_immature_density, self._dir_source(),
                self.pot_state_mono, self.s, cap=self.s.n_select_cap,
                sub_seed=self.s.seed + 7919 + frame["shell"]["id"] + 1)
        return lidar, mono

    def _new_traces_result(self, frame, slot, sel):
        """Insert the selected candidates into the immature pool (host and
        device)."""
        (out, keep), mono = sel
        lid_keep = keep & out["finite"]
        xs = out["u"][lid_keep]
        ys = out["v"][lid_keep]
        n_sens = int(lid_keep.sum())

        sel_src = [(out, lid_keep)]
        if mono is not None:
            mout, mkeep = mono
            pot = self.pot_state_mono.get("pot", 3)
            dxs = np.arange(-pot, pot + 1)
            dys = np.array([-1, 0, 1])
            sx = np.clip(xs[:, None, None] + dxs[None, :, None], 0,
                         self.w - 1)
            sy = np.clip(ys[:, None, None] + dys[None, None, :], 0,
                         self.h - 1)
            suppressed = np.zeros(self.h * self.w, bool)
            suppressed[(sy * self.w + sx).astype(np.int64).ravel()] = True
            mk = mkeep & mout["finite"]
            mpix = (mout["v"] * self.w + mout["u"]).astype(np.int64)
            mk &= ~suppressed[np.clip(mpix, 0, self.h * self.w - 1)]
            sel_src.append((mout, mk))

        all_u = np.concatenate([o["u"][k] for o, k in sel_src]).astype(
            np.float32)
        all_v = np.concatenate([o["v"][k] for o, k in sel_src]).astype(
            np.float32)
        col = np.concatenate([o["color"][k] for o, k in sel_src])
        wgt = np.concatenate([o["weights"][k] for o, k in sel_src])
        gradH = np.concatenate([o["gradH"][k] for o, k in sel_src])
        gcen = np.concatenate([o["gcen"][k] for o, k in sel_src])
        score = np.concatenate([o["score"][k] for o, k in sel_src])
        z = np.concatenate([out["z"][lid_keep],
                            np.zeros(len(all_u) - n_sens, np.float32)])
        if all_u.size == 0:
            self.last_new_traces = 0
            return
        max_score = score[:n_sens].max() if n_sens else 1.0

        rows = self._free_im_rows(len(all_u))
        self.last_new_traces = int(len(rows))
        sel = np.arange(len(all_u))[:len(rows)]
        im = self.im
        self.im_valid[rows] = True
        im["u"][rows] = all_u[sel]
        im["v"][rows] = all_v[sel]
        im["host"][rows] = slot
        im["color"][rows] = col[sel]
        im["weights"][rows] = wgt[sel]
        im["gradH"][rows] = gradH[sel]
        im["grad_center"][rows] = gcen[sel]
        im["energy_th"][rows] = 8 * self.s.outlier_th
        im["quality"][rows] = 10000.0
        im["pixel_interval"][rows] = 0.0
        is_sens = sel < n_sens
        im["is_sensor"][rows] = is_sens
        zsel = z[sel]
        idep = np.where(zsel > 0, 1.0 / np.maximum(zsel, 1e-6), 0.0)
        im["idepth_min"][rows] = np.where(is_sens, idep, 0.0)
        im["idepth_max"][rows] = np.where(is_sens, idep, np.inf)
        im["status"][rows] = np.where(is_sens, trace_ops.IPS_SKIPPED,
                                      trace_ops.IPS_UNINITIALIZED)
        sc = score[sel]
        im["type"][rows] = np.where(is_sens & (sc <= 0.01 * max_score),
                                    EDGELET, CORNER)
        im["my_type"][rows] = 1.0

        if rows.size:
            vals = {f: self._t(self.im[f][rows],
                               self._IM_DTYPES.get(f, torch.float32))
                    for f in kf_ops.IM_FIELDS}
            self._im_pool = kf_ops.commit_im_rows(
                self._im_pool_dev(), self._t(rows, torch.int64), vals)

    def _activate(self, frame, newest_slot):
        """activatePointsMT (FullSystem.cpp:569-723)."""
        req = self._activate_request(frame, newest_slot)
        dev = kf_ops.activate_full(**req["args"], **req["statics"])
        self._activate_result(dev, {k: self._np(dev[k])
                                    for k in ACT_PULL_KEYS})

    def _activate_request(self, frame, newest_slot):
        """The activation's request: dict(args, statics) of
        `kf_ops.activate_full` (updates the activation distance)."""
        s = self.s
        n_pts = int(self.pt_valid.sum())
        d = self.current_min_act_dist
        t = s.desired_point_density
        if n_pts < t * 0.66:
            d -= 0.8
        if n_pts < t * 0.8:
            d -= 0.5
        elif n_pts < t * 0.9:
            d -= 0.2
        elif n_pts < t:
            d -= 0.1
        if n_pts > t * 1.5:
            d += 0.8
        if n_pts > t * 1.3:
            d += 0.5
        if n_pts > t * 1.15:
            d += 0.2
        if n_pts > t:
            d += 0.1
        self.current_min_act_dist = float(np.clip(d, 0.0, 4.0))

        T_cw = self.T_cw
        T_new = T_cw[newest_slot]
        w1, h1 = self.calib.w[1], self.calib.h[1]
        K1 = np.eye(3)
        K1[0, 0], K1[1, 1] = self.calib.fx[1], self.calib.fy[1]
        K1[0, 2], K1[1, 2] = self.calib.cx[1], self.calib.cy[1]
        K0i = np.linalg.inv(np.array(
            [[self.K0[0], 0, self.K0[2]], [0, self.K0[1], self.K0[3]],
             [0, 0, 1]]))
        F = self.F
        KRKi1 = np.tile(np.eye(3, dtype=np.float32), (F, 1, 1))
        Kt1 = np.zeros((F, 3), np.float32)
        for slot in self.order:
            T_h2n = T_new @ np.linalg.inv(T_cw[slot])
            KRKi1[slot] = K1 @ T_h2n[:3, :3] @ K0i
            Kt1[slot] = K1 @ T_h2n[:3, 3]
        R_pair, t_pair, aff_pair = self._pair_transforms()

        pool_pt = self._kf_dev_pool()
        tt = self._t
        a_cap = next((c for c in (512, 1024, 2048)
                      if int(self.im_valid.sum()) <= c), self.M)
        args = dict(
            im=self._im_pool_dev(), pt_u=pool_pt["u"], pt_v=pool_pt["v"],
            pt_idepth=pool_pt["idepth"], pt_host=pool_pt["host"],
            pt_valid=pool_pt["pt_valid"], newest_slot=int(newest_slot),
            slot_used=tt(self.slot_used, torch.bool),
            slot_flagged=tt(self.slot_flagged, torch.bool),
            KRKi1=tt(KRKi1), Kt1=tt(Kt1), R_pair=tt(R_pair),
            t_pair=tt(t_pair), aff_pair=tt(aff_pair),
            dI0_stack=self.dI0_stack, K=tt(self.K0),
            min_act_dist=float(self.current_min_act_dist),
            min_trace_quality=float(s.min_trace_quality),
            min_idepth_h_act=float(s.min_idepth_h_act))
        statics = dict(w=self.w, h=self.h, w1=w1, h1=h1, n_frames=F,
                       a_cap=a_cap, gn_iters=s.gn_its_on_point_activation)
        return dict(args=args, statics=statics)

    def _activate_result(self, dev, out):
        """Apply an activation: `dev` its device outputs (the immature
        pool's validity and status stay on the device), `out` its
        ACT_PULL_KEYS as numpy."""
        im = self.im
        self._im_pool = dict(self._im_pool_dev(), im_valid=dev["im_valid"],
                             status=dev["im_status"])
        self._last_act = None
        dead, kill, drop_oob = out["dead"], out["kill"], out["drop_oob"]
        for slot in self.order:
            hm = im["host"] == slot
            self.slot_stats_out[slot] += int(((dead | kill) & hm).sum())
        self.im_valid[dead | kill | drop_oob] = False

        lane = out["lane_valid"]
        idx = out["cand_idx"][lane]
        success = out["success"][lane]
        new_idepth = out["idepth"][lane]
        inlier_t = out["inlier_targets"][lane]
        if idx.size == 0:
            return

        ok_idx = idx[success]
        rows = self._free_pt_rows(ok_idx.size)
        ok_idx = ok_idx[:rows.size]
        self._last_act = rows
        if rows.size:
            self.pt_valid[rows] = True
            self.pt["u"][rows] = im["u"][ok_idx]
            self.pt["v"][rows] = im["v"][ok_idx]
            self.pt["idepth"][rows] = new_idepth[success][:rows.size]
            self.pt["host"][rows] = im["host"][ok_idx]
            self.pt["color"][rows] = im["color"][ok_idx]
            self.pt["weights"][rows] = im["weights"][ok_idx]
            self.pt["is_sensor"][rows] = im["is_sensor"][ok_idx]
            self.pt["type"][rows] = im["type"][ok_idx]
            self.pt["prior"][rows] = 0.0
            self.pt["quality"][rows] = im["grad_center"][ok_idx]
            self.pt["num_good_res"][rows] = 0
            self.res_active[rows, :] = False
            self.res_state[rows, :] = backend.RES_IN
            self.res_is_new[rows, :] = False
            self.matcher_valid[rows, :] = False
            inl = inlier_t[success][:rows.size]
            for slot in self.order:
                tm = inl[:, slot] & self.slot_used[slot] & \
                    (im["host"][ok_idx] != slot)
                self.res_active[rows[tm], slot] = True
                self.res_is_new[rows[tm], slot] = True

        self.im_valid[idx[success]] = False
        failed = ~success
        self.im_valid[idx[failed]] = False
        for slot in self.order:
            self.slot_stats_out[slot] += int(
                (im["host"][idx[failed]] == slot).sum())

    def _set_coarse_tracking_ref(self, newest_slot):
        """makeCoarseDepthL0 from the host mirrors: sensor points splatted
        into the newest keyframe (used when resuming from a checkpoint)."""
        us, vs, ids, ws = [], [], [], []
        m_new = self.pt_valid & self.pt["is_sensor"] & \
            (self.pt["host"] == newest_slot)
        if m_new.any():
            us.append(self.pt["u"][m_new].astype(np.int64))
            vs.append(self.pt["v"][m_new].astype(np.int64))
            ids.append(self.pt["idepth"][m_new])
            hdif = 1.0 / np.maximum(self.pt["idepth_hessian"][m_new], 1e-10)
            ws.append(np.sqrt(1e-3 / (hdif + 1e-12)))
        m_other = self.pt_valid & self.pt["is_sensor"] & \
            (self.pt["host"] != newest_slot) & \
            self.res_active[:, newest_slot] & \
            (self.res_state[:, newest_slot] == backend.RES_IN)
        if m_other.any():
            c = self.centers[m_other, newest_slot]
            us.append((c[:, 0] + 0.5).astype(np.int64))
            vs.append((c[:, 1] + 0.5).astype(np.int64))
            ids.append(c[:, 2])
            hdif = 1.0 / np.maximum(self.pt["idepth_hessian"][m_other],
                                    1e-10)
            ws.append(np.sqrt(1e-3 / (hdif + 1e-12)))
        if not us:
            return
        u = np.concatenate(us)
        v = np.concatenate(vs)
        idp = np.concatenate(ids).astype(np.float32)
        wt = np.concatenate(ws).astype(np.float32)
        ok = (u >= 0) & (u < self.w) & (v >= 0) & (v < self.h) & (idp > 0)
        self._splat_and_build(newest_slot, u, v, idp, wt, ok)

    # ------------------------------------------------------------------
    # output
    # ------------------------------------------------------------------

    def get_trajectory(self) -> np.ndarray:
        """(n, 4, 4) camToWorld per input frame (printResult); drains a
        pipelined frame first."""
        self.flush()
        return np.stack([sh["T_wc"] for sh in self.shells])
