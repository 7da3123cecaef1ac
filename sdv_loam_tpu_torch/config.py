"""Typed configuration for the whole framework.

One frozen dataclass reproduces every behavior-relevant `setting_*` global of
the reference (src/util/settings.cpp:1-200, src/util/settings.h) plus the
compile-time constants (PYR_LEVELS settings.h:25, patternNum settings.h:174,
CPARS NumType.h:31, Velodyne geometry main.cpp:102-122) and the preset system
(main.cpp:192-241).

TPU-first deltas vs the reference:
  * fixed-capacity pools (``n_immature_cap`` etc.) replace dynamic vectors —
    every device tensor has a static shape and a validity mask;
  * the residual pattern is a static (8,2) array baked into kernels;
  * randomness is a seeded generator, never libc `rand()` (removes the
    reference README's nondeterminism caveat).
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

# --- compile-time constants of the reference -------------------------------
PYR_LEVELS = 6          # settings.h:25
PATTERN_NUM = 8         # settings.h:174 (patternNum)
CPARS = 4               # NumType.h:31 — fx fy cx cy
MAX_RES_PER_POINT = 8   # NumType.h:18

# The 8-point residual pattern ("8 for SSE efficiency"), settings.cpp
# staticPattern[8]: offsets (dx, dy) around the point.
PATTERN_P = np.array(
    [[0, -2], [-1, -1], [1, -1], [-2, 0], [0, 0], [2, 0], [-1, 1], [0, 2]],
    dtype=np.int32,
)

# Velodyne HDL-64 range-image geometry (main.cpp:102-122)
N_SCAN = 64
HORIZON_SCAN = 1800
ANG_RES_X = 0.2
ANG_RES_Y = 0.427
ANG_BOTTOM = 24.9
GROUND_SCAN_IND = 50
SENSOR_MOUNT_ANGLE = 0.0
SEGMENT_THETA = 60.0 / 180.0 * np.pi        # main.cpp:117
SEGMENT_VALID_POINT_NUM = 5                 # main.cpp:118
SEGMENT_VALID_LINE_NUM = 3                  # main.cpp:119
SEGMENT_ALPHA_X = ANG_RES_X / 180.0 * np.pi
SEGMENT_ALPHA_Y = ANG_RES_Y / 180.0 * np.pi

# State scaling constants (HessianBlocks.h:33-49)
SCALE_IDEPTH = 1.0
SCALE_XI_ROT = 1.0
SCALE_XI_TRANS = 0.5
SCALE_F = 50.0
SCALE_C = 50.0
SCALE_W = 1.0
SCALE_A = 10.0
SCALE_B = 1000.0


@dataclasses.dataclass(frozen=True)
class Settings:
    """All mutable `setting_*` globals of the reference, with its defaults.

    Citations are to src/util/settings.cpp unless noted.
    """

    # --- keyframe policy (settings.cpp:10-17) ---
    keyframes_per_second: float = 0.0
    real_time_max_kf: bool = False
    max_shift_weight_t: float = 0.04 * (640 + 480)
    max_shift_weight_r: float = 0.0 * (640 + 480)
    max_shift_weight_rt: float = 0.02 * (640 + 480)
    kf_global_weight: float = 1.0
    max_affine_weight: float = 2.0

    # --- priors (settings.cpp:21-28) ---
    idepth_fix_prior: float = 50.0 * 50.0
    idepth_fix_prior_marg_fac: float = 600.0 * 600.0
    initial_rot_prior: float = 1e11
    initial_trans_prior: float = 1e10
    initial_aff_b_prior: float = 1e14
    initial_aff_a_prior: float = 1e14
    initial_calib_hessian: float = 5e9

    # --- solver (settings.cpp:34-36) ---
    solver_mode_delta: float = 0.00001
    force_accept_step: bool = False
    # re-gate at every ACCEPTED LM step (reference re-gates every
    # linearizeAll; False caches the initial gate for the whole LM — the
    # fast path, see models/backend.linearize_residuals)
    ba_gate_refresh: bool = False
    # measure the BA's 2-D residual at the FEJ pair pose (reference-exact,
    # Residuals.cpp:93-96; see models/backend.linearize_residuals). False =
    # consistent Gauss-Newton at the current pose — diverges long-horizon
    # (matcher feedback loop, tools/drift_bisect.py findings).
    ba_resf_at_fej: bool = True
    # MAD-standardize the struct-pose Tukey residuals. The reference's raw
    # weighting (CoarseTracker.cpp:873-887) never reaches b=4.6851 and is
    # effectively plain least squares; measured long-run (200 straight
    # KITTI-scale frames) it lets seed-stuck outlier matches drag the pose
    # (ATE 41 m vs 13 m standardized) and cannot correct injected pose
    # errors (tools/drift_bisect.py round-3 findings). Default True is a
    # deliberate robustness deviation; False reproduces the reference.
    struct_pose_mad: bool = True
    # photometric veto on the struct pose: accept the stage-2 correction
    # only while the stage-1 (photometric) rmse at the corrected pose stays
    # within this factor of the accepted photometric optimum — unvetoed,
    # the self-seeded match set can push the pose meters (ops/frame_step)
    struct_pose_e_tol: float = 1.1
    # sanity veto on the windowed-BA result (robustness deviation — the
    # reference has no equivalent; its denser residual graph never leaves a
    # window direction unconstrained). With the FEJ-anchored residual the LM
    # accept test is governed by the prior/marg energies, so a pose left
    # unconstrained by a thinned residual graph can be flung meters and
    # still accepted (measured on the 400-frame S-curve: one -5.4 m z step
    # at a healthy keyframe cascaded into total point starvation). If BA
    # moves any window pose more than this far from its pre-BA shell pose,
    # the keyframe tail is re-run with BA disabled for that keyframe.
    # 0 disables. Healthy BA corrections measure <=0.15 m / <0.02 rad.
    ba_step_veto_m: float = 0.5
    ba_step_veto_rad: float = 0.15
    # >0: on a veto, first retry BA with this LM diagonal floor (trust
    # region) before falling back to BA-off; 0 = binary veto (default)
    ba_veto_damped_retry: float = 0.0
    # absolute LM damping floor (robustness deviation; solve_system). The
    # reference's multiplicative damping (1+lambda)*diag gives a thinned
    # window direction (diag~0) no stiffness at all — the mechanism behind
    # the vetoed multi-meter BA steps. Adds lambda*rel*mean|diag| to the
    # damped diagonal; healthy directions see a ~rel relative change.
    # 0 = reference-exact multiplicative damping (the default). The knob is
    # REGIME-DEPENDENT near the turn-collapse stability boundary (ROADMAP
    # round-3): on the compressed 400-frame S-curve it is monotonically
    # protective (0 -> 2.82 m ATE with terminal point starvation; 1e-3 ->
    # 1.58; 1e-2 -> 1.07 with veto 103 -> 59 and a healthy end state;
    # over-damps past 3e-2), but on the 500-frame gate scene it is
    # monotonically harmful (0 -> 2.04 m = 0.51%; 1e-3 -> 3.97;
    # 1e-2 -> 9.03): reducing veto triggers lets a degraded-regime BA act,
    # and its accepted steps drift more than the floor saves. The step
    # veto stays the protective mechanism; keep 0 unless a deployment's
    # veto rate is pathological. Straight 200-frame: 0 -> 0.319 m,
    # 1e-2 -> 0.370 m (both ~0.2% of path).
    ba_lm_diag_floor: float = 0.0
    # absolute bound (meters) on the translation the struct-pose stage may
    # move the photometric pose. The stage's photometric veto compares
    # cutoff-CLAMPED energies: once the photometric track itself diverges,
    # both poses saturate at the cutoff, the ratio test goes blind, and a
    # multi-meter struct "correction" can pass (measured at f414 of the
    # 500-frame S-curve: sp_dz -10.9 m accepted while both energies sat at
    # the clamp). Legitimate corrections are cm-scale. 0 disables.
    struct_pose_max_dt: float = 1.0
    # tracked-step sanity veto (robustness deviation, like ba_step_veto):
    # if the final tracked translation step exceeds
    # max(track_step_veto_x * median(recent steps), track_step_veto_m),
    # the frame keeps the motion-model (constant-velocity) pose instead of
    # the diverged track result. A 10 Hz automotive platform cannot move
    # 13 m in one frame; the reference's saturated coarsest-level residual
    # cannot tell such poses apart (all residuals at the cutoff clamp).
    # 0 disables.
    track_step_veto_x: float = 4.0
    track_step_veto_m: float = 1.5
    # pipelined frame processing (the TPU analog of the reference's
    # tracking/mapping thread overlap, FullSystem.cpp:902-1012): leave
    # frame N's track program running on device across the add() boundary
    # so frame N+1's host staging overlaps it; pose readback and the
    # keyframe pipeline are deferred one frame. Tracking always uses the
    # latest keyframe state (the deferral point is staging->tracking), so
    # the trajectory matches sequential mode; shell poses and is_lost lag
    # one frame until flush(). Default False = reference parity
    # (linearizeOperation=true sequential mode).
    pipelined_frames: bool = False
    # Defer the keyframe tail's control readback by one frame (pipelined
    # mode only): the kf_opt program's small state is async-copied at
    # dispatch and resolved at the NEXT frame's drain, so the host never
    # blocks on the BA program. The next frame tracks against the
    # device-chained post-BA window state (a tiny chained program builds
    # its pose constants), while host mirrors/veto/telemetry lag one
    # frame — the TPU analog of the reference's mapping-thread overlap
    # with the dual coarse-tracker swap (FullSystem.cpp:853-859,902-1012;
    # tracking there likewise proceeds while mapping finishes, and the
    # reference README documents the resulting nondeterminism — here the
    # schedule is deterministic). Trajectories are NOT bit-identical to
    # sequential mode (f32 device pose staging + one-frame-late veto);
    # tests gate equivalent QUALITY instead. MEASURED NEUTRAL on
    # throughput as of round 4 (bench 3.23 vs 3.20 f/s): removing the
    # kf_opt readback from the host path just moves the BA's device time
    # into the next track's device wait, because the keyframe tail's
    # select/activate readbacks still serialize its dispatches — the flag
    # pays only once the tail is pull-free. Accuracy is schedule-
    # perturbed with scene-dependent sign (bench scene 0.0211 -> 0.139 m,
    # CPU 50-frame scene 0.411 -> 0.208 m). Default OFF until the tail
    # readbacks are folded.
    deferred_kf_readback: bool = False
    # weak per-frame pose prior (1/sigma^2) anchoring each window frame's
    # eps to its tracked insertion pose — see _insert_frame_slot. Default
    # 0 (reference semantics: prior only on the first keyframe). MEASURED
    # NEGATIVE (400-frame S-curve: 1.21 m -> 13.0 m): marginalizing a
    # framed slot folds the prior into HM permanently, accumulating
    # world-frame insertion-pose springs that drag every later correction
    # (136 BA step vetoes). A useful diagnostic, not a production guard —
    # the step veto handles the degenerate-direction failure instead.
    frame_pose_prior_t: float = 0.0
    frame_pose_prior_r: float = 0.0
    # per-level tracking-reference pool capacities (coarser levels repeat
    # the last entry). Track-program cost scales with these lane counts;
    # overflow is stride-subsampled, not truncated (ops/photometric.
    # build_track_ref). Live counts at KITTI scale: ~4-6k on level 0.
    track_ref_caps: tuple = (6144, 4096, 2048, 1024)
    # how many hypothesis-ladder winners get the full-pyramid refinement
    # each frame (each costs ~34 ms device time; 1 loses ~5x accuracy,
    # measured round 2)
    track_refine_candidates: int = 3

    # --- activation / marginalization (settings.cpp:41-49) ---
    min_idepth_h_act: float = 100.0
    min_idepth_h_marg: float = 50.0
    desired_immature_density: float = 1500.0   # preset 0 (main.cpp:207)
    desired_point_density: float = 2000.0      # preset 0 (main.cpp:208)
    min_points_remaining: float = 0.05
    max_log_aff_fac_in_window: float = 0.7

    # --- window (settings.cpp:52-58) ---
    min_frames: int = 5
    max_frames: int = 7
    min_frame_age: int = 1
    max_opt_iterations: int = 6
    min_opt_iterations: int = 1
    th_opt_iterations: float = 1.2

    # --- outliers (settings.cpp:64-65) ---
    outlier_th: float = 12.0 * 12.0
    outlier_th_sum_component: float = 50.0 * 50.0

    marg_weight_fac: float = 0.5 * 0.5         # settings.cpp:72
    # settings.cpp:77 `re_track_threshold` is deliberately ABSENT: the
    # batched ladder evaluates every hypothesis at once and keeps the best,
    # and re-instating the reference's accept-constant-motion-within-1.5x
    # rule was measured CATASTROPHIC in round 3 (33% ATE over 80 m vs 1-5%
    # best-of-all — the accept ratchet lets a locked-in wrong velocity keep
    # passing the threshold frame after frame). See PARITY.md §43.

    min_good_active_res_for_marg: int = 3      # settings.cpp:82
    min_good_res_for_marg: int = 4             # settings.cpp:83

    # --- photometric calibration (settings.cpp:92-99) ---
    photometric_calibration: int = 2
    use_exposure: bool = True
    affine_opt_mode_a: float = 1e12
    affine_opt_mode_b: float = 1e8
    gamma_weights_pixel_select: int = 1

    huber_th: float = 6.0                      # settings.cpp:105

    # --- adaptive energy threshold (settings.cpp:110-115) ---
    frame_energy_th_const_weight: float = 0.5
    frame_energy_th_n: float = 0.7
    frame_energy_th_fac_median: float = 1.5
    overall_energy_th_weight: float = 1.0
    coarse_cutoff_th: float = 20.0
    # stage-2 structPoseEstimation (FullSystem.cpp:483-492); disable to run
    # photometric-only tracking (diagnostic / ablation)
    use_struct_pose: bool = True
    # Matcher patch-reference selection by closest viewing direction to the
    # target (the reference ships Reprojector::getCloseViewObs,
    # Reprojector.cpp:295-330, but findMatchDirect always warps from
    # pt->host, :238-254). Treats long-horizon match-acceptance decay: the
    # host patch's appearance diverges from the target view as the camera
    # approaches (VERDICT r4 item 5). The target frame itself is excluded
    # (a self-warped patch is a zero-information match). Measured A/B on
    # the 500-frame S-curve (2026-08-20): ATE 3.23 -> 1.51 m, KF-refresh
    # match survival ~2x (p2 matched 1.6k -> 6.9k mid-run), runtime < +5%.
    closest_view_ref: bool = True
    # view-ray cos-improvement threshold over the HOST before switching
    # the patch reference. NEGATIVE (default) = no host preference: always
    # take the argmax frame when any candidate is visible. This matters
    # for FAR points, whose view-ray cos values TIE in float32 across the
    # whole window: with no host preference they all re-reference to one
    # deterministic (lowest-slot) frame, which is where the measured win
    # lives — margin 0 (keep host on ties) degraded the 150-frame
    # protocol 0.96% -> 1.12% and margin 0.02 erased the S-curve win
    # entirely (3.04 vs 1.51). Positive values are a conservatism knob
    # for weak-geometry deployments.
    closest_view_margin: float = -1.0
    # apply closest-view references in the per-frame TRACKING match too
    # (the pass that feeds structPoseEstimation). SCALE-DEPENDENT (all
    # numbers deterministic, 2026-08-20): at KITTI scale it carries the
    # BASELINE-protocol win (150-frame fixture 0.96% of path vs 2.12%
    # with it off, 1.12% sensor-only — only full switching passes the 1%
    # target), but at the weak-geometry 320x96 CI scene the window POSE
    # error makes switched-patch transfer lossy (0.63% -> 9.0%;
    # tests/test_drift_gate.py runs that scene with this flag False, the
    # recommended configuration for low-resolution/weak-geometry
    # deployments).
    closest_view_track: bool = True
    closest_view_track_sensor_only: bool = False
    # restrict KF-REFRESH switching to LiDAR-pinned (sensor) depths.
    # Estimated-depth points pay patch-transfer error
    # ~ f * b_perp * idepth_error when switched, but their matches are
    # also the ones that decay fastest with a pinned host patch; the
    # refresh feeds the robust FEJ BA (many residuals), so all-points
    # switching is the default.
    closest_view_sensor_only: bool = False

    # --- pixel selection (settings.cpp:119-123) ---
    min_grad_hist_cut: float = 0.5
    min_grad_hist_add: float = 3.0
    grad_downweight_per_level: float = 0.75
    select_direction_distribution: bool = True

    # --- immature point tracing (settings.cpp:131-141) ---
    max_pix_search: float = 0.027
    min_trace_quality: float = 3.0
    min_trace_test_radius: int = 2
    gn_its_on_point_activation: int = 3
    trace_stepsize: float = 1.0
    trace_gn_iterations: int = 3
    trace_gn_threshold: float = 0.1
    trace_extra_slack_on_th: float = 1.2
    trace_slack_interval: float = 1.5
    trace_min_improvement_factor: float = 2.0

    # --- misc (settings.cpp:160-185) ---
    multi_threading: bool = False
    debugout_runquiet: bool = True
    log_stuff: bool = False        # deep-log streams: per-KF BA Hessian
                                   # eigen-spectrum, diagonal, nullspace
                                   # products (FullSystem.cpp:119-176,
                                   # 1419-1499) into the telemetry JSONL

    # ------------------------------------------------------------------
    # TPU-build additions (fixed pool capacities / precision — new design,
    # SURVEY.md §7 "Fixed shapes + masks everywhere")
    # ------------------------------------------------------------------
    n_frames_cap: int = 8          # window slots: max_frames(7) + incoming
    n_immature_cap: int = 2048     # immature pool (target density 1500)
    n_select_cap: int = 4096       # compacted selection rows per keyframe
    n_active_cap: int = 4096       # active point pool size
    n_lidar_cand_cap: int = 16384  # projected LiDAR pixel candidates per scan
    trace_max_steps: int = 64      # discrete epipolar search budget (see
                                   #   ops/trace.TRACE_STEPS)
    align_max_iters: int = 10      # Reprojector align2D GN iterations
    solve_dtype: str = "float32"   # the BA's dense solve dtype; float32 as
                                   # the JAX package solves (float64 only
                                   # to measure the solve's share of a
                                   # difference)
    seed: int = 0                  # torch.Generator seed replacing libc rand()

    @classmethod
    def preset_default(cls) -> "Settings":
        """Preset 0/1 (main.cpp:195-214): 2000 pts, 5-7 KFs, 1-6 iters."""
        return cls(desired_immature_density=1500.0, desired_point_density=2000.0,
                   min_frames=5, max_frames=7, max_opt_iterations=6,
                   min_opt_iterations=1)

    @classmethod
    def preset_fast(cls, **overrides) -> "Settings":
        """Preset 2/3 (main.cpp:217-238): 800 pts, 4-6 KFs, 1-4 iters at
        424x320 input. The reference defines this as its 5x-speed mode; the
        TPU build additionally shrinks the fixed pool capacities to match —
        gather-bound stage cost scales with LANE count, not occupancy,
        so the caps are the real content knob."""
        kw = dict(desired_immature_density=600.0, desired_point_density=800.0,
                  min_frames=4, max_frames=6, max_opt_iterations=4,
                  min_opt_iterations=1,
                  n_frames_cap=7,            # max_frames(6) + incoming
                  n_immature_cap=1024, n_select_cap=2048,
                  n_active_cap=2048, n_lidar_cand_cap=8192,
                  track_ref_caps=(3072, 2048, 1024, 512))
        kw.update(overrides)
        return cls(**kw)

    @cached_property
    def pattern(self) -> np.ndarray:
        """(8, 2) int32 residual-pattern offsets."""
        return PATTERN_P
