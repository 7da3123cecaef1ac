"""Trajectory evaluation: ATE (absolute trajectory error) and RPE.

The reference validates end-to-end by writing KITTI poses and evaluating
externally (SURVEY.md §4); this module provides the evaluator in-tree so the
synthetic-scene end-to-end tests and the benchmark can check accuracy
directly. Umeyama SE(3)/Sim(3) alignment + RMSE of translation, plus
KITTI-style relative pose error over fixed-length segments.
"""

from __future__ import annotations

import numpy as np


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares similarity transform aligning src -> dst ((N,3) each).

    Returns (s, R, t) with dst ≈ s R src + t.
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / src.shape[0]
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray,
             align_scale: bool = False) -> float:
    """RMSE of translation after SE(3) (or Sim(3)) alignment.

    est_poses, gt_poses: (N, 4, 4) camToWorld.
    """
    pe = est_poses[:, :3, 3]
    pg = gt_poses[:, :3, 3]
    s, R, t = umeyama(pe, pg, with_scale=align_scale)
    aligned = (s * (R @ pe.T)).T + t
    err = np.linalg.norm(aligned - pg, axis=1)
    return float(np.sqrt((err ** 2).mean()))


def rpe(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1):
    """Relative pose error over frame gaps of `delta`.

    Returns (trans_rmse, rot_rmse_rad)."""
    te, re = [], []
    for i in range(len(est_poses) - delta):
        de = np.linalg.inv(est_poses[i]) @ est_poses[i + delta]
        dg = np.linalg.inv(gt_poses[i]) @ gt_poses[i + delta]
        e = np.linalg.inv(dg) @ de
        te.append(np.linalg.norm(e[:3, 3]))
        c = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        re.append(np.arccos(c))
    return float(np.sqrt(np.mean(np.square(te)))), \
        float(np.sqrt(np.mean(np.square(re))))


def drift_decomposition(est_poses: np.ndarray, gt_poses: np.ndarray,
                        segment: int = 10) -> dict:
    """Decompose trajectory drift into scale vs yaw vs translation terms.

    Per-segment (default 10 frames ≈ 10 m at KITTI speed) relative motions
    are compared est vs gt:
      * scale_drift_pct: mean percent error of segment path length —
        positive = estimated trajectory too long;
      * yaw_drift_deg_per_m: mean signed yaw error per meter traveled
        (rotation about the camera y/down axis — heading drift);
      * pitch/roll analogues, and the end-point error fraction.

    This is the diagnostic VERDICT r1 item 5 asked for: with LiDAR depth the
    scale term should be ~0 and residual ATE should be heading drift.
    """
    n = min(len(est_poses), len(gt_poses))
    scales, yaws, pitches, rolls, lens = [], [], [], [], []
    for i in range(0, n - segment, segment):
        de = np.linalg.inv(est_poses[i]) @ est_poses[i + segment]
        dg = np.linalg.inv(gt_poses[i]) @ gt_poses[i + segment]
        lg = np.linalg.norm(dg[:3, 3])
        if lg < 1e-6:
            continue
        le = np.linalg.norm(de[:3, 3])
        scales.append((le - lg) / lg)
        err = np.linalg.inv(dg) @ de
        R = err[:3, :3]
        # yaw about y (down), pitch about x, roll about z — camera frame
        yaws.append(np.arctan2(R[0, 2], R[2, 2]) / lg)
        pitches.append(np.arctan2(-R[1, 2], np.hypot(R[1, 0], R[1, 1])) / lg)
        rolls.append(np.arctan2(R[1, 0], R[1, 1]) / lg)
        lens.append(lg)
    if not scales:
        return dict(scale_drift_pct=0.0, yaw_drift_deg_per_m=0.0,
                    pitch_drift_deg_per_m=0.0, roll_drift_deg_per_m=0.0,
                    endpoint_err_frac=0.0)
    path = float(np.sum(lens))
    ee = np.linalg.norm(est_poses[n - 1][:3, 3] - gt_poses[n - 1][:3, 3])
    return dict(
        scale_drift_pct=float(100.0 * np.mean(scales)),
        yaw_drift_deg_per_m=float(np.rad2deg(np.mean(yaws))),
        pitch_drift_deg_per_m=float(np.rad2deg(np.mean(pitches))),
        roll_drift_deg_per_m=float(np.rad2deg(np.mean(rolls))),
        endpoint_err_frac=float(ee / max(path, 1e-9)))
