"""KITTI-format trajectory output.

Reference: FullSystem::printResult (FullSystem.cpp:253-281) — one row per
frame: the 3x4 [R|t] of camToWorld, row-major, 12 values, `%e`-formatted.
"""

from __future__ import annotations

import numpy as np


def format_kitti(poses_cam_to_world: np.ndarray) -> str:
    rows = []
    for T in poses_cam_to_world:
        M = np.asarray(T)[:3, :4].reshape(-1)
        rows.append(" ".join(f"{v:e}" for v in M))
    return "\n".join(rows) + "\n"


def write_kitti(path: str, poses_cam_to_world: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write(format_kitti(poses_cam_to_world))


def read_kitti(path: str) -> np.ndarray:
    data = np.loadtxt(path).reshape(-1, 3, 4)
    n = data.shape[0]
    out = np.tile(np.eye(4), (n, 1, 1))
    out[:, :3, :4] = data
    return out
