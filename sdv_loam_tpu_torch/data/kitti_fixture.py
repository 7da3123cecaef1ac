"""Write a synthetic sequence out as a KITTI-Odometry-layout fixture.

Produces the exact on-disk contract the real-data path consumes
(reference input contract: README.md:62-76; trajectory output format:
FullSystem.cpp:253-281):

    <root>/sequences/<seq>/image_0/%06d.png    8-bit grayscale
    <root>/sequences/<seq>/velodyne/%06d.bin   float32 (x, y, z, refl)
    <root>/sequences/<seq>/times.txt
    <root>/calib.txt       DSO-format camera file (data.calib parser)
    <root>/sensor.txt      4-line intrinsics + [R|t]_cam<-lidar
    <root>/poses.txt       KITTI ground-truth rows (3x4 [R|t], camToWorld)

This is how the full ingestion chain — KittiSequence reader, Undistorter,
native velodyne parser (native/staging.cpp), PrefetchReader, CLI — gets
exercised end-to-end without real KITTI data (zero-egress environment).
"""

from __future__ import annotations

import os

import numpy as np

from sdv_loam_tpu_torch.io.images import write_image


def write_kitti_fixture(seq, root: str, seq_name: str = "00",
                        n_frames: int | None = None) -> dict:
    """Export `seq` (a SyntheticSequence) to a KITTI layout under `root`.

    Returns dict of the written paths (seq_dir, calib, sensor, poses).
    """
    n = len(seq) if n_frames is None else min(n_frames, len(seq))
    seq_dir = os.path.join(root, "sequences", seq_name)
    img_dir = os.path.join(seq_dir, "image_0")
    vel_dir = os.path.join(seq_dir, "velodyne")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(vel_dir, exist_ok=True)

    for i in range(n):
        img, cloud, _ = seq.get(i)
        write_image(os.path.join(img_dir, f"{i:06d}.png"),
                    np.clip(np.round(img), 0, 255).astype(np.uint8))
        raw = np.zeros((cloud.shape[0], 4), np.float32)
        raw[:, :3] = cloud
        raw[:, 3] = 0.5  # reflectance placeholder
        raw.tofile(os.path.join(vel_dir, f"{i:06d}.bin"))

    np.savetxt(os.path.join(seq_dir, "times.txt"),
               np.asarray(seq.timestamps[:n], np.float64), fmt="%.6f")

    c = seq.calib
    calib_path = os.path.join(root, "calib.txt")
    with open(calib_path, "w") as f:
        # distortion-free pinhole, passthrough output ("none" mode)
        f.write(f"Pinhole {c.fx[0]:.9f} {c.fy[0]:.9f} "
                f"{c.cx[0]:.9f} {c.cy[0]:.9f} 0\n")
        f.write(f"{c.w[0]} {c.h[0]}\n")
        f.write("none\n")
        f.write(f"{c.w[0]} {c.h[0]}\n")

    s = seq.sensor
    sensor_path = os.path.join(root, "sensor.txt")
    with open(sensor_path, "w") as f:
        f.write(f"{s.intrinsics[0]:.9f} {s.intrinsics[1]:.9f} "
                f"{s.intrinsics[2]:.9f} {s.intrinsics[3]:.9f}\n")
        for i in range(3):
            f.write(" ".join(f"{v:.9f}" for v in
                             list(s.R_cl[i]) + [s.t_cl[i]]) + "\n")

    poses_path = os.path.join(root, "poses.txt")
    with open(poses_path, "w") as f:
        for i in range(n):
            T = np.asarray(seq.poses_wc[i])
            f.write(" ".join(f"{v:.9e}" for v in T[:3].reshape(-1)) + "\n")

    return dict(seq_dir=seq_dir, calib=calib_path, sensor=sensor_path,
                poses=poses_path, n_frames=n)
