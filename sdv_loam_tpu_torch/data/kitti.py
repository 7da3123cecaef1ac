"""KITTI-Odometry sequence reader.

Replaces the reference's ROS ingestion path (rosbag + imgHandler/
lidarCloudHandler, main.cpp:537-858) and ImageFolderReader
(src/util/DatasetReader.h) with a direct reader over the standard
KITTI-Odometry folder layout:

    <root>/sequences/<seq>/image_0/%06d.png   (grayscale left camera)
    <root>/sequences/<seq>/velodyne/%06d.bin  (N x 4 float32 x,y,z,refl)
    <root>/sequences/<seq>/times.txt

Geometric undistortion uses a DSO-format calib file (see data.calib); the
LiDAR->camera extrinsics come from a 4-line sensor file. Frames and scans in
KITTI are strictly 1:1 paired at 10 Hz (reference README.md:68-76), so the
reference's ±0.01 s stamp-matching queue (main.cpp:468-535) degenerates to
index pairing here. Images decode through the port's own PNG codec
(io/images.py), so the reader needs neither OpenCV nor PIL.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from sdv_loam_tpu_torch.data.calib import (PhotometricCalib, SensorCalib, Undistorter,
                                     load_photometric_calib, load_sensor_calib,
                                     load_undistorter)
from sdv_loam_tpu_torch.io.images import read_gray
from sdv_loam_tpu_torch.utils.camera import PyramidCalib


def read_velodyne_bin(path: str) -> np.ndarray:
    """(N, 3) float32 points from a KITTI velodyne .bin (x, y, z, reflectance)."""
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    pts = raw[:, :3]
    return pts[np.isfinite(pts).all(axis=1)]


@dataclasses.dataclass
class KittiSequence:
    """Reader over one KITTI-Odometry sequence directory."""

    seq_dir: str
    undistorter: Undistorter
    sensor: SensorCalib
    photometric: PhotometricCalib
    timestamps: np.ndarray
    image_files: list
    velodyne_files: list
    exposures: np.ndarray = None  # (N,) ms; all-1.0 when the times file
    #   has no exposure column (KITTI's own times.txt is stamp-only)

    @classmethod
    def open(cls, seq_dir: str, calib_file: str, sensor_file: str,
             gamma_file: str | None = None,
             vignette_file: str | None = None) -> "KittiSequence":
        und = load_undistorter(calib_file)
        sensor = load_sensor_calib(sensor_file)
        pcal = load_photometric_calib(gamma_file, vignette_file)
        img_dir = os.path.join(seq_dir, "image_0")
        vel_dir = os.path.join(seq_dir, "velodyne")
        imgs = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir)
                      if f.endswith(".png"))
        vels = sorted(os.path.join(vel_dir, f) for f in os.listdir(vel_dir)
                      if f.endswith(".bin"))
        n = min(len(imgs), len(vels))
        times_path = os.path.join(seq_dir, "times.txt")
        exps = np.ones(n, np.float32)
        if os.path.exists(times_path):
            rows = np.atleast_2d(np.loadtxt(times_path, ndmin=2))[:n]
            if rows.shape[1] >= 3:
                # TUM-style "id stamp exposure" rows (the legacy
                # DatasetReader path, DatasetReader.h:231-275): zero
                # exposures are interpolated from their neighbors; if any
                # remain zero the whole column is discarded (all 1.0)
                ts = rows[:, 1]
                exps = rows[:, 2].astype(np.float32)
                for i in np.flatnonzero(exps == 0):
                    nb = [exps[j] for j in (i - 1, i + 1)
                          if 0 <= j < len(exps) and exps[j] > 0]
                    if nb:
                        exps[i] = np.mean(nb)
                if (exps == 0).any() or len(exps) != n:
                    exps = np.ones(n, np.float32)
            elif rows.shape[1] == 2:
                ts = rows[:, 1]
            else:
                ts = rows[:, 0]
        else:
            ts = np.arange(n) * 0.1
        return cls(seq_dir, und, sensor, pcal, ts, imgs[:n], vels[:n],
                   exposures=exps)

    @property
    def calib(self) -> PyramidCalib:
        return self.undistorter.pyramid_calib

    def __len__(self):
        return len(self.image_files)

    def get_image(self, i: int) -> np.ndarray:
        raw = read_gray(self.image_files[i])
        img = self.photometric.apply(raw)
        return self.undistorter.undistort(img)

    def get_cloud(self, i: int) -> np.ndarray:
        # native C++ parse (native/staging.cpp sdv_read_velodyne) with the
        # NumPy fallback inside; same filtering semantics either way
        from sdv_loam_tpu_torch.data import native
        return native.read_velodyne(self.velodyne_files[i])

    def get(self, i: int):
        return self.get_image(i), self.get_cloud(i), float(self.timestamps[i])

    def get_exposure(self, i: int) -> float:
        return float(self.exposures[i]) if self.exposures is not None else 1.0
