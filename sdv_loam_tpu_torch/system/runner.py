"""Sequence runner — the main-loop / process() equivalent.

Counterpart of `sdv_loam_tpu/system/runner.py` (reference src/main.cpp:
468-535 + 894-997): feeds a reader with `__len__` and
`get(i) -> (image, cloud, timestamp)` to FullSystem on one device, with the
full reset on an early initialization failure, and returns the run summary.
A pipelined system is flushed before the summary, so the summary counts
every frame and the trajectory is complete.
"""

from __future__ import annotations

import numpy as np

from sdv_loam_tpu_torch.config import Settings
from sdv_loam_tpu_torch.io.telemetry import Telemetry
from sdv_loam_tpu_torch.io.trajectory import write_kitti
from sdv_loam_tpu_torch.system.full_system import FullSystem

RESET_FRAME_LIMIT = 250  # main.cpp:510-528


def run_sequence(reader, settings: Settings | None = None, device="cuda",
                 result_path: str | None = None,
                 log_path: str | None = None, max_frames: int | None = None,
                 allow_reset: bool = True, prefetch: bool = True):
    """Run the odometry over a sequence reader on `device` (CUDA unless
    the caller asks for the CPU).

    Returns (FullSystem, summary dict)."""
    settings = settings or Settings()
    # each FullSystem sets the telemetry's device wait to its own stream
    telemetry = Telemetry(log_path=log_path, quiet=settings.debugout_runquiet)
    calib = reader.calib if not hasattr(reader, "undistorter") else \
        reader.undistorter.pyramid_calib
    if prefetch:
        from sdv_loam_tpu_torch.data.prefetch import PrefetchReader
        reader = PrefetchReader(reader)
    try:
        fs = FullSystem(calib, reader.sensor, settings, telemetry=telemetry,
                        device=device)
        n = len(reader) if max_frames is None else min(max_frames,
                                                       len(reader))
        for i in range(n):
            img, cloud, ts = reader.get(i)
            exp = reader.get_exposure(i) \
                if hasattr(reader, "get_exposure") else 1.0
            fs.add_active_frame(np.asarray(img), np.asarray(cloud),
                                float(ts), exposure=exp)
            if allow_reset and (fs.init_failed or (
                    fs.is_lost and len(fs.shells) < RESET_FRAME_LIMIT)):
                print("RESETTING!")
                fs = FullSystem(calib, reader.sensor, settings,
                                telemetry=telemetry, device=device)
        fs.flush()
    finally:
        if prefetch:
            reader.close()
    summary = telemetry.summary()
    summary["lost"] = fs.is_lost
    if not settings.debugout_runquiet:
        print(f"frames: {summary['frames']}  fps: {summary['fps']}  "
              f"ms/frame: {summary['ms_per_frame']}")
    if result_path:
        write_kitti(result_path, fs.get_trajectory())
    telemetry.close()
    return fs, summary
