"""Observer API — the Output3DWrapper equivalent.

Reference: src/IOWrapper/Output3DWrapper.h:89-182 — an abstract observer the
system publishes to: camera poses per frame, keyframe graph/point clouds,
live frame images, depth images, reset/join lifecycle. Implementations in
the reference: Pangolin 3-D viewer, printf sample wrapper, dummies.

Counterpart of `sdv_loam_tpu/io/observer.py` (a copy): the same event
surface as plain Python callbacks, so visualization / recording backends
can subscribe without touching the pipeline. A JSONL recording observer
is provided (the headless counterpart of SampleOutputWrapper); GUI
backends can be attached externally.
"""

from __future__ import annotations

import json

import numpy as np


class Observer:
    """Subscribe to system events (Output3DWrapper interface)."""

    def publish_cam_pose(self, frame_id: int, timestamp: float,
                         T_cam_to_world: np.ndarray):
        """Per tracked frame (Output3DWrapper::publishCamPose)."""

    def publish_keyframes(self, kf_ids, T_cam_to_world, points_xyz,
                          points_host):
        """After each KF's BA (Output3DWrapper::publishKeyframes)."""

    def publish_graph(self, connectivity):
        """Host->target residual counts (Output3DWrapper::publishGraph)."""

    def push_live_frame(self, image: np.ndarray):
        """The raw tracked frame (Output3DWrapper::pushLiveFrame)."""

    def push_depth_image(self, depth: np.ndarray):
        """Tracking-reference inverse depth (pushDepthImageFloat)."""

    def on_keyframe(self, fs):
        """Full-state hook after each KF. The reference's debug renderings
        (debugPlot/debugPlotTracking) run inside makeKeyFrame with direct
        FullSystem access rather than through Output3DWrapper
        (FullSystemDebugStuff.cpp:21,78); this hook is that entry point."""

    def reset(self):
        """System reset (Output3DWrapper::reset)."""

    def join(self):
        """Shutdown (Output3DWrapper::join)."""


class JsonlRecorder(Observer):
    """Headless recording observer (counterpart of SampleOutputWrapper)."""

    def __init__(self, path: str):
        self._f = open(path, "w")

    def publish_cam_pose(self, frame_id, timestamp, T_cam_to_world):
        self._f.write(json.dumps({
            "event": "cam_pose", "id": int(frame_id), "t": float(timestamp),
            "pose": np.asarray(T_cam_to_world)[:3, :4].reshape(-1).tolist(),
        }) + "\n")

    def publish_keyframes(self, kf_ids, T_cam_to_world, points_xyz,
                          points_host):
        self._f.write(json.dumps({
            "event": "keyframes", "ids": [int(i) for i in kf_ids],
            "n_points": int(len(points_xyz)),
        }) + "\n")

    def reset(self):
        self._f.write(json.dumps({"event": "reset"}) + "\n")

    def join(self):
        self._f.close()
