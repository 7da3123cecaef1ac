"""Optional visualization observer — the Pangolin viewer counterpart.

Counterpart of `sdv_loam_tpu/io/viewer.py` (reference src/IOWrapper/
Pangolin/PangolinViewer.{h,cpp} + KeyFrameDisplay.{h,cpp}). The JAX
package draws its two panels with matplotlib; the port draws the same two
panels with numpy into one RGB array, so the viewer runs where no plotting
library is installed:

  * left: the trajectory seen from above (x right, z up), the current
    position marked red;
  * right: the window map's points seen from above, coloured by height
    (y), with a red marker at each keyframe camera.

Each snapshot is written as `kf_%05d.png` through io/images.py, every
`every` keyframes. The class keeps the JAX package's name so the CLI's
`--viewer` flag reaches the same observer.
"""

from __future__ import annotations

import os

import numpy as np

from sdv_loam_tpu_torch.io.images import write_image
from sdv_loam_tpu_torch.io.observer import Observer

PANEL_W, PANEL_H, MARGIN = 480, 400, 24
_BLUE = np.uint8([31, 119, 180])
_RED = np.uint8([214, 39, 40])
_GREY = np.uint8([200, 200, 200])
# viridis at five stops, interpolated linearly
_VIRIDIS = np.float32([[68, 1, 84], [59, 82, 139], [33, 145, 140],
                       [94, 201, 98], [253, 231, 37]])


def _to_pixels(xz, lo, scale):
    """World (x, z) -> panel (col, row), z up, one scale for both axes."""
    col = MARGIN + (xz[:, 0] - lo[0]) * scale
    row = PANEL_H - MARGIN - (xz[:, 1] - lo[1]) * scale
    return np.stack([col, row], -1)


def _frame(xz):
    """The lower corner and the scale that fit `xz` into a panel."""
    if len(xz) == 0:
        return np.zeros(2), 1.0
    lo, hi = xz.min(0), xz.max(0)
    span = np.maximum(hi - lo, 1e-6)
    scale = float(min((PANEL_W - 2 * MARGIN) / span[0],
                      (PANEL_H - 2 * MARGIN) / span[1]))
    centre = 0.5 * (lo + hi)
    lo = centre - 0.5 * np.float64([PANEL_W - 2 * MARGIN,
                                    PANEL_H - 2 * MARGIN]) / scale
    return lo, scale


def _put(img, px, colors):
    """Set the pixels `px` ((n, 2) col, row) that fall inside the panel."""
    c = np.round(px[:, 0]).astype(np.int64)
    r = np.round(px[:, 1]).astype(np.int64)
    ok = (c >= 0) & (c < img.shape[1]) & (r >= 0) & (r < img.shape[0])
    img[r[ok], c[ok]] = colors[ok] if np.ndim(colors) == 2 else colors


def _polyline(img, px, color):
    for a, b in zip(px[:-1], px[1:]):
        n = int(np.ceil(np.abs(b - a).max())) + 1
        t = np.linspace(0.0, 1.0, n)[:, None]
        _put(img, a + (b - a) * t, color)


def _marker(img, px, color, radius, triangle=False):
    """A filled disc (or an upward triangle) of `radius` pixels at each
    point of `px`."""
    d = np.arange(-radius, radius + 1)
    dc, dr = np.meshgrid(d, d)
    if triangle:
        keep = (dr >= -radius) & (np.abs(dc) <= (dr + radius) / 2.0)
    else:
        keep = dc ** 2 + dr ** 2 <= radius ** 2
    off = np.stack([dc[keep], dr[keep]], -1)
    for p in px:
        _put(img, p + off, color)


def _viridis(t):
    x = np.clip(np.asarray(t, np.float32), 0.0, 1.0) * (len(_VIRIDIS) - 1)
    i = np.minimum(x.astype(np.int64), len(_VIRIDIS) - 2)
    f = (x - i)[:, None]
    return np.round(_VIRIDIS[i] * (1 - f) + _VIRIDIS[i + 1] * f).astype(
        np.uint8)


def render(poses_xyz, points_xyz, cams_T_wc) -> np.ndarray:
    """The viewer's snapshot: (PANEL_H, 2 * PANEL_W, 3) uint8 RGB."""
    left = np.full((PANEL_H, PANEL_W, 3), 255, np.uint8)
    right = np.full((PANEL_H, PANEL_W, 3), 255, np.uint8)
    for img in (left, right):
        img[:, [0, -1]] = _GREY
        img[[0, -1], :] = _GREY
    p = np.asarray(poses_xyz, np.float64).reshape(-1, 3)
    if len(p):
        lo, scale = _frame(p[:, [0, 2]])
        px = _to_pixels(p[:, [0, 2]], lo, scale)
        _polyline(left, px, _BLUE)
        _marker(left, px[-1:], _RED, 4)
    pts = np.asarray(points_xyz, np.float64).reshape(-1, 3)
    cams = np.asarray(cams_T_wc, np.float64).reshape(-1, 4, 4)[:, :3, 3]
    both = np.concatenate([pts, cams])
    if len(both):
        lo, scale = _frame(both[:, [0, 2]])
        if len(pts):
            y = pts[:, 1]
            t = (y - y.min()) / max(float(np.ptp(y)), 1e-9)
            _put(right, _to_pixels(pts[:, [0, 2]], lo, scale), _viridis(t))
        _marker(right, _to_pixels(cams[:, [0, 2]], lo, scale), _RED, 5,
                triangle=True)
    return np.concatenate([left, right], 1)


class MatplotlibViewer(Observer):
    """Headless viewer: writes snapshot PNGs every `every` keyframes."""

    def __init__(self, out_dir: str, every: int = 1):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.every = max(1, every)
        self._poses = []
        self._n_kf = 0

    def publish_cam_pose(self, frame_id, timestamp, T_cam_to_world):
        self._poses.append(np.asarray(T_cam_to_world)[:3, 3].copy())

    def publish_keyframes(self, kf_ids, T_cam_to_world, points_xyz,
                          points_host):
        self._n_kf += 1
        if self._n_kf % self.every:
            return
        write_image(os.path.join(self.out_dir, f"kf_{self._n_kf:05d}.png"),
                    render(self._poses, points_xyz, T_cam_to_world))

    def reset(self):
        self._poses.clear()
        self._n_kf = 0

    def join(self):
        pass
