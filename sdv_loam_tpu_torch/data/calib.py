"""Camera calibration file parsing and geometric undistortion.

Byte-compatible with the reference's DSO calib text format
(src/util/Undistort.cpp:225-316 factory + readFromFile:1160-1320):

    line 1: "<Model> p0 p1 p2 p3 [p4 ...]"   or bare 5/8 floats (legacy)
    line 2: "<in_w> <in_h>"
    line 3: "crop" | "full" | "none" | "fx fy cx cy 0"
    line 4: "<out_w> <out_h>"

Models (Undistort.h:82-133): Pinhole (5 params), RadTan (8), ATAN/FOV (5),
EquiDistant (8), KannalaBrandt (8). Legacy bare-float lines map 5 -> ATAN
(or Pinhole if p4 == 0) and 8 -> RadTan, as in Undistort.cpp:243-287.

If the first parameter set is relative (all of fx,fy,cx,cy <= 1), parameters
are rescaled to pixels with the -0.5 center convention (Undistort.cpp:1239+).

The "crop" output mode reproduces makeOptimalK_crop (Undistort.cpp:538-660):
stretch center rays, then shrink the worse dimension by 0.5% per iteration
until no border pixel maps out of the source image.

Undistortion itself builds a (out_h, out_w) remap once (host, NumPy) and
resamples bilinearly — the per-frame resample runs as a jitted gather on
device (see sdv_loam_tpu_torch.ops.warp.bilinear_sample).

Also here: the photometric calibration (gamma response G[256] + vignette,
reference Undistort.h:12-36 PhotometricUndistorter) and the sensor-extrinsics
file parser (FullSystem::loadSensorPrameters, FullSystem.cpp:77-117).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from sdv_loam_tpu_torch.utils.camera import PyramidCalib, make_pyramid_calib


# ---------------------------------------------------------------------------
# distortion models: map *ideal* (undistorted output) pixel -> source pixel
# ---------------------------------------------------------------------------

def _distort_pinhole(pars, K_new, x, y):
    # UndistortPinhole::distortCoordinates (Undistort.cpp:1127-1152)
    fx, fy, cx, cy = pars[:4]
    ix = (x - K_new[0, 2]) / K_new[0, 0]
    iy = (y - K_new[1, 2]) / K_new[1, 1]
    return fx * ix + cx, fy * iy + cy


def _distort_fov(pars, K_new, x, y):
    # UndistortFOV::distortCoordinates (Undistort.cpp:829-877)
    fx, fy, cx, cy, dist = pars[:5]
    ix = (x - K_new[0, 2]) / K_new[0, 0]
    iy = (y - K_new[1, 2]) / K_new[1, 1]
    if dist == 0:
        return fx * ix + cx, fy * iy + cy
    d2t = 2.0 * np.tan(dist / 2.0)
    r = np.sqrt(ix * ix + iy * iy)
    fac = np.where(r > 1e-8, np.arctan(r * d2t) / (dist * np.maximum(r, 1e-8)), 1.0)
    return fx * fac * ix + cx, fy * fac * iy + cy


def _distort_radtan(pars, K_new, x, y):
    # UndistortRadTan::distortCoordinates (Undistort.cpp:884-930)
    fx, fy, cx, cy, k1, k2, r1, r2 = pars[:8]
    ix = (x - K_new[0, 2]) / K_new[0, 0]
    iy = (y - K_new[1, 2]) / K_new[1, 1]
    mx2 = ix * ix
    my2 = iy * iy
    mxy = ix * iy
    r2_ = mx2 + my2
    rd = 1.0 + k1 * r2_ + k2 * r2_ * r2_
    dx = ix * rd + 2.0 * r1 * mxy + r2 * (r2_ + 2.0 * mx2)
    dy = iy * rd + 2.0 * r2 * mxy + r1 * (r2_ + 2.0 * my2)
    return fx * dx + cx, fy * dy + cy


def _distort_equidistant(pars, K_new, x, y):
    # UndistortEquidistant::distortCoordinates (Undistort.cpp:937-990)
    fx, fy, cx, cy, k1, k2, k3, k4 = pars[:8]
    ix = (x - K_new[0, 2]) / K_new[0, 0]
    iy = (y - K_new[1, 2]) / K_new[1, 1]
    r = np.sqrt(ix * ix + iy * iy)
    theta = np.arctan(r)
    t2 = theta * theta
    thetad = theta * (1 + k1 * t2 + k2 * t2**2 + k3 * t2**3 + k4 * t2**4)
    scaling = np.where(r > 1e-8, thetad / np.maximum(r, 1e-8), 1.0)
    return fx * ix * scaling + cx, fy * iy * scaling + cy


def _distort_kb(pars, K_new, x, y):
    # UndistortKB::distortCoordinates (Undistort.cpp:1030-1108)
    fx, fy, cx, cy, k0, k1, k2, k3 = pars[:8]
    ix = (x - K_new[0, 2]) / K_new[0, 0]
    iy = (y - K_new[1, 2]) / K_new[1, 1]
    r = np.sqrt(ix * ix + iy * iy)
    theta = np.arctan(r)
    t2 = theta * theta
    thetad = theta * (1 + k0 * t2 + k1 * t2**2 + k2 * t2**3 + k3 * t2**4)
    scaling = np.where(r > 1e-8, thetad / np.maximum(r, 1e-8), 1.0)
    return fx * ix * scaling + cx, fy * iy * scaling + cy


_MODELS = {
    "Pinhole": (5, _distort_pinhole),
    "FOV": (5, _distort_fov),
    "ATAN": (5, _distort_fov),
    "RadTan": (8, _distort_radtan),
    "EquiDistant": (8, _distort_equidistant),
    "KannalaBrandt": (8, _distort_kb),
}


@dataclasses.dataclass
class Undistorter:
    """Geometric undistorter: source camera -> rectified pinhole output."""

    model: str
    pars: np.ndarray            # original camera parameters (pixel units)
    in_w: int
    in_h: int
    out_w: int
    out_h: int
    K_new: np.ndarray           # 3x3 rectified pinhole intrinsics
    remap_x: np.ndarray         # (out_h, out_w) f32 source x, -1 where invalid
    remap_y: np.ndarray

    @property
    def passthrough(self) -> bool:
        return self.remap_x is None

    @property
    def pyramid_calib(self) -> PyramidCalib:
        return make_pyramid_calib(
            self.out_w, self.out_h,
            float(self.K_new[0, 0]), float(self.K_new[1, 1]),
            float(self.K_new[0, 2]), float(self.K_new[1, 2]))

    def undistort(self, image: np.ndarray) -> np.ndarray:
        """Bilinear remap (reference Undistort::undistort<T>, Undistort.cpp:319+).

        Out-of-range pixels get 0. NumPy implementation; the hot path in the
        pipeline undistorts on-device via ops.warp.bilinear_sample instead.
        """
        img = np.asarray(image, dtype=np.float32)
        assert img.shape == (self.in_h, self.in_w), (img.shape, self.in_h, self.in_w)
        if self.passthrough:
            return img.copy()
        x = self.remap_x
        y = self.remap_y
        valid = x >= 0
        x0 = np.clip(np.floor(x).astype(np.int32), 0, self.in_w - 2)
        y0 = np.clip(np.floor(y).astype(np.int32), 0, self.in_h - 2)
        ax = np.clip(x - x0, 0.0, 1.0)
        ay = np.clip(y - y0, 0.0, 1.0)
        i00 = img[y0, x0]
        i01 = img[y0, x0 + 1]
        i10 = img[y0 + 1, x0]
        i11 = img[y0 + 1, x0 + 1]
        out = (i00 * (1 - ax) * (1 - ay) + i01 * ax * (1 - ay)
               + i10 * (1 - ax) * ay + i11 * ax * ay)
        return np.where(valid, out, 0.0).astype(np.float32)


def _make_optimal_k_crop(distort_fn, pars, in_w, in_h, out_w, out_h):
    """NumPy port of the semantics of Undistort::makeOptimalK_crop
    (Undistort.cpp:538-660)."""
    K = np.eye(3)

    # 1. stretch center lines to find initial coarse range.
    grid = (np.arange(100000, dtype=np.float64) - 50000.0) / 10000.0
    zeros = np.zeros_like(grid)
    tx, _ = distort_fn(pars, K, grid, zeros)
    inx = (tx > 0) & (tx < in_w - 1)
    xs = grid[inx]
    min_x, max_x = (xs[0], xs[-1]) if xs.size else (-1.0, 1.0)
    _, ty = distort_fn(pars, K, zeros, grid)
    iny = (ty > 0) & (ty < in_h - 1)
    ys = grid[iny]
    min_y, max_y = (ys[0], ys[-1]) if ys.size else (-1.0, 1.0)

    min_x *= 1.01; max_x *= 1.01; min_y *= 1.01; max_y *= 1.01

    # 2. shrink until all border pixels valid.
    for _ in range(500):
        yy = min_y + (max_y - min_y) * np.arange(out_h) / (out_h - 1.0)
        lx, _ = distort_fn(pars, K, np.full(out_h, min_x), yy)
        rx, _ = distort_fn(pars, K, np.full(out_h, max_x), yy)
        oob_left = not np.all((lx > 0) & (lx < in_w - 1))
        oob_right = not np.all((rx > 0) & (rx < in_w - 1))

        xx = min_x + (max_x - min_x) * np.arange(out_w) / (out_w - 1.0)
        _, ty_ = distort_fn(pars, K, xx, np.full(out_w, min_y))
        _, by = distort_fn(pars, K, xx, np.full(out_w, max_y))
        oob_top = not np.all((ty_ > 0) & (ty_ < in_h - 1))
        oob_bottom = not np.all((by > 0) & (by < in_h - 1))

        if not (oob_left or oob_right or oob_top or oob_bottom):
            break
        if (oob_left or oob_right) and (oob_top or oob_bottom):
            if (max_x - min_x) > (max_y - min_y):
                oob_bottom = oob_top = False
            else:
                oob_left = oob_right = False
        if oob_left:
            min_x *= 0.995
        if oob_right:
            max_x *= 0.995
        if oob_top:
            min_y *= 0.995
        if oob_bottom:
            max_y *= 0.995

    K_new = np.eye(3)
    K_new[0, 0] = (out_w - 1.0) / (max_x - min_x)
    K_new[1, 1] = (out_h - 1.0) / (max_y - min_y)
    K_new[0, 2] = -min_x * K_new[0, 0]
    K_new[1, 2] = -min_y * K_new[1, 1]
    return K_new


def load_undistorter(path: str) -> Undistorter:
    """Parse a DSO calib file and build the undistorter.

    Mirrors Undistort::getUndistorterForFile + readFromFile
    (Undistort.cpp:225-316, 1160-1320).
    """
    with open(path) as f:
        lines = [ln.strip() for ln in f.readlines() if ln.strip()]
    assert len(lines) >= 4, f"calib file {path} needs 4 lines"

    toks = lines[0].split()
    if toks[0] in _MODELS:
        model = toks[0]
        n_pars, fn = _MODELS[model]
        pars = np.array([float(t) for t in toks[1:1 + n_pars]])
    else:
        vals = [float(t) for t in toks]
        if len(vals) == 5:
            model = "Pinhole" if vals[4] == 0 else "ATAN"
            pars = np.array(vals)
            n_pars, fn = _MODELS[model]
        elif len(vals) == 8:
            model = "RadTan"
            pars = np.array(vals)
            n_pars, fn = _MODELS[model]
        else:
            raise ValueError(f"unrecognized calib line: {lines[0]}")

    in_w, in_h = (int(t) for t in lines[1].split())
    out_mode = lines[2]
    out_w, out_h = (int(t) for t in lines[3].split())

    # relative -> pixel parameters (Undistort.cpp:1239-1255)
    if np.all(pars[:4] <= 1.0):
        pars = pars.copy()
        pars[0] *= in_w
        pars[1] *= in_h
        pars[2] = pars[2] * in_w - 0.5
        pars[3] = pars[3] * in_h - 0.5

    if out_mode == "crop":
        K_new = _make_optimal_k_crop(fn, pars, in_w, in_h, out_w, out_h)
    elif out_mode == "none":
        assert in_w == out_w and in_h == out_h
        K_new = np.eye(3)
        K_new[0, 0], K_new[1, 1] = pars[0], pars[1]
        K_new[0, 2], K_new[1, 2] = pars[2], pars[3]
        # passthrough: no remap
        return Undistorter(model, pars, in_w, in_h, out_w, out_h, K_new, None, None)
    elif out_mode == "full":
        raise NotImplementedError("'full' mode is unimplemented in the reference too "
                                  "(Undistort.cpp:664-668 asserts false)")
    else:
        # explicit "fx fy cx cy 0" output calibration (Undistort.cpp:1290-1307)
        ovals = [float(t) for t in out_mode.split()]
        K_new = np.eye(3)
        if all(v <= 1.0 for v in ovals[:4]):
            K_new[0, 0] = ovals[0] * out_w
            K_new[1, 1] = ovals[1] * out_h
            K_new[0, 2] = ovals[2] * out_w - 0.5
            K_new[1, 2] = ovals[3] * out_h - 0.5
        else:
            K_new[0, 0], K_new[1, 1], K_new[0, 2], K_new[1, 2] = ovals[:4]

    # build remap: for each output pixel, its source location
    xx, yy = np.meshgrid(np.arange(out_w, dtype=np.float64),
                         np.arange(out_h, dtype=np.float64))
    sx, sy = fn(pars, K_new, xx, yy)
    valid = (sx > 0) & (sx < in_w - 1) & (sy > 0) & (sy < in_h - 1)
    remap_x = np.where(valid, sx, -1.0).astype(np.float32)
    remap_y = np.where(valid, sy, -1.0).astype(np.float32)
    return Undistorter(model, pars, in_w, in_h, out_w, out_h, K_new,
                       remap_x, remap_y)


# ---------------------------------------------------------------------------
# photometric calibration (gamma + vignette)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PhotometricCalib:
    """Inverse response G[256] + inverse vignette map.

    Reference: PhotometricUndistorter (Undistort.h:12-36, Undistort.cpp:30-180).
    `apply` maps an 8-bit image to irradiance-like floats.
    """

    G: np.ndarray | None = None            # (256,) inverse response
    vignette_inv: np.ndarray | None = None  # (h, w) 1/V

    def apply(self, img_u8: np.ndarray) -> np.ndarray:
        out = np.asarray(img_u8, dtype=np.float32)
        if self.G is not None:
            out = self.G[np.clip(img_u8.astype(np.int32), 0, 255)].astype(np.float32)
        if self.vignette_inv is not None:
            out = out * self.vignette_inv
        return out


def load_photometric_calib(gamma_path: str | None,
                           vignette_path: str | None) -> PhotometricCalib:
    G = None
    vig_inv = None
    if gamma_path and os.path.exists(gamma_path):
        vals = np.loadtxt(gamma_path).ravel()
        # reference requires 256 values, normalizes to [0, 255]
        # (Undistort.cpp:52-79)
        G = vals.astype(np.float64)
        G = 255.0 * (G - G.min()) / (G.max() - G.min())
    if vignette_path and os.path.exists(vignette_path):
        from sdv_loam_tpu_torch.io.images import read_image
        vig = read_image(vignette_path).astype(np.float64)
        vig = vig / vig.max()
        vig_inv = (1.0 / np.maximum(vig, 1e-3)).astype(np.float32)
    return PhotometricCalib(G, vig_inv)


# ---------------------------------------------------------------------------
# sensor extrinsics (LiDAR -> camera)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SensorCalib:
    """Camera intrinsics + T_cam<-lidar from a 4-line sensor file.

    Format (sensor/00.txt, parsed at FullSystem.cpp:77-117): line 1 holds
    intrinsics (informational; the reference actually takes fx..cy from the
    camera calib), lines 2-4 are rows of [R|t]_cam<-lidar.
    """

    intrinsics: np.ndarray   # (4,) fx fy cx cy as written in the file
    R_cl: np.ndarray         # (3,3)
    t_cl: np.ndarray         # (3,)

    @property
    def T_cam_lidar(self) -> np.ndarray:
        T = np.eye(4)
        T[:3, :3] = self.R_cl
        T[:3, 3] = self.t_cl
        return T


def load_sensor_calib(path: str) -> SensorCalib:
    with open(path) as f:
        lines = [ln.strip() for ln in f.readlines() if ln.strip()]
    assert len(lines) >= 4, f"sensor file {path} needs 4 non-empty lines"
    intr = np.array([float(t) for t in lines[0].split()[:4]])
    R = np.zeros((3, 3))
    t = np.zeros(3)
    for i in range(3):
        vals = [float(v) for v in lines[1 + i].split()]
        R[i, :] = vals[:3]
        t[i] = vals[3]
    return SensorCalib(intr, R, t)
