"""Window debug renderings — the FullSystemDebugStuff equivalent.

Reference: src/FullSystem/FullSystemDebugStuff.cpp
  * debugPlot (:78-285): one image per window keyframe (dimmed intensity,
    c = I*0.9), with point overlays selected by `freeDebugParam5`:
      0/1  active points colored by rainbow(idepth)
      3    immature points colored by rainbow(mean idepth) when traced
      4    immature points colored by trace STATUS
      5    immature points colored red->green by sqrt(quality)-1
      6    points colored by my_type (selection scale)
      7    active points jet-normalized to the 5-95 idepth percentile
  * debugPlotTracking (:21-76): per window-frame images brightness-
    transferred into each frame's domain, active points marked setPixel9.
  * displayImageStitch: grid stitch of the per-frame images.

Colormaps reproduce globalFuncs.h makeRainbow3B (:310-324) / makeJet3B
(:326-343); markers reproduce MinimalImage::setPixelCirc / setPixel9
(MinimalImage.h:75-113). The reference draws BGR (OpenCV); we emit RGB.

Counterpart of `sdv_loam_tpu/io/debug_plots.py`: host numpy renderings
over the host point pools. The port keeps the window's level-0 images
(`dI0_stack`) on the device, so a rendering copies the intensity channel of
the window's slots to the host once; the caller syncs the immature pool's
host mirror first (FullSystem does so before `on_keyframe`). They cost
nothing unless called.
"""

from __future__ import annotations

import numpy as np

from sdv_loam_tpu_torch.ops import trace as trace_ops

# trace-status colors of debugPlot mode 4 (:200-216), BGR->RGB swapped
_STATUS_RGB = {
    int(trace_ops.IPS_GOOD): (0, 255, 0),
    int(trace_ops.IPS_OOB): (0, 0, 255),
    int(trace_ops.IPS_OUTLIER): (255, 0, 0),
    int(trace_ops.IPS_SKIPPED): (0, 255, 255),
    int(trace_ops.IPS_BADCONDITION): (255, 255, 255),
    int(trace_ops.IPS_UNINITIALIZED): (0, 0, 0),
}
# my_type colors of mode 6 (:236-247), BGR->RGB swapped
_TYPE_RGB = {0: (255, 0, 255), 1: (0, 0, 255), 2: (255, 0, 0),
             3: (255, 255, 0)}


def make_rainbow3(idepth, scale: float = 1.0) -> np.ndarray:
    """Vectorized makeRainbow3B (globalFuncs.h:310-324): (N,) -> (N, 3) u8
    RGB. `scale` is the reference's freeDebugParam3 (default 1)."""
    x = np.asarray(idepth, np.float32) * scale
    n = x.shape[0]
    out = np.full((n, 3), 255, np.uint8)
    pos = x > 0
    ic = np.floor(x).astype(np.int64)
    fr = x - ic
    ph = np.where(pos, ic % 3, -1)
    r = np.select([ph == 0, ph == 1, ph == 2],
                  [255 * (1 - fr), 0 * fr, 255 * fr], 255)
    g = np.select([ph == 0, ph == 1, ph == 2],
                  [255 * fr, 255 * (1 - fr), 0 * fr], 255)
    b = np.select([ph == 0, ph == 1, ph == 2],
                  [0 * fr, 255 * fr, 255 * (1 - fr)], 255)
    out[:, 0], out[:, 1], out[:, 2] = r, g, b
    out[~pos] = 255
    return out


def make_jet3(t) -> np.ndarray:
    """Vectorized makeJet3B (globalFuncs.h:326-343): t in [0,1] -> RGB u8."""
    t = np.asarray(t, np.float32)
    n = t.shape[0]
    x = np.clip(t * 8.0, 0.0, 8.0 - 1e-6)
    ic = np.floor(x).astype(np.int64)
    f = x - ic
    seg_r = [0.5 + 0.5 * f, np.ones_like(f), np.ones_like(f), 1 - 0.5 * f,
             0.5 - 0.5 * f, 0 * f, 0 * f, 0 * f]
    seg_g = [0 * f, 0.5 * f, 0.5 + 0.5 * f, np.ones_like(f),
             np.ones_like(f), 1 - 0.5 * f, 0.5 - 0.5 * f, 0 * f]
    seg_b = [0 * f, 0 * f, 0 * f, 0.5 * f, 0.5 + 0.5 * f, np.ones_like(f),
             np.ones_like(f), 1 - 0.5 * f]
    r = np.choose(ic, seg_r)
    g = np.choose(ic, seg_g)
    b = np.choose(ic, seg_b)
    out = np.stack([r, g, b], -1)
    out[t <= 0] = (128 / 255, 0, 0)
    out[t >= 1] = (0, 0, 128 / 255)
    return np.round(out * 255).astype(np.uint8)


def _draw_circ(img: np.ndarray, us, vs, colors) -> None:
    """setPixelCirc (MinimalImage.h:88-113): a 7x7 ring outline per point,
    drawn for all points at once (later points overwrite earlier, matching
    the reference's loop order)."""
    h, w = img.shape[:2]
    ring = [(du, dv) for du in range(-3, 4) for dv in range(-3, 4)
            if max(abs(du), abs(dv)) >= 2]
    us = np.asarray(us)
    vs = np.asarray(vs)
    colors = np.asarray(colors)
    for du, dv in ring:
        uu = us + du
        vv = vs + dv
        ok = (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
        img[vv[ok], uu[ok]] = colors[ok]


def _draw_sq9(img: np.ndarray, us, vs, colors) -> None:
    """setPixel9 (MinimalImage.h:75-86): 3x3 solid square per point."""
    h, w = img.shape[:2]
    us = np.asarray(us)
    vs = np.asarray(vs)
    colors = np.asarray(colors)
    for du in (-1, 0, 1):
        for dv in (-1, 0, 1):
            uu = us + du
            vv = vs + dv
            ok = (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
            img[vv[ok], uu[ok]] = colors[ok]


def stitch(images, cols: int | None = None) -> np.ndarray:
    """displayImageStitch equivalent: grid-stitch equal-size RGB images."""
    if not images:
        return np.zeros((1, 1, 3), np.uint8)
    h, w = images[0].shape[:2]
    n = len(images)
    if cols is None:
        cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    out = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, im in enumerate(images):
        r, c = divmod(i, cols)
        out[r * h:(r + 1) * h, c * w:(c + 1) * w] = im
    return out


def _window_intensity(fs) -> dict:
    """Level-0 intensity of every window slot on the host ({slot: (H, W)
    float32}), copied from the device in one transfer."""
    order = list(fs.order)
    if not order:
        return {}
    stack = fs.dI0_stack[order, ..., 0].detach().cpu().numpy()
    return dict(zip(order, stack))


def _base_image(intensity) -> np.ndarray:
    """Dimmed keyframe intensity (debugPlot:138-143, c = I*0.9)."""
    c = np.clip(intensity * 0.9, 0, 255).astype(np.uint8)
    return np.stack([c, c, c], -1)


def debug_plot(fs, mode: int = 0, rainbow_scale: float = 1.0):
    """One RGB image per window keyframe with point overlays.

    `mode` follows the reference's freeDebugParam5 switch (debugPlot:145-273).
    Marginalized/out point categories don't persist in the pool design
    ("delete" = mask clear), so modes 0/1/7 show the live active set only —
    a documented deviation (PARITY.md §2.3).

    Returns (list of (H, W, 3) uint8, stitched image).
    """
    images = []
    intensity = _window_intensity(fs)
    for slot in fs.order:
        img = _base_image(intensity[slot])
        pm = fs.pt_valid & (fs.pt["host"] == slot)
        us = np.round(fs.pt["u"][pm] + 0.5).astype(np.int64)
        vs = np.round(fs.pt["v"][pm] + 0.5).astype(np.int64)
        idp = fs.pt["idepth"][pm]
        imk = fs.im_valid & (fs.im["host"] == slot)
        ius = np.round(fs.im["u"][imk] + 0.5).astype(np.int64)
        ivs = np.round(fs.im["v"][imk] + 0.5).astype(np.int64)

        if mode in (0, 1):
            _draw_circ(img, us, vs, make_rainbow3(idp, rainbow_scale))
        elif mode == 3:
            st = fs.im["status"][imk]
            shown = np.isin(st, [trace_ops.IPS_GOOD, trace_ops.IPS_SKIPPED,
                                 trace_ops.IPS_BADCONDITION])
            mid = 0.5 * (fs.im["idepth_min"][imk] + fs.im["idepth_max"][imk])
            col = make_rainbow3(mid, rainbow_scale)
            col[~np.isfinite(fs.im["idepth_max"][imk])] = 0
            _draw_circ(img, ius[shown], ivs[shown], col[shown])
        elif mode == 4:
            col = np.zeros((imk.sum(), 3), np.uint8)
            for code, rgb in _STATUS_RGB.items():
                col[fs.im["status"][imk] == code] = rgb
            _draw_circ(img, ius, ivs, col)
        elif mode == 5:
            st = fs.im["status"][imk]
            shown = st != trace_ops.IPS_UNINITIALIZED
            d = np.clip(np.sqrt(np.maximum(fs.im["quality"][imk], 0)) - 1,
                        0, 1)
            col = np.stack([(1 - d) * 255, d * 255, np.zeros_like(d)],
                           -1).astype(np.uint8)
            _draw_circ(img, ius[shown], ivs[shown], col[shown])
        elif mode == 6:
            col = np.zeros((pm.sum(), 3), np.uint8)
            for code, rgb in _TYPE_RGB.items():
                col[fs.pt["type"][pm] == code] = rgb
            _draw_circ(img, us, vs, col)
        elif mode == 7:
            all_id = fs.pt["idepth"][fs.pt_valid]
            if all_id.size:
                lo = np.percentile(all_id, 5)
                hi = np.percentile(all_id, 95)
            else:
                lo, hi = 0.0, 1.0
            t = (idp - lo) / max(hi - lo, 1e-9)
            _draw_circ(img, us, vs, make_jet3(t))
        images.append(img)
    return images, stitch(images)


def debug_plot_tracking(fs):
    """debugPlotTracking (:21-76): for each window frame f, render every
    window frame f2 brightness-transferred into f's photometric domain
    (colL = a*I + b from AffLight::fromToVecExposure) and mark f's active
    points (3x3 squares, rainbow by idepth) on f's own image.

    Returns a list over f of stitched images.
    """
    out = []
    order = list(fs.order)
    intensity = _window_intensity(fs)
    for f in order:
        imgs = []
        for f2 in order:
            ef2 = float(fs.exposure[f2]) or 1.0
            ef = float(fs.exposure[f]) or 1.0
            a = np.exp(fs.aff[f][0] - fs.aff[f2][0]) * ef / ef2
            b = fs.aff[f][1] - a * fs.aff[f2][1]
            col = np.clip(a * intensity[f2] + b, 0, 255).astype(np.uint8)
            img = np.stack([col, col, col], -1)
            if f2 == f:
                pm = fs.pt_valid & (fs.pt["host"] == f)
                us = np.round(fs.pt["u"][pm] + 0.5).astype(np.int64)
                vs = np.round(fs.pt["v"][pm] + 0.5).astype(np.int64)
                _draw_sq9(img, us, vs,
                          make_rainbow3(fs.pt["idepth"][pm]))
            imgs.append(img)
        out.append(stitch(imgs))
    return out


class DebugPlotWriter:
    """Observer writing the window debug renderings per keyframe — the
    headless stand-in for the reference's live debugPlot windows
    (setting_render_renderWindowFrames / plotTrackingFull)."""

    def __init__(self, out_dir: str, mode: int = 0, tracking: bool = False,
                 every: int = 1):
        import os
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.mode = mode
        self.tracking = tracking
        self.every = max(1, every)
        self._n = 0

    # Output3DWrapper surface (unused events are no-ops)
    def publish_cam_pose(self, *a):
        pass

    def publish_keyframes(self, *a):
        pass

    def publish_graph(self, *a):
        pass

    def push_live_frame(self, *a):
        pass

    def push_depth_image(self, *a):
        pass

    def on_keyframe(self, fs):
        self._n += 1
        if self._n % self.every:
            return
        import os

        from sdv_loam_tpu_torch.io.images import write_image
        _, grid = debug_plot(fs, mode=self.mode)
        write_image(os.path.join(self.out_dir,
                                 f"window_{self._n:05d}.png"), grid)
        if self.tracking:
            for f, img in enumerate(debug_plot_tracking(fs)):
                write_image(os.path.join(
                    self.out_dir, f"tracking_{self._n:05d}_{f}.png"), img)

    def reset(self):
        self._n = 0

    def join(self):
        pass


def selector_debug_image(image: np.ndarray, status: np.ndarray) -> np.ndarray:
    """PixelSelector2 debug plot (:175-204): selected pixels as 3x3 squares,
    green / blue / red for cascade levels 1 / 2 / 4 over the dimmed image."""
    c = np.clip(np.asarray(image, np.float32) * 0.7, 0, 255).astype(np.uint8)
    img = np.stack([c, c, c], -1)
    for code, rgb in ((1, (0, 255, 0)), (2, (0, 0, 255)), (4, (255, 0, 0))):
        vs, us = np.nonzero(status == code)
        _draw_sq9(img, us, vs, np.tile(np.uint8(rgb), (us.size, 1)))
    return img
