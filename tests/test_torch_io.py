"""The port's io/ and data/noise modules, and its deep-log exports, against
the JAX package on the CPU:

  * the PNG codec of io/images.py against OpenCV's decoder (skipped where
    OpenCV is absent): 8-bit gray, RGB and 16-bit gray, each written with
    every one of the five row filters, and OpenCV's own files;
  * the observers: JsonlRecorder's events equal the JAX recorder's, the
    numpy viewer's PNGs decode to its panel size, Html3DViewer's file
    equals the JAX viewer's, and `debug_plot` / `debug_plot_tracking` on a
    port system equal the JAX package's functions run on the same host
    arrays, in every mode;
  * data/noise.py equal to the JAX package's for the same seeds;
  * `ba_core`'s H_final, b_final and nullspaces, and each lane of
    `ba_core_lanes`, against the JAX backend on tests/test_torch_backend.py's
    window.
"""

import json

import numpy as np
import pytest
import torch

from sdv_loam_tpu.data import noise as jnoise
from sdv_loam_tpu.data.synthetic import make_sequence
from sdv_loam_tpu.io import debug_plots as jdebug
from sdv_loam_tpu.io import observer as jobserver
from sdv_loam_tpu.io import viewer3d as jviewer3d
from sdv_loam_tpu.models import backend as jb
from sdv_loam_tpu_torch.config import Settings as TSettings
from sdv_loam_tpu_torch.data import noise as tnoise
from sdv_loam_tpu_torch.io import debug_plots as tdebug
from sdv_loam_tpu_torch.io import images
from sdv_loam_tpu_torch.io import observer as tobserver
from sdv_loam_tpu_torch.io import viewer as tviewer
from sdv_loam_tpu_torch.io import viewer3d as tviewer3d
from sdv_loam_tpu_torch.models import backend as tb
from sdv_loam_tpu_torch.system.full_system import FullSystem
from test_torch_backend import F, H, J, T, W, window  # noqa: F401

# the port's CPU ops are small: one intra-op thread per test process
torch.set_num_threads(1)

def _images():
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:96, 0:320]
    g8 = np.clip(127 + 100 * np.sin(x / 7.0) * np.cos(y / 5.0)
                 + rng.normal(0, 8, (96, 320)), 0, 255).astype(np.uint8)
    rgb = np.stack([g8, 255 - g8, (g8.astype(np.int64) * 3) % 256],
                   -1).astype(np.uint8)
    g16 = (g8.astype(np.uint16) * 257
           + rng.integers(0, 200, (96, 320))).astype(np.uint16)
    return dict(gray8=g8, rgb8=rgb, gray16=g16)


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "gray16"])
@pytest.mark.parametrize("filter_type", range(5))
def test_png_filters_against_opencv(tmp_path, kind, filter_type):
    cv2 = pytest.importorskip("cv2")
    img = _images()[kind]
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(images.encode_png(img, filter_type))
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if ref.ndim == 3:
        ref = ref[..., ::-1]                       # OpenCV's BGR
    np.testing.assert_array_equal(ref, img)
    got = images.read_image(path)
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "gray16"])
def test_png_reads_opencv_files(tmp_path, kind):
    """OpenCV (libpng) picks a filter per row: the codec must decode such
    files, and read_gray must agree with IMREAD_GRAYSCALE on gray ones."""
    cv2 = pytest.importorskip("cv2")
    img = _images()[kind]
    path = str(tmp_path / "x.png")
    assert cv2.imwrite(path, img[..., ::-1] if img.ndim == 3 else img)
    np.testing.assert_array_equal(images.read_image(path), img)
    if kind != "rgb8":
        np.testing.assert_array_equal(
            images.read_gray(path), cv2.imread(path, cv2.IMREAD_GRAYSCALE))


def test_write_image_roundtrip(tmp_path):
    img = np.random.default_rng(1).uniform(-20, 300, (40, 60, 3))
    path = str(tmp_path / "x.png")
    images.write_image(path, img)
    np.testing.assert_array_equal(images.read_image(path),
                                  np.clip(img, 0, 255).astype(np.uint8))
    with pytest.raises(ValueError):
        images.decode_png(b"not a png")


def test_jsonl_recorder_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    calls = [("publish_cam_pose", (3, 0.3, rng.normal(size=(4, 4)))),
             ("publish_keyframes", ([0, 1], rng.normal(size=(2, 4, 4)),
                                    rng.normal(size=(50, 3)),
                                    np.zeros(50, np.int64))),
             ("reset", ())]
    text = []
    for mod in (jobserver, tobserver):
        path = str(tmp_path / f"{mod.__name__}.jsonl")
        rec = mod.JsonlRecorder(path)
        for name, args in calls:
            getattr(rec, name)(*args)
        rec.join()
        text.append(open(path).read())
    assert text[0] == text[1]
    assert [json.loads(x)["event"] for x in text[1].splitlines()] == \
        ["cam_pose", "keyframes", "reset"]


def _keyframe_calls():
    rng = np.random.default_rng(3)
    poses = [np.eye(4) for _ in range(6)]
    for i, p in enumerate(poses):
        p[:3, 3] = [0.1 * i, 0.0, 0.8 * i]
    cams = np.stack(poses[-3:])
    pts = rng.normal(0, 1, (300, 3)) + [0.0, 0.0, 6.0]
    return poses, cams, pts, rng.integers(0, 8, 300)


def test_viewer_pngs_decode(tmp_path):
    poses, cams, pts, host = _keyframe_calls()
    v = tviewer.MatplotlibViewer(str(tmp_path / "view"), every=2)
    for i, p in enumerate(poses):
        v.publish_cam_pose(i, 0.1 * i, p)
        v.publish_keyframes([0, 1, 2], cams, pts, host)
    files = sorted((tmp_path / "view").iterdir())
    assert [f.name for f in files] == ["kf_00002.png", "kf_00004.png",
                                       "kf_00006.png"]
    img = images.read_image(str(files[-1]))
    assert img.shape == (tviewer.PANEL_H, 2 * tviewer.PANEL_W, 3)
    # the trajectory, the current position and the cameras are drawn
    assert (img == tviewer._BLUE).all(-1).sum() > 50
    assert (img == tviewer._RED).all(-1).sum() > 20


def test_viewer3d_matches_jax(tmp_path):
    poses, cams, pts, host = _keyframe_calls()
    text = []
    for mod in (jviewer3d, tviewer3d):
        path = str(tmp_path / f"{mod.__name__}.html")
        v = mod.Html3DViewer(path, every=2)
        for i, p in enumerate(poses):
            v.publish_cam_pose(i, 0.1 * i, p)
        v.publish_keyframes([0, 1, 2], cams, pts, host)
        v.join()
        text.append(open(path).read())
    assert text[0] == text[1]
    assert '"nKf": 1' in text[1]


@pytest.fixture(scope="module")
def port_system():
    """A port system six frames into tests/test_e2e.py's scene, with
    active and immature points, its immature mirror synced."""
    seq = make_sequence(n_frames=6, w=320, h=96, step=0.8, yaw_rate=0.01,
                        lidar_stride=2)
    fs = FullSystem(seq.calib, seq.sensor,
                    TSettings(desired_immature_density=600,
                              desired_point_density=800, n_active_cap=2048,
                              n_immature_cap=2048), device="cpu")
    for i in range(6):
        fs.add_active_frame(*seq.get(i))
    fs._sync_immature()
    assert len(fs.order) >= 3 and fs.im_valid.any()
    return fs


@pytest.mark.parametrize("mode", [0, 1, 3, 4, 5, 6, 7])
def test_debug_plot_matches_jax(port_system, mode):
    t_imgs, t_grid = tdebug.debug_plot(port_system, mode=mode)
    j_imgs, j_grid = jdebug.debug_plot(port_system, mode=mode)
    assert len(t_imgs) == len(port_system.order)
    for a, b in zip(t_imgs, j_imgs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t_grid, j_grid)
    # the overlay changed some pixels of the dimmed images
    inten = tdebug._window_intensity(port_system)
    assert any((img != tdebug._base_image(inten[s])).any()
               for img, s in zip(t_imgs, port_system.order))


def test_debug_plot_tracking_matches_jax(port_system):
    t = tdebug.debug_plot_tracking(port_system)
    j = jdebug.debug_plot_tracking(port_system)
    assert len(t) == len(port_system.order)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)


def test_debug_plot_writer(port_system, tmp_path):
    w = tdebug.DebugPlotWriter(str(tmp_path / "dbg"), tracking=True)
    w.on_keyframe(port_system)
    img = images.read_image(str(tmp_path / "dbg" / "window_00001.png"))
    assert img.shape == tdebug.debug_plot(port_system)[1].shape
    assert len(list((tmp_path / "dbg").glob("tracking_00001_*.png"))) == \
        len(port_system.order)
    status = np.zeros((96, 320), np.int8)
    status[10:20:3, 30:300:7] = 1
    status[50, 100] = 4
    np.testing.assert_array_equal(
        tdebug.selector_debug_image(np.full((96, 320), 100.0), status),
        jdebug.selector_debug_image(np.full((96, 320), 100.0), status))


@pytest.mark.parametrize("seed", [0, 5])
def test_noise_matches_jax(seed):
    img = _images()["gray8"].astype(np.float32)
    for fn, var in (("apply_photometric_noise", 1.5),
                    ("apply_blur_noise", 2.0)):
        a = getattr(tnoise, fn)(img, var, 3, seed)
        b = getattr(jnoise, fn)(img, var, 3, seed)
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, img)
    seq = make_sequence(n_frames=2, w=320, h=96)
    for i in range(2):
        a = tnoise.NoisySequence(seq, 1.0, 1.0, seed=seed).get(i)
        b = jnoise.NoisySequence(seq, 1.0, 1.0, seed=seed).get(i)
        np.testing.assert_array_equal(a[0], b[0])


def _ba_args(w, conv, eps_scale=1.0):
    D = 4 + 6 * F
    rng = np.random.default_rng(4)
    A = rng.normal(0, 1, (D, D))
    HM = (A @ A.T * 10.0).astype(np.float32)
    HM[:, 4 + 18:] = 0.0
    HM[4 + 18:, :] = 0.0
    bM = rng.normal(0, 1, D).astype(np.float32)
    bM[4 + 18:] = 0.0
    fprior = np.zeros((F, 6), np.float32)
    fprior[0] = [1e10] * 3 + [1e11] * 3
    eps = (w["eps"] * eps_scale).astype(np.float32)
    tensors = [w["T_cw_fej"], eps, w["K"], w["K"], w["fvalid"], fprior,
               np.full(4, 5e9 / 2500.0, np.float32), w["aff"], w["expo"],
               HM, bM]
    pts = [w["feth"], w["u"], w["v"], w["idepth"], w["host"], w["color"],
           w["weights"], w["is_sensor"], w["prior"], w["res_active"],
           w["res_state"], w["matcher_px"], w["matcher_valid"], w["stack"]]
    return [conv(x) for x in tensors], [conv(x) for x in pts]


BA_ITERS = 3


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_ba(w, eps_scale=1.0):
    head, pts = _ba_args(w, J, eps_scale)
    out = jb.ba_optimize_jit(*head, 2, *pts, BA_ITERS, 1, 1.0, False,
                             n_frames=F, w=W, h=H)
    return {k: np.asarray(out[k], np.float64)
            for k in ("H_final", "b_final", "nullspaces")}


def test_ba_core_deep_log_exports_match_jax(window):  # noqa: F811
    """H_final, b_final and nullspaces of the final BA linearization within
    1e-4 relative (norm-wise) of the JAX backend's."""
    head, pts = _ba_args(window, T)
    out, _, _ = tb.ba_core(*head, 2, *pts, BA_ITERS, 1, 1.0, False,
                           n_frames=F, w=W, h=H)
    ref = _jax_ba(window)
    assert int(out["lm_iters"]) >= 1
    for k, b in ref.items():
        a = out[k].double().numpy()
        assert a.shape == b.shape
        assert _rel(a, b) < 1e-4, (k, _rel(a, b))


def test_ba_core_lanes_deep_log_exports_match_jax(window):  # noqa: F811
    """The same exports per lane of a two-window `ba_core_lanes` call
    (the second window's eps scaled), each against its JAX window."""
    scales = (1.0, 2.0)
    lanes = [_ba_args(window, T, s) for s in scales]
    head = [torch.stack(x) for x in zip(*(ln[0] for ln in lanes))]
    pts = [torch.stack(x) for x in zip(*(ln[1] for ln in lanes))]
    out, _, _ = tb.ba_core_lanes(*head, [2, 2], pts[0], *pts[1:],
                                 [BA_ITERS] * 2, [1] * 2, [1.0] * 2,
                                 [False] * 2, n_frames=F, w=W, h=H)
    for j, s in enumerate(scales):
        ref = _jax_ba(window, s)
        for k, b in ref.items():
            a = out[k][j].double().numpy()
            assert _rel(a, b) < 1e-4, (j, k, _rel(a, b))
