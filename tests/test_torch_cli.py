"""The port's command line, runner observers, deep logs and LiDAR-dropout
frames on the CPU:

  * `python -m sdv_loam_tpu_torch.run --device cpu` on the synthetic scene
    and on a `write_kitti_fixture` directory with every observer flag
    (tests/test_runner.py's and tests/test_kitti_e2e.py's asserts), the
    port's KITTI reader against the JAX package's on the same files, and
    `run_sequence` with observers;
  * LiDAR dropout (every third frame after the first two without a cloud)
    on tests/test_e2e.py's scene: a hand-over from a JAX checkpoint to both
    packages, then a dropout frame tracked by each (1 mm / 5e-4 rad); the
    whole run within test_e2e's ATE bound, with one Hessian deep-log line
    per optimized keyframe; pipelined and deferred-readback runs equal to
    the sequential one, their observer events too.
"""

import json

import numpy as np
import pytest
import torch

from sdv_loam_tpu.config import Settings as JSettings
from sdv_loam_tpu.data.kitti import KittiSequence as JKitti
from sdv_loam_tpu.data.synthetic import make_sequence
from sdv_loam_tpu.system import checkpoint as jcheckpoint
from sdv_loam_tpu.system.full_system import FullSystem as JFullSystem
from sdv_loam_tpu_torch import run as cli
from sdv_loam_tpu_torch.config import Settings as TSettings
from sdv_loam_tpu_torch.data import synthetic as tsyn
from sdv_loam_tpu_torch.data.kitti import KittiSequence as TKitti
from sdv_loam_tpu_torch.data.kitti_fixture import write_kitti_fixture
from sdv_loam_tpu_torch.eval.ate import ate_rmse
from sdv_loam_tpu_torch.io import images
from sdv_loam_tpu_torch.io.observer import JsonlRecorder
from sdv_loam_tpu_torch.system import checkpoint as tcheckpoint
from sdv_loam_tpu_torch.system.runner import run_sequence

# the port's CPU ops are small: one intra-op thread per test process
torch.set_num_threads(1)

N_KITTI = 14
# tests/test_e2e.py's scene and settings
SCENE = dict(w=320, h=96, step=0.8, yaw_rate=0.01, lidar_stride=2)
SETTINGS = dict(desired_immature_density=600, desired_point_density=800,
                n_active_cap=2048, n_immature_cap=2048, ba_resf_at_fej=False)
N_DROP = 12


def _rows_to_T(rows):
    T = np.tile(np.eye(4), (rows.shape[0], 1, 1))
    T[:, :3, :] = rows.reshape(-1, 3, 4)
    return T


def test_cli_synthetic_cpu(tmp_path, monkeypatch):
    orig = tsyn.make_sequence

    def tiny_sequence(**kw):
        return orig(n_frames=5, w=256, h=96, lidar_stride=4)
    monkeypatch.setattr(tsyn, "make_sequence", tiny_sequence)
    out = tmp_path / "traj.txt"
    rc = cli.main(["--synthetic", "5", "--result", str(out), "--preset", "2",
                   "--device", "cpu"])
    assert rc == 0
    assert np.loadtxt(str(out)).shape == (5, 12)
    assert cli.build_parser().parse_args([]).device == "cuda"
    assert cli.main(["--device", "cpu"]) == 2      # no input given


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    seq = make_sequence(n_frames=N_KITTI, w=320, h=96)
    return write_kitti_fixture(seq, str(tmp_path_factory.mktemp("kitti")))


def test_kitti_reader_matches_jax(fixture_dir):
    """The port's reader (its own PNG codec) returns what the JAX reader
    (OpenCV) returns from the same files."""
    pytest.importorskip("cv2")
    args = (fixture_dir["seq_dir"], fixture_dir["calib"],
            fixture_dir["sensor"])
    t, j = TKitti.open(*args), JKitti.open(*args)
    assert len(t) == len(j) == N_KITTI
    for i in (0, 3):
        (ti, tc, tt), (ji, jc, jt) = t.get(i), j.get(i)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tc, jc)
        assert tt == jt


def test_cli_on_kitti_fixture_cpu(fixture_dir, tmp_path):
    d = tmp_path
    result = str(d / "traj.txt")
    rc = cli.main(["--seq-dir", fixture_dir["seq_dir"],
                   "--calib", fixture_dir["calib"],
                   "--sensor", fixture_dir["sensor"], "--result", result,
                   "--preset", "0", "--device", "cpu",
                   "--record", str(d / "rec.jsonl"),
                   "--log", str(d / "log.jsonl"),
                   "--viewer", str(d / "view"),
                   "--viewer3d", str(d / "map.html"),
                   "--debug-plots", str(d / "dbg"),
                   "--checkpoint", str(d / "ck.npz")])
    assert rc == 0, "CLI reported lost tracking"
    est_rows = np.loadtxt(result)
    assert est_rows.shape == (N_KITTI, 12)
    est = _rows_to_T(est_rows)
    gt = _rows_to_T(np.loadtxt(fixture_dir["poses"]))
    path_len = np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1))
    assert ate_rmse(est, gt) < 0.01 * path_len
    kinds = [json.loads(x)["event"] for x in open(d / "rec.jsonl")]
    assert "cam_pose" in kinds and "keyframes" in kinds
    assert any(json.loads(x)["kind"] == "keyframe"
               for x in open(d / "log.jsonl"))
    for sub in ("view", "dbg"):
        files = sorted((d / sub).glob("*.png"))
        assert len(files) == kinds.count("keyframes")
        assert images.read_image(str(files[-1])).ndim == 3
    assert "sdv_loam_tpu map" in (d / "map.html").read_text()
    back = tcheckpoint.load(str(d / "ck.npz"), TKitti.open(
        fixture_dir["seq_dir"], fixture_dir["calib"],
        fixture_dir["sensor"]).calib, None, TSettings.preset_default(),
        device="cpu")
    # the result file holds the trajectory to its printed precision
    np.testing.assert_allclose(back.get_trajectory()[:, :3, :].reshape(
        N_KITTI, 12), est_rows, rtol=1e-6, atol=1e-9)


def test_run_sequence_with_observers(tmp_path):
    """tests/test_runner.py's asserts on the port."""
    seq = make_sequence(n_frames=6, w=256, h=96, step=0.8, lidar_stride=4)
    s = TSettings(desired_immature_density=400, desired_point_density=500,
                  n_active_cap=1024, n_immature_cap=1024)
    rec = JsonlRecorder(str(tmp_path / "events.jsonl"))
    fs, summary = run_sequence(seq, s, device="cpu", observers=[rec],
                               result_path=str(tmp_path / "traj.txt"),
                               log_path=str(tmp_path / "log.jsonl"),
                               prefetch=False)
    assert summary["frames"] == 6 and summary["keyframes"] >= 2
    assert summary["fps"] > 0 and "track" in summary["stages_ms"]
    assert np.loadtxt(str(tmp_path / "traj.txt")).shape == (6, 12)
    kinds = {json.loads(x)["event"] for x in open(tmp_path / "events.jsonl")}
    assert "cam_pose" in kinds and "keyframes" in kinds
    logs = [json.loads(x) for x in open(tmp_path / "log.jsonl")]
    assert any(e["kind"] == "keyframe" for e in logs)


def _dropout(frames):
    """Every third frame after the first two loses its cloud."""
    return [(img, None if i >= 2 and i % 3 == 2 else c, ts)
            for i, (img, c, ts) in enumerate(frames)]


@pytest.fixture(scope="module")
def drop_seq():
    seq = make_sequence(n_frames=N_DROP, **SCENE)
    return seq, _dropout([seq.get(i) for i in range(N_DROP)])


def _pose_diff(A, B):
    d = np.linalg.inv(A) @ B
    return (float(np.linalg.norm(d[:3, 3])),
            float(np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1))))


def test_dropout_handover_tracking_matches_jax(drop_seq, tmp_path):
    """The JAX state after frames 0-4 (frame 2 without a cloud) loads into
    both packages; both track frame 5, a dropout frame."""
    seq, frames = drop_seq
    jfs = JFullSystem(seq.calib, seq.sensor, JSettings(**SETTINGS))
    for i in range(5):
        jfs.add_active_frame(*frames[i])
    path = str(tmp_path / "ckpt.npz")
    jcheckpoint.save(jfs, path)
    jres = jcheckpoint.load(path, seq.calib, seq.sensor,
                            JSettings(**SETTINGS))
    tfs = tcheckpoint.load(path, seq.calib, seq.sensor,
                           TSettings(**SETTINGS), device="cpu")
    assert frames[5][1] is None
    jres.add_active_frame(*frames[5])
    tfs.add_active_frame(*frames[5])
    assert not tfs.is_lost and not jres.is_lost
    dt, dr = _pose_diff(jres.shells[5]["T_wc_tracked"],
                        tfs.shells[5]["T_wc_tracked"])
    assert dt < 1e-3, dt
    assert dr < 5e-4, dr
    assert tfs.shells[5]["n_matched"] == jres.shells[5]["n_matched"]


class _Frames:
    def __init__(self, seq, frames):
        self.calib, self.sensor, self.frames = seq.calib, seq.sensor, frames

    def __len__(self):
        return len(self.frames)

    def get(self, i):
        return self.frames[i]


@pytest.fixture(scope="module")
def drop_runs(drop_seq, tmp_path_factory):
    """The dropout sequence through run_sequence sequentially (with the
    deep logs), pipelined, and pipelined with the deferred readback, each
    with a JsonlRecorder."""
    seq, frames = drop_seq
    d = tmp_path_factory.mktemp("drop")
    runs = {}
    for name, kw in (("sequential", dict(pipelined_frames=False,
                                         log_stuff=True)),
                     ("pipelined", dict(pipelined_frames=True)),
                     ("deferred", dict(pipelined_frames=True,
                                       deferred_kf_readback=True))):
        rec = str(d / f"{name}.jsonl")
        log = str(d / f"{name}.log")
        fs, summary = run_sequence(
            _Frames(seq, frames), TSettings(**SETTINGS, **kw), device="cpu",
            observers=[JsonlRecorder(rec)], log_path=log, prefetch=False,
            allow_reset=False)
        runs[name] = dict(fs=fs, traj=fs.get_trajectory(),
                          events=[json.loads(x) for x in open(rec)],
                          log=[json.loads(x) for x in open(log)])
    return runs


def test_dropout_run_accuracy_and_deep_logs(drop_seq, drop_runs):
    seq, _ = drop_seq
    r = drop_runs["sequential"]
    fs = r["fs"]
    assert not fs.is_lost and len(fs.kf_shells) >= 3
    assert ate_rmse(r["traj"], seq.poses_wc[:N_DROP]) < 0.12
    # the dropout keyframes selected monocular (non-sensor) candidates
    assert not fs.im["is_sensor"][fs.im_valid].all()
    kinds = [e["kind"] for e in r["log"]]
    # one Hessian line per optimized keyframe (all but the first)
    assert kinds.count("hessian") == len(fs.kf_shells) - 1
    assert kinds.count("keyframe") == len(fs.kf_shells) - 1
    assert kinds.count("nums") == len(fs.kf_shells) - 1
    assert kinds.count("coarse_tracking") == N_DROP - 1
    assert kinds.count("lifetime") == N_DROP
    h = next(e for e in r["log"] if e["kind"] == "hessian")
    assert len(h["eigen_all"]) == 4 + 6 * TSettings().n_frames_cap
    assert np.isfinite(h["nullspace_H_prods"]).all()


@pytest.mark.parametrize("mode", ["pipelined", "deferred"])
def test_dropout_pipelined_equals_sequential(drop_runs, mode):
    seq_r, r = drop_runs["sequential"], drop_runs[mode]
    assert len(r["fs"].kf_shells) == len(seq_r["fs"].kf_shells)
    # pipelined: the same trajectory; deferred readback: the frame after
    # each keyframe tracks against the device-built window, as in the
    # JAX package (test_torch_pipelined.py's bound)
    tol = 1e-6 if mode == "pipelined" else 5e-3
    assert np.abs(r["traj"] - seq_r["traj"]).max() <= tol
    if mode == "pipelined":
        assert r["events"] == seq_r["events"]
    # the same events in the same order: each frame's pose, each
    # keyframe's window (deferred: published one frame later, before the
    # next frame's pose, as in sequential mode)
    def order(events):
        return [(e["event"], e.get("id"), e.get("ids")) for e in events]
    assert order(r["events"]) == order(seq_r["events"])
