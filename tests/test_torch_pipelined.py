"""The port's pipelined mode, deferred keyframe readback and the two
diagnostics that live in the same code, on CPU torch.

Mirrors tests/test_pipelined.py (its 320x96 scene and settings): the
pipelined mode defers frame N's readback and keyframe work to the call
of frame N+1, after N+1's pyramid is staged, so its trajectory must match
sequential mode; with the keyframe readback deferred as well, the next
frame tracks against device-built window constants and only the accuracy
has to be equivalent.
"""

import numpy as np
import pytest
import torch

from sdv_loam_tpu_torch.config import Settings
from sdv_loam_tpu_torch.data.synthetic import make_sequence
from sdv_loam_tpu_torch.eval.ate import ate_rmse
from sdv_loam_tpu_torch.system.full_system import FullSystem
from sdv_loam_tpu_torch.system.runner import run_sequence

# the port's CPU ops are small: one intra-op thread per test process
# keeps parallel test workers (xdist) from oversubscribing the cores,
# where OpenMP's spinning barriers slow every op down by orders of
# magnitude
torch.set_num_threads(1)

N_FRAMES = 16
SETTINGS = dict(desired_immature_density=600, desired_point_density=800,
                n_active_cap=2048, n_immature_cap=2048)


@pytest.fixture(scope="module")
def seq():
    return make_sequence(n_frames=N_FRAMES, w=320, h=96, step=0.8,
                         yaw_rate=0.01, lidar_stride=2)


@pytest.fixture(scope="module")
def frames(seq):
    return [seq.get(i) for i in range(N_FRAMES)]


def _run(seq, frames, n=N_FRAMES, **kw):
    fs = FullSystem(seq.calib, seq.sensor, Settings(**SETTINGS, **kw),
                    device="cpu")
    for f in frames[:n]:
        fs.add_active_frame(*f)
    fs.flush()
    return fs


@pytest.fixture(scope="module")
def seq_run(seq, frames):
    return _run(seq, frames)


@pytest.fixture(scope="module")
def pipe_run(seq, frames):
    return _run(seq, frames, pipelined_frames=True)


def test_pipelined_matches_sequential(seq_run, pipe_run):
    assert not seq_run.is_lost and not pipe_run.is_lost
    a = seq_run.get_trajectory()
    b = pipe_run.get_trajectory()
    assert a.shape == b.shape == (N_FRAMES, 4, 4)
    # the mode changes WHEN readbacks happen, not what is computed
    np.testing.assert_allclose(b, a, atol=1e-5)
    assert len(pipe_run.kf_shells) == len(seq_run.kf_shells)
    assert pipe_run.telemetry.n_frames == seq_run.telemetry.n_frames


def test_deferred_kf_readback_quality(seq, frames, seq_run):
    fs = _run(seq, frames, pipelined_frames=True, deferred_kf_readback=True)
    assert not fs.is_lost
    assert fs._deferred_kf is None and fs._pending is None
    gt = seq.poses_wc[:N_FRAMES]
    ate_seq = ate_rmse(seq_run.get_trajectory(), gt)
    ate_def = ate_rmse(fs.get_trajectory(), gt)
    assert ate_def < max(2.0 * ate_seq, 0.02), (ate_def, ate_seq)
    assert len(fs.kf_shells) == len(seq_run.kf_shells)
    # every deferred readback was applied at a later drain
    assert fs.telemetry.stage_count["kf.resolve"] == \
        fs.telemetry.stage_count["kf.opt"]


def test_pipelined_flush_idempotent(pipe_run):
    t1 = pipe_run.get_trajectory()
    pipe_run.flush()
    pipe_run.flush()
    np.testing.assert_array_equal(pipe_run.get_trajectory(), t1)
    assert pipe_run._pending is None


def test_pipelined_lags_one_frame(seq, frames, pipe_run):
    """Before the flush the last frame is still in flight: its shell
    exists, its pose is not yet tracked."""
    fs = FullSystem(seq.calib, seq.sensor,
                    Settings(**SETTINGS, pipelined_frames=True), device="cpu")
    for f in frames[:6]:
        fs.add_active_frame(*f)
    assert fs._pending is not None and len(fs.shells) == 6
    assert fs.telemetry.n_frames == 5
    np.testing.assert_array_equal(fs.shells[-1]["T_wc"], np.eye(4))
    fs.flush()
    assert fs.telemetry.n_frames == 6
    np.testing.assert_array_equal(fs.get_trajectory()[5],
                                  pipe_run.get_trajectory()[5])


def test_run_sequence_pipelined(seq, pipe_run):
    """run_sequence drives pipelined settings and flushes before its
    summary: every frame counted, the trajectory complete."""
    fs, summary = run_sequence(
        seq, Settings(**SETTINGS, pipelined_frames=True), device="cpu",
        prefetch=False)
    assert summary["frames"] == N_FRAMES and not summary["lost"]
    assert fs._pending is None
    np.testing.assert_array_equal(fs.get_trajectory(),
                                  pipe_run.get_trajectory())


@pytest.fixture(scope="module")
def diag_run(seq, frames):
    """A BA step bound tight enough to veto every window step, with the
    damped retry, and a weak pose prior on every inserted keyframe."""
    return _run(seq, frames, ba_step_veto_m=1e-4, ba_step_veto_rad=1e-5,
                ba_veto_damped_retry=1e-2, frame_pose_prior_t=2.0,
                frame_pose_prior_r=3.0)


def test_ba_veto_damped_retry_fires_and_recovers(diag_run):
    c = diag_run.telemetry.counters
    assert not diag_run.is_lost
    assert c["ba_step_veto"] > 0
    # a damped retry that is still insane falls back to the binary veto
    assert 0 <= c["ba_step_veto_hard"] <= c["ba_step_veto"]
    assert len(diag_run.get_trajectory()) == N_FRAMES


def test_frame_pose_prior_lands_in_each_inserted_slot(diag_run):
    fs = diag_run
    prior = np.array([2.0] * 3 + [3.0] * 3, np.float32)
    kf0 = [sl for sl in fs.order if fs.frame_kf_id[sl] == 0]
    for sl in fs.order:
        if sl in kf0:        # the first keyframe keeps the gauge prior
            assert fs.frame_prior[sl][0] == 1e10
        else:
            np.testing.assert_array_equal(fs.frame_prior[sl], prior)
    assert len(fs.order) >= 3
