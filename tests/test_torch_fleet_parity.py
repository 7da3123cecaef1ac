"""The port's fleet path against the JAX package, on the CPU.

  * hand-over parity of the batched track step: two JAX FullSystems run
    six frames of tests/test_multi.py's two 320x96 scenes and are
    checkpointed; the port loads both files, and the JAX MultiSystem and
    the port's MultiSystem(batch_track=True) each take frame 6 (the port
    in the stage form and as stage programs);
  * the same hand-over through the batched keyframe stages, on
    mid-binned scans: both lanes take a keyframe at frame 6 (trace,
    selection with the JAX draws, activation, the keyframe optimization),
    and each lane's window, its keyframe count and its BA outputs are held
    to the JAX lockstep's;
  * the port's preprocess_scan_batch against the JAX package's on two
    scans as lanes of one batch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_parity import jax_dir_source, load_jax, mid_bin, mid_binned, \
    pose_diff
from sdv_loam_tpu.config import Settings as JSettings
from sdv_loam_tpu.data.synthetic import make_sequence
from sdv_loam_tpu.ops import lidar as jl
from sdv_loam_tpu.system import checkpoint as jcheckpoint
from sdv_loam_tpu.system.full_system import FullSystem as JFullSystem
from sdv_loam_tpu.system.multi import MultiSystem as JMultiSystem
from sdv_loam_tpu_torch.config import Settings
from sdv_loam_tpu_torch.ops import lidar as tl
from sdv_loam_tpu_torch.system import checkpoint as tcheckpoint
from sdv_loam_tpu_torch.system.multi import MultiSystem
from sdv_loam_tpu_torch.utils import device_loop

# the port's CPU ops are small: one intra-op thread per test process
# keeps parallel test workers (xdist) from oversubscribing the cores,
# where OpenMP's spinning barriers slow every op down by orders of
# magnitude
torch.set_num_threads(1)

SETTINGS = dict(desired_immature_density=600, desired_point_density=800,
                n_active_cap=2048, n_immature_cap=2048)


@pytest.fixture(scope="module")
def seqs():
    return [make_sequence(n_frames=7, w=320, h=96, step=0.8, yaw_rate=yr,
                          lidar_stride=2)
            for yr in (0.004, 0.012)]


@pytest.fixture(scope="module")
def frames(seqs):
    return [[seq.get(i) for i in range(7)] for seq in seqs]


def test_batched_track_matches_jax_multi(seqs, frames, tmp_path):
    """Hand-over parity of the batched track step: two JAX systems run six
    frames and are checkpointed; the port loads both, and the JAX
    MultiSystem and the port's MultiSystem(batch_track=True) each take
    frame 6. Each lane is held to the JAX lane's poses: measured
    photometric poses 1.1e-6 m / 3.0e-8 rad apart at most (bound 1e-5 m,
    1e-6 rad), tracked poses 3.5e-6 m / 2.5e-7 rad (bound 1e-4 m, 2e-6
    rad). The port takes the frame twice from the same checkpoints: in the
    stage form (the CPU default) and as stage programs in the CPU program
    mode (`device_loop.programs`: every loop to its cap, every cond
    computed and selected), each held to the same bounds, so the JAX side
    runs once."""
    jms, tfs, tfs_prog = [], [], []
    for k, seq in enumerate(seqs):
        j = JFullSystem(seq.calib, seq.sensor, JSettings(**SETTINGS))
        for i in range(6):
            j.add_active_frame(*frames[k][i])
        path = str(tmp_path / f"lane{k}.npz")
        jcheckpoint.save(j, path)
        jms.append(jcheckpoint.load(path, seq.calib, seq.sensor,
                                    JSettings(**SETTINGS)))
        for out in (tfs, tfs_prog):
            out.append(tcheckpoint.load(path, seq.calib, seq.sensor,
                                        Settings(**SETTINGS), device="cpu"))
    JMultiSystem(jms, batch_track=True, host_workers=0).add_frames(
        [fr[6] for fr in frames])
    MultiSystem(tfs, batch_track=True, host_workers=0).add_frames(
        [fr[6] for fr in frames])
    with device_loop.programs():
        MultiSystem(tfs_prog, batch_track=True, host_workers=0).add_frames(
            [fr[6] for fr in frames])
    for j, t in [*zip(jms, tfs), *zip(jms, tfs_prog)]:
        assert not j.is_lost and not t.is_lost
        dt, dr = pose_diff(j.shells[6]["T_wc_photo"],
                           t.shells[6]["T_wc_photo"])
        assert dt < 1e-5 and dr < 1e-6, (dt, dr)
        dt, dr = pose_diff(j.shells[6]["T_wc_tracked"],
                           t.shells[6]["T_wc_tracked"])
        assert dt < 1e-4 and dr < 2e-6, (dt, dr)
        assert t.shells[6]["n_matched"] == j.shells[6]["n_matched"]
        assert t.shells[6]["n_matched"] > 10


def test_batched_keyframe_matches_jax_multi(seqs, frames, tmp_path):
    """Hand-over parity through the batched keyframe stages: as
    test_batched_track_matches_jax_multi, at frame 6, where both lanes
    take a keyframe (trace, selection with the JAX draws, activation and
    the keyframe optimization as lanes of one call each).

    The scans are mid-binned (`jax_parity.mid_bin`) from frame 0, so that
    both packages select the same points, and the JAX lockstep loads its
    checkpoints with the window's pyramid stack (`jax_parity.load_jax`),
    which the JAX package's own load leaves unset. Per lane: the keyframe
    count and the window's slots equal the JAX lockstep's; the tracked
    pose (before the tail) within test_batched_track_matches_jax_multi's
    bounds (measured 1.6e-6 m / 1.3e-7 rad); the lane within 1e-5 of the same checkpoint's port system
    taking the frame alone; the BA's HM and bM within
    tests/test_torch_backend.py's bounds (1e-3 of the block's scale); the
    window poses within 1e-4 m and 1e-5 rad of the JAX lockstep's and eps
    within 1e-6 (measured 1.6e-6 m / 1.3e-7 rad and 7.4e-7 m / 4.1e-8
    rad, eps equal: both LMs reject every step here).

    Both steps are needed. Without the stack the JAX side matches its new
    points against zero images in the matcher's second pass (E0 2478.45
    over 3678 residuals against 2483.43 over 3775 with it); on the ring
    edges the selections differ by a few percent of their points. And at
    this keyframe the 2-D energy does not move with the poses (FEJ
    residuals, LiDAR depths), so the first step's E_new equals E0 to one
    or two float32 ulps and `E_new < E_last` follows the last bit: on
    the raw scans the JAX package accepts (E0 2642.639160, E_new
    2642.638916) where the port rejects (2641.875732 twice), and the
    windows part by up to 2.6 cm."""
    mid = [mid_binned(fr) for fr in frames]
    jms, tfs, singles = [], [], []
    for k, seq in enumerate(seqs):
        j = JFullSystem(seq.calib, seq.sensor, JSettings(**SETTINGS))
        for i in range(6):
            j.add_active_frame(*mid[k][i])
        path = str(tmp_path / f"lane{k}.npz")
        jcheckpoint.save(j, path)
        jms.append(load_jax(path, seq.calib, seq.sensor,
                            JSettings(**SETTINGS)))
        for out in (tfs, singles):
            t = tcheckpoint.load(path, seq.calib, seq.sensor,
                                 Settings(**SETTINGS), device="cpu")
            t._dir_source = jax_dir_source(jms[-1]._rng_key, t.h, t.w)
            out.append(t)
    JMultiSystem(jms, batch_track=True, host_workers=0).add_frames(
        [fr[6] for fr in mid])
    MultiSystem(tfs, batch_track=True, host_workers=0).add_frames(
        [fr[6] for fr in mid])
    for t, fr in zip(singles, mid):
        t.add_active_frame(*fr[6])
    for j, t, one in zip(jms, tfs, singles):
        assert not j.is_lost and not t.is_lost
        assert j.shells[6]["is_kf"] and t.shells[6]["is_kf"]
        assert len(t.kf_shells) == len(j.kf_shells)
        assert t.order == j.order
        dt, dr = pose_diff(j.shells[6]["T_wc_tracked"],
                           t.shells[6]["T_wc_tracked"])
        assert dt < 1e-4 and dr < 2e-6, (dt, dr)
        np.testing.assert_allclose(t.get_trajectory(), one.get_trajectory(),
                                   atol=1e-5)
        for sl in t.order:
            dt, dr = pose_diff(j.shells[j.frame_shell_idx[sl]]["T_wc"],
                               t.shells[t.frame_shell_idx[sl]]["T_wc"])
            assert dt < 1e-4 and dr < 1e-5, (sl, dt, dr)
        np.testing.assert_allclose(t.eps, np.asarray(j.eps), atol=1e-6)
        for name in ("HM", "bM"):
            a, b = getattr(t, name), np.asarray(getattr(j, name))
            np.testing.assert_allclose(a, b, rtol=1e-3,
                                       atol=1e-3 * max(np.abs(b).max(), 1e-9),
                                       err_msg=name)


def test_preprocess_scan_batch_matches_jax(seqs):
    """Two scans as lanes of one batch against the JAX package's
    preprocess_scan_batch: segmentation exact, per lane."""
    cap = 1 << 17
    sensor = seqs[0].sensor
    calib = seqs[0].calib
    K = np.array([calib.fx[0], calib.fy[0], calib.cx[0], calib.cy[0]],
                 np.float32)
    R = np.asarray(sensor.R_cl, np.float32)
    t = np.asarray(sensor.t_cl, np.float32)
    bufs, masks = [], []
    for k, seq in enumerate(seqs):
        cloud = mid_bin(seq.get_cloud(3 * k + 1))
        buf = np.zeros((cap, 3), np.float32)
        buf[:cloud.shape[0]] = cloud
        mask = np.zeros(cap, bool)
        mask[:cloud.shape[0]] = True
        bufs.append(buf)
        masks.append(mask)
    jo = jl.preprocess_scan_batch(
        tuple((jnp.asarray(b), jnp.asarray(m), jnp.asarray(R),
               jnp.asarray(t), *[np.float32(x) for x in K])
              for b, m in zip(bufs, masks)), w=320, h=96)
    to = tl.preprocess_scan_batch(
        torch.from_numpy(np.stack(bufs)), torch.from_numpy(np.stack(masks)),
        torch.from_numpy(np.stack([R, R])), torch.from_numpy(np.stack([t, t])),
        torch.from_numpy(np.stack([K, K])), w=320, h=96)
    for lane in range(2):
        np.testing.assert_array_equal(to["seg_mask"][lane].numpy(),
                                      np.asarray(jo["seg_mask"][lane]))
        np.testing.assert_array_equal(
            np.isfinite(to["range_img"][lane].numpy()),
            np.isfinite(np.asarray(jo["range_img"][lane])))
        assert float(to["bbox_area"][lane]) == float(jo["bbox_area"][lane])
        np.testing.assert_array_equal(to["depth_map"][lane].numpy() > 0,
                                      np.asarray(jo["depth_map"][lane]) > 0)
    # the lanes are distinct scans, and each lane is its unbatched scan
    assert not np.array_equal(to["seg_mask"][0].numpy(),
                              to["seg_mask"][1].numpy())
    one = tl.preprocess_scan(torch.from_numpy(bufs[1]),
                             torch.from_numpy(masks[1]), torch.from_numpy(R),
                             torch.from_numpy(t), *[float(x) for x in K],
                             320, 96)
    for k in one:
        assert torch.equal(one[k], to[k][1]), k
