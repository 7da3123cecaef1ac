"""The traffic generator: the torch renderer (float64, here on the CPU)
against the frozen NumPy generator, and the frozen copy against the
port's own generator at its texture seeds."""

import numpy as np
import pytest

from vo_bench import scene

TRAFFIC = dict(yaw_rates=[0.004, -0.006], step_m=0.7, half_width_m=16.0,
               ground_contrast=0.25, scene_seed=20260420)


def _rig(T_cl):
    return scene.Rig(w=320, h=96, fx=192.0, fy=192.0, cx=159.5, cy=47.5,
                     T_cam_lidar=T_cl, n_scan=64, horizon_scan=1800,
                     ang_res_x=0.2, ang_res_y=0.427, ang_bottom=24.9,
                     lidar_stride=2)


KITTI00_T_CL = np.array([
    [4.276802385584e-04, -9.999672484946e-01, -8.084491683471e-03,
     -1.198459927713e-02],
    [-7.210626507497e-03, 8.081198471645e-03, -9.999413164504e-01,
     -5.403984729748e-02],
    [9.999738645903e-01, 4.859485810390e-04, -7.206933692422e-03,
     -2.921968648686e-01],
    [0.0, 0.0, 0.0, 1.0]])


def test_torch_renderer_matches_the_numpy_generator():
    rig = _rig(KITTI00_T_CL)
    drives = scene.lane_drives(2, 7, TRAFFIC)
    got = scene.render_lanes(rig, drives, 7, "cpu", chunk=3)
    for j in range(2):
        for i in (0, 3, 6):
            img, cloud = scene.render_numpy(rig, drives[j], i)
            g_img, g_cloud = got[j][i]
            assert g_img.dtype == np.float32 and g_cloud.dtype == np.float32
            # float64 on both sides: a pixel may round apart in float32
            assert np.abs(g_img - img).max() <= 1e-3
            assert g_cloud.shape == cloud.shape
            assert np.abs(g_cloud - cloud).max() <= 1e-4


def test_lanes_differ_and_seeds_deal_the_same_drives():
    """Eight drives of their own, drive d on lane d, in every run."""
    a = scene.lane_drives(8, 3, TRAFFIC)
    key = lambda d: (d.yaw_rate, d.scene[0].tex_seed)
    assert len({d.scene[0].tex_seed for d in a}) == 8
    assert len({d.yaw_rate for d in a}) == 8
    assert [np.sign(d.yaw_rate) for d in a] == [1, -1] * 4
    again = scene.lane_drives(8, 3, TRAFFIC)
    assert list(map(key, again)) == list(map(key, a))


def test_planes_behind_every_camera_are_left_out_exactly():
    """The render with the culling against a cast over every plane."""
    import torch
    rig = _rig(KITTI00_T_CL)
    drive = scene.lane_drives(1, 90, TRAFFIC)[0]
    tab = scene._plane_tables(drive.scene, torch, "cpu")
    T = torch.tensor(drive.poses_wc[80:83])
    keep = scene._in_front(tab, T, torch)
    assert 0 < int(keep.sum()) < len(drive.scene)
    dirs = torch.tensor(rig.camera_dirs()) @ T[:, :3, :3].transpose(1, 2)
    a = scene._cast(scene._select(tab, keep), T[:, :3, 3], dirs, 0.15, 400.0,
                    1.0 / rig.fx, torch)
    b = scene._cast(tab, T[:, :3, 3], dirs, 0.15, 400.0, 1.0 / rig.fx, torch)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_frozen_copy_is_the_ports_generator():
    syn = pytest.importorskip("sdv_loam_tpu_torch.data.synthetic")
    seq = syn.make_sequence(n_frames=5, w=320, h=96, step=0.7,
                            yaw_rate=0.004, lidar_stride=2, half_width=16.0,
                            ground_contrast=0.25, follow_path=True,
                            cy_offset=0.0)
    c = seq.calib
    rig = scene.Rig(w=320, h=96, fx=c.fx[0], fy=c.fy[0], cx=c.cx[0],
                    cy=c.cy[0], T_cam_lidar=seq.sensor.T_cam_lidar,
                    n_scan=64, horizon_scan=1800, ang_res_x=0.2,
                    ang_res_y=0.427, ang_bottom=24.9, lidar_stride=2)
    poses = scene.make_trajectory(5, 0.7, 0.004)
    np.testing.assert_array_equal(poses, seq.poses_wc)
    drive = scene.Drive(poses, scene.scene_along_path(
        poses, half_width=16.0, ground_contrast=0.25), 0.004)
    for i in (0, 4):
        img, cloud = scene.render_numpy(rig, drive, i)
        p_img, p_cloud, _ = seq.get(i)
        np.testing.assert_array_equal(img, p_img)
        np.testing.assert_array_equal(cloud, p_cloud)
