"""The port's multi-device layer (`sdv_loam_tpu_torch/parallel/`) on the
CPU, the counterpart of tests/test_parallel.py:

  * `_single_step` against the JAX package's on `make_example_batch(2,
    seed=0)` (the same numpy arrays through both);
  * `make_batched_step` over a two-device mesh ([cpu, cpu]): each lane bit
    for bit `_single_step` run alone (the step runs lane by lane);
  * the dry-runs: the lockstep fleet's batched programs fire, a pinned
    fleet's systems hold their state on their devices and track bit for
    bit as alone, the production lane forms run finite over the mesh.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdv_loam_tpu.parallel import mesh as jmesh
from sdv_loam_tpu_torch.parallel import dryrun, mesh
from sdv_loam_tpu_torch.utils.se3 import se3_exp, se3_log

# the port's CPU ops are small: one intra-op thread per test process
torch.set_num_threads(1)

W, H, F, LEVELS = 128, 64, 4, 3
CPU2 = ("cpu", "cpu")


def test_example_batch_is_the_jax_packages():
    got = mesh.make_example_batch(3, w=W, h=H, F=F, seed=5)
    want = jmesh.make_example_batch(3, w=W, h=H, F=F, seed=5)
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g, w)
    assert got[0].keys() == want[0].keys()
    for k in want[0]:
        assert got[0][k].dtype == want[0][k].dtype, k
        assert np.array_equal(got[0][k], want[0][k]), k


def test_single_step_matches_jax():
    """The reduced step (pyramid, splat, K1's tracking reference, the
    coarse-to-fine track, one windowed-BA linearize / build / solve) of
    both lanes against the JAX package's on the same arrays.

    The example is changed the same way on both sides so that each stage
    has work to do: the track starts 1 cm and 0.01 rad off (the example
    tracks an image against its own pyramid, so both trackers must
    converge from there to the same pose), the window's frames get a
    baseline (with all frames at one pose no residual depends on depth
    and the inverse-depth step is zero), and every other point is not a
    sensor point (so the inverse-depth step is taken). Tolerances, those
    the port's stage parity tests hold these stages to:

      * the tracked pose (tests/test_torch_photometric.py): translation
        within 1e-4, rotation within 1e-4 rad;
      * each level's rmse: 1e-3 relative (the same test), with 1e-4
        absolute added. The converged rmse is rounding noise of 0-255
        intensities (3e-4 to 8e-3 here; float32 spacing at 255 is 1.5e-5),
        where a relative gate alone compares rounding: 1e-4 is about
        seven such spacings;
      * the BA energy (tests/test_torch_backend.py, build_system): 1e-3
        relative;
      * the frame step and the inverse-depth step (solve_system, the
        solveSystemF contract): 1e-3 of the step's scale.

    The JAX package's CPU dilation wraps at the map border where its TPU
    kernel, and K1, fill zeros; the example's points lie 8 pixels inside
    level 0, so no level's maps are nonzero at the border before its
    pass, and the two rules agree."""
    states, imgs, Ks = mesh.make_example_batch(2, w=W, h=H, F=F, seed=0)
    T0 = se3_exp(torch.tensor([0.01, 0.0, 0.0, 0.0, 0.0, 0.01])).numpy()
    states["T_init"][:] = T0
    states["T_cw_fej"][:, :, 0, 3] = 0.05 * np.arange(F)
    states["T_cw_fej"][:, :, 1, 3] = -0.02 * np.arange(F)
    states["pt_is_sensor"][:, 1::2] = False
    for i in range(2):
        st = {k: v[i] for k, v in states.items()}
        jn, jd = jmesh._single_step({k: jnp.asarray(v) for k, v in st.items()},
                                    jnp.asarray(imgs[i]), jnp.asarray(Ks[i]),
                                    LEVELS, W, H, F)
        tn, td = mesh._single_step(mesh.as_tensors(st, "cpu"),
                                   mesh.as_tensors(imgs[i], "cpu"),
                                   mesh.as_tensors(Ks[i], "cpu"),
                                   LEVELS, W, H, F)
        dT = np.linalg.inv(np.asarray(jn["T_init"], np.float64)) @ \
            tn["T_init"].double().numpy()
        xi = se3_log(torch.from_numpy(dT)).numpy()
        assert np.linalg.norm(xi[:3]) < 1e-4 and np.linalg.norm(xi[3:]) < \
            1e-4, xi
        res_j = np.asarray(jd["track_res"], np.float32)
        ran = np.isfinite(res_j)
        assert np.array_equal(ran, np.isfinite(td["track_res"].numpy()))
        np.testing.assert_allclose(td["track_res"].numpy()[ran], res_j[ran],
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(float(td["energy"]), float(jd["energy"]),
                                   rtol=1e-3)
        for k in ("eps", "pt_idepth"):
            want = np.asarray(jn[k], np.float32)
            scale = np.abs(want - st[k]).max()
            np.testing.assert_allclose(tn[k].numpy(), want, rtol=1e-3,
                                       atol=1e-3 * scale, err_msg=k)
        # the track moved from its start; a real step was taken; the
        # sensor points' depths stay, the others' moved
        assert np.abs(se3_log(tn["T_init"].double()).numpy()).max() < 1e-3
        assert np.abs(tn["eps"].numpy()).max() > 1e-3
        sensor = st["pt_is_sensor"]
        assert np.array_equal(tn["pt_idepth"].numpy()[sensor],
                              st["pt_idepth"][sensor])
        assert np.abs(tn["pt_idepth"].numpy()[~sensor]
                      - st["pt_idepth"][~sensor]).max() > 1e-3


def test_batched_step_on_two_devices_is_each_lane_alone():
    """Four lanes over [cpu, cpu]: block j (lanes 2j, 2j+1) on device j,
    each lane bit for bit `_single_step` alone, gathered in lane order."""
    m = mesh.make_batch_mesh(CPU2)
    assert m == (torch.device("cpu"),) * 2
    step, gather = mesh.make_batched_step(m, LEVELS, W, H, F)
    states, imgs, Ks = mesh.make_example_batch(4, w=W, h=H, F=F, seed=1)
    blocks = step(states, imgs, Ks)
    assert [b[0] for b in blocks] == list(m)
    assert all(b[1]["eps"].shape[0] == 2 for b in blocks)
    got_st, got_diag = gather(blocks)
    assert got_st["eps"].shape == (4, F, 6)
    for i in range(4):
        st, diag = mesh._single_step(
            mesh.as_tensors({k: v[i] for k, v in states.items()}, "cpu"),
            mesh.as_tensors(imgs[i], "cpu"), mesh.as_tensors(Ks[i], "cpu"),
            LEVELS, W, H, F)
        for k, v in st.items():
            assert np.array_equal(got_st[k][i], v.numpy()), (i, k)
        for k, v in diag.items():
            assert np.array_equal(got_diag[k][i], v.numpy(),
                                  equal_nan=True), (i, k)
    with pytest.raises(ValueError, match="divide"):
        step({k: v[:3] for k, v in states.items()}, imgs[:3], Ks[:3])


def test_batch_mesh_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_batch_mesh()


def test_dryrun_fleet_batch_fires_both_batched_programs():
    hits = dryrun.dryrun_fleet_batch(2, device="cpu", verbose=False)
    assert hits["track_batch"] >= dryrun.REC_FRAMES - 2
    assert hits["kf_batch"] >= 2


def test_dryrun_pinned_fleet_on_two_devices():
    """One pipelined system per device of [cpu, cpu] (a thread each): every
    tensor each holds on its device, and each trajectory bit for bit its
    run alone (checked inside)."""
    placed = dryrun.dryrun_pinned_fleet(CPU2, verbose=False)["placement"]
    assert len(placed) == 2
    assert all(set(p) == {"cpu"} and p["cpu"] > 0 for p in placed)


def test_dryrun_production_on_two_devices():
    """Two LiDAR, track and keyframe cycles of the lane forms over [cpu,
    cpu], two lanes each: finite, and every lane computed the same (tiled)
    sequence."""
    energies = np.asarray(dryrun.dryrun_production(CPU2, verbose=False))
    assert energies.shape == (2, 2 * dryrun.LANES_PER_DEVICE)
    assert np.isfinite(energies).all()
    assert (energies == energies[:, :1]).all()
