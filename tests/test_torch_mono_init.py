"""The port's camera-only bootstrap against the JAX package on the CPU:
ops/knn (knn, nearest_cross, on grid inputs full of distance ties), the
status-map selector ops/select.make_maps with the JAX draws injected,
ops/mono_init (`_median_masked`, one `_level_lm` level from identical
inputs, the whole MonoInitializer over tests/test_mono_init.py's scene) and
FullSystem with no cloud on any frame (test_full_system_camera_only's
asserts, and the port's scale-aligned trajectory against the JAX
package's), and the lockstep MultiSystem with a LiDAR-dropout lane and a
camera-only lane beside a LiDAR lane, each lane against its system alone.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdv_loam_tpu.config import Settings as JSettings
from sdv_loam_tpu.data.synthetic import make_sequence
from sdv_loam_tpu.ops import knn as jknn
from sdv_loam_tpu.ops import mono_init as jmono
from sdv_loam_tpu.ops import select as jsel
from sdv_loam_tpu.ops.pyramid import make_images as j_make_images
from sdv_loam_tpu.ops.warp import pack_bilinear as j_pack
from sdv_loam_tpu.system.full_system import FullSystem as JFullSystem
from sdv_loam_tpu_torch.config import Settings as TSettings
from sdv_loam_tpu_torch.ops import knn as tknn
from sdv_loam_tpu_torch.ops import mono_init as tmono
from sdv_loam_tpu_torch.ops import select as tsel
from sdv_loam_tpu_torch.ops.pyramid import make_images as t_make_images
from sdv_loam_tpu_torch.ops.warp import pack_bilinear as t_pack
from sdv_loam_tpu_torch.system.full_system import FullSystem as TFullSystem
from sdv_loam_tpu_torch.system.multi import MultiSystem

# the port's CPU ops are small: one intra-op thread per test process
torch.set_num_threads(1)

# tests/test_mono_init.py's scene
SCENE = dict(w=320, h=96, step=0.4, lidar_stride=8)
N_INIT = 12
N_FS = 16
SNAP_FRAME = 3        # the level-LM inputs: the JAX state before frame 3


@pytest.fixture(scope="module")
def seq():
    return make_sequence(n_frames=N_FS, **SCENE)


@pytest.fixture(scope="module")
def pyramids(seq):
    """The JAX package's pyramid of every frame, as numpy."""
    out = []
    for i in range(N_INIT):
        dI, ag = j_make_images(jnp.asarray(seq.get_image(i), jnp.float32),
                               seq.calib.levels)
        out.append(([np.asarray(x) for x in dI], [np.asarray(x) for x in ag]))
    return out


def jax_draws(key, h, w):
    """The two random draws of the JAX `make_maps`, for the port's: the
    direction grids of `select_cascade` (one key for every attempt) and
    the keep mask's uniforms."""
    k_sel, k_sub = jax.random.split(key)

    def dirs(pot):
        ks = jax.random.split(k_sel, 3)
        return tuple(torch.as_tensor(np.asarray(jax.random.randint(
            k, shape, 0, 16))) for k, shape in zip(
                ks, tsel.cascade_grid_shapes(h, w, pot)))

    def keep(shape):
        return np.asarray(jax.random.uniform(k_sub, shape))
    return dirs, keep


def _grid_points(rng, n_side=(24, 40), drop=0.3):
    """Selected-point-like input: integer pixels + 0.1, some missing, then
    padded with invalid rows (distance ties everywhere)."""
    v, u = np.nonzero(rng.random(n_side) > drop)
    pts = np.stack([u, v], -1).astype(np.float32) + 0.1
    n = len(pts)
    cap = int(2 ** np.ceil(np.log2(n)))
    out = np.zeros((cap, 2), np.float32)
    out[:n] = pts
    valid = np.zeros(cap, bool)
    valid[:n] = True
    valid[rng.choice(n, 20, replace=False)] = False
    return out, valid


@pytest.mark.parametrize("grid", [True, False])
@pytest.mark.parametrize("block", [tknn.BLOCK_ROWS, 37])
def test_knn_matches_jax(grid, block):
    rng = np.random.default_rng(0)
    if grid:
        pts, valid = _grid_points(rng)
    else:
        pts = rng.uniform(0, 100, (300, 2)).astype(np.float32)
        valid = rng.random(300) > 0.2
    ji, jd = jknn.knn(jnp.asarray(pts), jnp.asarray(valid), k=10)
    ti, td = tknn.knn(torch.as_tensor(pts), torch.as_tensor(valid), k=10,
                      block=block)
    if grid:
        # the ties really are there: many rows hold equal distances
        d = np.asarray(jd)
        assert (np.diff(d[valid], axis=1) == 0).mean() > 0.5
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("block", [tknn.BLOCK_ROWS, 37])
def test_nearest_cross_matches_jax(block):
    rng = np.random.default_rng(1)
    fine, fv = _grid_points(rng, (24, 40))
    coarse, cv = _grid_points(rng, (12, 20))
    a = np.stack([fine[:, 0] * 0.5 - 0.25, fine[:, 1] * 0.5 - 0.25], -1)
    ji, jd = jknn.nearest_cross(jnp.asarray(a), jnp.asarray(fv),
                                jnp.asarray(coarse), jnp.asarray(cv))
    ti, td = tknn.nearest_cross(torch.as_tensor(a), torch.as_tensor(fv),
                                torch.as_tensor(coarse), torch.as_tensor(cv),
                                block=block)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("density_frac,th_factor,pot", [
    (0.03, 2.0, 3),      # the bootstrap's level-0 call
    (0.002, 1.0, 3),     # few points wanted: re-run with a larger pot
    (0.2, 1.0, 6),       # many points wanted: re-run with a smaller pot
])
def test_make_maps_matches_jax(pyramids, density_frac, th_factor, pot):
    dI, ag = pyramids[0]
    h, w = ag[0].shape
    density = density_frac * w * h
    key = jax.random.PRNGKey(7)
    jstate, tstate = {"pot": pot}, {"pot": pot}
    js, jn = jsel.make_maps(jnp.asarray(dI[0]), tuple(jnp.asarray(a)
                                                      for a in ag[:3]),
                            jnp.ones((h, w), bool), density, key, jstate,
                            JSettings(), th_factor=th_factor)
    ts, tn = tsel.make_maps(torch.as_tensor(dI[0]),
                            tuple(torch.as_tensor(a) for a in ag[:3]),
                            torch.ones((h, w), dtype=torch.bool), density,
                            *jax_draws(key, h, w), tstate, TSettings(),
                            th_factor=th_factor)
    assert tn == jn and tn > 0
    assert tstate == jstate
    np.testing.assert_array_equal(ts, np.asarray(js))


def test_median_masked_matches_jax():
    rng = np.random.default_rng(2)
    vals = rng.uniform(0.1, 3.0, (200, 10)).astype(np.float32)
    ok = rng.random((200, 10)) > 0.4
    ok[:5] = False                          # no valid neighbour (nnn = 0)
    ok[5:10] = True
    jm, jn = jmono._median_masked(jnp.asarray(vals), jnp.asarray(ok))
    tm, tn = tmono._median_masked(torch.as_tensor(vals), torch.as_tensor(ok))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert np.isinf(tm.numpy()[:5]).all()


@pytest.fixture(scope="module")
def jax_init(seq, pyramids):
    """The JAX MonoInitializer over the scene: its state before frame
    SNAP_FRAME (the level-LM inputs), the frame it became ready at and
    its pose then."""
    ini = jmono.MonoInitializer(seq.calib)
    dI, ag = pyramids[0]
    ini.set_first([jnp.asarray(x) for x in dI], [jnp.asarray(x) for x in ag])
    state, ready_at = None, None
    for i in range(1, N_INIT):
        if i == SNAP_FRAME:
            state = copy.deepcopy(dict(T=ini.T, aff=ini.aff, pts=ini.pts,
                                       snapped=ini.snapped))
        if ini.track_frame([jnp.asarray(x) for x in pyramids[i][0]]):
            ready_at = i
            break
    return dict(state=state, ready_at=ready_at, T=ini.T.copy(),
                n_sel=[int((p["valid"] & p["is_good"]).sum())
                       for p in ini.pts])


_PT_KEYS = ("u", "v", "valid", "idepth", "iR", "is_good", "energy",
            "energy_a", "last_hessian")


def _level_inputs(seq, pyramids, jax_init, lvl):
    st = jax_init["state"]
    assert st["snapped"]
    p = st["pts"][lvl]
    img = pyramids[SNAP_FRAME][0][lvl]
    K = np.asarray(seq.calib.intrinsics_vec(lvl), np.float32)
    return p, img, K, dict(w=seq.calib.w[lvl], h=seq.calib.h[lvl])


@pytest.mark.parametrize("top", [True, False])
def test_level_lm_matches_jax(seq, pyramids, jax_init, top):
    """One level of trackFrame from identical inputs: the first
    calcResAndGS terms (max_iters 0) within 1e-4 relative, then the whole
    level LM: the pose within 1e-4 (rad, unit-scale translation) and the
    median idepth within 1e-3 relative."""
    lvl = seq.calib.levels - 1 if top else 0
    p, img, K, wh = _level_inputs(seq, pyramids, jax_init, lvl)
    st = jax_init["state"]
    max_iters = jmono.MAX_ITERS[min(lvl, len(jmono.MAX_ITERS) - 1)]

    def run(iters):
        jo = jmono._level_lm(
            jnp.asarray(st["T"]), jnp.asarray(st["aff"]),
            {k: jnp.asarray(p[k]) for k in _PT_KEYS},
            jnp.asarray(p["nbr_idx"]), jnp.asarray(p["nbr_ok"]),
            j_pack(jnp.asarray(img)), jnp.asarray(p["ref_color"]),
            jnp.asarray(K), jnp.asarray(True), max_iters=iters, **wh)
        to = tmono._level_lm(
            torch.as_tensor(st["T"]), torch.as_tensor(st["aff"]),
            {k: torch.as_tensor(p[k]) for k in _PT_KEYS},
            torch.as_tensor(p["nbr_idx"]), torch.as_tensor(p["nbr_ok"]),
            t_pack(torch.as_tensor(img)), torch.as_tensor(p["ref_color"]),
            torch.as_tensor(K), torch.tensor(True), max_iters=iters, **wh)
        return {k: np.asarray(v) for k, v in jax.device_get(jo).items()}, \
            {k: (v.numpy() if torch.is_tensor(v) else np.asarray(v))
             for k, v in to.items()}

    jo, to = run(0)
    np.testing.assert_array_equal(to["is_good"], jo["is_good"])
    assert jo["is_good"].sum() > 20
    for k in ("energy", "energy_a", "last_hessian", "rmse"):
        np.testing.assert_allclose(to[k], jo[k], rtol=1e-4,
                                   atol=1e-4 * np.abs(jo[k]).max(),
                                   err_msg=k)

    jo, to = run(max_iters)
    assert to["iters"] == int(jo["iters"]) and bool(to["snapped"])
    d = np.linalg.inv(jo["T"].astype(np.float64)) @ to["T"].astype(np.float64)
    rot = np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1))
    assert rot < 1e-4, rot
    assert np.linalg.norm(d[:3, 3]) < 1e-4, d[:3, 3]
    good = jo["is_good"] & to["is_good"]
    mj, mt = np.median(jo["idepth"][good]), np.median(to["idepth"][good])
    assert abs(mt - mj) < 1e-3 * abs(mj), (mt, mj)


def test_mono_initializer_matches_jax(seq, jax_init):
    """The whole bootstrap over the scene on the port's own pyramids (the
    level-0 selection fed the JAX draws): ready within one frame of the
    JAX initializer, the translation direction within cos > 0.999 of its,
    and tests/test_mono_init.py's asserts against the ground truth."""
    h, w = seq.calib.h[0], seq.calib.w[0]
    ini = tmono.MonoInitializer(
        seq.calib, TSettings(),
        select_draws=jax_draws(jax.random.PRNGKey(7), h, w))
    dI, ag = t_make_images(torch.as_tensor(seq.get_image(0),
                                           dtype=torch.float32),
                           seq.calib.levels)
    ini.set_first(dI, ag)
    n_sel = [int((p["valid"] & p["is_good"]).sum()) for p in ini.pts]
    assert n_sel[0] >= 100, n_sel
    ready_at = None
    for i in range(1, N_INIT):
        dI, _ = t_make_images(torch.as_tensor(seq.get_image(i),
                                              dtype=torch.float32),
                              seq.calib.levels)
        if ini.track_frame(dI):
            ready_at = i
            break
        if i >= 2:
            assert ini.snapped, f"not snapped by frame {i}"
    assert ready_at is not None and jax_init["ready_at"] is not None
    assert abs(ready_at - jax_init["ready_at"]) <= 1
    tj, tt = jax_init["T"][:3, 3], ini.T[:3, 3]
    cos = float(tj @ tt / (np.linalg.norm(tj) * np.linalg.norm(tt)))
    assert cos > 0.999, cos
    gt = np.linalg.inv(seq.poses_wc[ready_at]) @ seq.poses_wc[0]
    cos_gt = float(tt @ gt[:3, 3] / (np.linalg.norm(tt)
                                     * np.linalg.norm(gt[:3, 3])))
    assert cos_gt > 0.95, cos_gt
    u, v, idep, scale = ini.level0_points()
    assert len(u) >= 100 and scale > 0
    assert np.isfinite(idep).all() and (idep > 0).all()


def _aligned(est, gt, k):
    """The trajectory from frame k on with one global scale fitted to the
    ground truth (the monocular gauge) -> (aligned, gt, path length)."""
    e = est[k:, :3, 3] - est[k, :3, 3]
    g = gt[k:, :3, 3] - gt[k, :3, 3]
    s = float((e * g).sum() / max((e * e).sum(), 1e-12))
    assert s > 0, s
    return s * e, g, float(np.linalg.norm(np.diff(g, axis=0), axis=1).sum())


def test_full_system_camera_only_matches_jax(seq):
    """test_full_system_camera_only's asserts on the port (no cloud on any
    frame), and its scale-aligned trajectory within 0.10 x path of the
    JAX package's."""
    kw = dict(use_struct_pose=False, pipelined_frames=False)
    frames = [seq.get(i) for i in range(N_FS)]
    jfs = JFullSystem(seq.calib, seq.sensor, JSettings(**kw))
    tfs = TFullSystem(seq.calib, seq.sensor, TSettings(**kw), device="cpu")
    for img, _, ts in frames:
        jfs.add_active_frame(img, None, ts)
        tfs.add_active_frame(img, None, ts)
    assert not tfs.is_lost and tfs.initialized
    assert len(tfs.kf_shells) >= 2
    assert not tfs.pt["is_sensor"][tfs.pt_valid].any()
    # the bootstrap: K1 built the first keyframe's tracking reference
    assert tfs.track_ref is not None
    k = max(tfs.kf_shells[1], jfs.kf_shells[1])
    gt = seq.poses_wc[:N_FS]
    te, g, path = _aligned(tfs.get_trajectory(), gt, k)
    je, _, _ = _aligned(jfs.get_trajectory(), gt, k)
    err = np.linalg.norm(te - g, axis=1).max()
    assert err < 0.15 * path, (err, path)
    diff = np.linalg.norm(te - je, axis=1).max()
    assert diff < 0.10 * path, (diff, path)


# tests/test_e2e.py's scene and settings (the LiDAR lanes)
E2E_SCENE = dict(w=320, h=96, step=0.8, yaw_rate=0.01, lidar_stride=2)
E2E_SETTINGS = dict(desired_immature_density=600, desired_point_density=800,
                    n_active_cap=2048, n_immature_cap=2048,
                    ba_resf_at_fej=False)


def dropout(frames):
    """Every third frame after the first two loses its cloud."""
    return [(img, None if i >= 2 and i % 3 == 2 else c, ts)
            for i, (img, c, ts) in enumerate(frames)]


def test_multisystem_dropout_and_camera_only_lanes():
    """Lockstep MultiSystem over a LiDAR lane, a dropout lane and a
    camera-only lane (tests/test_mono_init.py's scene, in the bootstrap for
    most rounds): each lane within 1e-5 of its system alone."""
    n = 10
    lidar = make_sequence(n_frames=n, **E2E_SCENE)
    mono = make_sequence(n_frames=n, **SCENE)
    lanes = [(lidar, [lidar.get(i) for i in range(n)], {}),
             (lidar, dropout([lidar.get(i) for i in range(n)]), {}),
             (mono, [(img, None, ts) for img, _, ts in
                     (mono.get(i) for i in range(n))],
              dict(use_struct_pose=False))]

    def system(seq, kw):
        return TFullSystem(seq.calib, seq.sensor,
                           TSettings(**E2E_SETTINGS, **kw), device="cpu")
    alone = []
    for seq, frames, kw in lanes:
        fs = system(seq, kw)
        for f in frames:
            fs.add_active_frame(*f)
        alone.append(fs.get_trajectory())
    fleet = MultiSystem([system(seq, kw) for seq, _, kw in lanes],
                        batch_track=True)
    for i in range(n):
        fleet.add_frames([frames[i] for _, frames, _ in lanes])
    assert fleet.systems[2].initialized       # the bootstrap finished
    for fs, ref in zip(fleet.systems, alone):
        assert not fs.is_lost
        assert np.abs(fs.get_trajectory() - ref).max() <= 1e-5
