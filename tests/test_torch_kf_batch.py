"""The lane forms of the keyframe stages (the lockstep fleet's batched
trace, selection, activation and keyframe optimization), on the CPU.

  * `trace_points_lanes` and `select_compact_lanes` against the JAX
    package's `trace_points_batch` and `select_compact_batch` on the same
    numpy inputs, two lanes (the selection with the JAX draws injected,
    also as its stage program in the trace form);
  * `activate_full_lanes`, `kf_opt_step_lanes`, `build_track_ref` and
    `distance_map_lanes`: a two-lane call equals the two one-lane calls
    (`torch.equal`), on the requests two FullSystems of
    tests/test_torch_multi.py's two 320x96 scenes build at a frame where
    both take a keyframe.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdv_loam_tpu.ops import select as js
from sdv_loam_tpu.ops import trace as jt
from sdv_loam_tpu.ops.pyramid import make_images as j_make_images
from sdv_loam_tpu_torch.config import Settings
from sdv_loam_tpu_torch.data.synthetic import make_sequence
from sdv_loam_tpu_torch.ops import distmap as td
from sdv_loam_tpu_torch.ops import photometric as tph
from sdv_loam_tpu_torch.ops import select as ts
from sdv_loam_tpu_torch.ops import trace as tt
from sdv_loam_tpu_torch.ops.pyramid import make_images as t_make_images
from sdv_loam_tpu_torch.system import kf_ops
from sdv_loam_tpu_torch.system.full_system import FullSystem
from sdv_loam_tpu_torch.system.multi import _stack, _widen
from sdv_loam_tpu_torch.utils import device_loop as dl

# one intra-op thread per test process (see tests/test_torch_multi.py)
torch.set_num_threads(1)

W, H = 320, 96
N_FRAMES = 8
KF_FRAME = 4          # both scenes take a keyframe here (and at 1, 2, 6)
SETTINGS = dict(desired_immature_density=600, desired_point_density=800,
                n_active_cap=2048, n_immature_cap=2048)


@pytest.fixture(scope="module")
def seqs():
    return [make_sequence(n_frames=N_FRAMES, w=W, h=H, step=0.8,
                          yaw_rate=yr, lidar_stride=2)
            for yr in (0.004, 0.012)]


def T(x):
    a = np.ascontiguousarray(np.asarray(x))
    t = torch.from_numpy(a.copy())
    if a.dtype.kind == "f":
        t = t.to(torch.float32)
    elif a.dtype == np.int32:
        t = t.to(torch.int64)
    return t


def _pool(seq, frame, n, seed):
    """An immature pool hosted in `frame` at ground-truth depth, half of it
    bounded (the pool of tests/test_torch_frontend.py)."""
    rng = np.random.default_rng(seed)
    d0 = np.asarray(j_make_images(jnp.asarray(seq.get_image(frame)),
                                  seq.calib.levels)[0][0], np.float32)
    u = rng.uniform(10, W - 10, n).astype(np.float32)
    v = rng.uniform(10, H - 10, n).astype(np.float32)
    z = seq.get_depth(frame)[v.astype(int), u.astype(int)]
    idgt = (1.0 / z).astype(np.float32)
    color, wts, gradH, _, _ = (np.asarray(x, np.float32) for x in
                               jt.pattern_colors(jnp.asarray(d0),
                                                 jnp.asarray(u),
                                                 jnp.asarray(v)))
    bounded = rng.random(n) < 0.5
    return dict(u=u, v=v, idmin=np.where(bounded, idgt * 0.8, 0.0)
                .astype(np.float32),
                idmax=np.where(bounded, idgt * 1.25, np.inf)
                .astype(np.float32),
                status=np.where(bounded, jt.IPS_GOOD, jt.IPS_UNINITIALIZED)
                .astype(np.int32), color=color, weights=wts, gradH=gradH)


def _trace_args(seq, seed):
    """One lane's trace_points arguments: frame 0's pool into frame 2."""
    p = _pool(seq, 0, 500, seed)
    c = seq.calib
    Km = np.array([[c.fx[0], 0, c.cx[0]], [0, c.fy[0], c.cy[0]], [0, 0, 1]])
    F = 4
    KRKi = np.zeros((F, 3, 3), np.float32)
    Kt = np.zeros((F, 3), np.float32)
    Th = np.linalg.inv(seq.poses_wc[2]) @ seq.poses_wc[0]
    KRKi[0] = Km @ Th[:3, :3] @ np.linalg.inv(Km)
    Kt[0] = Km @ Th[:3, 3]
    aff = np.tile(np.array([1.0, 0.0], np.float32), (F, 1))
    n = p["u"].shape[0]
    d2 = np.asarray(j_make_images(jnp.asarray(seq.get_image(2)),
                                  c.levels)[0][0], np.float32)
    return (p["u"], p["v"], p["idmin"], p["idmax"], p["status"],
            np.full(n, 10000.0, np.float32), p["color"], p["weights"],
            p["gradH"], np.full(n, 8 * 144.0, np.float32),
            np.zeros(n, np.int32), KRKi, Kt, aff, d2)


def test_trace_points_lanes_match_jax_batch(seqs):
    lanes = [_trace_args(seq, k) for k, seq in enumerate(seqs)]
    floats = ((0.027, 6.0), (0.02, 5.0))
    jo = jt.trace_points_batch(
        tuple(tuple(jnp.asarray(a) for a in args)
              + (np.float32(f), np.float32(hb))
              for args, (f, hb) in zip(lanes, floats)), w=W, h=H)
    to = tt.trace_points_lanes(
        *(torch.stack([T(args[i]) for args in lanes])
          for i in range(len(lanes[0]))),
        [f for f, _ in floats], [hb for _, hb in floats], w=W, h=H)
    for lane in range(2):
        st_j = np.asarray(jo["status"][lane])
        st_t = to["status"][lane].numpy()
        # tests/test_torch_frontend.py's trace bounds: >= 99% of the
        # statuses agree (threshold flips), >= 98% of the intervals to
        # 1e-4 relative, all to 1e-2
        agree = st_j == st_t
        assert agree.mean() >= 0.99, (lane, agree.mean())
        good = agree & (st_j == jt.IPS_GOOD)
        assert good.sum() > 50
        for k in ("idepth_min", "idepth_max", "pixel_interval"):
            a = to[k][lane].numpy()[good]
            b = np.asarray(jo[k][lane])[good]
            assert np.isclose(a, b, rtol=1e-4, atol=1e-6).mean() >= 0.98, k
            np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-5,
                                       err_msg=k)


def test_trace_points_lanes_equal_one_lane_calls(seqs):
    lanes = [_trace_args(seq, k) for k, seq in enumerate(seqs)]
    floats = ((0.027, 6.0), (0.02, 5.0))
    both = tt.trace_points_lanes(
        *(torch.stack([T(args[i]) for args in lanes])
          for i in range(len(lanes[0]))),
        [f for f, _ in floats], [hb for _, hb in floats], w=W, h=H)
    for lane, (args, (f, hb)) in enumerate(zip(lanes, floats)):
        one = tt.trace_points(*(T(a) for a in args), f, hb, w=W, h=H)
        for k in one:
            assert torch.equal(both[k][lane], one[k]), k


def _jax_dirs(key, pot):
    k1, k2, k3 = jax.random.split(key, 3)
    return tuple(np.asarray(jax.random.randint(k, s, 0, 16))
                 for k, s in zip((k1, k2, k3),
                                 ts.cascade_grid_shapes(H, W, pot)))


def _select_args(seq, frame, lidar):
    d, ag = j_make_images(jnp.asarray(seq.get_image(frame)), seq.calib.levels)
    depth = seq.get_depth(frame).astype(np.float32)
    # the LiDAR candidates: every 7th pixel with a depth, at its pixel
    m = np.zeros((H, W), bool)
    m.reshape(-1)[::7] = True
    depth = np.where(m & np.isfinite(depth), depth, 0.0).astype(np.float32)
    cand = depth > 0 if lidar else np.ones((H, W), bool)
    yy, xx = np.mgrid[:H, :W].astype(np.float32)
    pu = np.where(depth > 0, xx, -1.0).astype(np.float32)
    pv = np.where(depth > 0, yy, -1.0).astype(np.float32)
    return (np.asarray(d[0], np.float32), np.asarray(ag[0], np.float32),
            np.asarray(ag[1], np.float32), np.asarray(ag[2], np.float32),
            cand, depth, pu, pv)


@pytest.mark.parametrize("pot,lidar", [(3, True), (2, False)])
def test_select_compact_lanes_match_jax_batch(seqs, pot, lidar):
    _select_lanes_against_jax(seqs, pot, lidar)


@pytest.mark.parametrize("pot,lidar", [(3, True), (2, False)])
def test_select_compact_lanes_program_form_match_jax_batch(seqs, pot, lidar):
    """The "select" program in its trace form (`device_loop.programs`)
    against `select_compact_batch`, with the same bounds."""
    with dl.programs():
        _select_lanes_against_jax(seqs, pot, lidar)


def _select_lanes_against_jax(seqs, pot, lidar):
    lanes = [_select_args(seq, 3, lidar) for seq in seqs]
    keys = [jax.random.PRNGKey(11), jax.random.PRNGKey(12)]
    jo = js.select_compact_batch(
        tuple(tuple(jnp.asarray(a) for a in args) + (key,)
              for args, key in zip(lanes, keys)), pot=pot, cap=2048)
    to = ts.select_compact_lanes(
        *(torch.stack([T(args[i]) for args in lanes]) for i in range(8)),
        tuple(torch.stack([T(_jax_dirs(k, pot)[g]) for k in keys])
              for g in range(3)), pot=pot, cap=2048)
    for lane in range(2):
        # the cascade is exact: same thresholds, same draws, same tie rule
        for k in ("valid", "counts", "u", "v", "z", "finite", "n_sel"):
            np.testing.assert_array_equal(to[k][lane].numpy(),
                                          np.asarray(jo[k][lane]),
                                          err_msg=f"{k} lane {lane}")
        assert int(to["counts"][lane].sum()) > 20
        # tests/test_torch_frontend.py's bounds for the pattern data
        for k in ("color", "weights", "gradH", "gcen"):
            np.testing.assert_allclose(to[k][lane].numpy(),
                                       np.asarray(jo[k][lane]), rtol=1e-5,
                                       atol=1e-3, err_msg=k)
        np.testing.assert_allclose(to["score"][lane].numpy(),
                                   np.asarray(jo["score"][lane]), rtol=1e-3,
                                   atol=1e-2)
    assert not np.array_equal(to["u"][0].numpy(), to["u"][1].numpy())


# ---------------------------------------------------------------------------
# two-lane calls against one-lane calls, on the requests of two systems
# ---------------------------------------------------------------------------

def _equal(a, b, what):
    if isinstance(a, dict):
        for k in a:
            _equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        for j, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{j}]")
    else:
        assert torch.equal(a, b), what


@pytest.fixture(scope="module")
def kf_requests(seqs):
    """Two systems run KF_FRAME frames, then take frame KF_FRAME phase by
    phase up to the keyframe optimization. Returns (systems, activation
    requests, the activations' one-lane outputs, optimization requests)."""
    systems, areqs, aouts, kreqs = [], [], [], []
    for seq in seqs:
        fs = FullSystem(seq.calib, seq.sensor, Settings(**SETTINGS),
                        device="cpu")
        for i in range(KF_FRAME):
            fs.add_active_frame(*seq.get(i))
        frame = fs._stage(*seq.get(KF_FRAME))
        fs._lidar(frame)
        ok = fs._track_result(frame, fs._track_inputs(frame))
        assert fs._decide(frame, ok) is True
        fs._trace(frame)
        slot = fs._kf_insert(frame)
        fs._make_new_traces(frame, slot)
        fs._insert_residuals(slot)
        areq = fs._activate_request(frame, slot)
        dev = kf_ops.activate_full(**areq["args"], **areq["statics"])
        fs._activate_result(dev, {k: dev[k].numpy() for k in
                                  ("dead", "kill", "drop_oob", "cand_idx",
                                   "lane_valid", "success", "idepth",
                                   "inlier_targets")})
        fs._commit_pool_dev(slot)
        systems.append(fs)
        areqs.append(areq)
        aouts.append(dev)
        kreqs.append(fs._kf_opt_request(frame, slot))
    return systems, areqs, aouts, kreqs


def test_activate_full_lanes_equal_one_lane_calls(kf_requests):
    _, areqs, aouts, _ = kf_requests
    host = ("newest_slot", "min_act_dist", "min_trace_quality",
            "min_idepth_h_act")
    # the fleet widens a_cap to its lanes' widest; here both lanes use it
    statics = _widen([r["statics"] for r in areqs], ("a_cap",))
    both = kf_ops.activate_full_lanes(
        **{k: _stack([r["args"][k] for r in areqs])
           for k in areqs[0]["args"] if k not in host},
        **{k: [r["args"][k] for r in areqs] for k in host}, **statics)
    for lane, r in enumerate(areqs):
        one = kf_ops.activate_full(**r["args"], **statics)
        _equal({k: both[k][lane] for k in both}, one, f"lane {lane}")
        assert int(one["lane_valid"].sum()) > 0
        # a wider a_cap only adds invalid compaction rows
        own = aouts[lane]
        n = own["cand_idx"].shape[0]
        for k in ("dead", "kill", "drop_oob", "keep", "im_valid",
                  "im_status"):
            assert torch.equal(own[k], one[k]), k
        for k in ("cand_idx", "lane_valid", "success", "idepth",
                  "inlier_targets"):
            assert torch.equal(own[k], one[k][:n]), k
    assert not torch.equal(both["keep"][0], both["keep"][1])


def _kf_lanes(kreqs):
    lanes = {k: _stack([r["args"][k] for r in kreqs])
             for k in kf_ops.KF_TENSOR_ARGS}
    lanes.update({k: [r["args"][k] for r in kreqs]
                  for k in kf_ops.KF_HOST_ARGS})
    lanes.update({k: kreqs[0]["args"][k] for k in kf_ops.KF_SHARED_ARGS})
    lanes["dI_newest_pyr"] = _stack([tuple(r["args"]["dI_newest_pyr"])
                                     for r in kreqs])
    return lanes


def test_kf_opt_step_lanes_equal_one_lane_calls(kf_requests):
    _, _, _, kreqs = kf_requests
    statics = _widen([r["statics"] for r in kreqs], ("p1_cap", "p2_cap"))
    # the lanes' own LM budgets differ, so the fleet-max loop runs one
    # lane past its stop
    kreqs = [dict(r, args=dict(r["args"], max_iters=it))
             for r, it in zip(kreqs, (6, 3))]
    both = kf_ops.kf_opt_step_lanes(**_kf_lanes(kreqs), **statics)
    for lane, r in enumerate(kreqs):
        one = kf_ops.kf_opt_step(**r["args"], **statics)
        _equal(kf_ops.lane_of(both, lane), one, f"lane {lane}")
        assert np.isfinite(float(one["energy"]))
    assert not torch.equal(both["idepth"][0], both["idepth"][1])


def test_kf_opt_step_lanes_freeze_a_stopped_lane(kf_requests):
    """A lane with no LM iteration keeps its input window while the other
    lane iterates (the veto's zero-iteration run); both windows start with
    slot 1 moved 2 mm."""
    _, _, _, kreqs = kf_requests
    statics = _widen([r["statics"] for r in kreqs], ("p1_cap", "p2_cap"))

    def moved(r, it):
        eps = r["args"]["eps"].clone()
        eps[1, 0] += 2e-3
        return dict(r, args=dict(r["args"], eps=eps, max_iters=it))
    kreqs = [moved(r, it) for r, it in zip(kreqs, (0, 6))]
    both = kf_ops.kf_opt_step_lanes(**_kf_lanes(kreqs), **statics)
    for lane, r in enumerate(kreqs):
        _equal(kf_ops.lane_of(both, lane),
               kf_ops.kf_opt_step(**r["args"], **statics), f"lane {lane}")
    assert torch.equal(both["eps"][0, 1], kreqs[0]["args"]["eps"][1])
    assert torch.equal(both["idepth"][0], kreqs[0]["args"]["pt_idepth"])


def test_build_track_ref_lanes_equal_one_lane_calls(seqs):
    rng = np.random.default_rng(5)
    pyrs, splats = [], []
    for k, seq in enumerate(seqs):
        dI, _ = t_make_images(T(seq.get_image(k + 1)), seq.calib.levels)
        pyrs.append(dI)
        n = 1500
        u = T(rng.integers(0, W, n))
        v = T(rng.integers(0, H, n))
        idp = T(rng.uniform(0.02, 0.5, n).astype(np.float32))
        wt = T(rng.uniform(1.0, 300.0, n).astype(np.float32))
        ok = T(rng.random(n) < 0.9)
        splats.append((u, v, idp, wt, ok))
    # splat_idepth over lanes: each lane sums its cells as alone
    lanes = tph.splat_idepth(*(torch.stack(x) for x in zip(*splats)), W, H)
    ones = [tph.splat_idepth(*s, W, H) for s in splats]
    for lane, one in enumerate(ones):
        assert torch.equal(lanes[0][lane], one[0])
        assert torch.equal(lanes[1][lane], one[1])
    caps = (3072, 2048, 1024, 512)
    levels = seqs[0].calib.levels
    both = tph.build_track_ref(_stack([tuple(p) for p in pyrs]), lanes[0],
                               lanes[1], levels, cap=caps)
    for lane, (pyr, one) in enumerate(zip(pyrs, ones)):
        alone = tph.build_track_ref(pyr, one[0], one[1], levels, cap=caps)
        for lvl, pool in enumerate(alone):
            _equal({k: both[lvl][k][lane] for k in pool}, pool,
                   f"lane {lane} level {lvl}")
        assert int(alone[0]["n"]) > 100


def test_distance_map_lanes_equal_one_lane_calls():
    rng = np.random.default_rng(3)
    w1, h1 = W // 2, H // 2
    u = T(rng.integers(-3, w1 + 3, (2, 500)))
    v = T(rng.integers(-3, h1 + 3, (2, 500)))
    valid = T(rng.random((2, 500)) < 0.8)
    both = td.distance_map_lanes(u, v, valid, w1, h1)
    for lane in range(2):
        assert torch.equal(both[lane],
                           td.distance_map(u[lane], v[lane], valid[lane],
                                           w1, h1))
    assert not torch.equal(both[0], both[1])
