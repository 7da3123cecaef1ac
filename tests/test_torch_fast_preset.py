"""The fast preset through the port on the CPU, against the JAX package.

`Settings.preset_fast()` is the reference's preset 2/3 (main.cpp:217-238):
424x320 input, 800 points, windows of 4-6 keyframes in 7 frame slots,
1-4 BA iterations and smaller pools (immature 1024, selection 2048,
active 2048, LiDAR candidates 8192, tracking-reference caps 3072 / 2048 /
1024 / 512). bench.py runs it on a non-proportional resize of the KITTI
frame (fx 245.6, fy 611.8, bench.py:104-116) as its second operating
point. Here:

  * both presets equal the JAX package's, field for field;
  * the port's fast scene equals the JAX package's: images, clouds,
    calibration (fx != fy) and poses;
  * the one-lane hand-over: the JAX package runs bench.py's scene A
    through frame HANDOVER - 1 and writes a checkpoint; the port loads it
    (with the JAX selection draws) and both take frames HANDOVER..N-1,
    through two keyframes, the port in the stage form and in the program
    trace form the card captures (`device_loop.programs()`), which must
    give the stage form's results bit for bit;
  * the two-lane batched lockstep: scenes A and B handed over from the
    JAX MultiSystem to the port's MultiSystem(batch_track=True) through
    the same keyframes, each lane also within 1e-5 of its system alone;
  * pipelined frames give the sequential trajectory.

Every hand-over runs on mid-binned scans (`jax_parity.mid_bin`) with the
JAX package under x64 off, as `test_trajectory_matches_jax` does: on the
ring edges XLA's and torch's atan2 put points in other rings, and with
x64 on the JAX package parts from itself by 6.5e-4 m after the first
keyframe. The port's selection draws are the JAX key chain's, drawn in
the JAX run's float mode (`jax_dir_source(..., x64=False)`): drawn with
x64 on they are other bits, and the hand-over parted by 1.7 cm at frame
10. A free run cannot be bounded this way: over scene A's 30 frames the
JAX package's own ATE reads 0.058 to 0.580 m across its two float modes
and the raw and mid-binned scans.

The bounds per frame and at each keyframe are
`test_batched_keyframe_matches_jax_multi`'s (HANDOVER_BOUNDS). Measured
on one torch thread, the largest over the frames: tracked poses 8.5e-5 m
/ 1.8e-6 rad (lane B of the lockstep 5.3e-5 m / 1.4e-6 rad), window
poses 8.3e-5 m / 1.9e-6 rad, eps 5.9e-7. Frame 11 is where the one lane
parts most: one of its 166 matched points lands 0.056 px from the JAX
package's, and the struct-pose LM moves the pose by 8.5e-5 m for it,
where the photometric pose is 4.1e-6 m apart; with four torch threads
(another reduction order) the same frame reads 8.2e-6 m.

The marginalization prior (HM, bM) is not held end to end: the second
keyframe's is formed at that pose and reads 2.3e-3 (HM) and 4.4e-3 (bM)
of its scale from the JAX package's at one thread (lane B: 1.1e-2), over
`tests/test_torch_backend.py`'s 1e-3. Each keyframe optimization is held
instead against the JAX package's `kf_opt_step` (and, for the lockstep,
`kf_opt_step_batch`) on the port's own inputs (KF_SAME_INPUT_TOL):
masks and diagnostics equal; measured energy 5.5e-5, eps 5.6e-6,
T_cw_fej 1.0e-7, HM 3.8e-7, bM 2.0e-5 (one lane) and 1.8e-3 (lane B at
frame 11), feth 7.5e-6, the valid points' depths 2.6e-6. Lane B's bM is
one far point (inverse depth 4.8e-3, Hessian 772) of the frame being
marginalized, which the BA steps to a negative depth (-6.9e-3 in the
port, -3.0e-3 in the JAX package) before it enters the prior; the JAX
package's batched and one-lane calls agree on it to 8e-7.

About 150 s on one torch thread with the JAX package's compile cache
warm, 200 s cold; most of it the JAX package's compiles.
"""

import contextlib
import dataclasses
import inspect

import jax
import numpy as np
import pytest
import torch

from jax_parity import checkpoint_key, jax_dir_source, load_jax, \
    mid_binned, pose_diff
from sdv_loam_tpu.config import Settings as JSettings
from sdv_loam_tpu.data.synthetic import make_sequence as jmake_sequence
from sdv_loam_tpu.system import checkpoint as jcheckpoint
from sdv_loam_tpu.system import kf_ops as jkf_ops
from sdv_loam_tpu.system.full_system import FullSystem as JFullSystem
from sdv_loam_tpu.system.multi import MultiSystem as JMultiSystem
from sdv_loam_tpu_torch.config import Settings as TSettings
from sdv_loam_tpu_torch.data.synthetic import make_sequence as tmake_sequence
from sdv_loam_tpu_torch.system import checkpoint as tcheckpoint
from sdv_loam_tpu_torch.system import kf_ops as tkf_ops
from sdv_loam_tpu_torch.system.multi import MultiSystem
from sdv_loam_tpu_torch.utils import device_loop as dl

# one intra-op thread per test process (tests/test_torch_fleet_parity.py)
torch.set_num_threads(1)

# bench.py's fast operating point: its scene keywords (bench.py:104-116,
# :122-132) and its two scenes
FAST_SCENE = dict(w=424, h=320, fx=245.6, fy=611.8, cy_offset=0.0, step=0.7,
                  lidar_stride=2, half_width=16.0, ground_contrast=0.25,
                  follow_path=True)
SCENES = {"A": dict(seed=7, yaw_rate=0.004),
          "B": dict(seed=13, yaw_rate=-0.006)}
N = 12
# the JAX package runs frames 0..HANDOVER-1; frames 9 and 11 are keyframes
HANDOVER = 8
# tracked pose (m, rad) per frame; window poses (m, rad) and eps at each
# keyframe
HANDOVER_BOUNDS = dict(tracked=(1e-4, 2e-6), window=(1e-4, 1e-5), eps=1e-6)
# a keyframe optimization against the JAX package's on the same inputs:
# relative to each output's largest value (module docstring); `idepth`
# over the points valid after it
KF_SAME_INPUT_TOL = dict(energy=1e-4, eps=1e-4, T_cw_fej=1e-5, HM=1e-3,
                         bM=1e-2, feth=1e-4, idepth=1e-4, rmse=1e-4)
LANE_TOL = 1e-5


@pytest.mark.parametrize("preset", ["preset_default", "preset_fast"])
def test_presets_match_jax(preset):
    """Every field of the port's preset equals the JAX package's."""
    t = getattr(TSettings, preset)()
    j = getattr(JSettings, preset)()
    names = [f.name for f in dataclasses.fields(JSettings)]
    assert names == [f.name for f in dataclasses.fields(TSettings)]
    for name in names:
        assert getattr(t, name) == getattr(j, name), name


@pytest.fixture(scope="module")
def scenes():
    """bench.py's two fast scenes (the JAX package's renderer) and their
    first N frames, mid-binned."""
    out = {}
    for name, kw in SCENES.items():
        seq = jmake_sequence(n_frames=N, **FAST_SCENE, **kw)
        out[name] = (seq, mid_binned([seq.get(i) for i in range(N)]))
    return out


def test_fast_scene_matches_jax(scenes):
    """The port's renderer at the fast scene: the calibration of every
    pyramid level (fx != fy), the LiDAR extrinsics, poses, timestamps, and
    the first and last frames' images and clouds equal the JAX
    package's."""
    jseq = scenes["A"][0]
    tseq = tmake_sequence(n_frames=N, **FAST_SCENE, **SCENES["A"])
    assert dataclasses.asdict(tseq.calib) == dataclasses.asdict(jseq.calib)
    assert tseq.calib.fx[0] == 245.6 and tseq.calib.fy[0] == 611.8
    assert tseq.calib.w == (424, 212, 106, 53)
    for k in ("intrinsics", "R_cl", "t_cl"):
        np.testing.assert_array_equal(getattr(tseq.sensor, k),
                                      getattr(jseq.sensor, k), err_msg=k)
    np.testing.assert_array_equal(tseq.poses_wc, jseq.poses_wc)
    np.testing.assert_array_equal(tseq.timestamps, jseq.timestamps)
    for i in (0, N - 1):
        for t, j in zip(tseq.get(i), jseq.get(i)):
            np.testing.assert_array_equal(t, j)


def _frame_record(fs, i):
    """What a hand-over holds after frame i: the tracked pose, keyframe
    decisions and window slots, and at a keyframe the window's poses, eps
    and the marginalization prior (the prior is compared between the
    port's forms, not with the JAX package's: module docstring)."""
    r = dict(tracked=np.array(fs.shells[i]["T_wc_tracked"]),
             is_kf=bool(fs.shells[i]["is_kf"]), n_kf=len(fs.kf_shells),
             order=[int(x) for x in fs.order])
    if r["is_kf"]:
        T_wc = np.linalg.inv(np.asarray(fs.T_cw))
        r.update(window=np.stack([T_wc[sl] for sl in r["order"]]),
                 eps=np.array(fs.eps), HM=np.array(fs.HM),
                 bM=np.array(fs.bM))
    return r


@contextlib.contextmanager
def _calls(module, name, calls):
    """Append (arguments, keyword arguments) of each call of
    `module.name` to `calls`, the port's tensors cloned as they were
    passed."""
    orig = getattr(module, name)

    def wrapped(*a, **kw):
        calls.append(torch.utils._pytree.tree_map(
            lambda v: v.clone() if isinstance(v, torch.Tensor) else v,
            (a, kw)))
        return orig(*a, **kw)
    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


@pytest.fixture(scope="module")
def handover(scenes, tmp_path_factory):
    """The JAX package (x64 off) on frames 0..HANDOVER-1 of each scene, a
    checkpoint each, then from those checkpoints frames HANDOVER..N-1 of
    scene A alone and of both scenes as the lanes of the JAX
    MultiSystem(batch_track=True): the per-frame records, and the
    arguments of each keyframe optimization (one lane, and the lockstep's
    batched calls)."""
    tmp = tmp_path_factory.mktemp("fast")
    paths, solo, lanes = {}, [], [[], []]
    with jax.enable_x64(False):
        for name, (seq, frames) in scenes.items():
            fs = JFullSystem(seq.calib, seq.sensor, JSettings.preset_fast())
            for fr in frames[:HANDOVER]:
                fs.add_active_frame(*fr)
            paths[name] = str(tmp / f"{name}.npz")
            jcheckpoint.save(fs, paths[name])

        def load(name):
            seq = scenes[name][0]
            return load_jax(paths[name], seq.calib, seq.sensor,
                            JSettings.preset_fast())
        fs = load("A")
        with _calls(jkf_ops, "kf_opt_step", []) as solo_kf:
            for i in range(HANDOVER, N):
                fs.add_active_frame(*scenes["A"][1][i])
                solo.append(_frame_record(fs, i))
        multi = JMultiSystem([load(name) for name in SCENES],
                             batch_track=True, host_workers=0)
        with _calls(jkf_ops, "kf_opt_step_batch", []) as lanes_kf:
            for i in range(HANDOVER, N):
                multi.add_frames([scenes[name][1][i] for name in SCENES])
                for rec, fs in zip(lanes, multi.systems):
                    rec.append(_frame_record(fs, i))
    return dict(paths=paths, solo=solo, lanes=lanes, solo_kf=solo_kf,
                lanes_kf=lanes_kf)


def _port_system(scenes, handover, name, **kw):
    """The port's system loaded from scene `name`'s JAX checkpoint, with
    the JAX selection draws."""
    seq, path = scenes[name][0], handover["paths"][name]
    fs = tcheckpoint.load(path, seq.calib, seq.sensor,
                          TSettings.preset_fast(**kw), device="cpu")
    fs._dir_source = jax_dir_source(checkpoint_key(path), fs.h, fs.w,
                                    x64=False)
    return fs


_PORT = {}


def _port_one_lane(scenes, handover, form):
    """Scene A's frames HANDOVER..N-1 through the port's system alone, in
    `form` ("stage", "programs" or "pipelined"): (records, trajectory, the
    keyframe optimizations' lane-form calls)."""
    if form not in _PORT:
        fs = _port_system(scenes, handover, "A",
                          pipelined_frames=form == "pipelined")
        recs = []
        with contextlib.ExitStack() as stack:
            if form == "programs":
                stack.enter_context(dl.programs())
            kf = stack.enter_context(_calls(tkf_ops, "kf_opt_step_lanes",
                                            []))
            for i in range(HANDOVER, N):
                fs.add_active_frame(*scenes["A"][1][i])
                if form != "pipelined":
                    recs.append(_frame_record(fs, i))
            fs.flush()
        _PORT[form] = (recs, fs.get_trajectory(), kf)
    return _PORT[form]


def _hold(port, ref):
    """Hold a hand-over's records to the JAX package's: per frame the
    tracked pose, keyframe count and window slots; at each keyframe the
    window poses and eps."""
    b = HANDOVER_BOUNDS
    assert len(port) == len(ref) == N - HANDOVER
    for i, (t, j) in enumerate(zip(port, ref), HANDOVER):
        assert (t["is_kf"], t["n_kf"], t["order"]) == \
            (j["is_kf"], j["n_kf"], j["order"]), i
        dt, dr = pose_diff(j["tracked"], t["tracked"])
        assert dt < b["tracked"][0] and dr < b["tracked"][1], (i, dt, dr)
        if not j["is_kf"]:
            continue
        for sl, (a, c) in zip(j["order"], zip(j["window"], t["window"])):
            dt, dr = pose_diff(a, c)
            assert dt < b["window"][0] and dr < b["window"][1], \
                (i, sl, dt, dr)
        np.testing.assert_allclose(t["eps"], j["eps"], atol=b["eps"])
    assert sum(r["is_kf"] for r in ref) >= 2


# the JAX keyframe optimization's positional parameters, in order
_KF_PARAMS = list(inspect.signature(jkf_ops._kf_opt_step_impl).parameters)


def _jax_lane_args(template, port_kw, lane):
    """The JAX package's positional arguments of one keyframe optimization
    (`template`, its own call at the same keyframe) with every value the
    port passed to its lane form for `lane` in its place, in the JAX
    argument's dtype."""
    def like(v, tmpl):
        if isinstance(v, torch.Tensor):
            v = v.numpy()
        return np.asarray(v, dtype=np.asarray(tmpl).dtype)

    out = []
    for name, tmpl in zip(_KF_PARAMS, template):
        v = port_kw.get(name)
        if v is None:
            out.append(tmpl)
        elif name == "dI_newest_pyr":
            out.append(tuple(like(x[lane], t) for x, t in zip(v, tmpl)))
        elif name in tkf_ops.KF_TENSOR_ARGS or name in tkf_ops.KF_HOST_ARGS:
            out.append(like(v[lane], tmpl))
        else:
            out.append(like(v, tmpl))
    return tuple(out)


def _hold_kf_same_inputs(port_calls, jax_calls, batched):
    """Each of the port's keyframe optimizations against the JAX
    package's on the port's own inputs (the JAX call's statics, which must
    be the port's): the masks and diagnostics equal, the energy, poses,
    step, prior and depths within KF_SAME_INPUT_TOL of each output's
    scale. Returns the largest relative difference per output."""
    assert len(port_calls) == len(jax_calls) >= 2
    worst = {}
    for (_, pkw), (jargs, jkw) in zip(port_calls, jax_calls):
        for k in ("p1_cap", "p2_cap", "n_frames", "w", "h"):
            assert pkw[k] == jkw.get(k, 0), k
        templates = jargs[0] if batched else [jargs]
        args = [_jax_lane_args(t, pkw, j) for j, t in enumerate(templates)]
        with jax.enable_x64(False):
            if batched:
                ref = jkf_ops.kf_opt_step_batch(tuple(args), **jkw)
            else:
                ref = jkf_ops.kf_opt_step(*args[0], **jkw)
        got = tkf_ops.kf_opt_step_lanes(**pkw)
        for j in range(len(args)):
            r = {k: np.asarray(v)[j] if batched else np.asarray(v)
                 for k, v in ref.items() if k != "track_ref"}
            t = tkf_ops.lane_of(got, j)
            for k in ("new_state", "res_active", "pt_valid",
                      "matcher_valid", "res_diag", "match_diag",
                      "death_diag", "stats_out"):
                np.testing.assert_array_equal(t[k].numpy(), r[k], err_msg=k)
            valid = r["pt_valid"]
            for k, rel in KF_SAME_INPUT_TOL.items():
                a = t[k].numpy().astype(np.float64)
                b = r[k]
                if k == "idepth":
                    a, b = a[valid], b[valid]
                diff = float(np.abs(a - b).max())
                scale = max(float(np.abs(b).max()), 1e-9)
                worst[k] = max(worst.get(k, 0.0), diff / scale)
                assert diff <= rel * scale, (k, diff, scale)
    return worst


@pytest.mark.parametrize("form", ["stage", "programs"])
def test_handover_one_lane(scenes, handover, form):
    """Scene A handed over at frame HANDOVER, through the keyframes of
    frames 9 and 11: the port within HANDOVER_BOUNDS of the JAX package,
    in the stage form and in the program trace form; the trace form's
    records and trajectory bit for bit the stage form's."""
    recs, traj, _ = _port_one_lane(scenes, handover, form)
    _hold(recs, handover["solo"])
    if form == "programs":
        stage, stage_traj, _ = _port_one_lane(scenes, handover, "stage")
        assert np.array_equal(traj, stage_traj)
        for a, b in zip(recs, stage):
            assert a.keys() == b.keys()
            for k in a:
                assert np.array_equal(a[k], b[k]), k


def test_handover_keyframes_match_jax_on_the_ports_inputs(scenes, handover):
    """The one-lane hand-over's keyframe optimizations (F = 7 slots, N =
    2048 points, the 320x424 tracking-reference chain) against the JAX
    package's `kf_opt_step` on the port's own inputs; the
    marginalization prior (HM, bM) is held here, where a hand-over's
    float-level pose differences do not reach it."""
    _, _, calls = _port_one_lane(scenes, handover, "stage")
    worst = _hold_kf_same_inputs(calls, handover["solo_kf"], batched=False)
    print(f"\n[fast preset kf_opt, same inputs] {worst}")


def test_handover_two_lanes_lockstep(scenes, handover):
    """Scenes A and B handed over from the JAX MultiSystem to the port's
    MultiSystem(batch_track=True) as two lanes: each lane within
    HANDOVER_BOUNDS of its JAX lane, each batched keyframe optimization
    within the same-input tolerances of the JAX package's
    `kf_opt_step_batch` on the port's lanes, and each lane within LANE_TOL
    of its system run alone."""
    systems = [_port_system(scenes, handover, name) for name in SCENES]
    alone = _port_system(scenes, handover, "B")
    multi = MultiSystem(systems, batch_track=True, host_workers=0)
    recs = [[], []]
    with _calls(tkf_ops, "kf_opt_step_lanes", []) as calls:
        for i in range(HANDOVER, N):
            multi.add_frames([scenes[name][1][i] for name in SCENES])
            for fs, rec in zip(systems, recs):
                rec.append(_frame_record(fs, i))
    for i in range(HANDOVER, N):
        alone.add_active_frame(*scenes["B"][1][i])
    for rec, ref in zip(recs, handover["lanes"]):
        _hold(rec, ref)
    worst = _hold_kf_same_inputs(calls, handover["lanes_kf"], batched=True)
    print(f"\n[fast preset kf_opt lanes, same inputs] {worst}")
    for fs, traj in zip(systems, (
            _port_one_lane(scenes, handover, "stage")[1],
            alone.get_trajectory())):
        np.testing.assert_allclose(fs.get_trajectory(), traj, atol=LANE_TOL)


def test_pipelined_matches_sequential(scenes, handover):
    """The same hand-over with pipelined frames (each frame's readback and
    keyframe work run in the next frame's call) gives the sequential
    trajectory."""
    seq_traj = _port_one_lane(scenes, handover, "stage")[1]
    pipe_traj = _port_one_lane(scenes, handover, "pipelined")[1]
    np.testing.assert_array_equal(pipe_traj, seq_traj)
