"""The Hopper kernels against their plain PyTorch versions on the card,
the iterated stages' graph replays against their eager loops, and the
stage programs (one captured graph per stage, IF nodes for the later loop
chunks and the conds) against the stage form.

Marked `cuda`: skipped without a GPU. On a GPU machine (`--noconftest`
skips tests/conftest.py, which sets up JAX; these tests need none):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import contextlib

import numpy as np
import pytest
import torch

from sdv_loam_tpu_torch.ops import hopper_kernels as hk


def _splat(h, w, seed, frac=0.04):
    rng = np.random.default_rng(seed)
    wt = np.zeros((h, w), np.float32)
    idp = np.zeros((h, w), np.float32)
    m = rng.random((h, w)) < frac
    wt[m] = rng.uniform(1.0, 300.0, m.sum()).astype(np.float32)
    idp[m] = wt[m] * rng.uniform(0.01, 0.5, m.sum()).astype(np.float32)
    return idp, wt


def _seeds(h, w, seed, n=200):
    rng = np.random.default_rng(seed)
    s = np.full((h, w), 1000.0, np.float32)
    s.reshape(-1)[rng.choice(h * w, n, replace=False)] = 0.0
    return s


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _pyramid_equal(a, b):
    return all(torch.equal(x, y) for (ai, aw), (bi, bw) in zip(a, b)
               for x, y in ((ai, bi), (aw, bw)))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [None, 4])
@pytest.mark.parametrize("shape,levels", [
    ((360, 1200), 4), ((320, 424), 4), ((45, 70), 4), ((90, 300), 1),
    ((90, 300), 2), ((37, 91), 3), ((150, 212), 5), ((360, 1200), 6)])
def test_dilate_pyramid_kernel_matches_plain(cuda, shape, levels, lanes):
    maps = [_splat(*shape, seed=11 + b) for b in range(lanes or 1)]
    idp = np.stack([m[0] for m in maps]) if lanes else maps[0][0]
    wt = np.stack([m[1] for m in maps]) if lanes else maps[0][1]
    ti, tw = torch.from_numpy(idp).to(cuda), torch.from_numpy(wt).to(cuda)
    before = hk.LAUNCHES["dilate_pyramid"]
    got = hk.dilate_pyramid(ti, tw, levels)
    assert hk.LAUNCHES["dilate_pyramid"] == before + 1
    ref = hk.dilate_pyramid_plain(ti, tw, levels)
    assert [g[0].shape for g in got] == [r[0].shape for r in ref]
    assert _pyramid_equal(got, ref)                           # exact


@pytest.mark.cuda
def test_build_track_ref_launches_the_chain_once(cuda):
    from sdv_loam_tpu_torch.ops.photometric import build_track_ref
    from sdv_loam_tpu_torch.ops.pyramid import make_images
    h, w = 320, 424
    rng = np.random.default_rng(2)
    img = torch.from_numpy(rng.random((h, w)).astype(np.float32) * 255)
    dI, _ = make_images(img.to(cuda), 4)
    idp, wt = _splat(h, w, seed=4)
    before = hk.LAUNCHES["dilate_pyramid"]
    pools = build_track_ref(dI, torch.from_numpy(idp).to(cuda),
                            torch.from_numpy(wt).to(cuda), 4, cap=2048)
    assert hk.LAUNCHES["dilate_pyramid"] == before + 1
    assert len(pools) == 4 and all(int(p["n"]) > 0 for p in pools)


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [0, 1, 32, 40, 64])
@pytest.mark.parametrize("shape", [(180, 600), (160, 212), (37, 91)])
def test_distance_transform_kernel_matches_plain(cuda, shape, iters):
    s = torch.from_numpy(_seeds(*shape, seed=5, n=20)).to(cuda)
    before = hk.LAUNCHES["distance_transform"]
    assert torch.equal(hk.distance_transform(s, iters),
                       hk.distance_transform_plain(s, iters))   # exact
    # 0 sweeps are a copy, not a launch
    assert hk.LAUNCHES["distance_transform"] == before + (iters > 0)


@pytest.mark.cuda
def test_distance_transform_kernel_takes_lanes(cuda):
    """L maps in one launch (more tiles than SMs: the 64x64 tiles), and
    float maps that are not seeds: the separable sweep is exact for all."""
    rng = np.random.default_rng(8)
    s = np.stack([_seeds(180, 600, seed=b, n=30) for b in range(4)])
    s[1] = rng.uniform(0.0, 2000.0, s[1].shape).astype(np.float32)
    s[2, rng.random(s[2].shape) < 0.01] = np.inf
    ts = torch.from_numpy(s).to(cuda)
    for iters in (32, 64):
        got = hk.distance_transform(ts, iters)
        assert torch.equal(got, hk.distance_transform_plain(ts, iters))
        for b in range(4):
            assert torch.equal(got[b], hk.distance_transform(ts[b], iters))


@pytest.mark.cuda
def test_kernel_wrappers_raise_on_bad_input(cuda):
    x = torch.zeros((8, 8), device=cuda)
    s = torch.from_numpy(_seeds(45, 70, seed=1, n=1)).to(cuda)
    # beyond the halo runs in chunks: any iters, as the TPU kernel
    assert torch.equal(hk.distance_transform(s, 64),
                       hk.distance_transform_plain(s, 64))
    with pytest.raises(ValueError):
        hk.distance_transform(x, -1)
    with pytest.raises(ValueError):
        hk.dilate_pyramid(x, torch.zeros((8, 9), device=cuda), 4)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 2])
def test_loop_graphs_match_eager_loops(cuda, lanes):
    """Every iterated stage's graph replays (chunks of CHUNK[stage], the
    stop flag read once per chunk) against its eager early-exit loop on the
    same inputs, bit for bit: the loops of two frames of the 320x96 scene
    (one sequence, or two as lanes of the batched lockstep), recorded on
    the card; the first loop of each stage recorded, then replayed through
    graphs captured on the first one. The frames run in the stage form
    (`device_loop.stage_form`), where the loops are graphs of their own."""
    from sdv_loam_tpu_torch.config import Settings
    from sdv_loam_tpu_torch.data.synthetic import make_sequence
    from sdv_loam_tpu_torch.system.full_system import FullSystem
    from sdv_loam_tpu_torch.system.multi import MultiSystem
    from sdv_loam_tpu_torch.utils import device_loop as dl

    seqs = [make_sequence(n_frames=6, w=320, h=96, lidar_stride=2,
                          yaw_rate=0.003 * b) for b in range(lanes)]
    systems = [FullSystem(s.calib, s.sensor, Settings(), device=cuda)
               for s in seqs]
    run = MultiSystem(systems, batch_track=True) if lanes > 1 else None
    log = []
    for i in range(6):
        frames = [s.get(i) for s in seqs]
        # the stage form: the loops run outside captured stage programs
        with dl.stage_form(), \
                dl.recording(log) if i >= 4 else contextlib.nullcontext():
            if run is not None:
                run.add_frames(frames)
            else:
                systems[0].add_active_frame(*frames[0])
    seen = {}
    for rec in log:
        seen.setdefault(rec["stage"], []).append(rec)
    assert {"lm", "struct", "ba0", "sweep"} <= set(seen), seen.keys()
    # the alignment is one K5 launch on the card, no loop
    assert "align" not in seen, seen.keys()
    for stage, recs in seen.items():
        for rec in recs[:2]:
            res = dl.compare(rec)
            assert res["equal"], res


@pytest.mark.cuda
def test_whole_run_graphs_match_eager_loops(cuda):
    """Six frames of the 320x96 scene with every loop as graph replays
    against the same frames with eager loops (`device_loop.reference`):
    the same trajectory bit for bit. Later iterations run on the strides
    of the body's outputs, which the graphs' buffers must keep."""
    from sdv_loam_tpu_torch.config import Settings
    from sdv_loam_tpu_torch.data.synthetic import make_sequence
    from sdv_loam_tpu_torch.system.full_system import FullSystem
    from sdv_loam_tpu_torch.utils import device_loop as dl

    seq = make_sequence(n_frames=6, w=320, h=96, lidar_stride=2)
    trajs = []
    for ctx in (contextlib.nullcontext(), dl.reference()):
        fs = FullSystem(seq.calib, seq.sensor, Settings(), device=cuda)
        with ctx:
            for i in range(6):
                fs.add_active_frame(*seq.get(i))
        trajs.append(fs.get_trajectory())
    assert np.array_equal(trajs[0], trajs[1])



@pytest.mark.cuda
def test_capture_survives_dead_systems_graphs(cuda):
    """A dead cache's graphs, left as cyclic garbage, are not freed inside
    another cache's capture: destroying a graph while a thread captures
    invalidates that capture, so automatic collection is off during every
    capture (read inside the captured body) and back on after it."""
    import gc

    from sdv_loam_tpu_torch.utils import device_loop as dl

    collecting = []

    def body(x, st):
        if torch.cuda.is_current_stream_capturing():
            collecting.append(gc.isenabled())
        c = st["c"] + (st["c"] < x["stop"]).to(torch.int64)
        return dict(c=c), (c < x["stop"]).any()
    x = dict(stop=torch.tensor([7], device=cuda))
    st = dict(c=torch.zeros(1, dtype=torch.int64, device=cuda))
    dead = dl.LoopCache()
    dead.cycle = dead
    with dl.use(dead):
        dl.run("t", body, x, st, 20, chunk=3)
    assert len(dead) >= 1
    del dead
    with dl.use(dl.LoopCache()):
        out = dl.run("t", body, x, st, 20, chunk=3)
    assert int(out["c"]) == 7
    assert collecting and not any(collecting)
    assert gc.isenabled()
    gc.collect()


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 2])
def test_programs_match_stage_form(cuda, lanes):
    """Each stage program recorded on frames 2-5 of the 320x96 scene (one
    sequence, or two as lanes of the batched lockstep, whose keyframe
    optimizations there take both lanes), replayed on the card, against
    the stage form on the same inputs: bit for bit."""
    from sdv_loam_tpu_torch.config import Settings
    from sdv_loam_tpu_torch.data.synthetic import make_sequence
    from sdv_loam_tpu_torch.system.full_system import FullSystem
    from sdv_loam_tpu_torch.system.multi import MultiSystem
    from sdv_loam_tpu_torch.utils import device_loop as dl

    seqs = [make_sequence(n_frames=6, w=320, h=96, lidar_stride=2,
                          yaw_rate=0.003 * b) for b in range(lanes)]
    systems = [FullSystem(s.calib, s.sensor, Settings(), device=cuda)
               for s in seqs]
    run = MultiSystem(systems, batch_track=True) if lanes > 1 else None
    log = []
    for i in range(6):
        frames = [s.get(i) for s in seqs]
        with dl.recording(log, programs=True) if i >= 2 else \
                contextlib.nullcontext():
            if run is not None:
                run.add_frames(frames)
            else:
                systems[0].add_active_frame(*frames[0])
    seen = {}
    for rec in log:
        seen.setdefault(rec["stage"], []).append(rec)
    need = {"track", "lidar", "trace", "activate", "kf_opt", "select",
            "pyramid"} if lanes == 1 else {"track", "lidar", "kf_opt",
                                           "pyramid"}
    assert need <= set(seen), seen.keys()
    if lanes > 1:
        assert any(r["leaves"][0].shape[0] == lanes for r in seen["kf_opt"])
    for stage, recs in seen.items():
        for rec in recs[:2]:
            res = dl.compare_program(rec)
            assert res["equal"] and res["replayed"], res


@pytest.mark.cuda
def test_whole_run_programs_match_stage_form(cuda):
    """Six frames of the 320x96 scene as stage programs (the keyframe
    optimization's among them) against the same frames in the stage form:
    the same trajectory bit for bit. A second system replaying the first
    one's programs (its graph cache) gives it again, and reads no flag in
    the stages the programs hold."""
    from sdv_loam_tpu_torch.config import Settings
    from sdv_loam_tpu_torch.data.synthetic import make_sequence
    from sdv_loam_tpu_torch.system.full_system import FullSystem
    from sdv_loam_tpu_torch.utils import device_loop as dl

    seq = make_sequence(n_frames=6, w=320, h=96, lidar_stride=2)
    trajs, cache = [], None
    for ctx in (contextlib.nullcontext(), contextlib.nullcontext(),
                dl.stage_form()):
        dl.reset_counts()
        fs = FullSystem(seq.calib, seq.sensor, Settings(), device=cuda)
        if cache is not None and len(trajs) == 1:
            fs.loops = cache
        cache = fs.loops
        with ctx:
            for i in range(6):
                fs.add_active_frame(*seq.get(i))
        trajs.append(fs.get_trajectory())
        if len(trajs) == 2:
            c = dl.counts()
            assert c["programs"]["replays"] > 0
            assert c["programs"].get("captures", 0) == 0, c["programs"]
            assert not any(c.get(k, {}).get("reads", 0) for k in
                           ("lm", "cutoff", "repeat", "align", "struct",
                            "sweep", "ba0", "ba", "match2", "marg")), c
    assert np.array_equal(trajs[0], trajs[2])
    assert np.array_equal(trajs[1], trajs[2])


@pytest.mark.cuda
def test_bootstrap_programs_match_stage_form(cuda):
    """Four frames of the camera-only 320x96 scene: the bootstrap's
    programs ("select_map", "mono_lm", "pyramid") replayed on the card
    against the stage form on the same inputs, bit for bit; a second
    system past the process's warm-up reads no flag, takes the stage
    form's level LM iterations and reaches its pose bit for bit."""
    from sdv_loam_tpu_torch.config import Settings
    from sdv_loam_tpu_torch.data.synthetic import make_sequence
    from sdv_loam_tpu_torch.system.full_system import FullSystem
    from sdv_loam_tpu_torch.utils import device_loop as dl

    seq = make_sequence(n_frames=4, w=320, h=96, step=0.4, lidar_stride=8)
    kw = dict(use_struct_pose=False, pipelined_frames=False)
    inis, log = [], []
    for ctx in (contextlib.nullcontext(), contextlib.nullcontext(),
                dl.stage_form()):
        dl.reset_counts()
        fs = FullSystem(seq.calib, seq.sensor, Settings(**kw), device=cuda)
        first = not inis
        with ctx:
            for i in range(4):
                img, _, ts = seq.get(i)
                with dl.recording(log, programs=True) if first else \
                        contextlib.nullcontext():
                    fs.add_active_frame(img, None, ts)
                if i == 0:
                    inis.append(fs._mono)
        if len(inis) == 2:
            c = dl.counts()
            assert c["mono_lm"]["replays"] > 0
            assert c.get("mono", {}).get("reads", 0) == 0, c
    assert inis[0].lm_iters == inis[1].lm_iters == inis[2].lm_iters
    assert np.array_equal(inis[1].T, inis[2].T)
    seen = {}
    for rec in log:
        seen.setdefault(rec["stage"], []).append(rec)
    assert {"select_map", "mono_lm", "pyramid"} <= set(seen), seen.keys()
    for stage, recs in seen.items():
        for rec in recs[:4]:
            res = dl.compare_program(rec)
            assert res["equal"] and res["replayed"], res


@pytest.mark.cuda
def test_warm_up_outputs_have_replay_layout(cuda):
    """A program whose output is a view with gaps: its process-first call
    (the eager warm-up) and its replays return it in one layout, the dense
    one, so a program fed from it keeps one key."""
    from sdv_loam_tpu_torch.utils import device_loop as dl

    def first_channel(x):
        return (x["v"] * 2.0)[..., 0]
    x = dict(v=torch.arange(24.0, device=cuda).reshape(6, 4))
    with dl.use(dl.LoopCache()):
        outs = [dl.program("toy_layout", first_channel, x) for _ in range(3)]
    assert all(o.stride() == (1,) and torch.equal(o, outs[0]) for o in outs)
    assert torch.equal(outs[0], x["v"][:, 0] * 2.0)


def _toy(x, k2):
    """A loop whose rows stop at their own counts, a cond on its result,
    and (with `k2`) one K2 launch outside any IF node."""
    from sdv_loam_tpu_torch.utils import device_loop as dl

    def body(xx, st):
        go = st["n"] < xx["stop"]
        n = torch.where(go, st["n"] + 1, st["n"])
        v = torch.where(go, st["v"] * 1.5 + 0.25, st["v"])
        return dict(n=n, v=v), (n < xx["stop"]).any()
    st = dl.run("align", body, x, dict(n=torch.zeros_like(x["stop"]),
                                       v=x["v0"]), 12, chunk=3)
    out = dl.cond("repeat", (st["v"] > 10.0).any(),
                  lambda c: dict(c, v=c["v"] * 2.0), st)
    if k2:
        out["d"] = hk.distance_transform(x["seed"], 32)
    return out


@pytest.mark.cuda
def test_program_replays_new_inputs_without_capture(cuda):
    """One capture, then replays with new input values (loops that stop in
    their first chunk and at their cap, the cond either way): each equals
    the stage form, and no call captures again."""
    from sdv_loam_tpu_torch.utils import device_loop as dl

    dl.reset_counts()
    with dl.use(dl.LoopCache()):
        for stop in ([1, 2], [1, 12], [0, 0], [5, 3], [1, 12]):
            x = dict(stop=torch.tensor(stop, device=cuda),
                     v0=torch.tensor([1.0, 3.0], device=cuda))
            got = dl.program("toy", _toy, x, dict(k2=False))
            with dl.stage_form():
                ref = dl.program("toy", _toy, x, dict(k2=False))
            for k in ref:
                assert dl.same_bits(got[k], ref[k]), (stop, k)
            assert got["n"].tolist() == stop
    c = dl.counts()["toy"]
    # the process's first call of the function may be its eager warm-up
    assert c["captures"] == 1 and c["calls"] == 5, c
    assert c["replays"] == 5 - c.get("warmups", 0), c


def _toy_counted(x, **kw):
    return _toy(x, **kw)


@pytest.mark.cuda
def test_program_counts_replay_copies_and_annotates_its_capture(cuda):
    """A program function's first call in the process is its eager warm-up
    and its capture, each a profiler annotation (`stage:program.warmup`,
    `stage:program.capture`); a replay is `stage:program.replay` (its
    steps `stage:program.inputs`, `.launch` and `.outputs`) and counts
    its input copies and output clones as `copies`."""
    from torch.profiler import ProfilerActivity, profile

    from sdv_loam_tpu_torch.utils import device_loop as dl

    x = dict(stop=torch.tensor([1, 2], device=cuda),
             v0=torch.tensor([1.0, 3.0], device=cuda))
    dl.reset_counts()
    with dl.use(dl.LoopCache()), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        dl.program("toyc", _toy_counted, x, dict(k2=False))
        out = dl.program("toyc", _toy_counted, x, dict(k2=False))
        torch.cuda.synchronize()
    c = dl.counts()["toyc"]
    assert (c["warmups"], c["captures"], c["replays"]) == (1, 1, 1), c
    assert c["copies"] == len(x) + len(out), c
    names = {e.name for e in prof.events()}
    assert {"stage:program.warmup", "stage:program.capture",
            "stage:program.replay", "stage:program.inputs",
            "stage:program.launch", "stage:program.outputs"} <= names, names


@pytest.mark.cuda
def test_program_counts_k2_launches_per_replay(cuda):
    """A program holding one K2 launch: a warm-up call launches it (one
    count), the capture launches nothing, and every replay counts one
    launch of its lanes; the output equals the plain version."""
    from sdv_loam_tpu_torch.utils import device_loop as dl

    seed = torch.from_numpy(np.stack([_seeds(180, 600, 3 + b)
                                      for b in range(2)])).to(cuda)
    x = dict(stop=torch.tensor([1, 4], device=cuda),
             v0=torch.tensor([1.0, 3.0], device=cuda), seed=seed)
    hk.reset_launch_counts()
    with dl.use(dl.LoopCache()):
        for n in range(1, 4):
            out = dl.program("toyk2", _toy, x, dict(k2=True))
            torch.cuda.synchronize()
            assert hk.LAUNCHES["distance_transform"] == n
            assert hk.LANES["distance_transform"] == 2 * n
    assert torch.equal(out["d"], hk.distance_transform_plain(seed.cpu(),
                                                             32).to(cuda))


def _toy_k1(x):
    """`_toy`'s loop and cond, then one K1 launch outside any IF node."""
    out = _toy(x, False)
    out["maps"] = hk.dilate_pyramid(x["id0"], x["w0"], 4)
    return out


@pytest.mark.cuda
def test_program_counts_k1_launches_per_replay(cuda):
    """K1 captured in a program, as in the keyframe program: a warm-up
    call launches it (one count), the capture launches nothing, and every
    replay counts one launch of its lanes; the maps equal the plain
    version's."""
    from sdv_loam_tpu_torch.utils import device_loop as dl

    maps = [_splat(96, 320, seed=21 + b) for b in range(2)]
    id0 = torch.from_numpy(np.stack([m[0] for m in maps])).to(cuda)
    w0 = torch.from_numpy(np.stack([m[1] for m in maps])).to(cuda)
    x = dict(stop=torch.tensor([1, 4], device=cuda),
             v0=torch.tensor([1.0, 3.0], device=cuda), id0=id0, w0=w0)
    hk.reset_launch_counts()
    with dl.use(dl.LoopCache()):
        for n in range(1, 4):
            out = dl.program("toyk1", _toy_k1, x)
            torch.cuda.synchronize()
            assert hk.LAUNCHES["dilate_pyramid"] == n
            assert hk.LANES["dilate_pyramid"] == 2 * n
    ref = hk.dilate_pyramid_plain(id0.cpu(), w0.cpu(), 4)
    assert all(torch.equal(g.cpu(), r) for (gi, gw), (ri, rw) in
               zip(out["maps"], ref) for g, r in ((gi, ri), (gw, rw)))


@pytest.mark.cuda
def test_kernel_inside_if_node_is_refused(cuda):
    """A Hopper kernel inside a cond's IF node could be skipped by a
    replay, so its capture raises instead of counting it."""
    from sdv_loam_tpu_torch.utils import device_loop as dl

    def fn(x):
        return dl.cond("t", x["p"], lambda c: dict(
            d=hk.distance_transform(c["d"], 32)), dict(d=x["seed"]))
    x = dict(p=torch.tensor(True, device=cuda),
             seed=torch.from_numpy(_seeds(37, 91, 5)).to(cuda))
    with dl.use(dl.LoopCache()), pytest.raises(RuntimeError,
                                               match="cannot be counted"):
        dl.program("k2if", fn, x)



# ---------------------------------------------------------------------------
# K3 (track_res_gs) and K4 (lm_update_step / lm_update_accept_step)
# ---------------------------------------------------------------------------

# K3 against its plain version: counts exact, every other output within
# TRACK_REL of the row's largest magnitude of that output (the sums' order
# differs, and K3 sums in float64: csrc/track_res_gs.cu; 1.3e-5 measured
# at 6144 points), non-finite outputs at the same places; K4's step within
# SOLVE_REL of the step's norm (a float64 LU against solve_ex's float32
# one, whose error grows with the system's condition), the pose and
# affine update from that step within UPDATE_TOL
# of max(1, |value|), the accept exact (chip_smoke.py's tolerances)
TRACK_REL = 1e-4
SOLVE_REL = 1e-3
UPDATE_TOL = 1e-5
# (h, w, points, rows): the main path's K3 shapes at the default preset
# (the hypothesis ladder on the coarsest level, the refinement on level 0,
# the struct-pose veto on level 1) and at the fast preset
TRACK_SHAPES = [(45, 150, 1024, 32), (360, 1200, 6144, 3),
                (180, 600, 4096, 2), (40, 53, 512, 32), (320, 424, 3072, 3),
                (160, 212, 2048, 2)]


def _track_args(x, single):
    """track_res_gs's arguments from kernel_timing.track_inputs: the lane
    form, or (`single`) lane 0 with (N,) pools."""
    if single:
        return (({k: v[0] for k, v in x["pool"].items()}, x["dI"][0],
                 x["K"][0], x["T"], x["aff_rel"], x["ref_b"], x["cutoff"],
                 9.0), dict(packed=x["packed"], lane=None))
    return ((x["pool"], x["dI"], x["K"], x["T"], x["aff_rel"], x["ref_b"],
             x["cutoff"], 9.0), dict(packed=x["packed"], lane=x["lane"]))


def _res_close(got, ref, what):
    g = {k: v.double().cpu().numpy() for k, v in got.items()}
    r = {k: v.double().cpu().numpy() for k, v in ref.items()}
    assert np.array_equal(g["n"], r["n"]), what
    n = np.maximum(r["n"], 1)
    assert np.array_equal(np.round(g["sat_frac"] * n),
                          np.round(r["sat_frac"] * n)), what
    for k in ("E", "H", "b", "flow_t", "flow_rt"):
        for b in range(g[k].shape[0]):
            gb, rb = g[k][b], r[k][b]
            assert np.array_equal(np.isfinite(gb), np.isfinite(rb)), \
                (what, k, b)
            f = np.isfinite(rb)
            if f.any():
                scale = max(float(np.abs(rb[f]).max()), 1e-30)
                err = float(np.abs(gb[f] - rb[f]).max())
                assert err <= TRACK_REL * scale, (what, k, b, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [None, 4])
@pytest.mark.parametrize("shape", TRACK_SHAPES)
def test_track_res_gs_kernel_matches_plain(cuda, shape, lanes):
    """K3 against its plain version at the main path's shapes, one lane
    ((N,) pools, no lane index) and four, with points out of bounds,
    saturated points, a point at depth 0 and an image patch of inf."""
    from sdv_loam_tpu_torch.eval import kernel_timing as kt

    h, w, n, rows = shape
    sc = kt.track_scene(31, h, w, n, lanes or 1, rows, poison=True)
    x = kt.track_inputs(sc, cuda)
    a, kw = _track_args(x, lanes is None)
    hk.reset_launch_counts()
    got = hk.track_res_gs(*a, **kw)
    ref = hk.calc_res_gs_plain(*a, **kw)
    assert hk.device_launches()["track_res_gs"] == 1
    _res_close(got, ref, f"{shape} lanes={lanes}")
    assert not torch.isfinite(ref["H"][0]).all()     # the poisoned row


@pytest.mark.cuda
def test_track_res_gs_row_alone_equals_row_among_lanes(cuda):
    """A row's sums run in a fixed order: the row launched alone gives the
    bits it gives among the 128 rows of four lanes."""
    from sdv_loam_tpu_torch.eval import kernel_timing as kt

    sc = kt.track_scene(32, 45, 150, 1024, 4, 32, poison=True)
    x = kt.track_inputs(sc, cuda)
    a, kw = _track_args(x, False)
    full = hk.track_res_gs(*a, **kw)
    for b in (0, 37, 127):
        s = slice(b, b + 1)
        one = hk.track_res_gs(a[0], a[1], a[2], x["T"][s], x["aff_rel"][s],
                              x["ref_b"][s], x["cutoff"][s], 9.0,
                              packed=x["packed"], lane=x["lane"][s])
        for k in one:
            assert dl_same_bits(one[k][0], full[k][b]), (b, k)


def dl_same_bits(a, b):
    from sdv_loam_tpu_torch.utils import device_loop as dl
    return dl.same_bits(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("shape", [TRACK_SHAPES[0], TRACK_SHAPES[1]])
def test_lm_update_kernels_match_plain(cuda, shape, per_row):
    """K4's step against its plain version (the solve within SOLVE_REL of
    the step, a poisoned system's step zeroed in both, the pose and affine
    update of the kernel's own step within UPDATE_TOL), and its
    accept-step against the plain accept then step: the accept and every
    carry bit for bit, the next step within SOLVE_REL, on the scene's
    systems with lambda from 1e-4 to 1, rows done and running; exposures
    and the reference affine one pair or one per row."""
    from sdv_loam_tpu_torch.eval import kernel_timing as kt
    from sdv_loam_tpu_torch.utils import se3

    h, w, n, rows = shape
    sc = kt.track_scene(33, h, w, n, 4, rows, poison=True)
    x = kt.track_inputs(sc, cuda)
    a, kw = _track_args(x, False)
    r = hk.calc_res_gs_plain(*a, **kw)
    B = x["T"].shape[0]
    rng = np.random.default_rng(34)

    def t(v, dtype=torch.float32):
        return torch.as_tensor(np.asarray(v), dtype=dtype, device=cuda)
    lam = t(np.array([1e-4, 0.01, 0.3, 1.0])[np.arange(B) % 4])
    aff = t(rng.normal(0, [0.02, 1.0], (B, 2)))
    exposures = t(rng.uniform(0.8, 1.2, (B, 2) if per_row else (2,)))
    ref_aff = t(rng.normal(0, [0.05, 2.0], (B, 2) if per_row else (2,)))
    hk.reset_launch_counts()
    got = hk.lm_update_step(r["H"], r["b"], lam, x["T"], aff, exposures,
                            ref_aff)
    ref = hk.lm_update_step_plain(r["H"], r["b"], lam, x["T"], aff,
                                  exposures, ref_aff)
    T_new, aff_new, aff_rel, inc = got
    err = (inc - ref[3]).abs().amax(-1)
    assert (err <= SOLVE_REL * torch.linalg.vector_norm(ref[3], dim=-1)
            + 1e-30).all(), err
    assert not inc[0].any() and not ref[3][0].any()   # poisoned: zeroed
    S = torch.tensor(hk.STEP_SCALE, device=cuda)
    for got_, own in (
            (T_new, se3.se3_exp((inc * S)[:, :6]) @ x["T"]),
            (aff_new, aff + (inc * S)[:, 6:]),
            (aff_rel, hk.aff_transfer(exposures[..., 0], exposures[..., 1],
                                      ref_aff, aff_new))):
        assert ((got_ - own).abs() <= UPDATE_TOL * own.abs().clamp(min=1.0)
                ).all()
    r_new = hk.calc_res_gs_plain(a[0], a[1], a[2], T_new, aff_rel, a[5],
                                 a[6], 9.0, **kw)
    done = t(rng.random(B) < 0.3, torch.bool)
    n_it = t(rng.integers(0, 5, B), torch.int64)
    args = (r, r_new, x["T"], T_new, aff, aff_new, lam, done, n_it, inc,
            exposures, ref_aff)
    ok = hk.lm_update_accept_step(*args)
    op = hk.lm_update_accept_step_plain(*args)
    for k in ("T", "aff", "lam", "done", "n_it", "active"):
        assert dl_same_bits(ok[k], op[k]), k
    for k in ok["r"]:
        assert dl_same_bits(ok["r"][k], op["r"][k]), k
    err = (ok["inc"] - op["inc"]).abs().amax(-1)
    assert (err <= SOLVE_REL * torch.linalg.vector_norm(op["inc"], dim=-1)
            + 1e-30).all(), err
    assert hk.device_launches() == {"track_res_gs": 0, "track_lm_update": 2,
                                    "lm_step": 1, "lm_accept_step": 1,
                                    "align_batch": 0, "warp_patches": 0,
                                    "warp_align": 0, "align_zero": 0,
                                    "ba_linearize": 0, "ba_accumulate": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("systems", ["scene", "tied"])
def test_lm_step_kernel_is_the_serial_lu(cuda, systems):
    """K4's warp-parallel solve is the serial float64 LU with each
    multiply-subtract fused, bit for bit (tests/k4_lu.py's emulation, whose
    pivot rule is a one-thread serial scan's), in the step entry and in the
    accept-step's next step: on the scene's damped systems at lambda 1e-4
    to 1, and on systems of small integers (tied pivots, zeros)."""
    import k4_lu
    from sdv_loam_tpu_torch.eval import kernel_timing as kt

    rng = np.random.default_rng(37)
    if systems == "scene":
        sc = kt.track_scene(38, 45, 150, 1024, 4, 8)
        x = kt.track_inputs(sc, cuda)
        a, kw = _track_args(x, False)
        r = hk.calc_res_gs_plain(*a, **kw)
        H, b, T = r["H"], r["b"], x["T"]
    else:
        B = 32
        A = rng.integers(-3, 4, (B, 8, 8)).astype(np.float32)
        A = A + 8 * np.eye(8, dtype=np.float32)[None] \
            * (np.arange(B) % 2)[:, None, None]
        H = torch.as_tensor(A.astype(np.float32), device=cuda)
        b = torch.as_tensor(rng.integers(-5, 6, (B, 8)).astype(np.float32),
                            device=cuda)
        T = torch.eye(4, device=cuda).expand(B, 4, 4).contiguous()
    B = H.shape[0]
    lam = torch.as_tensor(np.array([1e-4, 0.01, 0.3, 1.0],
                                   np.float32)[np.arange(B) % 4],
                          device=cuda)
    aff = torch.zeros((B, 2), device=cuda)
    ex, ra = torch.ones(2, device=cuda), torch.zeros(2, device=cuda)
    want = np.stack([k4_lu.step_inc(H[i].cpu().numpy(), b[i].cpu().numpy(),
                                    float(lam[i])) for i in range(B)])
    inc = hk.lm_update_step(H, b, lam, T, aff, ex, ra)[3]
    assert np.array_equal(inc.cpu().numpy().view(np.int32),
                          want.view(np.int32))
    # the accept-step of rows that all keep their state: its next step is
    # the step of the same carries at lambda 4x (at least the limit)
    res = dict(E=torch.ones(B, device=cuda),
               n=torch.ones(B, dtype=torch.int64, device=cuda),
               sat_frac=torch.zeros(B, device=cuda), H=H, b=b,
               flow_t=torch.zeros(B, device=cuda),
               flow_rt=torch.zeros(B, device=cuda))
    o = hk.lm_update_accept_step(
        res, dict(res, E=torch.full((B,), 2.0, device=cuda)), T, T, aff, aff,
        lam, torch.zeros(B, dtype=torch.bool, device=cuda),
        torch.zeros(B, dtype=torch.int64, device=cuda), inc, ex, ra)
    lam4 = torch.clamp(lam * 4.0, min=1e-3)
    assert torch.equal(o["lam"], lam4)
    want = np.stack([k4_lu.step_inc(H[i].cpu().numpy(), b[i].cpu().numpy(),
                                    float(lam4[i])) for i in range(B)])
    assert np.array_equal(o["inc"].cpu().numpy().view(np.int32),
                          want.view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [TRACK_SHAPES[0], TRACK_SHAPES[1]])
def test_track_res_gs_kernel_equals_its_emulation(cuda, shape):
    """K3 on the card against its CPU emulation in the kernel's arithmetic
    and order (tests/k3_order.py: float32 per-point terms, the cluster's
    float64 order, each output rounded once): every output bit for bit,
    two lanes."""
    import k3_order
    from sdv_loam_tpu_torch.eval import kernel_timing as kt

    h, w, n, rows = shape
    sc = kt.track_scene(39, h, w, n, 2, rows)
    x = kt.track_inputs(sc, cuda)
    a, kw = _track_args(x, False)
    got = hk.track_res_gs(*a, **kw)
    xc = kt.track_inputs(sc, "cpu")
    emu = k3_order.emulate(xc["pool"], xc["packed"], xc["K"], xc["T"],
                           xc["aff_rel"], xc["ref_b"], xc["cutoff"], 9.0,
                           xc["lane"], h, w)
    differ = {k: int((~(torch.eq(got[k].cpu(), emu[k])
                        | (got[k].cpu().isnan() & emu[k].isnan()))).sum())
              for k in emu if k != "n"}
    differ["n"] = int((got["n"].cpu() != emu["n"]).sum())
    assert not any(differ.values()), differ


def _track_level_program(x, huber_th, max_iters):
    from sdv_loam_tpu_torch.ops import photometric as tph
    T, aff, r, rep = tph.track_level(
        x["pool"], x["dI"], x["K"], x["T"], x["aff"], x["ref_aff"],
        x["exposures"], x["cutoff_base"], huber_th, max_iters,
        packed=x["packed"], lane=x["lane"])
    return dict(T=T, aff=aff, n_iters=r["n_iters"], rep=rep)


@pytest.mark.cuda
def test_track_kernels_count_the_loops_evaluations(cuda):
    """K3 and K4 inside a captured program's WHILE node: their device
    counters equal the evaluations the LM ran (per call: one first
    evaluation and one per iteration for K3; for K4 the step once per
    call and the accept-step once per iteration; iterations = the rows'
    largest n_iters, the cutoff loop idle),
    over the process's eager first call and the replays; a replay in a
    profile window is timed on the device."""
    from sdv_loam_tpu_torch.eval import kernel_timing as kt
    from sdv_loam_tpu_torch.utils import device_loop as dl

    sc = kt.track_scene(35, 45, 150, 1024, 2, 8)
    x = kt.track_inputs(sc, cuda)
    B = x["T"].shape[0]
    rng = np.random.default_rng(36)
    inputs = dict(pool=x["pool"], dI=x["dI"], K=x["K"], T=x["T"],
                  packed=x["packed"], lane=x["lane"],
                  aff=torch.as_tensor(rng.normal(0, [0.02, 1.0], (B, 2)),
                                      dtype=torch.float32, device=cuda),
                  ref_aff=torch.zeros((B, 2), device=cuda),
                  exposures=torch.ones((B, 2), device=cuda),
                  cutoff_base=torch.full((), 1000.0, device=cuda))
    hk.reset_launch_counts()
    want, outs = [0, 0], []
    with dl.use(dl.LoopCache()):
        for i in range(4):
            with dl.program_timing() as timed:
                out = dl.program("tl_count", _track_level_program, inputs,
                                 dict(huber_th=9.0, max_iters=10))
            outs.append(out)
            it = int(out["n_iters"].max())
            want[0] += 1 + it
            want[1] += 1 + it
            assert float(out["rep"].max()) == 1.0
            if i:
                assert timed["tl_count"]["replays"] == 1 and \
                    timed["tl_count"]["ms"] > 0, timed
    got = hk.device_launches()
    assert [got["track_res_gs"], got["track_lm_update"]] == want, (got, want)
    assert got["lm_step"] == 4 and got["lm_accept_step"] == want[1] - 4
    assert 1 < int(outs[-1]["n_iters"].max()) <= 10
    for k in outs[0]:
        assert dl.same_bits(outs[1][k], outs[-1][k]), k


# ---------------------------------------------------------------------------
# K5 (align_batch) and K6 (warp_affine_patches)
# ---------------------------------------------------------------------------

# the tolerances of tests/test_torch_align_kernels.py: converged flags
# agree on at least ALIGN_FLAG_SHARE of the rows but one, px within
# ALIGN_PX_TOL where both converge, the failure masks equal where the
# flags agree;
# patches with the plain version's zero and NaN pattern, values within
# PATCH_TOL
ALIGN_FLAG_SHARE = 0.999
ALIGN_PX_TOL = 0.01
PATCH_TOL = 0.02
# the fused call's px gate: a row that converges in both but one iteration
# later on one side (its float64 sums against the plain version's float32
# ones put a step on the other side of the threshold) differs by that last
# step, less than the threshold of 0.03 px; such rows share the flags'
# budget of one row plus 0.1 % (read on an H100 80GB HBM3 at 700 W: 1 of
# 10,240 rows, 0.016 px, on warp_align_scene(84) at the default pass 1
# with four lanes; the CPU emulation gives the same px bit for bit)
ALIGN_STEP_TOL = 0.03
# (preset, matcher call): kernel_timing.ALIGN_SHAPES's main-path rows
ALIGN_CALLS = [(p, c) for p in ("default", "fast")
               for c in ("track", "pass1", "pass2")]


def _align_masks(x, out):
    return torch.stack([x["valid"] & ~out["conv"] & ~out["alive"],
                        x["valid"] & ~out["conv"] & out["alive"]], -1)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("preset,call", ALIGN_CALLS)
def test_align_kernel_matches_plain_and_emulation(cuda, preset, call,
                                                  lanes):
    """K5 at the main path's shapes (the fused kernel reading the given
    patches): against the plain batched loop under the CPU tests'
    tolerances, and bit for bit (NaN payloads aside) against its CPU
    emulation (tests/k5_align.py: the kernel's float64 sums and order);
    one device launch, in that mode, after one launch of the kernel that
    zeroes the failure counts, per-lane failure counts equal to the masks'
    sums."""
    import k5_align
    from sdv_loam_tpu_torch.eval import kernel_timing as kt
    from sdv_loam_tpu_torch.utils import device_loop as dl

    (h, w), rows = kt.ALIGN_SHAPES[preset]
    sc = kt.align_scene(50 + lanes, h, w, rows[call], lanes, poison=True)
    args = kt.align_args(sc, cuda)
    hk.reset_launch_counts()
    px, conv, fails = hk.align_batch(*args, n_lanes=lanes)
    launched = hk.device_launches()
    assert launched["align_batch"] == 1 and launched["warp_align"] == 0
    assert launched["warp_patches"] == 0 and launched["align_zero"] == 1
    x, st = hk.align_setup(*args)
    out = dl.run("align", hk.align_body, x, st, 10)
    ref_px, ref_conv = torch.stack([out["u"], out["v"]], -1), out["conv"]
    agree = conv == (ref_conv & x["valid"])
    both = conv & ref_conv
    assert int((~agree).sum()) <= 1 + (1 - ALIGN_FLAG_SHARE) * agree.numel()
    assert float((px - ref_px).abs()[both].max()) <= ALIGN_PX_TOL
    emu = k5_align.align_batch(*(a.cpu() for a in args))
    # bit for bit but for NaN payloads (the card's arithmetic makes its own)
    n = k5_align.bits_differ(px, emu[0])
    assert n == 0, f"{n} of {px.numel()} differ"
    assert torch.equal(conv.cpu(), emu[1])
    assert torch.equal(fails.cpu(), emu[2].reshape(lanes, -1, 2).sum(1))
    assert torch.equal(_align_masks(x, out)[agree].cpu(),
                       emu[2][agree.cpu()])


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("preset,call", ALIGN_CALLS)
def test_warp_kernel_matches_plain_and_emulation(cuda, preset, call,
                                                 lanes):
    """K6 at the main path's shapes (the fused kernel's patches-only
    mode): against the plain version (the same zero and NaN pattern,
    values within PATCH_TOL) and bit for bit against its CPU emulation;
    one device launch, in that mode, and no zeroing launch (nothing is
    aligned)."""
    import k5_align
    from sdv_loam_tpu_torch.eval import kernel_timing as kt

    (h, w), rows = kt.ALIGN_SHAPES[preset]
    sc = kt.warp_scene(60 + lanes, h, w, rows[call], lanes, poison=True)
    args, kw = kt.warp_args(sc, cuda)
    hk.reset_launch_counts()
    got = hk.warp_affine_patches(*args, **kw)
    launched = hk.device_launches()
    assert launched["warp_patches"] == 1 and launched["warp_align"] == 0
    assert launched["align_batch"] == 0 and launched["align_zero"] == 0
    ref = hk.warp_affine_patches_plain(*args, **kw)
    nan_g, nan_r = torch.isnan(got), torch.isnan(ref)
    assert torch.equal(nan_g, nan_r) and torch.equal(got == 0, ref == 0)
    assert float((got - ref).abs()[~nan_r].max()) <= PATCH_TOL
    emu = k5_align.warp_patches(kw["quad_stack"].cpu(), *(a.cpu() for a in
                                                          args[1:]), h, w)
    assert dl_same_bits(got.cpu(), emu)


def _match_program(x):
    from sdv_loam_tpu_torch.utils import device_loop as dl

    def fused(c):
        px, conv, fails = hk.warp_align(*x["fused"], quad_stack=x["quad"])
        return dict(px=px, fails=fails)
    return dl.cond("t", x["go"], fused, dict(
        px=torch.zeros_like(x["fused"][10]),
        fails=torch.zeros(2, dtype=torch.int64, device=x["go"].device)))


@pytest.mark.cuda
def test_align_kernels_count_inside_an_if_node(cuda):
    """The fused K5 / K6 launch inside a captured program's IF node (the
    keyframe program's second matcher pass): its device counters count the
    replays whose predicate holds, one launch and one zeroing launch each,
    and each replay's outputs equal the eager call's: px, and the failure
    counts bit for bit
    (the kernel adds them up after a zeroing kernel of the same call, both
    replayed in the IF node; a replay that lost the zeroing would pile the
    counts up across replays). The poisoned rows make the counts
    nonzero."""
    from sdv_loam_tpu_torch.eval import kernel_timing as kt
    from sdv_loam_tpu_torch.utils import device_loop as dl

    args, kw = kt.warp_align_args(kt.warp_align_scene(
        70, 96, 320, 64, 1, levels=3, poison=True), cuda)
    x = dict(fused=args, quad=kw["quad_stack"],
             go=torch.tensor(True, device=cuda))
    hk.reset_launch_counts()
    runs, outs = 0, []
    with dl.use(dl.LoopCache()):
        for go in (True, True, False, True, False, True):
            x["go"] = torch.tensor(go, device=cuda)
            outs.append((go, dl.program("k5if", _match_program, x)))
            runs += go
    want = hk.warp_align(*args, **kw)
    got = hk.device_launches()
    assert got["warp_align"] == runs + 1
    assert got["align_batch"] == got["warp_patches"] == runs + 1
    assert got["align_zero"] == runs + 1
    assert int(want[2].sum()) > 0, want[2]
    for go, out in outs:
        if go:
            assert dl_same_bits(out["px"], want[0])
            assert torch.equal(out["fails"], want[2]), (out["fails"],
                                                        want[2])
        else:
            assert not bool(out["fails"].any())


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("preset,call", ALIGN_CALLS)
def test_fused_kernel_matches_plain_and_emulation(cuda, preset, call,
                                                  lanes):
    """The fused call (MODE_FUSED: K6's patch warp into shared memory, then
    K5 on it) at the main path's shapes: on
    warp_align_scene's poisoned inputs, its px, flags and failure counts
    against the plain loop's on the kernel's own patches (the
    patches-only mode's, the same device code) under the CPU tests'
    tolerances (with ALIGN_STEP_TOL for rows that converge one iteration
    apart), and those patches against warp_affine_patches_plain's;
    there and with `kernel_timing.edge_cases`' rows (rows at a level's
    edge, rows that walk far from their start, rows on a level the pack
    cuts short) bit for bit (NaN payloads aside) against its CPU
    emulation (tests/k5_align.py warp_align); one launch, counted for K5
    and K6, after one zeroing launch."""
    import k5_align
    from sdv_loam_tpu_torch.eval import kernel_timing as kt

    (h, w), rows = kt.ALIGN_SHAPES[preset]
    for cases in (False, True):
        sc = kt.warp_align_scene(80 + lanes, h, w, rows[call], lanes,
                                 poison=True)
        if cases:
            sc = kt.edge_cases(sc, 80 + lanes)
        args, kw = kt.warp_align_args(sc, cuda)
        hk.reset_launch_counts()
        px, conv, fails = hk.warp_align(*args, n_lanes=lanes, **kw)
        assert hk.device_launches() == {
            "track_res_gs": 0, "track_lm_update": 0, "lm_step": 0,
            "lm_accept_step": 0, "align_batch": 1, "warp_patches": 1,
            "warp_align": 1, "align_zero": 1, "ba_linearize": 0,
            "ba_accumulate": 0}
        if not cases:
            (wargs, wkw), align = kt.split_warp_align(args, kw)
            patches = hk.warp_affine_patches(*wargs, **wkw)
            plain = hk.warp_affine_patches_plain(*wargs, **wkw)
            assert torch.equal(torch.isnan(patches), torch.isnan(plain))
            assert float((patches - plain).abs()[~torch.isnan(plain)]
                         .max()) <= PATCH_TOL
            ref = hk.align_batch_plain(*align(patches), n_lanes=lanes)
            agree = conv == ref[1]
            both = conv & ref[1]
            d = (px - ref[0]).abs().amax(-1)
            late = both & (d > ALIGN_PX_TOL)
            assert int((~agree).sum()) + int(late.sum()) <= \
                1 + (1 - ALIGN_FLAG_SHARE) * agree.numel()
            assert float(d[both].max()) <= ALIGN_STEP_TOL
            assert int((fails - ref[2]).abs().sum()) <= int((~agree).sum())
        cpu = [a.cpu() for a in args]
        emu = k5_align.warp_align(kw["quad_stack"].cpu(), *cpu[1:5], h, w,
                                  *cpu[5:])
        n = k5_align.bits_differ(px, emu[0])
        assert n == 0, f"{n} of {px.numel()} differ"
        assert torch.equal(conv.cpu(), emu[1])
        assert torch.equal(fails.cpu(), emu[2].reshape(lanes, -1, 2).sum(1))


# ---------------------------------------------------------------------------
# systems pinned to a card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_full_system_refuses_a_card_it_cannot_have(cuda):
    """A FullSystem asked for an ordinal past the visible cards raises (no
    move to another card or to the CPU); asked for "cuda" it is pinned to
    the current card by ordinal."""
    from sdv_loam_tpu_torch.data.synthetic import make_sequence
    from sdv_loam_tpu_torch.system.full_system import FullSystem

    seq = make_sequence(n_frames=1, w=320, h=96)
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="visible"):
        FullSystem(seq.calib, seq.sensor, device=f"cuda:{n}")
    fs = FullSystem(seq.calib, seq.sensor, device="cuda")
    assert fs.device == torch.device("cuda", torch.cuda.current_device())
    assert fs.stream.device == fs.device


@pytest.mark.cuda
def test_batch_mesh_lists_every_visible_card(cuda):
    from sdv_loam_tpu_torch.parallel.mesh import make_batch_mesh

    mesh = make_batch_mesh()
    assert mesh == tuple(torch.device("cuda", i)
                         for i in range(torch.cuda.device_count()))
