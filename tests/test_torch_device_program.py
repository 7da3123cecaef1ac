"""The port's stage programs (`device_loop.program`) on the CPU.

On the card each stage (the pyramid, the track step, the LiDAR
preprocessing, the trace, the selection attempt, the activation, the
keyframe optimization, and the camera-only bootstrap's status-map
selection and level LM) is one captured CUDA graph, its loops' later
chunks and its conds IF nodes. The CPU cannot capture; its program mode
(`device_loop.programs`) runs the same functions in the trace form a
capture records: every loop to its cap, every cond computed and selected,
no host read. On recorded 320x96 frames, one lane and two (the bootstrap's
programs on a camera-only scene, one lane):

  * capture safety: a program's function dispatches none of the ops a
    capture refuses or that read the device from the host
    (`_local_scalar_dense`, `nonzero`, `is_nonzero`, `equal`, `unique*`,
    `masked_select`, `lift_fresh` (a tensor from host data), `bincount`,
    an index by a bool mask);
  * its outputs equal the stage form's bit for bit (early-exit loops and
    host reads), also where the cutoff doubling and the level repeat fire
    and where a loop stops in its first chunk; for the keyframe
    optimization also where each of its conds fires: a flagged slot's
    frame marginalization, the two-keyframe window's swapped matcher
    references, the windowed LM's second loop, and a second-pass target
    that one lane runs and the other skips;
  * two consecutive keyframes of one window size class give the keyframe
    program one key (no capture per keyframe on the card);
  * the level LM's program equals its stage form on each of the loop's
    three exits: two rejected steps in a row, a step below 1e-4, the
    iteration cap.
"""

import pytest
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils._python_dispatch import TorchDispatchMode

from sdv_loam_tpu_torch.config import Settings
from sdv_loam_tpu_torch.data.synthetic import make_sequence
from sdv_loam_tpu_torch.system.full_system import FullSystem
from sdv_loam_tpu_torch.system.multi import MultiSystem
from sdv_loam_tpu_torch.utils import device_loop as dl

torch.set_num_threads(1)

SETTINGS = dict(desired_immature_density=600, desired_point_density=800,
                n_active_cap=2048, n_immature_cap=2048)
N_FRAMES = 6
# the ops a stage program must not dispatch (their overload packets)
FORBIDDEN = ("_local_scalar_dense", "nonzero", "nonzero_static",
             "is_nonzero", "equal", "masked_select", "lift_fresh",
             "bincount", "item")
CASES = [("track", 1), ("track", 2), ("lidar", 1), ("lidar", 2),
         ("trace", 1), ("activate", 1), ("kf_opt", 1), ("kf_opt", 2),
         ("select", 1), ("select", 2), ("pyramid", 1), ("pyramid", 2),
         ("mono_lm", 1), ("select_map", 1)]
# the camera-only scene (tests/test_mono_init.py's): the bootstrap's
# programs of its first frames
MONO_SCENE = dict(w=320, h=96, step=0.4, lidar_stride=8)
MONO_FRAMES = 4


class _Refused(TorchDispatchMode):
    """Collects the forbidden ops a block dispatches."""

    def __init__(self):
        super().__init__()
        self.seen = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        bad = name in FORBIDDEN or "unique" in name
        if name in ("index", "index_put", "index_put_"):
            bad = bad or any(t is not None and t.dtype == torch.bool
                             for t in args[1])
        if bad:
            self.seen[name] = self.seen.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _scene(**kw):
    return make_sequence(n_frames=N_FRAMES, w=320, h=96, step=0.8,
                         lidar_stride=2, **kw)


@pytest.fixture(scope="module")
def records():
    """The first recorded program of each (stage, lanes): one sequence's
    frames 1-5, and a batched lockstep of two sequences."""
    out = {}
    seq = _scene()
    fs = FullSystem(seq.calib, seq.sensor, Settings(**SETTINGS),
                    device="cpu")
    log = []
    for i in range(N_FRAMES):
        with dl.recording(log, programs=True):
            fs.add_active_frame(*seq.get(i))
    seqs = [_scene(yaw_rate=yr) for yr in (0.004, 0.012)]
    fleet = MultiSystem([FullSystem(s.calib, s.sensor, Settings(**SETTINGS),
                                    device="cpu") for s in seqs],
                        batch_track=True, host_workers=0)
    for i in range(3):
        with dl.recording(log, programs=True):
            fleet.add_frames([s.get(i) for s in seqs])
    for rec in log:
        lanes = (len(tree_unflatten(rec["leaves"], rec["spec"])["lanes"])
                 if rec["stage"] == "track" else
                 next(v for v in rec["leaves"]
                      if isinstance(v, torch.Tensor)).shape[0])
        out.setdefault((rec["stage"], lanes), rec)
        if rec["stage"] == "kf_opt":
            out.setdefault(("kf_opt", "all"), []).append(rec)
    mono = make_sequence(n_frames=MONO_FRAMES, **MONO_SCENE)
    fs = FullSystem(mono.calib, mono.sensor,
                    Settings(use_struct_pose=False, pipelined_frames=False),
                    device="cpu")
    log = []
    for i in range(MONO_FRAMES):
        img, _, ts = mono.get(i)
        with dl.recording(log, programs=True):
            fs.add_active_frame(img, None, ts)
    assert not fs.initialized
    for rec in log:
        if rec["stage"] in ("mono_lm", "select_map"):
            out.setdefault((rec["stage"], 1), rec)
            out.setdefault((rec["stage"], "all"), []).append(rec)
    return out


def _inputs(rec):
    return tree_unflatten([v.clone() if isinstance(v, torch.Tensor) else v
                           for v in rec["leaves"]], rec["spec"])


@pytest.mark.parametrize("stage,lanes", CASES)
def test_program_is_capture_safe(records, stage, lanes):
    rec = records[(stage, lanes)]
    mode = _Refused()
    with mode, dl._inner_form("trace"):
        rec["fn"](_inputs(rec), **rec["static"])
    assert not mode.seen, mode.seen


@pytest.mark.parametrize("stage,lanes", CASES)
def test_program_equals_stage_form(records, stage, lanes):
    res = dl.compare_program(records[(stage, lanes)])
    assert res["equal"], res


def test_track_program_when_cutoff_doubles_and_level_repeats(records,
                                                             monkeypatch):
    """A low cutoff saturates most residuals: the stage form reads the
    cutoff pre-loop's and the level repeat's predicates true, and the
    program (both blocks computed and selected) gives its outputs bit for
    bit."""
    rec = records[("track", 1)]
    inputs = _inputs(rec)
    inputs["shared"]["cutoff_th"] = torch.tensor(0.25)
    leaves, spec = tree_flatten(inputs)
    rec = dict(rec, leaves=leaves, spec=spec)
    seen = []
    read = dl.read

    def logged(stage, flag):
        out = read(stage, flag)
        seen.append((stage, out))
        return out
    monkeypatch.setattr(dl, "read", logged)
    res = dl.compare_program(rec)
    assert ("cutoff", True) in seen and ("repeat", True) in seen, seen
    assert ("cutoff", False) in seen or ("repeat", False) in seen, seen
    assert res["equal"], res


def _toy_program(x, max_iters, chunk):
    """A loop whose rows stop at their own iteration counts (in the first
    chunk when `x["stop"]` is small), then a cond on its result."""
    def body(xx, st):
        go = st["n"] < xx["stop"]
        n = torch.where(go, st["n"] + 1, st["n"])
        v = torch.where(go, st["v"] * 1.5 + 0.25, st["v"])
        return dict(n=n, v=v), (n < xx["stop"]).any()
    st = dl.run("align", body, x, dict(n=torch.zeros_like(x["stop"]),
                                       v=x["v0"]), max_iters, chunk=chunk)
    return dl.cond("repeat", (st["v"] > 10.0).any(),
                   lambda c: dict(c, v=c["v"] * 2.0), st)


@pytest.mark.parametrize("stop", [[1, 2], [1, 9], [0, 0]])
def test_loop_and_cond_program_equal_stage_form(stop):
    """A loop that stops in its first chunk (or never runs a row), or
    later, followed by a cond either way: the trace form equals the
    early-exit loop and the host-read cond bit for bit, and counts no
    read."""
    x = dict(stop=torch.tensor(stop), v0=torch.tensor([1.0, 3.0]))
    with dl.stage_form():
        ref = dl.program("toy", _toy_program, x, dict(max_iters=9, chunk=3))
    dl.reset_counts()
    with dl.programs():
        got = dl.program("toy", _toy_program, x, dict(max_iters=9, chunk=3))
    assert dl.counts()["all"].get("reads", 0) == 0
    for k in ref:
        assert dl.same_bits(got[k], ref[k]), k
    assert got["n"].tolist() == stop


def test_cond_forms():
    """`cond` in the trace form selects `fn`'s outputs where the predicate
    holds and keeps the carries where it does not, as the host read does;
    an output laid out unlike its carry is refused."""
    c = dict(a=torch.arange(6.0).reshape(2, 3))
    fn = (lambda d: dict(a=d["a"] + 1))
    for p in (True, False):
        with dl._inner_form("trace"):
            got = dl.cond("t", torch.tensor(p), fn, c)
        ref = dl.cond("t", torch.tensor(p), fn, c)
        assert torch.equal(got["a"], ref["a"])
    with pytest.raises(RuntimeError, match="strides"):
        with dl._inner_form("trace"):
            dl.cond("t", torch.tensor(True),
                    lambda d: dict(a=torch.empty_strided((2, 3), (1, 2))
                                   .copy_(d["a"] + 1)), c)


def _variant(rec, edit):
    """`rec` with its inputs changed in place by `edit(inputs)`."""
    inputs = _inputs(rec)
    edit(inputs)
    leaves, spec = tree_flatten(inputs)
    return dict(rec, leaves=leaves, spec=spec)


def _reads(monkeypatch):
    """The (stage, value) of every counted host read from now on."""
    seen = []
    read = dl.read

    def logged(stage, flag):
        out = read(stage, flag)
        seen.append((stage, out))
        return out
    monkeypatch.setattr(dl, "read", logged)
    return seen


def _kf_window(records, n):
    return next(r for r in records[("kf_opt", "all")]
                if int(_inputs(r)["frame_valid"][0].sum()) == n)


def test_kf_opt_program_marginalizes_a_flagged_slot(records, monkeypatch):
    """Slot 0 of a four-keyframe window flagged: the stage form's
    frame-marginalization cond reads true for it (and false for the
    others), and the program's outputs equal it bit for bit."""
    rec = _kf_window(records, 4)

    def flag(x):
        x["slot_flagged"][0, 0] = True
    rec = _variant(rec, flag)
    seen = _reads(monkeypatch)
    res = dl.compare_program(rec)
    marg = [v for st, v in seen if st == "marg"]
    assert marg == [True] + [False] * 7, marg
    assert res["equal"], res


def test_kf_opt_program_two_keyframe_window(records, monkeypatch):
    """The window's second keyframe: the matcher references are swapped
    (each point references the other keyframe), the budget is 100 and the
    windowed LM enters its second loop; the program equals the stage form
    bit for bit."""
    rec = _kf_window(records, 2)
    x = _inputs(rec)
    assert int(x["ctl"]["max_it"][0]) == 100
    assert not torch.equal(x["ref_idx_multi"][0, 0], x["pt_host"][0])

    def longer(xx):
        # at least 4 iterations: past the first loop's two
        xx["ctl"]["min_it"][:] = 4
    rec = _variant(rec, longer)
    seen = _reads(monkeypatch)
    res = dl.compare_program(rec)
    assert ("ba", True) in seen, seen
    assert ("match2", True) in seen, seen
    assert res["equal"], res


def test_kf_opt_program_target_one_lane_skips(records, monkeypatch):
    """Two lanes: lane 1 skips every second-pass target, lane 0 runs its
    own. The stage form runs target 0 for lane 0 alone and gives lane 1
    no match there; the program equals it bit for bit."""
    rec = records[("kf_opt", 2)]
    assert bool(_inputs(rec)["multi_target_mask"][0, 0])

    def skip(x):
        x["multi_target_mask"][1] = False
    rec = _variant(rec, skip)
    seen = _reads(monkeypatch)
    res = dl.compare_program(rec)
    assert ("match2", True) in seen, seen
    assert res["equal"], res
    with dl.stage_form():
        out = dl.program(rec["stage"], rec["fn"], _inputs(rec),
                         rec["static"])
    x = _inputs(rec)
    newest = x["pt_host"][1] == x["ctl"]["newest"][1]
    # lane 1's newest-host points gained no second-pass match
    assert not (out["matcher_valid"][1][newest] & ~x["matcher_valid"][1][
        newest] & (torch.arange(8) != x["ctl"]["newest"][1])).any()


def test_kf_opt_program_key_holds_across_keyframes(records):
    """The keyframes of windows of three and four frames have the same
    compaction caps and budget bound, and their programs one key: the
    chained inputs keep their shapes, strides and dtypes."""
    a, b = _kf_window(records, 3), _kf_window(records, 4)
    assert a["static"] == b["static"]
    keys = [dl._program_key(r["stage"], r["fn"], r["leaves"], r["spec"],
                            r["static"], "cpu") for r in (a, b)]
    assert keys[0] == keys[1]


def _mono_exit(rec):
    """How the level LM's loop of `rec` (a "mono_lm" program) stops in the
    stage form: ("fails" | "done" | "cap", iterations). The loop's own
    body, stepped from its recorded first carries."""
    loops = []
    with dl.stage_form(), dl.recording(loops):
        rec["fn"](_inputs(rec), **rec["static"])
    (loop,) = [r for r in loops if r["stage"] == "mono"]
    st = loop["st"]
    for n in range(loop["max_iters"]):
        st, active = loop["body"](loop["x"], st, **loop["static"])
        if not bool(active):
            why = "fails" if int(st["fails"]) >= 2 else "done"
            return (why if n + 1 < loop["max_iters"] else "cap"), n + 1
    return "cap", loop["max_iters"]


def _empty_level(x):
    """No point good and no translation: the increment is zero, so the
    first iteration's step is below the stop threshold."""
    x["pt"]["is_good"][:] = False
    x["T"][:3, 3] = 0.0


@pytest.mark.parametrize("exit_", ["fails", "done", "cap"])
def test_mono_lm_program_on_each_exit(records, exit_):
    """The level LM stops on two rejected steps in a row (a coarse level),
    on a step below 1e-4 (an empty level), and at its cap (a fine level's
    five iterations): the program's trace form equals the stage form bit
    for bit, iterations included, and reads no flag."""
    recs = records[("mono_lm", "all")]
    if exit_ == "done":
        recs = [_variant(recs[0], _empty_level)]
    rec = next(r for r in recs if _mono_exit(r)[0] == exit_)
    why, n = _mono_exit(rec)
    dl.reset_counts()
    res = dl.compare_program(rec)
    assert res["equal"], res
    with dl.programs():
        out = dl.program(rec["stage"], rec["fn"], _inputs(rec),
                         rec["static"])
    assert int(out["iters"]) == n
    assert dl.counts()["mono"]["reads"] == n - (exit_ == "cap")
