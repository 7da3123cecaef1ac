"""The port's loop driver (`sdv_loam_tpu_torch/utils/device_loop.py`) on
the CPU, where there is no card to capture on.

On CUDA every iterated stage runs as replays of a captured chunk of `k`
iterations, with its stop flag read once per chunk. That is exact only
because every loop body freezes the rows that have stopped. Here, on
inputs recorded from real frames of the 320x96 synthetic scene (one
sequence, and two sequences as lanes of the batched lockstep), for each
stage (the tracking LM and its cutoff pre-loop, the matcher's alignment,
the struct-pose LM, both windowed-BA loops and the LiDAR components
sweeps):

  * the chunked driver without capture, `k` in {1, 3, max_iters}, is bit
    for bit the early-exit loop;
  * one more iteration over rows that have all stopped changes no carry
    (the property the graphs rely on) and reads the flag false;
  * a whole run in chunks of 3 is bit for bit the run with early exits.

The card's test (graph replays against the eager loop) is in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from sdv_loam_tpu_torch.config import Settings
from sdv_loam_tpu_torch.data.synthetic import make_sequence
from sdv_loam_tpu_torch.ops import photometric
from sdv_loam_tpu_torch.system.full_system import FullSystem
from sdv_loam_tpu_torch.system.multi import MultiSystem
from sdv_loam_tpu_torch.utils import device_loop as dl

# one intra-op thread per test process (tests/test_torch_fleet_parity.py)
torch.set_num_threads(1)

N_FRAMES = 6
RECORD = (4, 5)            # frames whose loops are recorded (a keyframe)
STAGES = ("cutoff", "lm", "align", "struct", "ba0", "ba", "sweep")
# the second lane's scene differs from the first's in yaw only, so both
# take their keyframes in the same rounds and the BA runs as two lanes
LANE_SCENES = (dict(seed=0, yaw_rate=0.0), dict(seed=0, yaw_rate=0.003))


def _scene(**kw):
    return make_sequence(n_frames=N_FRAMES, w=320, h=96, lidar_stride=2,
                         **kw)


def _cutoff_record(lm):
    """A cutoff pre-loop over a recorded LM level's inputs: per-row base
    cutoffs low enough that the rows double 1-6 times, stopping at
    different iterations."""
    x = {k: v for k, v in lm["x"].items() if k != "cutoff"}
    T0, aff0 = lm["st"]["T"], lm["st"]["aff"]
    B = T0.shape[0]
    base = torch.tensor([0.3, 1.0, 3.0, 8.0], dtype=torch.float32)
    x.update(T0=T0, aff0=aff0, cutoff_base=base[torch.arange(B) % 4])
    r0 = photometric._level_res(x, T0, aff0, x["cutoff_base"], **lm["static"])
    st = dict({"r_" + k: v for k, v in r0.items()},
              rep=torch.ones(B, dtype=torch.float32))
    return dict(stage="cutoff", body=photometric._cutoff_body, x=x, st=st,
                max_iters=6, static=lm["static"], chunk=None)


def _first_per_stage(log, lanes):
    out = {}
    for rec in log:
        st = rec["st"]
        n = next(iter(st.values())).shape[0]
        # the lane form's LM rows are (lane, hypothesis) pairs: take a
        # record that holds rows of both lanes
        if lanes > 1 and rec["stage"] == "lm" and "lane" in rec["x"] and \
                int(rec["x"]["lane"].max()) < lanes - 1:
            continue
        if rec["stage"] in ("ba0", "ba", "sweep", "struct") and n != lanes:
            continue
        out.setdefault(rec["stage"], rec)
    out["cutoff"] = _cutoff_record(out["lm"])
    return out


@pytest.fixture(scope="module")
def records():
    """The first recorded loop of each stage, one lane and two lanes, and
    the trajectories of the one-lane run with early exits and in chunks of
    3."""
    seq = _scene()
    frames = [seq.get(i) for i in range(N_FRAMES)]
    out, trajs = {}, {}
    for k in (None, 3):
        fs = FullSystem(seq.calib, seq.sensor, Settings(), device="cpu")
        log = []
        ctx = dl.chunks(k) if k else dl.reference()
        with ctx:
            for i, fr in enumerate(frames):
                if i in RECORD and k is None:
                    with dl.recording(log):
                        fs.add_active_frame(*fr)
                else:
                    fs.add_active_frame(*fr)
        trajs[k] = (fs.get_trajectory(), len(fs.kf_shells))
        if k is None:
            out[1] = _first_per_stage(log, 1)
    seqs = [_scene(**kw) for kw in LANE_SCENES]
    fleet = MultiSystem([FullSystem(s.calib, s.sensor, Settings(),
                                    device="cpu") for s in seqs],
                        batch_track=True, host_workers=0)
    log = []
    for i in range(N_FRAMES):
        frs = [s.get(i) for s in seqs]
        if i in RECORD:
            with dl.recording(log):
                fleet.add_frames(frs)
        else:
            fleet.add_frames(frs)
    out[2] = _first_per_stage(log, 2)
    return dict(records=out, trajs=trajs)


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert dl.same_bits(a[k], b[k]), k


@pytest.mark.parametrize("k", [1, 3, "max_iters"])
@pytest.mark.parametrize("lanes", [1, 2])
@pytest.mark.parametrize("stage", STAGES)
def test_chunked_equals_early_exit(records, stage, lanes, k):
    rec = records["records"][lanes].get(stage)
    assert rec is not None, f"no {stage} loop with {lanes} lanes recorded"
    n = rec["max_iters"] if k == "max_iters" else k
    ref = dl.eager_loop(stage, rec["body"], rec["x"], rec["st"],
                        rec["max_iters"], rec["static"])
    got = dl.chunked_loop(stage, rec["body"], rec["x"], rec["st"],
                          rec["max_iters"], rec["static"], n)
    _same(got, ref)


def _stop_all(stage, st):
    """A carry with every row stopped, as the loop would leave it."""
    st = dict(st)
    if stage == "cutoff":
        st["rep"] = torch.full_like(st["rep"], 64.0)
    elif stage in ("lm", "struct"):
        st["done"] = torch.ones_like(st["done"])
    elif stage == "align":
        st["alive"] = torch.zeros_like(st["alive"])
    elif stage in ("ba0", "ba"):
        st["active"] = torch.zeros_like(st["active"])
    return st


@pytest.mark.parametrize("lanes", [1, 2])
@pytest.mark.parametrize("stage", STAGES)
def test_stopped_rows_are_frozen(records, stage, lanes):
    """One iteration over rows that have all stopped leaves every carry
    unchanged, bit for bit, and its flag reads false."""
    rec = records["records"][lanes][stage]
    max_iters = 24 if stage == "sweep" else rec["max_iters"]
    st = dl.eager_loop(stage, rec["body"], rec["x"], rec["st"], max_iters,
                       rec["static"])
    st = _stop_all(stage, st)
    nxt, act = rec["body"](rec["x"], st, **rec["static"])
    assert not bool(act)
    _same(nxt, st)


def test_whole_run_in_chunks_is_exact(records):
    """Six frames of one sequence with every loop in chunks of 3 (the
    card's form without capture) against the early-exit loops."""
    (t_ref, n_ref), (t_chk, n_chk) = records["trajs"][None], \
        records["trajs"][3]
    assert n_ref == n_chk >= 2
    np.testing.assert_array_equal(t_chk, t_ref)


def test_stats_count_reads_per_chunk():
    """The chunked driver reads the flag after each chunk but the last,
    and never past max_iters."""
    def body(x, st):
        c = st["c"] + (st["c"] < x["stop"]).to(torch.int64)
        return dict(c=c), (c < x["stop"]).any()
    x = dict(stop=torch.tensor([7]))
    for k, max_iters, want_c, want_reads in ((3, 20, 7, 3), (3, 5, 5, 1),
                                             (20, 20, 7, 0), (1, 7, 7, 6)):
        dl.reset_counts()
        st = dl.chunked_loop("t", body, x, dict(c=torch.tensor([0])),
                             max_iters, {}, k)
        assert int(st["c"]) == want_c
        assert dl.counts()["t"]["reads"] == want_reads, (k, max_iters)
