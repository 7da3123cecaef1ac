"""The port's fleets on CPU torch: InterleavedFleet and the lockstep
MultiSystem, against single-sequence runs of the port
(tests/test_torch_fleet_parity.py holds them against the JAX package).

Mirrors tests/test_multi.py (its two 320x96 scenes and settings). Systems
of a fleet share only the device, so every per-sequence result must be the
one the sequence gets alone; the batched track step folds the sequences
into lanes of one launch stream, and each lane must come out as its
unbatched run.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from sdv_loam_tpu_torch.config import Settings
from sdv_loam_tpu_torch.data.synthetic import make_sequence
from sdv_loam_tpu_torch.ops import distmap, photometric
from sdv_loam_tpu_torch.ops import hopper_kernels as hk
from sdv_loam_tpu_torch.system.full_system import FullSystem
from sdv_loam_tpu_torch.system.multi import InterleavedFleet, MultiSystem

# the port's CPU ops are small: one intra-op thread per test process
# keeps parallel test workers (xdist) from oversubscribing the cores,
# where OpenMP's spinning barriers slow every op down by orders of
# magnitude
torch.set_num_threads(1)

N_FRAMES = 8
SETTINGS = dict(desired_immature_density=600, desired_point_density=800,
                n_active_cap=2048, n_immature_cap=2048)


@pytest.fixture(scope="module")
def seqs():
    return [make_sequence(n_frames=N_FRAMES, w=320, h=96, step=0.8,
                          yaw_rate=yr, lidar_stride=2)
            for yr in (0.004, 0.012)]


@pytest.fixture(scope="module")
def frames(seqs):
    return [[seq.get(i) for i in range(N_FRAMES)] for seq in seqs]


def _systems(seqs, **kw):
    return [FullSystem(seq.calib, seq.sensor, Settings(**SETTINGS, **kw),
                       device="cpu") for seq in seqs]


def _single(seq, frames, **kw):
    fs = FullSystem(seq.calib, seq.sensor, Settings(**SETTINGS, **kw),
                    device="cpu")
    for f in frames:
        fs.add_active_frame(*f)
    return fs.get_trajectory()


def _lockstep(seqs, frames, **kw):
    ms = MultiSystem(_systems(seqs), **kw)
    for i in range(N_FRAMES):
        ms.add_frames([fr[i] for fr in frames])
    assert not ms.any_lost
    return [fs.get_trajectory() for fs in ms.systems]


@pytest.fixture(scope="module")
def singles(seqs, frames):
    return [_single(seq, fr) for seq, fr in zip(seqs, frames)]


@pytest.fixture(scope="module")
def batched_run(seqs, frames):
    """The batched lockstep over the two scenes, with every K1 and K2
    wrapper call recorded (kernel, lanes) per frame round, beside the
    systems that took a keyframe in that round."""
    calls, rounds = [], []
    wrapped = ((photometric, "dilate_pyramid", hk.dilate_pyramid),
               (distmap, "distance_transform", hk.distance_transform))

    def recorder(name, fn):
        def call(x, *a, **k):
            calls.append((name, 1 if x.dim() == 2 else x.shape[0]))
            return fn(x, *a, **k)
        return call
    for mod, name, fn in wrapped:
        setattr(mod, name, recorder(name, fn))
    try:
        ms = MultiSystem(_systems(seqs), batch_track=True, host_workers=0)
        for i in range(N_FRAMES):
            n0 = len(calls)
            ms.add_frames([fr[i] for fr in frames])
            rounds.append(([fs.shells[-1]["is_kf"] for fs in ms.systems],
                           calls[n0:]))
    finally:
        for mod, name, fn in wrapped:
            setattr(mod, name, fn)
    assert not ms.any_lost
    return [fs.get_trajectory() for fs in ms.systems], rounds, ms


@pytest.fixture(scope="module")
def lockstep_batched(batched_run):
    return batched_run[0]


def test_lockstep_matches_single(seqs, frames, singles):
    """Without batching the lockstep only interleaves the phases of the
    sequences: bit-identical to each sequence alone."""
    out = _lockstep(seqs, frames, batch_track=False, host_workers=0)
    for a, ref in zip(out, singles):
        np.testing.assert_array_equal(a, ref)


def test_batched_track_matches_unbatched(singles, lockstep_batched):
    """Pyramid, LiDAR and first track attempt, then trace, selection,
    activation and the keyframe optimization as lanes of one call each:
    each lane's loops stop on their own conditions (the windowed LM runs
    to the fleet's largest iteration count with stopped lanes frozen), so
    a lane comes out as its unbatched run (the JAX package's bound for its
    batched keyframe stages, tests/test_multi.py)."""
    for a, ref in zip(lockstep_batched, singles):
        np.testing.assert_allclose(a, ref, atol=1e-5)


def test_batched_keyframes_launch_each_kernel_once_per_round(batched_run):
    """Every frame round in which both systems take a keyframe calls K2
    (the activation's distance map) and K1 (the tracking reference) once,
    with both systems as its lanes; the only one-lane K1 calls are the
    first frames' references, one per system. Counted through the
    hopper_kernels wrappers."""
    _, rounds, ms = batched_run
    both_kf = 0
    for kfs, calls in rounds:
        batched = [c for c in calls if c[1] >= 2]
        if all(kfs):
            both_kf += 1
            assert sorted(batched) == [("dilate_pyramid", 2),
                                       ("distance_transform", 2)], calls
        else:
            assert not batched, calls
    assert both_kf >= 3
    one_lane = [c for _, calls in rounds for c in calls if c[1] == 1]
    assert one_lane == [("dilate_pyramid", 1)] * len(ms.systems)
    n_k1 = sum(c[0] == "dilate_pyramid" for _, calls in rounds
               for c in calls)
    assert n_k1 < sum(len(fs.kf_shells) for fs in ms.systems)
    for fs in ms.systems:
        st = fs.telemetry.stage_time
        for name in ("trace.batch", "kf.select.batch", "kf.activate.batch",
                     "kf.opt.batch"):
            assert st[name] > 0, name


def test_threaded_host_staging_matches_serial(seqs, frames,
                                              lockstep_batched):
    out = _lockstep(seqs, frames, batch_track=True, host_workers=2)
    for a, ref in zip(out, lockstep_batched):
        np.testing.assert_array_equal(a, ref)


def test_lockstep_ragged_lengths(seqs, frames):
    """Sequences of different lengths: finished ones pass None."""
    ms = MultiSystem(_systems(seqs), host_workers=0)
    for i in range(6):
        ms.add_frames([frames[0][i], frames[1][i] if i < 4 else None])
    assert len(ms.systems[0].shells) == 6
    assert len(ms.systems[1].shells) == 4
    assert not ms.any_lost


def test_lockstep_rejects_pipelined_systems(seqs):
    with pytest.raises(ValueError):
        MultiSystem(_systems(seqs, pipelined_frames=True))


def test_launch_counts_survive_threads():
    """A threaded fleet's systems share the kernels' launch counts: their
    read-modify-writes, interleaved as often as the interpreter allows,
    must lose no update."""
    n_threads, n_each = 16, 2000
    old = sys.getswitchinterval()
    hk.reset_launch_counts()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [
            hk._count_launch("dilate_pyramid") for _ in range(n_each)])
            for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert hk.LAUNCHES["dilate_pyramid"] == n_threads * n_each
    hk.reset_launch_counts()


@pytest.fixture(scope="module")
def pipelined_singles(seqs, frames):
    return [_single(seq, fr, pipelined_frames=True)
            for seq, fr in zip(seqs, frames)]


@pytest.mark.parametrize("workers", [0, 2])
def test_interleaved_matches_single(seqs, frames, pipelined_singles,
                                    workers):
    """B pipelined systems round-robined, serially or one thread each:
    bit-identical per sequence to each system alone."""
    fleet = InterleavedFleet(_systems(seqs, pipelined_frames=True),
                             workers=workers)
    for i in range(N_FRAMES):
        fleet.add_frames([fr[i] for fr in frames])
    fleet.flush()
    assert not fleet.any_lost
    for fs, ref in zip(fleet.systems, pipelined_singles):
        assert fs._pending is None
        np.testing.assert_array_equal(fs.get_trajectory(), ref)


def test_worker_pool_raises_when_a_thread_cannot_prepare(monkeypatch):
    """A worker thread whose library handles cannot be made on a card breaks
    the pool's start barrier: the pool raises that failure instead of the
    other threads waiting for it forever."""
    import types

    from sdv_loam_tpu_torch.system import multi
    from sdv_loam_tpu_torch.utils import device_loop

    def prepare(device):
        if threading.current_thread().name.endswith("_1"):
            raise RuntimeError("no handle on " + str(device))
    monkeypatch.setattr(device_loop, "prepare_thread", prepare)
    systems = [types.SimpleNamespace(device=torch.device("cuda", i))
               for i in range(2)]
    got = []

    def make():
        try:
            multi._worker_pool(3, systems)
        except Exception as e:     # noqa: BLE001 - the test reads it
            got.append(e)
    t = threading.Thread(target=make)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "the pool's start hung"
    assert len(got) == 1 and isinstance(got[0], RuntimeError), got
    assert "no handle" in str(got[0])
