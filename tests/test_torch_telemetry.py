"""The port's span recorder (`io/telemetry`) and the readback and copy
counters of `utils/device_loop`, on the CPU: spans and stages record into
`stage_time`, a stage's device wait is its own `wait.stage_end` span, a
span is a `stage:<name>` profiler annotation only while a profiler
records (one per batched call), per-frame span records go to the log, the
summary's fps counts from the first frame, and a small lockstep fleet's
`round.*` spans cover its rounds, with every readback counted."""

import json
import time

import numpy as np
import pytest
import torch

from sdv_loam_tpu_torch.config import Settings
from sdv_loam_tpu_torch.data.synthetic import make_sequence
from sdv_loam_tpu_torch.io import telemetry as tm
from sdv_loam_tpu_torch.io.telemetry import Telemetry, spans
from sdv_loam_tpu_torch.system.full_system import FullSystem
from sdv_loam_tpu_torch.system.multi import MultiSystem
from sdv_loam_tpu_torch.utils import device_loop as dl

# one intra-op thread per test process (see tests/test_torch_multi.py)
torch.set_num_threads(1)

ROUND_PHASES = ("round.pyramid", "round.stage", "round.lidar",
                "round.track_inputs", "round.track", "round.decide",
                "round.trace", "round.kf_insert", "round.select",
                "round.activate", "round.commit", "round.kf_request",
                "round.kf_opt")


def _annotations(prof, tmp_path):
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e["name"] for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and e["name"].startswith(tm.ANNOTATION)]


def test_span_and_stage_record_into_stage_time():
    t = Telemetry()
    with t.span("outer"):
        time.sleep(0.01)
        with t.stage("inner"):
            time.sleep(0.01)
    with t.stage("inner"):
        pass
    assert t.stage_count["outer"] == 1 and t.stage_count["inner"] == 2
    assert t.stage_time["outer"] >= 0.02
    assert t.stage_time["inner"] >= 0.01
    # the nested stage's time is the outer span's child time
    assert 0.01 <= t.child_time["outer"] <= t.stage_time["outer"]
    assert t._stack == []
    assert "wait.stage_end" not in t.stage_time   # no device_sync set


@pytest.mark.parametrize("sync", [False, True], ids=["span", "stage"])
def test_stage_end_wait_is_timed_apart(sync):
    """A stage's device wait at its exit is the span `wait.stage_end`,
    inside the stage's inclusive time; a span does not wait."""
    calls = []

    def device_sync():
        calls.append(1)
        time.sleep(0.03)
    t = Telemetry(device_sync=device_sync)
    with (t.stage if sync else t.span)("s"):
        time.sleep(0.01)
    if not sync:
        assert not calls and "wait.stage_end" not in t.stage_time
        return
    assert calls == [1]
    w = t.stage_time["wait.stage_end"]
    assert t.stage_count["wait.stage_end"] == 1 and w >= 0.03
    assert t.stage_time["s"] >= w + 0.01
    # the wait is the stage's wait time, not its child or host time
    assert t.wait_time["s"] == w and t.child_time.get("s", 0.0) == 0.0
    row = next(ln.split() for ln in t.stage_table().splitlines()
               if ln.startswith("s "))
    assert float(row[4]) == round(w, 2)


def test_batched_span_records_its_full_time_in_every_system():
    """`spans` over three systems' telemetries: one interval, recorded
    with its full time in each; a stage waits once, in the first."""
    waits = []
    tels = [Telemetry(device_sync=lambda i=i: waits.append(i))
            for i in range(3)]
    with spans(tels, "kf.opt.batch", sync=True):
        time.sleep(0.01)
    assert waits == [0]
    times = {t.stage_time["kf.opt.batch"] for t in tels}
    assert len(times) == 1 and times.pop() >= 0.01
    assert tels[0].stage_count["wait.stage_end"] == 1
    assert "wait.stage_end" not in tels[1].stage_time
    assert all(t._stack == [] for t in tels)


def test_annotations_under_the_profiler(tmp_path):
    """Under `torch.profiler.profile` on the CPU every span is one
    `stage:<name>` user annotation, a batched span one for all its
    systems; a wait nests in its stage."""
    from torch.profiler import ProfilerActivity, profile

    tels = [Telemetry(device_sync=lambda: None) for _ in range(4)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans(tels, "round.trace"):
            with spans(tels[1:], "trace.batch", sync=True):
                torch.ones(4).sum()
            with tels[0].span("host.trace_result"):
                pass
    names = _annotations(prof, tmp_path)
    assert sorted(names) == sorted(
        ["stage:round.trace", "stage:trace.batch", "stage:wait.stage_end",
         "stage:host.trace_result"]), names


def test_no_record_function_without_a_profiler(monkeypatch, tmp_path):
    """With no profiler recording, a span never calls `record_function`;
    while one records, it does (counted by a wrapper)."""
    from torch.profiler import ProfilerActivity, profile

    made = []
    real = torch.profiler.record_function

    def counting(name):
        made.append(name)
        return real(name)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    t = Telemetry(device_sync=lambda: None)
    for _ in range(10):
        with t.stage("track"), t.span("host.stack"):
            pass
    with spans([t, Telemetry()], "round.pyramid"):
        pass
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]):
        with t.stage("track"):
            pass
    assert made == ["stage:track", "stage:wait.stage_end"]


def test_span_records_in_the_log(tmp_path):
    """With a log path every span is one JSONL record (name, parent,
    the frame's shell id, start and end); without one nothing is kept."""
    log = tmp_path / "log.jsonl"
    t = Telemetry(log_path=str(log), device_sync=lambda: None)
    t.frame_id = 7
    with t.stage("kf.opt"), t.span("host.kf_opt_result"):
        pass
    t.close()
    recs = [json.loads(x) for x in open(log)]
    assert [r["kind"] for r in recs] == ["span"] * 3
    by = {r["name"]: r for r in recs}
    assert set(by) == {"kf.opt", "host.kf_opt_result", "wait.stage_end"}
    assert by["host.kf_opt_result"]["parent"] == "kf.opt"
    assert by["wait.stage_end"]["parent"] == "kf.opt"
    assert by["kf.opt"]["parent"] is None
    assert all(r["frame"] == 7 and r["start"] <= r["end"] for r in recs)
    assert by["kf.opt"]["start"] <= by["host.kf_opt_result"]["start"]
    assert by["wait.stage_end"]["end"] <= by["kf.opt"]["end"]
    quiet = Telemetry()
    with quiet.span("x"):
        pass
    assert quiet._log_f is None


def test_summary_counts_from_the_first_frame():
    """fps and ms/frame over the frames after the first: time before the
    first `frame_done` (set-up, the first frame) stays out."""
    t = Telemetry()
    time.sleep(0.3)
    for _ in range(5):
        t.frame_done(False)
        time.sleep(0.01)
    s = t.summary()
    run = t.t_last - t.t_first
    assert s["frames"] == 5 and s["fps"] == round(4 / run, 2)
    assert s["ms_per_frame"] == round(1000.0 * run / 4, 2)
    assert s["fps"] > 20 and s["wall_s"] >= 0.3
    assert "sync_ms" not in s and "sync_count" not in s
    assert Telemetry().summary()["fps"] == 0.0


def test_fetch_counts_readbacks():
    dl.reset_counts()
    x = torch.arange(6.0).reshape(2, 3)
    np.testing.assert_array_equal(dl.fetch(x), x.numpy())

    class Event:
        waited = 0

        def synchronize(self):
            Event.waited += 1
    assert dl.fetch(Event()) is None and Event.waited == 1
    assert dl.counts()["readback"]["fetches"] == 2
    assert dl.counts()["all"]["fetches"] == 2


N_FRAMES = 5


@pytest.fixture(scope="module")
def lockstep_rounds():
    """Two 320x96 lanes in a batched lockstep on the CPU: each round's
    wall time beside the `round.*` spans it added to the first system's
    table, and every `Tensor.cpu` call counted beside the fetches."""
    seqs = [make_sequence(n_frames=N_FRAMES, w=320, h=96, step=0.8,
                          yaw_rate=yr, lidar_stride=2)
            for yr in (0.004, 0.012)]
    s = Settings(desired_immature_density=600, desired_point_density=800,
                 n_active_cap=2048, n_immature_cap=2048)
    ms = MultiSystem([FullSystem(q.calib, q.sensor, s, device="cpu")
                      for q in seqs], batch_track=True, host_workers=0)
    frames = [[q.get(i) for i in range(N_FRAMES)] for q in seqs]
    real_cpu = torch.Tensor.cpu
    cpu_calls = [0]

    def cpu(self, *a, **k):
        cpu_calls[0] += 1
        return real_cpu(self, *a, **k)
    def spanned():
        return sum(v for k, v in ms.systems[0].telemetry.stage_time.items()
                   if k.startswith("round."))
    rounds, kf_rounds = [], []
    dl.reset_counts()
    torch.Tensor.cpu = cpu
    try:
        for i in range(N_FRAMES):
            s0, t0 = spanned(), time.perf_counter()
            ms.add_frames([fr[i] for fr in frames])
            rounds.append((time.perf_counter() - t0, spanned() - s0))
            kf_rounds.append(any(fs.shells[-1]["is_kf"]
                                 for fs in ms.systems))
    finally:
        torch.Tensor.cpu = real_cpu
    assert not ms.any_lost
    return ms, rounds, kf_rounds, cpu_calls[0], dl.counts()


def test_round_spans_cover_the_round(lockstep_rounds):
    """The `round.*` spans of a lockstep fleet partition its rounds: their
    sum is within 10 % of each round's wall time, and each phase is
    recorded with the same time in every system."""
    ms, rounds, kf_rounds, _, _ = lockstep_rounds
    assert any(kf_rounds[2:]), "no keyframe round past the first frames"
    tables = [fs.telemetry.stage_time for fs in ms.systems]
    for name in ROUND_PHASES:
        assert tables[0][name] > 0, name
        assert all(t[name] == tables[0][name] for t in tables), name
    for wall, spanned in rounds:
        assert abs(spanned - wall) <= 0.1 * wall, rounds
    # host steps and waits are spans of their own, no new `kf.*` names
    for name in ("host.stack", "wait.readback", "wait.upload"):
        assert tables[0][name] > 0, name
    names = set().union(*tables)
    assert not {n for n in names if n.startswith("kf.")} - {
        "kf.select", "kf.select.batch", "kf.activate", "kf.activate.batch",
        "kf.opt", "kf.opt.batch"}
    assert all(fs.telemetry._stack == [] for fs in ms.systems)


def test_fetches_count_every_readback(lockstep_rounds):
    """Every host readback of the rounds went through `device_loop.fetch`:
    as many fetches as `Tensor.cpu` calls, and as many as the systems'
    `wait.readback` spans."""
    ms, _, _, cpu_calls, counts = lockstep_rounds
    fetches = counts["all"]["fetches"]
    spans_ = sum(fs.telemetry.stage_count["wait.readback"]
                 for fs in ms.systems)
    assert fetches > 0 and fetches == cpu_calls == spans_, \
        (fetches, cpu_calls, spans_)
