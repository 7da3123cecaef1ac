"""Device-resident stages: the JAX package's compiled stage programs and
their `lax.while_loop`s as CUDA graphs.

Loops (`run`). Each iterated stage of the JAX package (the tracking LM and
its cutoff pre-loop, the feature alignment, the struct-pose LM, the
windowed BA, the LiDAR components fixpoint and the camera-only
bootstrap's level LM) is a loop on the device. The port runs the same
loops through `run`:

* a *body* is a function `body(x, st, **static) -> (st, active)`: `x` is a
  dict of input tensors that stay fixed over the loop, `st` the dict of
  carry tensors (the body returns the same keys, shapes and dtypes), and
  `active` a device bool, whether any row is still running. `static` holds
  the hashable Python arguments (shapes, flags, thresholds) the body's
  launches depend on.
* Every body freezes the rows that have stopped, so an iteration over rows
  that have all stopped changes no carry, bit for bit (tests hold this).
  Running `k` iterations and then testing therefore gives what the
  early-exit loop gives, which is also how the JAX package's vmapped
  `while_loop` runs rows that stopped before the fleet's last one.
* Outside a stage program, CPU tensors take `eager_loop` (the early-exit
  loop: one host read of `active` per iteration) and CUDA tensors
  `graph_loop`: `k` unrolled iterations captured once per shape as a
  `torch.cuda.CUDAGraph` (`capture_error_mode="thread_local"`, so systems
  on other threads keep running) and replayed until `active` reads false
  or `max_iters` iterations have run, the flag read once per chunk (not
  after the last; a shorter tail has a graph of its own). Inputs and
  carries live in static buffers in the strides the eager loop sees at
  each iteration (see `_Entry`): cuBLAS picks its kernels from the
  strides, and another kernel rounds otherwise.

Stage programs (`program`). The JAX package compiles each stage into one
program. `program(stage, fn, inputs, static)` is its counterpart for every
per-frame stage: the pyramid ("pyramid"), the track step ("track"), the
LiDAR preprocessing ("lidar"), the trace ("trace"), a selection attempt
("select"), the activation ("activate"), the keyframe optimization
("kf_opt"), and the camera-only bootstrap's status-map selection attempt
("select_map") and level LM ("mono_lm"). On
CUDA, `fn(inputs, **static)` is captured whole as one CUDA graph per key
(stage, function, the inputs' structure, shapes, strides and dtypes,
device, `static`); a call copies its inputs into the graph's static
buffers (in the caller's strides), replays, and clones the outputs out.
Inside a capture:

* `run` records a loop's first iteration, then a CUDA conditional WHILE
  node (csrc/graph_cond.cu) whose body is one iteration (`PROGRAM_CHUNK`)
  and passes again while the flag it wrote holds and the cap is not
  reached: the early-exit loop bit for bit, decided on the device;
* `cond(stage, pred, fn, carries)` is an IF node on `pred` whose body's
  outputs are copied into the results (laid out like `carries`), where
  the stage form reads `pred` on the host.

The process's first call of a stage runs `fn` eagerly (early-exit loops
and host reads: the same values), which loads the kernels' modules and
touches every lazily made constant, and returns its results (cloned as a
replay's outputs are, so they come out in one layout); the capture
follows in the same call (a cache first makes its threads' library handles
on its streams), and a failed capture raises. A later new key (another
shape, or another system's cache) captures at its first call and
replays. Conditional bodies run on the cache's body streams (one per
nesting depth) and allocate from the cache's body pool. A Hopper kernel
captured in a program counts one launch per replay
(`ops/hopper_kernels`), and none of those may sit in a conditional body
(K3-K8, which count themselves on the card, may). On the
CPU `fn` runs in the stage form (early-exit loops, host reads), or under
`programs()` in the *trace form* a capture records: every loop to its
cap, every `cond` computed and selected (the same values, since rows
freeze), no host read.

Graphs live in a `LoopCache`. A `FullSystem` (and a `MultiSystem`) owns
one and makes it current with `use` around its work (`_on_stream`), so
two systems never replay one graph at once, and the cache goes with the
system; outside a system each thread has a cache of its own. The graphs of
one cache share one memory pool: what a graph allocates and frees is
reused by the next capture, and one cache's replays never overlap.
Captures take turns, and Python's automatic garbage collection is paused
during one (a collection could free another system's graphs
mid-capture).

There is no switch away from programs or graph loops on CUDA on the main
path: `stage_form` (the stages called directly: loops as chunk replays,
conds as host reads), `reference` (eager loops on every device) and
`chunks` (the chunk size, and on the CPU the chunked driver without
capture) exist for the comparisons of `chip_smoke.py` and the tests.
`STATS` counts, per stage, captures and their seconds, replays, host reads
of a stop flag, and (eager loops) the iterations run; per program also
instantiate seconds, the ops its capture recorded (graph nodes), the graph
pools' growth (MiB), warm-up calls, and each replay's device copies of its
inputs into the static buffers and of its outputs out of the graph's pool
(`copies`). `fetch` is the host's one readback path: its count is
`fetches` under "readback". While the autograd profiler records, a
program's eager warm-up, its capture and its replays are profiler
annotations (`io/telemetry.annotation`): `stage:program.warmup`,
`stage:program.capture`, and `stage:program.replay` around its steps
`stage:program.inputs`, `stage:program.launch` and `stage:program.outputs`.
Inside `program_timing()` (a profile window, eval/profile) a pair of CUDA
events brackets every program replay, read once at the window's end: each
program's device time.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import threading
import time

import numpy as np
import torch

from sdv_loam_tpu_torch.io.telemetry import annotation, end_annotation

# Chunk sizes (iterations per replay). A replay costs one host launch and
# one read of the stop flag; an iteration over stopped rows costs its
# device time for nothing. The choice follows the iterations the early-exit
# loops ran on 12 frames of the default-preset slice (1200x360, scene A;
# the port on the CPU with `HIST`, the same code the card runs):
#   lm       the pyramid levels stop after 1-7 iterations, 3 most often
#            (15 of 43 calls): one replay and one read then. The coarsest
#            level's hypothesis batch runs to its cap of 10 on every frame,
#            so its caller asks for one chunk of 10 and no read;
#   cutoff   the cutoff-doubling pre-loop (<= 6 doublings) never ran there:
#            a host read says whether any row needs it;
#   align    the matcher's alignment: some candidate runs to the cap of 10
#            on 23 of 38 calls; an iteration is a few small kernels, so one
#            replay runs all 10 and no flag is read (the CPU's loop: on
#            the card the whole alignment is one K5 launch, no loop);
#   struct   the struct-pose LM (cap 10): 8-10 iterations on 7 of 11 calls:
#            one replay of 10;
#   ba0/ba   the windowed BA (cap 6): the first two iterations (no
#            nullspace projection) are one replay; the rest ran 1-3 more
#            iterations, one per replay: a BA iteration is the heaviest
#            body, and an extra one costs more device time than a read;
#   sweep    the LiDAR components: 2 sweeps on every scan (the fixpoint,
#            then one that sees no change): one replay, one read;
#   splat    the tracking reference's splat rounds (round r adds the r-th
#            point of every pixel): outside the keyframe program only the
#            first frame's runs here; every splat chip_smoke.py compares
#            at 1200x360 ended within one replay of 4 rounds;
#   mono     the camera-only bootstrap's level LM (caps 5, 5, 10, 30, 50,
#            fine to coarse), outside its program only in the stage form.
#            On the 320x96 camera-only scene (three levels, 21 calls over
#            its 7 bootstrap frames) the two fine levels ran to their cap
#            of 5 on every call and the coarsest stopped after 6-10: one
#            replay of 5 covers a fine level with no read, the coarsest
#            takes one or two.
# The fast preset's counts (424x320, bench.py's scene A, frames 0-14, the
# early-exit loops on an H100; chip_smoke.py phase 8): lm 4-6 iterations
# on 38 of 70 calls and 10 or more on 21; align at its cap of 10 on 33 of
# 48; struct at its cap on 12 of 14; ba0 2 on all 7; ba 2 on 6 of 7;
# sweep 2 on all 15; splat 1-2. The chunks are not retuned for it.
CHUNK = {"lm": 3, "cutoff": 2, "align": 10, "struct": 10, "ba0": 2, "ba": 1,
         "sweep": 2, "splat": 4, "mono": 5}

# Inside a stage program a loop's chunk is one iteration: a pass of its
# WHILE node costs a few small device copies and no host read, so a longer
# chunk would only add iterations over stopped rows, and ops to the
# capture (it records the first chunk, one chunk as the WHILE body and the
# shorter last chunk).
PROGRAM_CHUNK = 1

STATS: dict = {}
# the stages that have run through `program`
PROGRAMS: set = set()
# (stage, start event, end event) of each program replay while
# `program_timing` is open, else None
_TIMED: list | None = None
# eager loops: how many calls of each stage ran n iterations
HIST: dict = {}
_lock = threading.Lock()
# one capture at a time in the process (captures are few; a capture
# running beside another thread's capture is not one this driver needs)
_capture_lock = threading.Lock()
_tls = threading.local()


def _count(stage, **kw):
    with _lock:
        st = STATS.setdefault(stage, dict(captures=0, capture_s=0.0,
                                          replays=0, reads=0, calls=0,
                                          iters=0))
        for k in kw:
            st.setdefault(k, 0)
        for k, v in kw.items():
            st[k] += v


def reset_counts() -> None:
    with _lock:
        STATS.clear()
        HIST.clear()


def counts() -> dict:
    """A copy of `STATS`, plus the totals over stages under "all" and over
    the stage programs under "programs"."""
    with _lock:
        out = {k: dict(v) for k, v in STATS.items()}
        progs = set(PROGRAMS)
    tot, ptot = {}, {}
    for name, v in out.items():
        for k, x in v.items():
            tot[k] = tot.get(k, 0) + x
            if name in progs:
                ptot[k] = ptot.get(k, 0) + x
    out["all"] = tot
    out["programs"] = ptot
    return out


class LoopCache:
    """The captured graphs of one system: entries by key, one capture
    stream and one memory pool (made at the first capture); for the stage
    programs also the IF bodies' streams (one per nesting depth) and
    memory pool."""

    def __init__(self):
        self.entries: dict = {}
        self.stream = None
        self.pool = None
        self.body_streams: list = []
        self.body_pool = None
        self.prepared: set = set()     # threads whose handles are made

    def __len__(self):
        return sum(len(e.graphs) for e in self.entries.values())


@contextlib.contextmanager
def use(cache: LoopCache):
    """Make `cache` the current thread's graph cache."""
    prev = getattr(_tls, "cache", None)
    _tls.cache = cache
    try:
        yield cache
    finally:
        _tls.cache = prev


def current_cache() -> LoopCache:
    c = getattr(_tls, "cache", None)
    if c is None:
        c = getattr(_tls, "default", None)
        if c is None:
            c = _tls.default = LoopCache()
    return c


@contextlib.contextmanager
def stage_form():
    """The stage form: `program` calls its function directly,
    loops replay their chunk graphs on CUDA with a host read per chunk,
    `cond` reads its predicate on the host (the comparisons' form: never
    the main path)."""
    prev = getattr(_tls, "mode", None)
    _tls.mode = "stage"
    try:
        yield
    finally:
        _tls.mode = prev


@contextlib.contextmanager
def programs():
    """`program` as a program on every device: on CUDA the default (a
    captured graph); on the CPU the trace form (every loop to its cap,
    every `cond` computed and selected, no host read)."""
    prev = getattr(_tls, "mode", None)
    _tls.mode = "program"
    try:
        yield
    finally:
        _tls.mode = prev


@contextlib.contextmanager
def reference():
    """Eager early-exit loops on every device (the comparisons' reference:
    never the main path)."""
    prev = getattr(_tls, "mode", None)
    _tls.mode = "reference"
    try:
        yield
    finally:
        _tls.mode = prev


@contextlib.contextmanager
def chunks(k):
    """Every stage's chunk size `k` (an int, or None for the stage's
    `max_iters`); on the CPU the loops then run the chunked driver
    without capture (the tests' form of the graph path)."""
    prev = getattr(_tls, "mode", None), getattr(_tls, "chunk", None)
    _tls.mode, _tls.chunk = "chunked", k
    try:
        yield
    finally:
        _tls.mode, _tls.chunk = prev


@contextlib.contextmanager
def recording(log: list, programs: bool = False):
    """Append every loop this thread runs outside a stage program to `log`
    as a dict (stage, body, x, st: clones of the inputs and initial
    carries, max_iters, static, chunk), for `compare`; with `programs`,
    every stage program instead, as a dict (kind "program", stage, fn,
    static, spec, leaves: clones of the inputs), for `compare_program`."""
    key = "plog" if programs else "log"
    prev = getattr(_tls, key, None)
    setattr(_tls, key, log)
    try:
        yield log
    finally:
        setattr(_tls, key, prev)


@contextlib.contextmanager
def program_timing():
    """Time every stage program's replay (any thread) on the device while
    open: a CUDA event pair on the replay's stream around it. Yields a dict
    that holds, after the block, {stage: dict(ms, replays)}: the replays'
    summed device ms (event to event) and their count. The events are read
    once, at the end, after a synchronize; outside the block nothing is
    recorded."""
    global _TIMED
    log, res = [], {}
    prev, _TIMED = _TIMED, log
    try:
        yield res
    finally:
        _TIMED = prev
        if log:
            torch.cuda.synchronize()
        for stage, a, b in log:
            d = res.setdefault(stage, dict(ms=0.0, replays=0))
            d["ms"] += a.elapsed_time(b)
            d["replays"] += 1


def read(stage: str, flag) -> bool:
    """A counted host read of a device flag outside a loop."""
    _count(stage, reads=1)
    return bool(flag)


def fetch(x):
    """The host's counted readback (`fetches` under "readback" in `STATS`):
    a tensor's values as a numpy array, once the work queued before it is
    done; or the wait for an event that ends earlier asynchronous copies
    (returns None)."""
    _count("readback", fetches=1)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    x.synchronize()


def _inner():
    """How `run` and `cond` behave inside a stage program: "capture",
    "trace", or None outside one."""
    return getattr(_tls, "inner", None)


@contextlib.contextmanager
def _inner_form(form):
    prev = getattr(_tls, "inner", None)
    _tls.inner = form
    try:
        yield
    finally:
        _tls.inner = prev


def cond(stage: str, pred, fn, carries: dict) -> dict:
    """`fn(carries)` where `pred` (a device bool) holds, else `carries`:
    a host read of `pred` in the stage form, an IF node in a captured
    program, `fn` computed and selected with `torch.where` in the trace
    form. `fn` returns the keys, shapes, dtypes and strides of
    `carries`."""
    form = _inner()
    if form is None:
        return fn(carries) if read(stage, pred) else carries
    if form == "trace":
        out = fn(carries)
        _check_like(stage, out, carries)
        return {k: torch.where(pred, out[k], v) for k, v in carries.items()}
    res = {k: v.clone() for k, v in carries.items()}
    with _cond_node(pred):
        out = fn(carries)
        _check_like(stage, out, carries)
        for k, v in out.items():
            res[k].copy_(v)
    return res


def _check_like(stage, out, carries):
    for k, v in carries.items():
        o = out[k]
        if (o.shape, o.dtype) != (v.shape, v.dtype) or \
                (o.numel() > 1 and o.stride() != v.stride()):
            raise RuntimeError(f"{stage} cond: output {k} differs from its "
                               "carry in shape, dtype or strides")


_CONSTANTS: dict = {}


def full_device(device) -> torch.device:
    """`device` by ordinal: "cuda" is the CUDA device current now."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def constant(values, device, dtype=torch.float32):
    """`values` (host numbers, nested lists or an array) as a `dtype`
    tensor on `device`, made once per values, dtype and device and shared
    by every caller (none writes to it): nothing is uploaded inside a
    stage program."""
    a = np.asarray(values)
    device = full_device(device)
    key = (a.dtype.str, a.shape, a.tobytes(), dtype, str(device))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.as_tensor(a, dtype=dtype, device=device)
    return t


# one thread at a time prepares: the process's first linear-algebra call
# on CUDA loads torch's linalg library, and two threads doing so at once
# fail ("lazy wrapper should be called at most once")
_prepare_lock = threading.Lock()


def prepare_thread(device) -> None:
    """Make this thread's cuBLAS, cuBLASLt and cuSOLVER handles (a small
    product, a one-matrix solve and a batched one). A thread that makes
    its first handle while another thread captures breaks that capture, so
    the fleets start their worker threads with this (handles are made per
    thread and device)."""
    with _prepare_lock, torch.cuda.device(device):
        a = torch.eye(8, device=device) * 2.0
        b = torch.ones(8, device=device)
        torch.addmm(a, a, a)
        torch.linalg.solve_ex(a, b)
        torch.linalg.solve_ex(a.expand(2, 8, 8), b.expand(2, 8))
        torch.cuda.current_stream(device).synchronize()


def _overlapping(t) -> bool:
    """Whether two elements of `t` share memory (an expanded view)."""
    reach = 0
    for stride, size in sorted((st, n) for st, n in zip(t.stride(), t.shape)
                               if n > 1):
        if stride <= reach:
            return True
        reach += (size - 1) * stride
    return False


def _own_memory(d):
    """Expanded views materialized (a static buffer cannot hold one);
    every other layout is kept, on every path: the library kernels a body
    launches (cuBLAS's transposes, gemv variants) follow the strides."""
    return {k: (v.contiguous() if _overlapping(v) else v)
            for k, v in d.items()}


def run(stage: str, body, x: dict, st: dict, max_iters: int,
        static: dict | None = None, chunk: int | None = None):
    """Run `body` until no row is active or `max_iters` iterations have
    run; returns the final carries. `chunk` defaults to `CHUNK[stage]`."""
    static = static or {}
    max_iters = int(max_iters)
    if max_iters <= 0:
        return st
    x, st = _own_memory(x), _own_memory(st)
    form = _inner()
    if form == "trace":
        return trace_loop(stage, body, x, st, max_iters, static)
    if form == "capture":
        return captured_loop(stage, body, x, st, max_iters, static,
                             PROGRAM_CHUNK)
    log = getattr(_tls, "log", None)
    if log is not None:
        log.append(dict(stage=stage, body=body, max_iters=max_iters,
                        static=dict(static), chunk=chunk,
                        x={k: v.clone() for k, v in x.items()},
                        st={k: v.clone() for k, v in st.items()}))
    mode = getattr(_tls, "mode", None)
    k = CHUNK[stage] if chunk is None else chunk
    if mode == "chunked":
        k = getattr(_tls, "chunk", None) or max_iters
    k = max(1, min(int(k), max_iters))
    on_card = next(iter(st.values())).device.type == "cuda"
    if mode == "reference":
        return eager_loop(stage, body, x, st, max_iters, static)
    if on_card:
        return graph_loop(stage, body, x, st, max_iters, static, k)
    if mode == "chunked":
        return chunked_loop(stage, body, x, st, max_iters, static, k)
    return eager_loop(stage, body, x, st, max_iters, static)


def trace_loop(stage, body, x, st, max_iters, static):
    """The trace form: `max_iters` iterations, no read (rows that stopped
    are frozen, so this is the early-exit loop's result)."""
    for _ in range(max_iters):
        st, _ = body(x, st, **static)
    return st


def captured_loop(stage, body, x, st, max_iters, static, k):
    """A loop inside a capture, as the chunked driver runs it: the first
    chunk of `k` iterations unconditionally, then a WHILE node whose body
    is one chunk (it passes again while the chunk's flag holds and fewer
    than the full chunks have run), then the shorter last chunk in an IF
    node on the flag. The carries after the first chunk live in buffers in
    the body's output strides, as the eager loop's later iterations see
    them."""
    n0 = min(k, max_iters)
    act = None
    for _ in range(n0):
        st, act = body(x, st, **static)
    buf = {name: _empty(v) for name, v in st.items()}
    for name, v in st.items():
        buf[name].copy_(v)
    flag = act.reshape(()).clone()
    n_full, tail = divmod(max_iters - n0, k)

    def chunk(n):
        cur, a = buf, None
        for _ in range(n):
            cur, a = body(x, cur, **static)
        for name, v in cur.items():
            if v.stride() != buf[name].stride() and v.numel() > 1:
                raise RuntimeError(f"{stage} loop: carry {name} changes "
                                   "strides between iterations")
            buf[name].copy_(v)
        flag.copy_(a.reshape(()))

    if n_full:
        passes = torch.zeros((), dtype=torch.int32, device=flag.device)
        go = flag.clone()
        with _cond_node(go, loop=True):
            chunk(k)
            passes.add_(1)
            torch.logical_and(flag, passes < n_full, out=go)
    if tail:
        with _cond_node(flag):
            chunk(tail)
    return buf


def eager_loop(stage, body, x, st, max_iters, static):
    """The early-exit loop: one host read of the flag after every
    iteration but the last allowed one."""
    n = 0
    for i in range(max_iters):
        st, act = body(x, st, **static)
        n += 1
        if i + 1 < max_iters:
            _count(stage, reads=1)
            if not bool(act):
                break
    _count(stage, calls=1, iters=n)
    with _lock:
        h = HIST.setdefault(stage, {})
        h[n] = h.get(n, 0) + 1
    return st


def _drive(stage, run_chunk, max_iters, k):
    """The chunked driver: chunks of `k` iterations (the last one shorter
    so none runs past `max_iters`), the flag read after each chunk but the
    last."""
    done = 0
    while True:
        n = min(k, max_iters - done)
        act = run_chunk(n)
        done += n
        if done >= max_iters:
            return
        _count(stage, reads=1)
        if not bool(act):
            return


def chunked_loop(stage, body, x, st, max_iters, static, k):
    """The graph path's driver with each chunk run eagerly (no capture)."""
    box = [st]

    def run_chunk(n):
        act = None
        for _ in range(n):
            box[0], act = body(x, box[0], **static)
        return act
    _drive(stage, run_chunk, max_iters, k)
    _count(stage, calls=1)
    return box[0]


def _layout(d):
    return tuple((k, tuple(v.shape), v.stride(), v.dtype)
                 for k, v in sorted(d.items()))


def _empty(v, stride=None):
    return torch.empty_strided(v.shape, v.stride() if stride is None
                               else stride, dtype=v.dtype, device=v.device)


class _Entry:
    """Static buffers of one loop key and its graphs by (phase, chunk
    length). A body's outputs may come in other strides than its first
    carries (a `torch.where` of transposed operands stays transposed),
    and the eager loop's later iterations run on those strides. So the
    carries have two buffer sets: `st0` in the first carries' strides,
    read by the first chunk only, and `st1` in the body's output strides,
    which every chunk writes and the later chunks read (one set when the
    two agree)."""

    def __init__(self, x, st, out_strides):
        self.x = {k: _empty(v) for k, v in x.items()}
        self.st1 = {k: _empty(v, out_strides[k]) for k, v in st.items()}
        same = all(st[k].stride() == out_strides[k] for k in st)
        self.st0 = self.st1 if same else {k: _empty(v) for k, v in st.items()}
        dev = next(iter(st.values())).device
        self.flag = torch.zeros((), dtype=torch.bool, device=dev)
        self.graphs: dict = {}
        self.stream = None         # the stream of the last call


def _side_stream(cache, dev):
    """The cache's capture stream (made on `dev` at its first capture). A
    cache holds one device's graphs: a capture for another device
    raises."""
    if cache.stream is None:
        cache.stream = torch.cuda.Stream(dev)
        cache.pool = torch.cuda.graph_pool_handle()
    elif cache.stream.device != dev:
        raise RuntimeError(f"a LoopCache of {cache.stream.device} asked to "
                           f"capture on {dev}: give each device a cache of "
                           "its own (device_loop.use)")
    return cache.stream


def _new_entry(cache, stage, body, x, st, static):
    """Two iterations on copies, on the capture stream: library handles
    and per-stream workspaces are made outside any capture, and they tell
    the body's output strides, which must settle after one iteration."""
    dev = next(iter(st.values())).device
    cur = torch.cuda.current_stream(dev)
    side = _side_stream(cache, dev)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out1, _ = body(x, {k: v.clone() for k, v in st.items()}, **static)
        out2, _ = body(x, out1, **static)
    cur.wait_stream(side)
    for k, v in st.items():
        if (out1[k].shape, out1[k].dtype) != (v.shape, v.dtype) or \
                out1[k].stride() != out2[k].stride():
            raise RuntimeError(f"{stage} loop: carry {k} changes shape, "
                               "dtype or strides between iterations")
    return _Entry(x, st, {k: v.stride() for k, v in out1.items()})


@contextlib.contextmanager
def _collector_paused():
    """Python's automatic cyclic collection off: a collection inside a
    capture can free a dead system's graphs, and destroying a graph while
    this thread captures invalidates the capture."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def _capture(cache, stage, body, e, n, static, first):
    """Capture `n` iterations of `body` over `e`'s static buffers (from
    `st0` for the first chunk, else `st1`), the final carries and flag
    written back into `st1` and `flag`."""
    dev = e.flag.device
    cur = torch.cuda.current_stream(dev)
    side = _side_stream(cache, dev)
    side.wait_stream(cur)
    t0 = time.perf_counter()
    with _capture_lock, _collector_paused(), torch.cuda.stream(side):
        g = torch.cuda.CUDAGraph()
        g.capture_begin(pool=cache.pool, capture_error_mode="thread_local")
        try:
            st, act = (e.st0 if first else e.st1), None
            for _ in range(n):
                st, act = body(e.x, st, **static)
            for k, v in st.items():
                if v is not e.st1[k]:
                    e.st1[k].copy_(v)
            e.flag.copy_(act)
        except BaseException:
            with contextlib.suppress(Exception):
                g.capture_end()
            raise
        g.capture_end()
    cur.wait_stream(side)
    _count(stage, captures=1, capture_s=time.perf_counter() - t0)
    return g


def graph_loop(stage, body, x, st, max_iters, static, k):
    """The CUDA path: chunks of `k` iterations as graph replays on the
    current stream."""
    cache = current_cache()
    dev = next(iter(st.values())).device
    key = (stage, body, _layout(x), _layout(st), str(dev),
           tuple(sorted(static.items())))
    e = cache.entries.get(key)
    if e is None:
        e = cache.entries[key] = _new_entry(cache, stage, body, x, st,
                                            static)
    cur = torch.cuda.current_stream(dev)
    if e.stream is not None and e.stream != cur:
        cur.wait_stream(e.stream)      # the last call's replays and clones
    e.stream = cur
    for name, v in x.items():
        e.x[name].copy_(v)
    for name, v in st.items():
        e.st0[name].copy_(v)
    first = [e.st0 is not e.st1]

    def run_chunk(n):
        key = (first[0], n)
        first[0] = False
        g = e.graphs.get(key)
        if g is None:
            g = e.graphs[key] = _capture(cache, stage, body, e, n, static,
                                         key[0])
        g.replay()
        _count(stage, replays=1)
        return e.flag
    _drive(stage, run_chunk, max_iters, k)
    _count(stage, calls=1)
    return {name: v.clone() for name, v in e.st1.items()}


# ---------------------------------------------------------------------------
# stage programs
# ---------------------------------------------------------------------------

# conditional-node nesting the body streams allow (a track program nests
# three deep: the level repeat, the cutoff pre-loop, its later chunks)
MAX_DEPTH = 4


def _cond_lib():
    from sdv_loam_tpu_torch.ops import hopper_kernels
    return hopper_kernels._load()


@contextlib.contextmanager
def _cond_node(pred, loop=False):
    """Capture the block's work into a conditional node on the device bool
    `pred`: an IF node (at replay the block runs only where `pred` holds
    when the node is reached) or, with `loop`, a WHILE node (the block runs
    again while `pred` holds after it: the block updates `pred` in place,
    and its last work copies it into the node's condition). The block runs
    on the body stream of its depth, allocating from the cache's body
    pool."""
    cache = _tls.capture_cache
    depth = _tls.depth
    if depth >= len(cache.body_streams):
        raise RuntimeError(f"conditional nodes nested deeper than "
                           f"{MAX_DEPTH}")
    flag = pred.reshape(())
    if flag.dtype != torch.bool or not flag.is_contiguous():
        if loop:
            raise TypeError("a WHILE node's predicate must be a contiguous "
                            "0-dim bool tensor (updated in place)")
        flag = flag.to(torch.bool).contiguous()
    parent = torch.cuda.current_stream(flag.device)
    body = cache.body_streams[depth]
    lib = _cond_lib()
    handle = ctypes.c_ulonglong(0)
    rc = lib.sdv_cond_begin(parent.cuda_stream, body.cuda_stream,
                            flag.data_ptr(), int(loop), ctypes.byref(handle))
    if rc:
        raise RuntimeError(f"conditional node: cudaError {rc} starting the "
                           "body")
    dev = flag.device.index
    if depth == 0:
        torch._C._cuda_beginAllocateCurrentThreadToPool(
            dev, cache.body_pool.id)
    _tls.depth = depth + 1
    ok = False
    try:
        with torch.cuda.stream(body):
            yield
        ok = True
    finally:
        _tls.depth = depth
        rc = lib.sdv_cond_set(body.cuda_stream, handle.value,
                              flag.data_ptr()) if loop and ok else 0
        nodes = ctypes.c_ulonglong(0)
        rc = lib.sdv_cond_end(body.cuda_stream, ctypes.byref(nodes)) or rc
        _tls.nodes += nodes.value
        if depth == 0:
            torch._C._cuda_endAllocateToPool(dev, cache.body_pool.id)
            torch._C._cuda_releasePool(dev, cache.body_pool.id)
    if rc:
        raise RuntimeError(f"conditional node: cudaError {rc} ending the "
                           "body")


def launch_log():
    """The list a capture records the host-counted Hopper kernels' (K1's
    and K2's) launches into (None outside a capture); raises inside a
    conditional body, whose launches a replay may skip or repeat, so that
    no count can depart from the card's. (K3-K8 count on the card and
    never ask.)"""
    log = getattr(_tls, "launch_log", None)
    if log is not None and getattr(_tls, "depth", 0):
        raise RuntimeError("a Hopper kernel inside an IF or WHILE node "
                           "cannot be counted per replay")
    return log


def _prepare_streams(cache, dev):
    """The capture stream, the body streams and pool, and this thread's
    library handles and workspaces on each of those streams (made outside
    any capture)."""
    side = _side_stream(cache, dev)
    if not cache.body_streams:
        cache.body_streams = [torch.cuda.Stream(dev)
                              for _ in range(MAX_DEPTH)]
        with torch.cuda.device(dev):      # a pool belongs to one device
            cache.body_pool = torch.cuda.MemPool()
    me = threading.get_ident()
    if me not in cache.prepared:
        cur = torch.cuda.current_stream(dev)
        for s in [side] + cache.body_streams:
            s.wait_stream(cur)
            with torch.cuda.stream(s):
                prepare_thread(dev)
            cur.wait_stream(s)
        _cond_lib()
        cache.prepared.add(me)
    return side


class _Program:
    """One captured stage program: static input buffers, the graph, its
    outputs (graph pool memory), and the Hopper launches it records."""

    def __init__(self, leaves):
        self.inputs = [_empty(v) if isinstance(v, torch.Tensor) else v
                       for v in leaves]
        self.graphs: dict = {}      # the one graph, once captured
        self.graph = None
        self.out_leaves = None
        self.out_spec = None
        self.launches: list = []
        self.stream = None


def _program_key(stage, fn, leaves, spec, static, dev):
    lay = tuple((tuple(v.shape), v.stride(), v.dtype)
                if isinstance(v, torch.Tensor) else ("const", v)
                for v in leaves)
    return ("program", stage, fn, str(spec), lay, str(dev),
            tuple(sorted(static.items())))


def program(stage: str, fn, inputs, static: dict | None = None):
    """`fn(inputs, **static)` as one stage program (see the module
    docstring): a captured CUDA graph on CUDA; on the CPU the stage form,
    or under `programs()` the trace form. `inputs` is a pytree of tensors
    (and hashable constants, which join the key); `fn` returns a pytree of
    tensors."""
    from torch.utils._pytree import tree_flatten

    static = static or {}
    mode = getattr(_tls, "mode", None)
    if _inner() is not None:
        return fn(inputs, **static)
    leaves, spec = tree_flatten(inputs)
    dev = next(v.device for v in leaves if isinstance(v, torch.Tensor))
    log = getattr(_tls, "plog", None)
    if log is not None:
        log.append(dict(kind="program", stage=stage, fn=fn,
                        static=dict(static), spec=spec,
                        leaves=[v.clone() if isinstance(v, torch.Tensor)
                                else v for v in leaves]))
    with _lock:
        PROGRAMS.add(stage)
    if mode in ("stage", "reference"):
        return fn(inputs, **static)
    if dev.type != "cuda":
        if mode != "program":
            return fn(inputs, **static)
        with _inner_form("trace"):
            return fn(inputs, **static)
    return _graph_program(stage, fn, leaves, spec, static, dev)[0]


# The stage programs warmed up in this process, by function and device: a
# warm-up loads the kernels' modules and makes the lazily made constants,
# which every later key and system of the process then finds made (each
# system's cache makes its threads' library handles on its own streams).
_WARM: set = set()


def _graph_program(stage, fn, leaves, spec, static, dev):
    """Replay the program of this key (capturing it at the first call; the
    process's first call of `fn` returns its eager warm-up run instead,
    in the layout a replay's clones have); returns (outputs, replayed)."""
    from torch.utils._pytree import tree_map, tree_unflatten

    from sdv_loam_tpu_torch.ops import hopper_kernels

    leaves = [v.contiguous() if isinstance(v, torch.Tensor) and _overlapping(v)
              else v for v in leaves]
    cache = current_cache()
    key = _program_key(stage, fn, leaves, spec, static, dev)
    e = cache.entries.get(key)
    cur = torch.cuda.current_stream(dev)
    if e is None:
        with _lock:
            warm = (fn, str(dev)) in _WARM
        if not warm:
            # the warm-up: this call's result, in the eager form (early-exit
            # loops, host reads: the same values); marked done only once it
            # has run, so another thread's first call warms up too rather
            # than capture before the modules and constants are made
            prev = getattr(_tls, "mode", None)
            _tls.mode = "reference"
            rf = annotation("program.warmup")
            try:
                out = fn(tree_unflatten(leaves, spec), **static)
            finally:
                _tls.mode = prev
                end_annotation(rf)
            with _lock:
                _WARM.add((fn, str(dev)))
            _count(stage, warmups=1, calls=1)
        e = _Program(leaves)
        rf = annotation("program.capture")
        try:
            _capture_program(cache, stage, fn, e, spec, static, dev)
        finally:
            end_annotation(rf)
        cache.entries[key] = e
        if not warm:
            # cloned as a replay's outputs are: a view with gaps comes out
            # dense, so an input chained from it keeps the next program's
            # key
            return tree_map(torch.Tensor.clone, out), False
    if e.stream is not None and e.stream != cur:
        cur.wait_stream(e.stream)      # the last call's replay and clones
    e.stream = cur
    rf = annotation("program.replay")
    step = annotation("program.inputs")
    copies = 0
    for buf, v in zip(e.inputs, leaves):
        if isinstance(v, torch.Tensor):
            buf.copy_(v)
            copies += 1
    end_annotation(step)
    timed = _TIMED
    if timed is not None:
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record(cur)
    step = annotation("program.launch")
    e.graph.replay()
    end_annotation(step)
    if timed is not None:
        ev[1].record(cur)
        with _lock:
            timed.append((stage, *ev))
    hopper_kernels.count_launches(e.launches)
    step = annotation("program.outputs")
    outs = [v.clone() for v in e.out_leaves]
    end_annotation(step)
    end_annotation(rf)
    _count(stage, replays=1, calls=1, copies=copies + len(outs))
    return tree_unflatten(outs, e.out_spec), True


def _capture_program(cache, stage, fn, e, spec, static, dev):
    """Capture `fn` over `e`'s static inputs; counts the capture's seconds,
    its instantiation's (capture_end), its nodes (`ops`: kernels, copies,
    memsets and conditional nodes, every conditional body's included) and
    the graph pool's growth."""
    from torch.utils._pytree import tree_flatten, tree_unflatten

    cur = torch.cuda.current_stream(dev)
    with _capture_lock:
        side = _prepare_streams(cache, dev)
        side.wait_stream(cur)
        reserved0 = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        with _collector_paused(), torch.cuda.stream(side):
            g = torch.cuda.CUDAGraph()
            g.capture_begin(pool=cache.pool,
                            capture_error_mode="thread_local")
            _tls.capture_cache, _tls.depth, _tls.launch_log = cache, 0, []
            _tls.nodes = 0
            try:
                with _inner_form("capture"):
                    out = fn(tree_unflatten(e.inputs, spec), **static)
                out_leaves, out_spec = tree_flatten(out)
                if not all(isinstance(v, torch.Tensor) for v in out_leaves):
                    raise TypeError(f"{stage} program: every output must "
                                    "be a tensor")
                nodes = ctypes.c_ulonglong(0)
                rc = _cond_lib().sdv_capture_nodes(side.cuda_stream,
                                                   ctypes.byref(nodes))
                if rc:
                    raise RuntimeError(f"{stage} program: cudaError {rc} "
                                       "counting the graph's nodes")
                ops = _tls.nodes + nodes.value
            except BaseException:
                with contextlib.suppress(Exception):
                    g.capture_end()
                raise
            finally:
                e.launches = _tls.launch_log
                _tls.capture_cache, _tls.depth, _tls.launch_log = \
                    None, 0, None
            t1 = time.perf_counter()
            g.capture_end()
        t2 = time.perf_counter()
        cur.wait_stream(side)
    e.graph, e.out_leaves, e.out_spec = g, out_leaves, out_spec
    e.graphs[0] = g
    _count(stage, captures=1, capture_s=t1 - t0, instantiate_s=t2 - t1,
           ops=ops,
           pool_mib=(torch.cuda.memory_reserved(dev) - reserved0) / 2**20)


def compare_program(rec: dict) -> dict:
    """One recorded program (see `recording`) run as a program (a replay
    on CUDA: a key seen first is captured, then replayed; the trace form
    on the CPU) and in the stage form on the same inputs: returns
    dict(stage, equal, differ (output indices), replayed)."""
    from torch.utils._pytree import tree_flatten, tree_unflatten

    leaves = [v.clone() if isinstance(v, torch.Tensor) else v
              for v in rec["leaves"]]
    inputs = tree_unflatten(leaves, rec["spec"])
    dev = next(v.device for v in leaves if isinstance(v, torch.Tensor))
    if dev.type == "cuda":
        got, replayed = _graph_program(rec["stage"], rec["fn"], leaves,
                                       rec["spec"], rec["static"], dev)
        if not replayed:
            got, replayed = _graph_program(rec["stage"], rec["fn"], leaves,
                                           rec["spec"], rec["static"], dev)
    else:
        with _inner_form("trace"):
            got = rec["fn"](inputs, **rec["static"])
        replayed = False
    with stage_form():
        ref = rec["fn"](tree_unflatten(rec["leaves"], rec["spec"]),
                        **rec["static"])
    a, _ = tree_flatten(got)
    b, _ = tree_flatten(ref)
    diff = [i for i, (x, y) in enumerate(zip(a, b)) if not same_bits(x, y)]
    return dict(stage=rec["stage"], equal=not diff and len(a) == len(b),
                differ=diff, replayed=replayed)


def same_bits(a, b) -> bool:
    """Bitwise equality (NaN payloads and signed zeros included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        it = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        return torch.equal(a.contiguous().view(it), b.contiguous().view(it))
    return torch.equal(a, b)


def compare(rec: dict) -> dict:
    """One recorded loop (see `recording`) run by `graph_loop` and by
    `eager_loop` on its device: returns dict(equal, keys that differ,
    chunk, replays, reads)."""
    stage = rec["stage"]
    k = CHUNK[stage] if rec["chunk"] is None else rec["chunk"]
    k = max(1, min(int(k), rec["max_iters"]))
    before = counts().get(stage, {})
    if rec["st"][next(iter(rec["st"]))].device.type == "cuda":
        got = graph_loop(stage, rec["body"], rec["x"], rec["st"],
                         rec["max_iters"], rec["static"], k)
    else:
        got = chunked_loop(stage, rec["body"], rec["x"], rec["st"],
                           rec["max_iters"], rec["static"], k)
    after = counts().get(stage, {})
    ref = eager_loop(stage, rec["body"], rec["x"], rec["st"],
                     rec["max_iters"], rec["static"])
    diff = [n for n in ref if not same_bits(got[n], ref[n])]
    return dict(stage=stage, equal=not diff, differ=diff, chunk=k,
                replays=after.get("replays", 0) - before.get("replays", 0),
                reads=after.get("reads", 0) - before.get("reads", 0))
