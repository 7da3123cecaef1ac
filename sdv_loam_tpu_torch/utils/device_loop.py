"""Device-resident iterated stages: the JAX package's `lax.while_loop`s as
replayed CUDA graphs.

Each iterated stage of the JAX package (the tracking LM and its cutoff
pre-loop, the feature alignment, the struct-pose LM, the windowed BA and
the LiDAR components fixpoint) is one compiled program with its loop on the
device. The port runs the same loops through `run`:

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
* CPU tensors take `eager_loop` (the early-exit loop: one host read of
  `active` per iteration). CUDA tensors take `graph_loop`: the body's `k`
  unrolled iterations are captured once per shape as a `torch.cuda.CUDAGraph`
  (the public capture API, `capture_error_mode="thread_local"`, so systems
  on other threads keep running), and replayed until `active` reads false
  or `max_iters` iterations have run. The flag is read once per chunk, and
  not after the last chunk; a tail shorter than `k` has a graph of its own,
  so no replay runs past `max_iters`.
* Graph inputs and carries live in static buffers: each call copies its
  inputs and initial carries into them (`copy_`, stream ordered), and the
  results are cloned out before the call returns. The buffers keep the
  strides the eager loop would see at each iteration (see `_Entry`):
  cuBLAS picks its kernels (transposes, gemv variants) from the strides,
  and another kernel rounds otherwise.

Graphs are cached in a `LoopCache`, keyed by stage, body, shapes, strides,
dtypes, device, the static arguments and the chunk length. A `FullSystem`
(and a `MultiSystem`) owns one and makes it current with `use` around its
work (`_on_stream`), so two systems never replay one graph at once, and
the cache goes with the system; outside a system each thread has a cache
of its own. The graphs of one cache share one memory pool: nothing a graph
allocates outlives its replay (carries and flag are static buffers made
outside capture), and one cache's replays never overlap. Captures take
turns, and Python's automatic garbage collection is paused during one (a
collection could free another system's graphs mid-capture).

There is no switch to the eager loop on CUDA on the main path: `reference`
(eager loops on every device) and `chunks` (the chunk size, and on the CPU
the chunked driver without capture) exist for the comparisons of
`chip_smoke.py` and the tests. `STATS` counts, per stage, captures and
their seconds, replays, host reads of a stop flag, and (eager loops) the
iterations run.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time

import torch

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
#            replay runs all 10 and no flag is read;
#   struct   the struct-pose LM (cap 10): 8-10 iterations on 7 of 11 calls:
#            one replay of 10;
#   ba0/ba   the windowed BA (cap 6): the first two iterations (no
#            nullspace projection) are one replay; the rest ran 1-3 more
#            iterations, one per replay: a BA iteration is the heaviest
#            body, and an extra one costs more device time than a read;
#   sweep    the LiDAR components: 2 sweeps on every scan (the fixpoint,
#            then one that sees no change): one replay, one read.
CHUNK = {"lm": 3, "cutoff": 2, "align": 10, "struct": 10, "ba0": 2, "ba": 1,
         "sweep": 2}

STATS: dict = {}
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
        for k, v in kw.items():
            st[k] += v


def reset_counts() -> None:
    with _lock:
        STATS.clear()
        HIST.clear()


def counts() -> dict:
    """A copy of `STATS`, plus the totals over stages under "all"."""
    with _lock:
        out = {k: dict(v) for k, v in STATS.items()}
    tot = {}
    for v in out.values():
        for k, x in v.items():
            tot[k] = tot.get(k, 0) + x
    out["all"] = tot
    return out


class LoopCache:
    """The captured graphs of one system: entries by key, one capture
    stream and one memory pool (made at the first capture)."""

    def __init__(self):
        self.entries: dict = {}
        self.stream = None
        self.pool = None

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
def recording(log: list):
    """Append every loop this thread runs to `log` as a dict (stage, body,
    x, st: clones of the inputs and initial carries, max_iters, static,
    chunk), for `compare`."""
    prev = getattr(_tls, "log", None)
    _tls.log = log
    try:
        yield log
    finally:
        _tls.log = prev


def read(stage: str, flag) -> bool:
    """A counted host read of a device flag outside a loop (a stage's
    entry test, the level repeat)."""
    _count(stage, reads=1)
    return bool(flag)


def prepare_thread(device) -> None:
    """Make this thread's cuBLAS, cuBLASLt and cuSOLVER handles (a small
    product, a one-matrix solve and a batched one). A thread that makes
    its first handle while another thread captures breaks that capture, so
    the fleets start their worker threads with this."""
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
    if cache.stream is None:
        cache.stream = torch.cuda.Stream(dev)
        cache.pool = torch.cuda.graph_pool_handle()
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
