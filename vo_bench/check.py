"""What decides `correct`: the window's outputs against plain references.

Three comparisons, each number printed beside its limit:

* trajectories: the lanes the system lost (`lost_lanes`). Each lane's
  camera path against the rendered ground truth (`ate_path_pct`: the worst
  lane's ATE as a share of its path) is printed, not compared: the
  control's TF32 products leave it within the spread of sound runs
  (PERF.md), so no limit separates the two;
* the window's programs: on rounds drawn from the seed, the stage programs
  the cell's checks name are recorded as the window ran them (inputs and
  outputs, copied to the host). Once the window has closed, each is run
  again in its eager form (the program's own step-by-step form: early-exit
  loops, host reads) on the same inputs; its outputs must be the window's
  bit for bit (`rerun_outputs_differ`);
* the kernels inside them: every call of a checked kernel in those eager
  runs is re-derived by its plain reference from the call's own inputs,
  and the check turns the calls into named numbers. `kernels_not_compared`
  counts the checked kernels that no rerun called.

A check is a module `vo_bench/checks/<name>.py` (found by
`vo_bench.cells.checks`); a cell runs it when its configuration's
`limits` name one of its numbers. It declares:

* `PROGRAMS`: {stage: when} for the stage programs its kernels run in:
  "round" records the stage's first call at a sampled round (none if the
  round makes none), "next" its next call from a sampled round on;
* `TAPS`: ((module, attribute, kernel), ...), the kernels' dispatchers
  where the port's modules call them;
* `NUMBERS`: the names of the numbers it computes;
* `reference(kernel, args, kwargs, out, low=False)`: the kernel's plain
  reference from the call's inputs (`low`: the control's variant);
* `numbers(compared)`: {name: value} from the tapped calls, each as
  (kernel, args, kwargs, out, want) (`compared`).

The references cannot follow the programs' whole state (the selection,
the BA, the matcher) without being a second odometry system, so the
programs are followed step by step from their recorded inputs: the eager
rerun ties the window's outputs to the kernel calls the references judge.

The control (`control=True`): the references computed with TF32 products
(and each check's lower-precision variant) stand in the kernels' place,
and the program runs with TF32 on; it must come out not correct.
"""

from __future__ import annotations

import collections
import contextlib
import importlib

import numpy as np
import torch

from vo_bench import reference as ref

# a tensor this large is held by reference, not copied, in a tapped call
# (the image packs the LM reads unchanged)
KEEP_BY_REFERENCE = 1 << 22


def _map(fn, x):
    from torch.utils._pytree import tree_map
    return tree_map(lambda v: fn(v) if isinstance(v, torch.Tensor) else v, x)


def _host(x):
    return _map(lambda t: t.detach().to("cpu", copy=True), x)


def programs(checks):
    """{stage: when} over `checks`: "next" where any check asks for it
    (the next call from a sampled round on includes the round's first)."""
    out = {}
    for c in checks:
        for stage, when in c.PROGRAMS.items():
            if when not in ("round", "next"):
                raise ValueError(f"{c.__name__}: {stage}: {when!r}")
            out[stage] = "next" if "next" in (when, out.get(stage)) else when
    return out


def taps(checks):
    """The dispatchers `checks` tap, each once, in order."""
    return tuple(dict.fromkeys(t for c in checks for t in c.TAPS))


class Recorder:
    """Records the stage programs of the sampled rounds: `programs` maps a
    stage to "round" (its first call at a sampled round) or "next" (its
    next call from a sampled round on)."""

    def __init__(self, rounds, programs):
        self.rounds = set(rounds)
        self.programs = dict(programs)
        self.armed: set = set()
        self.records: list = []

    @contextlib.contextmanager
    def installed(self):
        from sdv_loam_tpu_torch.utils import device_loop

        orig = device_loop.program

        def program(stage, fn, inputs, static=None):
            if stage not in self.armed:
                return orig(stage, fn, inputs, static)
            self.armed.discard(stage)
            host_in = _host(inputs)
            out = orig(stage, fn, inputs, static)
            self.records.append(dict(stage=stage, fn=fn,
                                     static=dict(static or {}),
                                     inputs=host_in, outputs=_host(out)))
            return out

        device_loop.program = program
        try:
            yield self
        finally:
            device_loop.program = orig

    def start_round(self, r):
        if r in self.rounds:
            self.armed |= set(self.programs)

    def end_round(self):
        self.armed -= {s for s, w in self.programs.items() if w == "round"}


@contextlib.contextmanager
def tapped(calls: list, taps):
    """Every call through the dispatchers `taps` ((module, attribute,
    kernel), ...) appended to `calls` as (kernel, args, kwargs, outputs),
    small tensors copied."""
    def keep(v):
        return v if v.numel() >= KEEP_BY_REFERENCE else v.clone()

    saved = []
    for mod_name, attr, kernel in taps:
        mod = importlib.import_module(mod_name)
        orig = getattr(mod, attr)

        def wrap(*a, _o=orig, _k=kernel, **kw):
            args, kwargs = _map(keep, a), _map(keep, kw)
            out = _o(*a, **kw)
            calls.append((_k, args, kwargs, _map(keep, out)))
            return out

        saved.append((mod, attr, orig))
        setattr(mod, attr, wrap)
    try:
        yield calls
    finally:
        for mod, attr, orig in reversed(saved):
            setattr(mod, attr, orig)


def same_bits(a, b):
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        it = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        return torch.equal(a.contiguous().view(it), b.contiguous().view(it))
    return torch.equal(a, b)


def rerun(records, device, taps=()):
    """Each recorded program run again in its eager form on its recorded
    inputs, the dispatchers `taps` tapped. Returns (outputs that differ
    from the window's, leaves compared, the calls)."""
    from torch.utils._pytree import tree_flatten

    from sdv_loam_tpu_torch.utils import device_loop

    calls, differ, leaves = [], 0, 0
    for rec in records:
        inputs = _map(lambda t: t.to(device), rec["inputs"])
        with device_loop.reference(), tapped(calls, taps):
            out = rec["fn"](inputs, **rec["static"])
        a, _ = tree_flatten(_host(out))
        b, _ = tree_flatten(rec["outputs"])
        leaves += len(b)
        differ += abs(len(a) - len(b)) + sum(
            not same_bits(x, y) for x, y in zip(a, b))
    return differ, leaves, calls


def compared(check, calls, control=False):
    """`check`'s tapped calls, each with its reference's outputs from the
    call's own inputs: (kernel, args, kwargs, out, want). In the control
    the reference's lower-precision variant, with TF32 products, stands
    in the kernel's place."""
    kernels = {k for *_, k in check.TAPS}
    for kernel, args, kwargs, out in calls:
        if kernel not in kernels:
            continue
        with ref.precision(False):
            want = check.reference(kernel, args, kwargs, out)
        if control:
            with ref.precision(True):
                out = check.reference(kernel, args, kwargs, out, low=True)
        yield kernel, args, kwargs, out, want


def run(checks, records, device, control=False):
    """`checks` over the recorded programs: the eager reruns with every
    check's dispatchers tapped, then each check's numbers. Returns
    (numbers, calls per kernel, leaves compared)."""
    differ, leaves, calls = rerun(records, device, taps(checks))
    seen = collections.Counter(k for k, *_ in calls)
    numbers = dict(rerun_outputs_differ=differ)
    for c in checks:
        numbers.update(c.numbers(compared(c, calls, control)))
    numbers["kernels_not_compared"] = sum(
        1 for *_, k in taps(checks) if not seen[k])
    return numbers, dict(seen), leaves


# comparisons the checks share

def cells_differ(a, b):
    """Elements of two float maps that differ (two NaNs agree)."""
    return int((~((a == b) | (torch.isnan(a) & torch.isnan(b)))).sum())


def rel(got, want, dims):
    """Per row the largest |got - want| over `dims`, divided by the row's
    largest |want|; a row whose reference is all zero is judged by its
    absolute gap. NaN against a number reads inf. The largest over rows."""
    gap = (got.double() - want.double()).abs()
    both_nan = torch.isnan(got) & torch.isnan(want)
    gap = torch.where(both_nan, torch.zeros_like(gap), gap)
    gap = torch.nan_to_num(gap, nan=float("inf"))
    if dims:
        gap = gap.amax(dim=dims)
        scale = want.double().abs().nan_to_num(0.0).amax(dim=dims)
    else:
        scale = want.double().abs().nan_to_num(0.0)
    return float((gap / torch.where(scale > 0, scale,
                                     torch.ones_like(scale))).max())


def over(got, want, scale, dims):
    """Per row the largest |got - want| / scale over `dims` (two NaNs
    agree, NaN against a number reads inf; a zero scale admits no gap)."""
    gap = (got.double() - want.double()).abs()
    gap = torch.where(torch.isnan(got) & torch.isnan(want),
                      torch.zeros_like(gap), gap)
    gap = torch.nan_to_num(gap, nan=float("inf"))
    scale = scale.double().abs()
    r = torch.where(gap > 0, gap / torch.where(
        scale > 0, scale, torch.zeros_like(scale)), torch.zeros_like(gap))
    r = torch.nan_to_num(r, nan=float("inf"))
    return r.amax(dim=dims) if dims else r


def trajectory_numbers(lanes):
    """`lanes`: (estimated poses, ground-truth poses, lost) per lane."""
    pct = max(100.0 * ref.ate_rmse(est, gt) / max(ref.path_length(gt), 1e-9)
              for est, gt, _ in lanes)
    return dict(ate_path_pct=pct,
                lost_lanes=sum(bool(lost) for _, _, lost in lanes))


def judge(numbers, limits):
    """(correct, lines): every number beside its limit; a number over its
    limit, or missing, makes the run not correct."""
    ok, lines = True, []
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and np.isfinite(v) and v <= limit
        ok &= bool(good)
        lines.append(dict(name=name, value=v, limit=limit, ok=bool(good)))
    return ok, lines
