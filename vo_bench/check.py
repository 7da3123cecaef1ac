"""What decides `correct`: the window's outputs against the plain reference.

Three comparisons, each number printed beside its limit:

* trajectories: the lanes the system lost (`lost_lanes`). Each lane's
  camera path against the rendered ground truth (`ate_path_pct`: the worst
  lane's ATE as a share of its path) is printed, not compared: the
  control's TF32 products leave it within the spread of sound runs
  (PERF.md), so no limit separates the two;
* the window's programs: on rounds drawn from the seed, the track program
  and the next keyframe's activation and keyframe-optimization programs
  are recorded as the window ran them (inputs and outputs, copied to the
  host). Once the window has closed, each is run again in its eager form
  (the program's own step-by-step form: early-exit loops, host reads) on
  the same inputs; its outputs must be the window's bit for bit
  (`rerun_outputs_differ`);
* the kernels inside them: every call of K1-K5 in those eager runs is
  re-derived by `vo_bench/reference.py` from the call's own inputs
  (`k1_cells_differ`, `k2_cells_differ`, `k3_row_err`, `k3_count_diff`,
  `k4_rel_err`, `k4_decisions_differ`, `k5_flags_differ`, `k5_px_err`).
  K3 is judged by its worst row; a point whose residual lies within
  float32 rounding of the cutoff may fall on either side, and each row
  takes the side (of up to `MAX_NEAR` such points) nearest the kernel's.

The reference cannot follow the programs' whole state (the selection,
the BA, the matcher) without being a second odometry system, so the
programs are followed step by step from their recorded inputs: the
eager rerun ties the window's outputs to the kernel calls the reference
judges.

The control (`control=True`): the references computed with TF32 products
stand in the kernels' place, and the program runs with TF32 on; it must
come out not correct.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from vo_bench import reference as ref

CHECKED_PROGRAMS = ("track", "activate", "kf_opt")
# the kernels' dispatchers where the port's modules call them: (module,
# attribute, kernel)
TAPS = (("sdv_loam_tpu_torch.ops.photometric", "dilate_pyramid", "K1"),
        ("sdv_loam_tpu_torch.ops.distmap", "distance_transform", "K2"),
        ("sdv_loam_tpu_torch.ops.photometric", "track_res_gs", "K3"),
        ("sdv_loam_tpu_torch.ops.photometric", "lm_update_step", "K4.step"),
        ("sdv_loam_tpu_torch.ops.photometric", "lm_update_accept_step",
         "K4.accept_step"),
        ("sdv_loam_tpu_torch.models.matcher", "warp_align", "K5"))
REFERENCE = {"K1": ref.dilate_pyramid, "K2": ref.distance_transform,
             "K3": ref.track_res_gs, "K4.step": ref.lm_step,
             "K4.accept_step": ref.lm_accept_step, "K5": ref.warp_align}
# the references that take an accumulation dtype (float64; float32 in the
# control)
ACC = ("K3", "K4.step", "K4.accept_step", "K5")
# points near K3's cutoff whose two sides are tried, per row
MAX_NEAR = 4
# variant rows a reference call takes at once
VARIANTS_A_CALL = 256
# a tensor this large is held by reference, not copied, in a tapped call
# (the image packs the LM reads unchanged)
KEEP_BY_REFERENCE = 1 << 22


def _map(fn, x):
    from torch.utils._pytree import tree_map
    return tree_map(lambda v: fn(v) if isinstance(v, torch.Tensor) else v, x)


def _host(x):
    return _map(lambda t: t.detach().to("cpu", copy=True), x)


class Recorder:
    """Records the checked programs of the sampled rounds: at a sampled
    round the track program's first call, and the next call of each
    keyframe program from that round on."""

    def __init__(self, rounds):
        self.rounds = set(rounds)
        self.armed: set = set()
        self.records: list = []
        self._orig = None

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
            self.armed |= set(CHECKED_PROGRAMS)

    def end_round(self):
        self.armed.discard("track")


@contextlib.contextmanager
def tapped(calls: list):
    """Every call of K1-K4 through the port's dispatchers appended to
    `calls` as (kernel, args, kwargs, outputs), small tensors copied."""
    import importlib

    def keep(v):
        return v if v.numel() >= KEEP_BY_REFERENCE else v.clone()

    saved = []
    for mod_name, attr, kernel in TAPS:
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
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)


def same_bits(a, b):
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        it = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        return torch.equal(a.contiguous().view(it), b.contiguous().view(it))
    return torch.equal(a, b)


def rerun(records, device):
    """Each recorded program run again in its eager form on its recorded
    inputs, its kernel calls tapped. Returns (outputs that differ from the
    window's, leaves compared, the calls)."""
    from torch.utils._pytree import tree_flatten

    from sdv_loam_tpu_torch.utils import device_loop

    calls, differ, leaves = [], 0, 0
    for rec in records:
        inputs = _map(lambda t: t.to(device), rec["inputs"])
        with device_loop.reference(), tapped(calls):
            out = rec["fn"](inputs, **rec["static"])
        a, _ = tree_flatten(_host(out))
        b, _ = tree_flatten(rec["outputs"])
        leaves += len(b)
        differ += abs(len(a) - len(b)) + sum(
            not same_bits(x, y) for x, y in zip(a, b))
    return differ, leaves, calls


def _cells_differ(a, b):
    """Elements of two float maps that differ (two NaNs agree)."""
    return int((~((a == b) | (torch.isnan(a) & torch.isnan(b)))).sum())


def _rel(got, want, dims):
    """Per row the largest |got - want| over `dims`, divided by the row's
    largest |want|; a row whose reference is all zero is judged by its
    absolute gap. NaN against a number reads inf."""
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


def _over(got, want, scale, dims):
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


def _k3_rows(got, want):
    """Per row, the largest gap of a sum over the sum of its terms'
    magnitudes (H, b: the reference's H_abs, b_abs; E and the flows are
    sums of non-negative terms) and of the saturated share."""
    return torch.stack([
        _over(got["H"], want["H"], want["H_abs"], (1, 2)),
        _over(got["b"], want["b"], want["b_abs"], (1,)),
        *(_over(got[k], want[k], want[k], ()) for k in
          ("E", "flow_t", "flow_rt")),
        _over(got["sat_frac"], want["sat_frac"],
              torch.ones_like(want["sat_frac"]), ())]).amax(0)


def _k3_args(args, kwargs):
    """A K3 call's arguments by name, in the lane form (pool fields (L,
    N), K (L, 4), the image's pack, `hw`, `lane`)."""
    import inspect

    ba = inspect.signature(ref.track_res_gs).bind(*args, **kwargs)
    ba.apply_defaults()
    a = dict(ba.arguments)
    a.pop("acc"), a.pop("flip")
    B = a["T_ref_to_new"].shape[0]
    if a["hw"] is None:
        a["hw"] = tuple(a["dI_new"].shape[-3:-1])
    if a["packed"] is None:
        a["packed"] = ref.pack_bilinear(a["dI_new"])
    if a["lane"] is None:
        a["pool"] = {k: a["pool"][k][None] for k in ("u", "v", "idepth",
                                                     "color", "valid")}
        a["K"] = a["K"][None]
        a["lane"] = torch.zeros(B, dtype=torch.int64,
                                device=a["T_ref_to_new"].device)
    return a


def _k3_near_sides(args, kwargs, got, want, rows):
    """`rows` (per row the error against the reference) lowered, where a
    row has points near the cutoff, to its least over the sides those
    points may take (each subset of its first `MAX_NEAR` moved across).
    Returns (rows, rows with points near the cutoff)."""
    near = want["near"]
    k = near.sum(-1)
    with_near = torch.nonzero(k > 0).flatten().tolist()
    if not with_near:
        return rows, 0
    sel, flips = [], []
    N = near.shape[1]
    for r in with_near:
        pts = torch.nonzero(near[r]).flatten()[:MAX_NEAR]
        for c in range(1, 1 << len(pts)):
            f = torch.zeros(N, dtype=torch.bool, device=near.device)
            f[pts[[i for i in range(len(pts)) if c >> i & 1]]] = True
            sel.append(r)
            flips.append(f)
    a = _k3_args(args, kwargs)
    B = rows.shape[0]
    rows = rows.clone()
    for i in range(0, len(sel), VARIANTS_A_CALL):
        s = torch.tensor(sel[i:i + VARIANTS_A_CALL], device=near.device)
        part = dict(a, T_ref_to_new=a["T_ref_to_new"][s],
                    aff_rel=a["aff_rel"][s], lane=a["lane"][s])
        for key in ("ref_aff_b", "cutoff"):
            x = a[key]
            if isinstance(x, torch.Tensor) and x.numel() == B:
                part[key] = x.reshape(B)[s]
        alt = ref.track_res_gs(**part,
                               flip=torch.stack(flips[i:i + VARIANTS_A_CALL]))
        err = _k3_rows({key: got[key][s] for key in got}, alt).to(rows.device)
        rows = rows.scatter_reduce(0, s.to(rows.device), err, "amin")
    return rows, len(with_near)


def _k5_numbers(got, want):
    """(flags that differ: each row's converged flag and each failure
    count's gap; the largest |px - px_ref| (pixels of the row's search
    level) over the valid rows whose flag agrees: two NaNs agree, NaN
    against a number reads inf)."""
    px, conv, fails = got[:3]
    rpx, rconv, rfails = want[:3]
    same = conv == rconv
    differ = int((~same).sum()) + int((fails.long() - rfails.long()).abs()
                                      .sum())
    gap = (px.double() - rpx.double()).abs()
    gap = torch.where(torch.isnan(px) & torch.isnan(rpx),
                      torch.zeros_like(gap), gap)
    gap = torch.nan_to_num(gap, nan=float("inf")).amax(-1)
    gap = torch.where(same, gap, torch.zeros_like(gap))
    return differ, float(gap.max()) if gap.numel() else 0.0


def _step_rel(got, want):
    """The step's and the new pose's largest gap, each over its row's
    norm (the pose's at least 1)."""
    T_new, aff_new, _, inc = got
    rT, ra, _, ri = want
    gi = (inc.double() - ri.double()).norm(dim=-1) / torch.clamp(
        ri.double().norm(dim=-1), min=1e-6)
    gT = (T_new.double() - rT.double()).abs().amax(dim=(1, 2)) / torch.clamp(
        rT.double().abs().amax(dim=(1, 2)), min=1.0)
    ga = (aff_new.double() - ra.double()).abs().amax(dim=-1) / torch.clamp(
        ra.double().abs().amax(dim=-1), min=1.0)
    return float(torch.nan_to_num(torch.cat([gi, gT, ga]),
                                  nan=float("inf")).max())


def kernel_numbers(calls, control=False):
    """The kernels' numbers over the tapped calls: each call's outputs
    (in the control: the reference's with TF32 products) against the
    reference's from the call's own inputs. Returns (numbers, calls
    compared per kernel)."""
    num = dict(k1_cells_differ=0, k2_cells_differ=0, k3_count_diff=0,
               k4_rel_err=0.0, k4_decisions_differ=0, k5_flags_differ=0,
               k5_px_err=0.0, k3_rows_near_cutoff=0)
    seen, k3_rows, worst = {}, [], None
    for kernel, args, kwargs, out in calls:
        fn = REFERENCE[kernel]
        low = dict(acc=torch.float32) if kernel in ACC else {}
        with ref.precision(False):
            want = fn(*args, **kwargs)
        if control:
            with ref.precision(True):
                out = fn(*args, **kwargs, **low)
        seen[kernel] = seen.get(kernel, 0) + 1
        if kernel == "K1":
            num["k1_cells_differ"] += sum(
                _cells_differ(g, w) for lv_g, lv_w in zip(out, want)
                for g, w in zip(lv_g, lv_w))
        elif kernel == "K2":
            num["k2_cells_differ"] += _cells_differ(out, want)
        elif kernel == "K3":
            with ref.precision(False):
                rows, n_near = _k3_near_sides(args, kwargs, out, want,
                                              _k3_rows(out, want))
            num["k3_rows_near_cutoff"] += n_near
            k3_rows.append(rows.cpu())
            num["k3_count_diff"] = max(num["k3_count_diff"], int(
                (out["n"].long() - want["n"].long()).abs().max()))
            j = int(rows.argmax())
            if worst is None or float(rows[j]) > worst[0]:
                worst = (float(rows[j]), j, int(want["n"][j]),
                         float(out["sat_frac"][j]),
                         float(want["sat_frac"][j]))
        elif kernel == "K5":
            differ, gap = _k5_numbers(out, want)
            num["k5_flags_differ"] += differ
            num["k5_px_err"] = max(num["k5_px_err"], gap)
        elif kernel == "K4.step":
            num["k4_rel_err"] = max(num["k4_rel_err"], _step_rel(out, want))
        else:
            keys = ("T_new", "aff_new", "aff_rel", "inc")
            num["k4_rel_err"] = max(
                num["k4_rel_err"],
                _step_rel(tuple(out[k] for k in keys),
                          tuple(want[k] for k in keys)),
                _rel(out["T"], want["T"], (1, 2)),
                _rel(out["lam"], want["lam"], ()))
            num["k4_decisions_differ"] += sum(
                int((out[k] != want[k]).sum()) for k in ("done", "n_it"))
    if k3_rows:
        rows = torch.cat(k3_rows)
        num["k3_row_err"] = float(rows.max())
        num["k3_worst_row"] = dict(zip(
            ("err", "row", "n", "sat_frac", "sat_frac_ref"), worst))
    return num, seen


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
