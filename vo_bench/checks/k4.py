"""K4 (`lm_update_step` and `lm_update_accept_step`, in the track
program): the LM's damped step and its accept test against the plain
reference's, solved in float64 (the control's variant in float32).

`k4_rel_err`: the step's gap over its norm, the new pose's and affine
state's over max(1, their norm), the accept's pose and lambda;
`k4_decisions_differ`: the accept's done flags and iteration counts."""

import torch

from vo_bench import check
from vo_bench import reference as ref

PROGRAMS = {"track": "round"}
TAPS = (("sdv_loam_tpu_torch.ops.photometric", "lm_update_step", "K4.step"),
        ("sdv_loam_tpu_torch.ops.photometric", "lm_update_accept_step",
         "K4.accept_step"))
NUMBERS = ("k4_rel_err", "k4_decisions_differ")
REFERENCE = {"K4.step": ref.lm_step, "K4.accept_step": ref.lm_accept_step}


def reference(kernel, args, kwargs, out, low=False):
    return REFERENCE[kernel](*args, **kwargs,
                             **(dict(acc=torch.float32) if low else {}))


def step_rel(got, want):
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


def numbers(compared):
    num = dict(k4_rel_err=0.0, k4_decisions_differ=0)
    keys = ("T_new", "aff_new", "aff_rel", "inc")
    for kernel, _, _, out, want in compared:
        if kernel == "K4.step":
            num["k4_rel_err"] = max(num["k4_rel_err"], step_rel(out, want))
            continue
        num["k4_rel_err"] = max(
            num["k4_rel_err"],
            step_rel(tuple(out[k] for k in keys),
                     tuple(want[k] for k in keys)),
            check.rel(out["T"], want["T"], (1, 2)),
            check.rel(out["lam"], want["lam"], ()))
        num["k4_decisions_differ"] += sum(
            int((out[k] != want[k]).sum()) for k in ("done", "n_it"))
    return num
