"""K5 with K6 as its prologue (`warp_align`, in the track program and
the keyframe program's matcher passes): the matcher's affine patch warp
and each candidate's Gauss-Newton alignment to its own stop against the
plain reference's (float32 per pixel, sums in float64; the control's
variant sums in float32).

`k5_flags_differ`: each candidate's converged flag and each lane's
failure counts; `k5_px_err`: the largest |px - px_ref| (pixels of the
row's search level) over the rows whose flag agrees."""

import torch

from vo_bench import reference as ref

PROGRAMS = {"track": "round", "kf_opt": "next"}
TAPS = (("sdv_loam_tpu_torch.models.matcher", "warp_align", "K5"),)
NUMBERS = ("k5_flags_differ", "k5_px_err")


def reference(kernel, args, kwargs, out, low=False):
    return ref.warp_align(*args, **kwargs,
                          **(dict(acc=torch.float32) if low else {}))


def call_numbers(got, want):
    """(flags that differ: each row's converged flag and each failure
    count's gap; the largest |px - px_ref| over the valid rows whose flag
    agrees: two NaNs agree, NaN against a number reads inf)."""
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


def numbers(compared):
    num = dict(k5_flags_differ=0, k5_px_err=0.0)
    for _, _, _, out, want in compared:
        differ, gap = call_numbers(out, want)
        num["k5_flags_differ"] += differ
        num["k5_px_err"] = max(num["k5_px_err"], gap)
    return num
