"""K1 (`dilate_pyramid`, in the keyframe program): its levels against
the plain reference's hole-filling chain, element by element."""

from vo_bench import check
from vo_bench import reference as ref

PROGRAMS = {"kf_opt": "next"}
TAPS = (("sdv_loam_tpu_torch.ops.photometric", "dilate_pyramid", "K1"),)
NUMBERS = ("k1_cells_differ",)


def reference(kernel, args, kwargs, out, low=False):
    return ref.dilate_pyramid(*args, **kwargs)


def numbers(compared):
    return dict(k1_cells_differ=sum(
        check.cells_differ(g, w) for _, _, _, out, want in compared
        for lv_g, lv_w in zip(out, want) for g, w in zip(lv_g, lv_w)))
