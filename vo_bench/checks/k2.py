"""K2 (`distance_transform`, in the activation program): its chamfer
map against the plain reference's, element by element."""

from vo_bench import check
from vo_bench import reference as ref

PROGRAMS = {"activate": "next"}
TAPS = (("sdv_loam_tpu_torch.ops.distmap", "distance_transform", "K2"),)
NUMBERS = ("k2_cells_differ",)


def reference(kernel, args, kwargs, out, low=False):
    return ref.distance_transform(*args, **kwargs)


def numbers(compared):
    return dict(k2_cells_differ=sum(check.cells_differ(out, want)
                                    for _, _, _, out, want in compared))
