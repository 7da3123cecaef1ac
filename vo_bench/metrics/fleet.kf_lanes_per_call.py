"""Lanes per batched keyframe optimisation over the window: the lanes that
K1 (`dilate_pyramid`, one launch per keyframe-optimisation program) took,
over its launches (`hopper_kernels.LANES` / `LAUNCHES`)."""

LAYER = 'fleet (system/multi.MultiSystem)'
UNIT = 'lanes'
SOURCE = 'program_counter'
MOVES = 'fleet_fps'


def read(ctx):
    if not ctx["k1_launches"]:
        return None
    return ctx["k1_lanes"] / ctx["k1_launches"]
