"""Lanes per batched keyframe optimisation over the window: the lanes that
K1 (`dilate_pyramid`, one launch per keyframe-optimisation program) took,
over its launches (`hopper_kernels.LANES` / `LAUNCHES`)."""

LAYER = 'fleet (system/multi.MultiSystem)'
UNIT = 'lanes'
SOURCE = 'program_counter'
MOVES = 'fleet_fps'


def read(ctx):
    launches = ctx["kernel_launches"]["dilate_pyramid"]
    if not launches:
        return None
    return ctx["kernel_lanes"]["dilate_pyramid"] / launches
