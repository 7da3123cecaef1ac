"""CUDA graphs captured inside the window (`device_loop.counts()`: stage
programs and loop graphs): keys the warm-up did not reach."""

LAYER = 'loop driver (utils/device_loop.run, LoopCache)'
UNIT = 'graphs'
SOURCE = 'program_counter'
MOVES = 'fleet_fps'


def read(ctx):
    return ctx["loops"].get("captures", 0)
