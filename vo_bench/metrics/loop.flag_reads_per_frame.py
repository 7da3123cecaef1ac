"""Host reads of a loop's stop flag over the window, per frame
(`device_loop.counts()`)."""

LAYER = 'loop driver (utils/device_loop.run, LoopCache)'
UNIT = 'reads'
SOURCE = 'program_counter'
MOVES = 'fleet_fps'


def read(ctx):
    return ctx["loops"].get("reads", 0) / ctx["frames"]
