"""Device time of the track programs' replays (`device_loop.program_timing`:
a CUDA event pair around each replay) over the window of a traced run, per
frame."""

LAYER = 'stage programs (utils/device_loop.program)'
UNIT = 'ms'
SOURCE = 'program_span'
MOVES = 'fleet_fps'


def read(ctx):
    t = ctx["program_ms"].get("track")
    return t["ms"] / ctx["frames"] if t else None
