"""Device time of the keyframe-optimisation programs' replays
(`device_loop.program_timing`) over the window of a traced run, per frame."""

LAYER = 'stage programs (utils/device_loop.program)'
UNIT = 'ms'
SOURCE = 'program_span'
MOVES = 'fleet_fps'


def read(ctx):
    t = ctx["program_ms"].get("kf_opt")
    return t["ms"] / ctx["frames"] if t else None
