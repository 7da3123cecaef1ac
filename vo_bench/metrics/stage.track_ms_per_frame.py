"""Telemetry's `track` and `track.batch` stages over the window, per frame:
the time a lane's frame spent in the track step (a batched call counts
for each of its lanes). The lockstep's stages end on their stream, so
the device work is inside."""

LAYER = 'orchestrator (system/full_system stages via io/telemetry)'
UNIT = 'ms'
SOURCE = 'program_span'
MOVES = 'fleet_fps'


def read(ctx):
    s = ctx["stage_s"]
    t = s.get("track", 0.0) + s.get("track.batch", 0.0)
    return 1000.0 * t / ctx["frames"] if t > 0 else None
