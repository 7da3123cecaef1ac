"""The host's waits at the end of a telemetry stage over the window, per
frame: the program's `wait.stage_end` spans (`io/telemetry`: each
stage's device synchronize, timed apart from the stage; a batched stage
waits once, in its first lane's table). Absent from a program without
the span."""

LAYER = 'orchestrator (system/full_system stages via io/telemetry)'
UNIT = 'ms'
SOURCE = 'program_span'
MOVES = 'fleet_fps'


def read(ctx):
    t = ctx["stage_s"].get("wait.stage_end")
    return 1000.0 * t / ctx["frames"] if t is not None else None
