"""The host's device-to-host readbacks over the window, per frame: the
program's `wait.readback` spans (`FullSystem._np` and its pending copies'
waits: the host waits for the queued work, then copies). Absent from a
program without the span."""

LAYER = 'orchestrator (system/full_system stages via io/telemetry)'
UNIT = 'ms'
SOURCE = 'program_span'
MOVES = 'fleet_fps'


def read(ctx):
    t = ctx["stage_s"].get("wait.readback")
    return 1000.0 * t / ctx["frames"] if t is not None else None
