"""Telemetry's keyframe stages (`kf.select`, `kf.activate`, `kf.opt` and
their `.batch` forms) over the window, per frame (a batched call counts
for each of its lanes)."""

LAYER = 'orchestrator (system/full_system stages via io/telemetry)'
UNIT = 'ms'
SOURCE = 'program_span'
MOVES = 'fleet_fps'


def read(ctx):
    t = sum(v for k, v in ctx["stage_s"].items() if k.startswith("kf."))
    return 1000.0 * t / ctx["frames"] if t > 0 else None
