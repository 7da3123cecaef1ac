"""The share of the traced rounds' wall time in which nothing ran on the
card: 1 - (union of the kernel, copy and memset intervals) / wall."""

LAYER = 'device (one H100)'
UNIT = '%'
SOURCE = 'device_trace'
MOVES = 'fleet_fps'


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["idle_share"] is None:
        return None
    return 100.0 * tr["idle_share"]
