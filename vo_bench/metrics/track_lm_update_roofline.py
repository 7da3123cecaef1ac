"""K4's share of its roofline over the traced rounds: its launches'
bounds (the rows of the K3 launch before each on its stream) over their
device times."""

LAYER = 'kernels (ops/hopper_kernels, csrc/)'
UNIT = '%'
SOURCE = 'device_trace'
MOVES = 'fleet_fps'


def read(ctx):
    tr = ctx["trace"]
    return tr["k4_roofline_pct"] if tr else None
