"""K3's share of its roofline over the traced rounds: the sum of its
launches' bounds (`vo_bench/bounds.py`: rows from the launch's grid,
points a row from the cell's `Settings`; a refinement launch's level is
not in the record, so its smallest pool is taken and the share is a
floor) over the sum of their device times."""

LAYER = 'kernels (ops/hopper_kernels, csrc/)'
UNIT = '%'
SOURCE = 'device_trace'
MOVES = 'fleet_fps'


def read(ctx):
    tr = ctx["trace"]
    return tr["k3_roofline_pct"] if tr else None
