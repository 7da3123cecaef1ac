"""Kernels the card ran in the traced rounds (each node of a graph replay
counts), per frame."""

LAYER = 'device (one H100)'
UNIT = 'kernels'
SOURCE = 'device_trace'
MOVES = 'fleet_fps'


def read(ctx):
    tr = ctx["trace"]
    return tr["kernels_per_frame"] if tr else None
