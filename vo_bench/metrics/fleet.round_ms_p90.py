"""The 90th percentile of the window's round times: host clock around each
`MultiSystem.add_frames` round (its device work included: the lockstep's
stages end on their stream), over every round of the window."""

import statistics

LAYER = 'fleet (system/multi.MultiSystem)'
UNIT = 'ms'
SOURCE = 'host_clock'
MOVES = 'fleet_fps'


def read(ctx):
    if len(ctx["round_s"]) < 10:
        return None
    return 1000.0 * statistics.quantiles(ctx["round_s"], n=10)[8]
