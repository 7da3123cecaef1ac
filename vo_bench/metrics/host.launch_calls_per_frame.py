"""Launch calls the host made in the traced rounds (`cudaLaunchKernel*`,
`cuLaunchKernel*`, `cudaGraphLaunch`, `cuGraphLaunch` in the profiler's
record), per frame."""

LAYER = 'host dispatch'
UNIT = 'calls'
SOURCE = 'device_trace'
MOVES = 'fleet_fps'


def read(ctx):
    tr = ctx["trace"]
    return tr["launch_calls_per_frame"] if tr else None
