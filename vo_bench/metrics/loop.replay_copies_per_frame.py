"""Device copies around the window's stage-program replays, per frame:
`device_loop.counts()`'s `copies` (each input copied into its static
buffer and each output cloned out of the graph's pool;
`cudaMemcpyAsync` calls, which `host.launch_calls_per_frame` does not
count). Absent from a program without the counter."""

LAYER = 'loop driver (utils/device_loop.run, LoopCache)'
UNIT = 'copies'
SOURCE = 'program_counter'
MOVES = 'fleet_fps'


def read(ctx):
    n = ctx["loops"].get("copies")
    return n / ctx["frames"] if n is not None else None
