"""Host readbacks over the window, per frame: `device_loop.counts()`'s
`fetches`, one for each call of the program's readback path
(`device_loop.fetch`: a tensor copied to the host, or the wait for an
earlier asynchronous copy). Absent from a program without the counter."""

LAYER = 'loop driver (utils/device_loop.run, LoopCache)'
UNIT = 'reads'
SOURCE = 'program_counter'
MOVES = 'fleet_fps'


def read(ctx):
    n = ctx["loops"].get("fetches")
    return n / ctx["frames"] if n is not None else None
