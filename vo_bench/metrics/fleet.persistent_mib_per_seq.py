"""What one sequence's system holds on the card at the window's end
(`hbm.system_device_bytes`: its tensors and its programs' static buffers,
each storage once), the mean over the fleet's systems."""

LAYER = 'fleet capacity (utils/hbm)'
UNIT = 'MiB'
SOURCE = 'program_counter'
MOVES = 'mib_per_seq'


def read(ctx):
    b = ctx["persistent_bytes"]
    return sum(b) / len(b) / 2**20 if b else None
