"""K8's share of its roofline over the traced rounds: the sum of its
calls' bounds (`vo_bench/bounds.py`) over the sum of the device times of
its three launches (the tiles' sums, their sum in tile order, the
transport). A call's lanes are its tiles launch's grid's second size,
its points and frame slots the cell's `Settings` caps (`n_active_cap`,
`n_frames_cap`), which the keyframe program's BA runs at; a call whose
tiles do not match them counts the fewest points its grid admits, a
floor."""

from vo_bench import bounds

LAYER = 'kernels (ops/hopper_kernels, csrc/)'
UNIT = '%'
SOURCE = 'device_trace'
MOVES = 'fleet_fps'
TILES = "ba_acc_tiles_kernel"
KERNELS = (TILES, "ba_acc_sum_kernel", "ba_acc_stitch_kernel")
TILE = 128             # points a tile (csrc/ba_accumulate.cu)


def read(ctx):
    tr = ctx["trace"]
    if not tr:
        return None
    n_cap, f = ctx["settings"].n_active_cap, ctx["settings"].n_frames_cap
    bound = busy = 0.0
    for name, dur, grid in tr["kernels"]:
        if not any(k in name for k in KERNELS):
            continue
        busy += dur
        if TILES in name and len(grid) >= 2:
            tiles, lanes = grid[0], grid[1]
            n = n_cap if -(-n_cap // TILE) == tiles else (tiles - 1) * TILE + 1
            bound += bounds.ba_accumulate(lanes, n, f)
    return 100.0 * bound / busy if busy > 0 else None
