"""K7's share of its roofline over the traced rounds: the sum of its
launches' bounds (`vo_bench/bounds.py`) over the sum of their device
times. A launch's lanes are its grid's second size; its points and frame
slots the cell's `Settings` caps (`n_active_cap`, `n_frames_cap`), which
the keyframe program's BA runs at; a launch whose grid does not match
them counts the fewest residuals its grid admits, a floor."""

from vo_bench import bounds

LAYER = 'kernels (ops/hopper_kernels, csrc/)'
UNIT = '%'
SOURCE = 'device_trace'
MOVES = 'fleet_fps'
KERNEL = "ba_linearize_kernel"
THREADS = 256          # residuals a block (csrc/ba_linearize.cu)


def read(ctx):
    tr = ctx["trace"]
    if not tr:
        return None
    n_cap, f = ctx["settings"].n_active_cap, ctx["settings"].n_frames_cap
    bound = busy = 0.0
    for name, dur, grid in tr["kernels"]:
        if KERNEL not in name or len(grid) < 2:
            continue
        blocks, lanes = grid[0], grid[1]
        res = n_cap * f
        if -(-res // THREADS) != blocks:
            res = (blocks - 1) * THREADS + 1
        bound += bounds.ba_linearize(lanes, res / f, f)
        busy += dur
    return 100.0 * bound / busy if busy > 0 else None
