"""The port's device-memory accounting (`sdv_loam_tpu_torch/utils/hbm.py`)
against the JAX package's (`tests/test_hbm.py`): storage deduplication,
the fleet pick on the same inputs, a 320x96 system's persistent bytes
under the analytic window-stack bound, and no budget on the CPU.
"""

import types

import pytest
import torch

from sdv_loam_tpu.utils import hbm as jhbm
from sdv_loam_tpu_torch.config import Settings
from sdv_loam_tpu_torch.data.synthetic import make_sequence
from sdv_loam_tpu_torch.system.full_system import FullSystem
from sdv_loam_tpu_torch.utils import device_loop, hbm

# the port's CPU ops are small: one intra-op thread per test process
torch.set_num_threads(1)


def test_tree_device_bytes_dedup():
    a = torch.zeros(100, dtype=torch.float32)
    b = torch.zeros(50, dtype=torch.float32)
    assert hbm.tree_device_bytes([a, b]) == 600
    # the same tensor referenced twice counts once
    assert hbm.tree_device_bytes([a, a, {"x": a}]) == 400
    # a view and its base: one storage
    assert hbm.tree_device_bytes((a, a[10:20], a.view(10, 10))) == 400
    # two tensors on one storage (a view alone keeps all of it alive)
    c = torch.zeros(64, dtype=torch.float64)
    d = torch.empty(0).set_(c.untyped_storage(), 8, (4, 4))
    assert hbm.tree_device_bytes([c[::2], d]) == 512
    # only the device asked for
    assert hbm.tree_device_bytes([a, b], device="cpu") == 600
    assert hbm.tree_device_bytes([a, b], device="meta") == 0


def test_tree_device_bytes_sees_a_loop_cache():
    """A system's LoopCache: its programs' static input buffers count."""
    x = torch.zeros(1000)
    cache = device_loop.LoopCache()
    cache.entries["k"] = device_loop._Program([torch.zeros(500), 3])
    fs = types.SimpleNamespace(device=torch.device("cpu"), x=x,
                               view=x[:10], loops=cache)
    assert hbm.system_device_bytes(fs) == 4000 + 2000


@pytest.mark.parametrize("per_system,requested,budget", [
    (0, 8, 10**9), (100_000_000, 8, 10**9), (10**12, 8, 10**9),
    (300_000_000, 8, 68 * 10**9), (2_000_000_000, 8, 68 * 10**9)])
@pytest.mark.parametrize("factor", [4.0, hbm.TEMPORARIES_FACTOR, 7.5])
def test_pick_fleet_size_is_the_jax_packages(per_system, requested, budget,
                                             factor):
    """tests/test_hbm.py's cases (and two at an H100's budget) give the
    JAX function's answer for the same inputs and factor; the default
    factor is `TEMPORARIES_FACTOR`."""
    got = hbm.pick_fleet_size(per_system, requested, factor, budget=budget)
    assert got == jhbm.pick_fleet_size(per_system, requested, factor,
                                       budget=budget)
    assert got >= 1
    assert hbm.pick_fleet_size(per_system, requested, budget=budget) == \
        jhbm.pick_fleet_size(per_system, requested, hbm.TEMPORARIES_FACTOR,
                             budget=budget)


def test_system_device_bytes_bounded():
    """tests/test_hbm.py's bound on the port: a 320x96 system's persistent
    bytes after 10 frames stay under 1.5x the window-stack model
    (dI0_stack, the flat pyramid stack and the per-slot pyramids) plus
    64 MB of pool slack; they hold at least the window stacks."""
    w, h, levels = 320, 96, 4
    seq = make_sequence(n_frames=10, w=w, h=h, step=0.8, lidar_stride=2)
    s = Settings(desired_immature_density=600, desired_point_density=800,
                 n_active_cap=2048, n_immature_cap=2048)
    fs = FullSystem(seq.calib, seq.sensor, s, device="cpu")
    for i in range(10):
        fs.add_active_frame(*seq.get(i))
    fs.flush()
    assert not fs.is_lost

    got = hbm.system_device_bytes(fs)
    T = sum((w >> l) * (h >> l) for l in range(levels))
    stacks = fs.F * (h * w * 3 * 4 + 3 * T * 3 * 4)
    bound = int(1.5 * stacks) + 64_000_000
    assert 0 < got < bound, (got, bound)
    assert got >= hbm.tree_device_bytes(
        [fs.dI0_stack, fs.flat_slots_stack])
    assert got == hbm.tree_device_bytes(vars(fs), "cpu")


def test_no_budget_on_the_cpu():
    """A CPU device has no device-memory budget and no allocator count:
    both raise (a caller on the CPU passes budget=)."""
    with pytest.raises(ValueError, match="budget"):
        hbm.hbm_budget_bytes("cpu")
    with pytest.raises(ValueError):
        hbm.live_device_bytes(torch.device("cpu"))
    assert hbm.pick_fleet_size(10**12, 8, budget=1) == 1
