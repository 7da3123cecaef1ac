"""Device-memory accounting and fleet capacity (counterpart of
`sdv_loam_tpu/utils/hbm.py`).

How many sequences one card holds: each system's persistent device bytes
(`system_device_bytes`: its pools, window stacks, pyramids and the static
buffers of its captured programs), the card's budget (`hbm_budget_bytes`,
from the size the card reports) and `pick_fleet_size`, which sizes the
fleet from the two with a working-set factor calibrated on the card.

Persistent bytes leave out what the caching allocator holds for a moment:
a stage's temporaries, and the part of each captured graph's private pool
that no static buffer occupies. `TEMPORARIES_FACTOR` budgets them: it is
the largest ratio of a fleet run's peak (`torch.cuda.max_memory_allocated`
less what the process held before it) to B x one system's persistent
bytes that the card measured (`chip_smoke.py` phase 9, PERF.md).
"""

from __future__ import annotations

import torch

from sdv_loam_tpu_torch.utils.device_loop import full_device

# The working set of one system per persistent byte. The JAX package's
# factor, 4.0, stays while the card's measured ratio is below it (1.37-1.91
# at B = 1, 4 and 8 on an H100, both presets: PERF.md section 6).
TEMPORARIES_FACTOR = 4.0


def held_tensors(tree):
    """Every tensor reachable from `tree` through dicts, lists, tuples, sets
    and the attributes of plain objects (a LoopCache, its programs and
    loop entries), each container visited once."""
    seen_objects: set = set()
    todo = [tree]
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            yield x
            continue
        if x is None or isinstance(x, (str, bytes, int, float, bool,
                                       type)) or callable(x):
            continue
        if id(x) in seen_objects:
            continue
        seen_objects.add(id(x))
        if isinstance(x, dict):
            todo.extend(x.values())
        elif isinstance(x, (list, tuple, set, frozenset)):
            todo.extend(x)
        elif hasattr(x, "__dict__") and not isinstance(
                x, (torch.device, torch.dtype)):
            todo.extend(vars(x).values())


def device_storages(tree) -> dict:
    """{device: {storage address: bytes}} over the distinct storages behind
    the tensors of a nested structure: a view and its base, or two tensors
    on one storage, give one entry (a view keeps all of it alive)."""
    out: dict = {}
    for t in held_tensors(tree):
        st = t.untyped_storage()
        out.setdefault(t.device, {})[st.data_ptr()] = st.nbytes()
    return out


def tree_device_bytes(tree, device=None) -> int:
    """Bytes of the distinct storages behind the tensors of a nested
    structure (`device_storages`), each storage once. With `device`, only
    tensors on that device count."""
    by_device = device_storages(tree)
    if device is not None:
        by_device = {device: by_device.get(full_device(device), {})}
    return sum(sum(st.values()) for st in by_device.values())


def system_device_bytes(fs) -> int:
    """Persistent device bytes one FullSystem holds on its device: every
    attribute (pools, window stacks, pyramid slots, caches), its
    `LoopCache` (`fs.loops`) with the static input and output buffers of
    its captured programs and loops, each storage once.

    Not seen: a captured graph's private pool beyond those buffers (the
    intermediates its replays reuse), the caching allocator's free
    blocks, and the temporaries of a stage while it runs; the peak of a
    run includes them (`pick_fleet_size`'s factor budgets them)."""
    return tree_device_bytes(vars(fs), fs.device)


def _cuda(device, what: str) -> torch.device:
    d = full_device(device)
    if d.type != "cuda":
        raise ValueError(f"{what}: {d} is not a CUDA device (a CPU device "
                         "has no device-memory budget; pass budget= to "
                         "pick_fleet_size)")
    return d


def live_device_bytes(device) -> int:
    """Bytes the caching allocator has handed out on `device` (a CUDA
    device): every live tensor of every system and the graph pools'
    blocks in use."""
    return int(torch.cuda.memory_allocated(_cuda(device,
                                                 "live_device_bytes")))


def hbm_budget_bytes(device, reserve_frac: float = 0.15) -> int:
    """The usable part of the card's memory: its total
    (`torch.cuda.mem_get_info`) less `reserve_frac` for the CUDA context,
    the kernels' library and fragmentation. Raises for a CPU device."""
    d = _cuda(device, "hbm_budget_bytes")
    _, total = torch.cuda.mem_get_info(d)
    return int(total * (1.0 - reserve_frac))


def pick_fleet_size(per_system_bytes: int, requested: int,
                    temporaries_factor: float = TEMPORARIES_FACTOR,
                    budget: int | None = None) -> int:
    """Largest fleet size <= requested whose working set fits `budget`
    (default: the current CUDA device's `hbm_budget_bytes`), each system
    taking per_system_bytes * temporaries_factor; never below 1."""
    budget = hbm_budget_bytes("cuda") if budget is None else budget
    if per_system_bytes <= 0:
        return requested
    fit = int(budget // (per_system_bytes * temporaries_factor))
    return max(1, min(requested, fit))
