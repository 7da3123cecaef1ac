"""Hand-written Hopper kernels and their plain PyTorch versions.

Counterpart of `sdv_loam_tpu/ops/pallas_kernels.py`, whose two Pallas TPU
kernels are both on the odometry main path:

  * `dilate_pyramid` (K1, csrc/dilate_pyramid.cu) replaces the chain of
    `dilate_depth_pallas` calls in `build_track_ref`: the hole-filling
    pass of every pyramid level and the 2x2 sum-pools between them, in one
    launch per `build_track_ref`;
  * `distance_transform` (K2, csrc/distance_transform.cu) replaces
    `distance_transform_pallas`: the chamfer distance map behind the
    activation spread test, one launch per keyframe.

Both take one map (H, W) or a stack of lanes (L, H, W) and compute each
lane as the single-map call would.

Dispatch: a CPU tensor goes to the plain version beside each kernel; a CUDA
tensor goes to the kernel, and a failed build or launch raises. There is no
fallback from the kernel to the plain version.

The kernels are compiled with nvcc for sm_90a into a shared library with a
plain C interface (bound with ctypes) under `sdv_loam_tpu_torch/build/`, at
the first CUDA call, from the sources in `csrc/` only; a change of any
source's hash builds a new library. Importing this module never needs nvcc.

`LAUNCHES` counts the kernel launches the card ran (plain-version calls do
not count), so a run can show that the main path went through the kernels;
`LANES` counts the lanes (maps) those launches took, so a fleet run can
show its launches took several sequences at once. A wrapper called while a
stage program is being captured (utils/device_loop.program) launches
nothing then: the capture records the launch, and every replay of the
program counts it.

The same library holds csrc/graph_cond.cu, the conditional (IF and WHILE)
nodes of the captured stage programs (`sdv_cond_begin`, `sdv_cond_set`,
`sdv_cond_end`, `sdv_capture_nodes`, used by utils/device_loop).

Threads: each launch goes to the calling thread's current stream (a fleet
system's own stream), the counts are updated under a lock, and the first
build and load happen once, under another.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from sdv_loam_tpu_torch.utils import device_loop

LAUNCHES = {"dilate_pyramid": 0, "distance_transform": 0}
LANES = {"dilate_pyramid": 0, "distance_transform": 0}

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
SOURCES = ("dilate_pyramid.cu", "distance_transform.cu", "graph_cond.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
DILATE_MAX_LEVELS = 8   # levels one K1 launch takes (csrc/dilate_pyramid.cu)

_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
            LANES[k] = 0


def _count_launch(name: str, lanes: int = 1) -> None:
    log = device_loop.launch_log()
    if log is not None:         # captured: each replay counts it
        log.append((name, lanes))
        return
    count_launches([(name, lanes)])


def count_launches(launches) -> None:
    """Count launches given as (name, lanes) pairs (a replayed program's
    recorded launches)."""
    if not launches:
        return
    with _count_lock:
        for name, lanes in launches:
            LAUNCHES[name] += 1
            LANES[name] += lanes


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the reference the kernels are
# compared with on the card)
# ---------------------------------------------------------------------------

def _shift(x, dy, dx, fill):
    """out[..., y, x] = x[..., y + dy, x + dx], `fill` outside the image."""
    h, w = x.shape[-2:]
    out = torch.full_like(x, fill)
    ys = slice(max(0, -dy), min(h, h - dy))
    xs = slice(max(0, -dx), min(w, w - dx))
    yd = slice(max(0, dy), min(h, h + dy))
    xd = slice(max(0, dx), min(w, w + dx))
    out[..., ys, xs] = x[..., yd, xd]
    return out


# neighbour offsets (dy, dx) in the TPU kernel's summation order
_DIAG_ORDER = ((1, 1), (-1, -1), (1, -1), (-1, 1))     # ul, dr, ur, dl
_CROSS_ORDER = ((0, -1), (0, 1), (-1, 0), (1, 0))      # r, l, d, u


def dilate_depth_plain(idepth: torch.Tensor, weight: torch.Tensor,
                       diagonal: bool):
    """One hole-filling pass over (..., H, W) maps, zero fill outside the
    image, summed in the TPU kernel's order (`_dilate_kernel`)."""
    ssum = torch.zeros_like(idepth)
    nsum = torch.zeros_like(idepth)
    cnt = torch.zeros_like(idepth)
    zero = torch.zeros((), dtype=idepth.dtype, device=idepth.device)
    for dy, dx in (_DIAG_ORDER if diagonal else _CROSS_ORDER):
        si = _shift(idepth, dy, dx, 0.0)
        sw = _shift(weight, dy, dx, 0.0)
        filled = sw > 0
        ssum = ssum + torch.where(filled, si, zero)
        nsum = nsum + torch.where(filled, sw, zero)
        cnt = cnt + filled.to(idepth.dtype)
    fill_ok = (weight <= 0) & (cnt > 0)
    denom = torch.clamp(cnt, min=1.0)
    return (torch.where(fill_ok, ssum / denom, idepth),
            torch.where(fill_ok, nsum / denom, weight))


def sum_pool2(x):
    """2x2 sum-pool of (..., H, W) maps, the odd row and column cropped."""
    h, w = x.shape[-2:]
    x = x[..., : (h // 2) * 2, : (w // 2) * 2]
    # (row-0 pair) + (row-1 pair): the order XLA sums this 2x2 window in
    # the JAX package's build_track_ref (make_images' pooling sums left to
    # right instead), so the pools agree bit for bit
    return ((x[..., 0::2, 0::2] + x[..., 0::2, 1::2])
            + (x[..., 1::2, 0::2] + x[..., 1::2, 1::2]))


def dilate_pyramid_plain(idepth0: torch.Tensor, weight0: torch.Tensor,
                         levels: int):
    """The hole-filling chain of `build_track_ref`: level 0 dilated, then
    per coarser level the 2x2 sum-pool of the level above and its pass
    (diagonal on levels 0-1, the cross on coarser ones). Returns a tuple
    over levels of (idepth, weight), each (..., H_l, W_l)."""
    out = []
    idl, wl = idepth0, weight0
    for lvl in range(levels):
        if lvl > 0:
            idl, wl = sum_pool2(idl), sum_pool2(wl)
        idl, wl = dilate_depth_plain(idl, wl, diagonal=(lvl < 2))
        out.append((idl, wl))
    return tuple(out)


def distance_transform_plain(seed: torch.Tensor, iters: int = 32):
    """`iters` sweeps of 8-neighbour min-plus (+1) relaxation over (..., H,
    W) maps, 1000 outside the image (`_distmap_kernel` /
    `distmap._relax_jnp`)."""
    h, w = seed.shape[-2:]
    d = seed
    for _ in range(iters):
        p = torch.nn.functional.pad(d, (1, 1, 1, 1), value=1000.0)
        m = d
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                m = torch.minimum(m, p[..., 1 + dy:1 + dy + h,
                                       1 + dx:1 + dx + w] + 1.0)
        d = torch.minimum(d, m)
    return d


# ---------------------------------------------------------------------------
# build + bind
# ---------------------------------------------------------------------------

def _source_hash() -> str:
    hsh = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            hsh.update(name.encode() + b"\0" + f.read())
    hsh.update(" ".join(NVCC_FLAGS).encode())
    return hsh.hexdigest()[:16]


def _nvcc() -> str:
    cands = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append(shutil.which("nvcc") or "")
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the Hopper kernels are built with the "
                       "CUDA toolkit's nvcc (set CUDA_HOME)")


def build_library(verbose: bool = False) -> str:
    """Compile csrc/*.cu into build/libsdv_hopper_<hash>.so (no-op when the
    library for the current sources exists). Returns its path."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"libsdv_hopper_{_source_hash()}.so")
    if os.path.exists(path):
        return path
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(CSRC_DIR, s) for s in SOURCES)]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr)
    os.replace(tmp, path)
    return path


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.sdv_dilate_pyramid.argtypes = [vp, vp, vp, ci, ci, ci, ci,
                                               vp]
            lib.sdv_dilate_pyramid.restype = ci
            lib.sdv_distance_transform.argtypes = [vp, vp, vp, ci, ci, ci,
                                                   ci, ci, vp]
            lib.sdv_distance_transform.restype = ci
            ull = ctypes.c_ulonglong
            lib.sdv_cond_begin.argtypes = [vp, vp, vp, ci,
                                           ctypes.POINTER(ull)]
            lib.sdv_cond_begin.restype = ci
            lib.sdv_cond_set.argtypes = [vp, ull, vp]
            lib.sdv_cond_set.restype = ci
            lib.sdv_cond_end.argtypes = [vp, ctypes.POINTER(ull)]
            lib.sdv_cond_end.restype = ci
            lib.sdv_capture_nodes.argtypes = [vp, ctypes.POINTER(ull)]
            lib.sdv_capture_nodes.restype = ci
            _lib = lib
    return _lib


def _check_map(x: torch.Tensor, name: str):
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: float32 required, got {x.dtype}")
    if x.dim() not in (2, 3):
        raise ValueError(f"{name}: (H, W) or (L, H, W) required, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: contiguous tensor required")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def _check_rc(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def _lanes_hw(x: torch.Tensor):
    return (1, *x.shape) if x.dim() == 2 else tuple(x.shape)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def dilate_pyramid(idepth0: torch.Tensor, weight0: torch.Tensor,
                   levels: int):
    """K1: the hole-filling chain of `build_track_ref` over (H, W) or
    (L, H, W) level-0 splat maps; a tuple over levels of (idepth, weight)
    with the input's leading dimensions. CPU -> plain version; CUDA -> one
    launch, all levels in one buffer."""
    _check_map(idepth0, "idepth0")
    _check_map(weight0, "weight0")
    if weight0.shape != idepth0.shape or weight0.device != idepth0.device:
        raise ValueError("idepth0 and weight0 must share shape and device")
    if not 1 <= levels <= DILATE_MAX_LEVELS:
        raise ValueError(f"levels must be in [1, {DILATE_MAX_LEVELS}]")
    if idepth0.device.type == "cpu":
        return dilate_pyramid_plain(idepth0, weight0, levels)
    lib = _load()
    lanes, h, w = _lanes_hw(idepth0)
    lead = idepth0.shape[:-2]
    shapes = [(h, w)]
    for _ in range(levels - 1):
        shapes.append((shapes[-1][0] // 2, shapes[-1][1] // 2))
    sizes = [lanes * hl * wl for hl, wl in shapes]
    # D_0..D_{levels-1}, then the kernel's scratch: at most the pooled
    # maps of the coarser levels, and a counter
    buf = torch.empty(2 * sum(sizes) + 2 * sum(sizes[1:]) + 1,
                      dtype=torch.float32, device=idepth0.device)
    with torch.cuda.device(idepth0.device):
        stream = torch.cuda.current_stream(idepth0.device).cuda_stream
        rc = lib.sdv_dilate_pyramid(idepth0.data_ptr(), weight0.data_ptr(),
                                    buf.data_ptr(), lanes, h, w, levels,
                                    stream)
    _check_rc(rc, "dilate_pyramid")
    if idepth0.numel():
        _count_launch("dilate_pyramid", lanes)
    out, off = [], 0
    for (hl, wl), n in zip(shapes, sizes):
        out.append((buf[off:off + n].view(*lead, hl, wl),
                    buf[off + n:off + 2 * n].view(*lead, hl, wl)))
        off += 2 * n
    return tuple(out)


def distance_transform(seed: torch.Tensor, iters: int = 32):
    """K2: chamfer distance transform of (H, W) or (L, H, W) seed maps,
    any `iters` >= 0. CPU -> plain version; CUDA -> kernel (one launch per
    16 sweeps)."""
    _check_map(seed, "seed")
    if iters < 0:
        raise ValueError("iters must be >= 0")
    if seed.device.type == "cpu":
        return distance_transform_plain(seed, iters)
    lib = _load()
    lanes, h, w = _lanes_hw(seed)
    # the output, and a scratch map that chunks of sweeps ping-pong through
    buf = torch.empty((2, *seed.shape), dtype=torch.float32,
                      device=seed.device)
    out = buf[0]
    with torch.cuda.device(seed.device):
        stream = torch.cuda.current_stream(seed.device).cuda_stream
        rc = lib.sdv_distance_transform(
            seed.data_ptr(), out.data_ptr(), buf[1].data_ptr(), lanes, h, w,
            int(iters), 0, stream)
    _check_rc(rc, "distance_transform")
    if iters and seed.numel():   # 0 sweeps are a copy, not a launch
        _count_launch("distance_transform", lanes)
    return out
