"""Hand-written Hopper kernels and their plain PyTorch versions.

Counterpart of `sdv_loam_tpu/ops/pallas_kernels.py`, whose two Pallas TPU
kernels are both on the odometry main path:

  * `dilate_depth` (K1, csrc/dilate_depth.cu) replaces `dilate_depth_pallas`:
    one hole-filling pass of the tracking-reference depth maps, four
    launches per `build_track_ref`;
  * `distance_transform` (K2, csrc/distance_transform.cu) replaces
    `distance_transform_pallas`: the chamfer distance map behind the
    activation spread test, one launch per keyframe.

Dispatch: a CPU tensor goes to the plain version beside each kernel; a CUDA
tensor goes to the kernel, and a failed build or launch raises. There is no
fallback from the kernel to the plain version.

The kernels are compiled with nvcc for sm_90a into a shared library with a
plain C interface (bound with ctypes) under `sdv_loam_tpu_torch/build/`, at
the first CUDA call, from the sources in `csrc/` only; a change of any
source's hash builds a new library. Importing this module never needs nvcc.

`LAUNCHES` counts kernel launches (plain-version calls do not count), so a
run can show that the main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

LAUNCHES = {"dilate_depth": 0, "distance_transform": 0}

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
SOURCES = ("dilate_depth.cu", "distance_transform.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
DISTMAP_MAX_ITERS = 32     # the kernel's halo width (csrc/distance_transform.cu)

_lib = None
_lib_lock = threading.Lock()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the reference the kernels are
# compared with on the card)
# ---------------------------------------------------------------------------

def _shift(x, dy, dx, fill):
    """out[y, x] = x[y + dy, x + dx], `fill` outside the image."""
    h, w = x.shape
    out = torch.full_like(x, fill)
    ys = slice(max(0, -dy), min(h, h - dy))
    xs = slice(max(0, -dx), min(w, w - dx))
    yd = slice(max(0, dy), min(h, h + dy))
    xd = slice(max(0, dx), min(w, w + dx))
    out[ys, xs] = x[yd, xd]
    return out


# neighbour offsets (dy, dx) in the TPU kernel's summation order
_DIAG_ORDER = ((1, 1), (-1, -1), (1, -1), (-1, 1))     # ul, dr, ur, dl
_CROSS_ORDER = ((0, -1), (0, 1), (-1, 0), (1, 0))      # r, l, d, u


def dilate_depth_plain(idepth: torch.Tensor, weight: torch.Tensor,
                       diagonal: bool):
    """One hole-filling pass, zero fill outside the image, summed in the
    TPU kernel's order (`_dilate_kernel`)."""
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


def distance_transform_plain(seed: torch.Tensor, iters: int = 32):
    """`iters` sweeps of 8-neighbour min-plus (+1) relaxation, 1000 outside
    the image (`_distmap_kernel` / `distmap._relax_jnp`)."""
    h, w = seed.shape
    d = seed
    for _ in range(iters):
        p = torch.nn.functional.pad(d[None, None], (1, 1, 1, 1),
                                    value=1000.0)[0, 0]
        m = d
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                m = torch.minimum(m, p[1 + dy:1 + dy + h,
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
            lib.sdv_dilate_depth.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
            lib.sdv_dilate_depth.restype = ci
            lib.sdv_distance_transform.argtypes = [vp, vp, ci, ci, ci, vp]
            lib.sdv_distance_transform.restype = ci
            _lib = lib
    return _lib


def _check_map(x: torch.Tensor, name: str):
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: float32 required, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{name}: (H, W) required, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: contiguous tensor required")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def _check_rc(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def dilate_depth(idepth: torch.Tensor, weight: torch.Tensor, diagonal: bool):
    """K1: one hole-filling pass. CPU -> plain version; CUDA -> kernel."""
    _check_map(idepth, "idepth")
    _check_map(weight, "weight")
    if weight.shape != idepth.shape or weight.device != idepth.device:
        raise ValueError("idepth and weight must share shape and device")
    if idepth.device.type == "cpu":
        return dilate_depth_plain(idepth, weight, diagonal)
    lib = _load()
    h, w = idepth.shape
    out_i = torch.empty_like(idepth)
    out_w = torch.empty_like(weight)
    with torch.cuda.device(idepth.device):
        stream = torch.cuda.current_stream(idepth.device).cuda_stream
        rc = lib.sdv_dilate_depth(idepth.data_ptr(), weight.data_ptr(),
                                  out_i.data_ptr(), out_w.data_ptr(),
                                  h, w, int(bool(diagonal)), stream)
    _check_rc(rc, "dilate_depth")
    LAUNCHES["dilate_depth"] += 1
    return out_i, out_w


def distance_transform(seed: torch.Tensor, iters: int = 32):
    """K2: chamfer distance transform. CPU -> plain version; CUDA ->
    kernel (iters <= 32, the kernel's halo)."""
    _check_map(seed, "seed")
    if seed.device.type == "cpu":
        return distance_transform_plain(seed, iters)
    if not 0 <= iters <= DISTMAP_MAX_ITERS:
        raise ValueError(f"iters must be in [0, {DISTMAP_MAX_ITERS}]")
    lib = _load()
    h, w = seed.shape
    out = torch.empty_like(seed)
    with torch.cuda.device(seed.device):
        stream = torch.cuda.current_stream(seed.device).cuda_stream
        rc = lib.sdv_distance_transform(seed.data_ptr(), out.data_ptr(),
                                        h, w, int(iters), stream)
    _check_rc(rc, "distance_transform")
    LAUNCHES["distance_transform"] += 1
    return out
