"""sdv_loam_tpu_torch — the PyTorch / CUDA port of sdv_loam_tpu.

LiDAR-assisted semi-direct visual odometry for an NVIDIA H100. The layout
mirrors the JAX package module for module (`ops/photometric.py` here is the
counterpart of `sdv_loam_tpu/ops/photometric.py`, and so on), so every
function can be held against its reference on the same numpy inputs.

  config        typed settings (copied from the JAX package)
  utils/        SE3 Lie ops in torch, pyramid camera calib
  data/         calib/sensor parsers, KITTI reader, synthetic sequences
  ops/          tensor stages; ops/hopper_kernels.py binds the hand-written
                CUDA kernels in csrc/ (built with nvcc at first CUDA use)
  models/       matcher, windowed BA backend
  system/       FullSystem orchestrator (sequential and pipelined), the
                fleets (multi), checkpoint, runner
  utils/hbm.py  device bytes per system, the card's budget, the fleet size
  parallel/     a batch of sequences over several cards (mesh), the
                production programs and a pinned fleet there (dryrun)
  io/, eval/    trajectory writer, telemetry, ATE / RPE

Every op takes its device from its tensor arguments; nothing probes for a
device. This package never imports jax.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry / normal-equation math runs in true float32, the counterpart of
# jax_default_matmul_precision="highest" in the JAX package: TF32 matmuls or
# convolutions keep ~3 decimal digits and destroy pose-composition and
# Jacobian accuracy.
_torch.set_float32_matmul_precision("highest")
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
# One linear-algebra library for every batch size: PyTorch's default
# heuristic sends the same small LU solve to cuSOLVER / cuBLAS or to MAGMA
# depending on how many systems are batched, so a sequence's solves would
# change library between running alone and as a lane of a fleet (and
# MAGMA's unbatched routines hold the host on stream synchronizations).
# cuSOLVER / cuBLAS run every solve on the caller's current stream.
if _torch.backends.cuda.is_built():
    _torch.backends.cuda.preferred_linalg_library("cusolver")

from sdv_loam_tpu_torch.config import Settings  # noqa: E402,F401
