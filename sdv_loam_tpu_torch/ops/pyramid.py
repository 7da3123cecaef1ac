"""Image pyramid with gradients — the `makeImages` stage.

Counterpart of `sdv_loam_tpu/ops/pyramid.py` (reference:
FrameHessian::makeImages, HessianBlocks.cpp:107-167): level l intensity is
the exact 2x2 average of level l-1; per-level central-difference gradients
with zeroed border rows/columns; absSquaredGrad = dx^2 + dy^2, optionally
weighted by the squared gamma-response derivative.
"""

from __future__ import annotations

import torch


def avg_pool2(img: torch.Tensor) -> torch.Tensor:
    """Exact 2x2 average pooling, (H, W) -> (H//2, W//2)."""
    h, w = img.shape
    x = img[: (h // 2) * 2, : (w // 2) * 2]
    # row-major, left to right: the summation order of the 2x2 window
    # reduction in the JAX package's compiled programs
    s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
    return 0.25 * s


def gradients(img: torch.Tensor):
    """Central-difference gradients with zeroed borders."""
    dx = torch.zeros_like(img)
    dy = torch.zeros_like(img)
    dx[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    dy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    return dx, dy


def make_images(color: torch.Tensor, levels: int,
                gamma_grad: torch.Tensor | None = None):
    """Build the per-frame pyramid.

    Args:
      color: (H, W) float32 intensity image on the system's device.
      levels: number of pyramid levels.
      gamma_grad: optional (256,) dB/dI lookup for gradient weighting.

    Returns:
      dI: tuple of (H_l, W_l, 3) tensors [intensity, dx, dy] per level.
      abs_grad: tuple of (H_l, W_l) squared-gradient tensors per level.
    """
    dI = []
    abs_grad = []
    img = color
    for lvl in range(levels):
        if lvl > 0:
            img = avg_pool2(img)
        dx, dy = gradients(img)
        dI.append(torch.stack([img, dx, dy], dim=-1))
        g2 = dx * dx + dy * dy
        if gamma_grad is not None:
            idx = torch.clamp(img.to(torch.int64), 0, 254)
            gw = gamma_grad[idx]
            g2 = g2 * gw * gw
        abs_grad.append(g2)
    return tuple(dI), tuple(abs_grad)
