"""Image pyramid with gradients — the `makeImages` stage.

Counterpart of `sdv_loam_tpu/ops/pyramid.py` (reference:
FrameHessian::makeImages, HessianBlocks.cpp:107-167): level l intensity is
the exact 2x2 average of level l-1; per-level central-difference gradients
with zeroed border rows/columns; absSquaredGrad = dx^2 + dy^2, optionally
weighted by the squared gamma-response derivative.

The pyramid is one stage program (`utils/device_loop.program`,
"pyramid"), as the JAX package compiles `make_images`: a key per image
shape, lanes, level count and whether `gamma_grad` is given.
"""

from __future__ import annotations

import torch

from sdv_loam_tpu_torch.utils import device_loop


def avg_pool2(img: torch.Tensor) -> torch.Tensor:
    """Exact 2x2 average pooling over the last two dimensions,
    (..., H, W) -> (..., H//2, W//2)."""
    h, w = img.shape[-2:]
    x = img[..., : (h // 2) * 2, : (w // 2) * 2]
    # row-major, left to right: the summation order of the 2x2 window
    # reduction in the JAX package's compiled programs
    s = x[..., 0::2, 0::2] + x[..., 0::2, 1::2] + x[..., 1::2, 0::2] \
        + x[..., 1::2, 1::2]
    return 0.25 * s


def gradients(img: torch.Tensor):
    """Central-difference gradients with zeroed borders (last two dims)."""
    dx = torch.zeros_like(img)
    dy = torch.zeros_like(img)
    dx[..., :, 1:-1] = 0.5 * (img[..., :, 2:] - img[..., :, :-2])
    dy[..., 1:-1, :] = 0.5 * (img[..., 2:, :] - img[..., :-2, :])
    return dx, dy


def make_images(color: torch.Tensor, levels: int,
                gamma_grad: torch.Tensor | None = None):
    """Build the per-frame pyramid.

    Args:
      color: (H, W) float32 intensity image on the system's device, or a
        stack (L, H, W) of L frames.
      levels: number of pyramid levels.
      gamma_grad: optional (256,) dB/dI lookup for gradient weighting.

    Returns:
      dI: tuple of (H_l, W_l, 3) tensors [intensity, dx, dy] per level
        ((L, H_l, W_l, 3) for a stack).
      abs_grad: tuple of (H_l, W_l) squared-gradient tensors per level.
    """
    single = color.dim() == 2
    x = dict(color=color[None] if single else color)
    if gamma_grad is not None:
        x["gamma_grad"] = gamma_grad
    dI, abs_grad = device_loop.program("pyramid", _pyramid_program, x,
                                       dict(levels=int(levels)))
    if single:
        return tuple(d[0] for d in dI), tuple(a[0] for a in abs_grad)
    return tuple(dI), tuple(abs_grad)


def _pyramid_program(x, levels):
    dI = []
    abs_grad = []
    img = x["color"]
    gamma_grad = x.get("gamma_grad")
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


def make_images_batch(colors: torch.Tensor, levels: int):
    """L-frame fleet pyramid (the JAX package's vmap of make_images): one
    program for a (L, H, W) stack. Returns per-lane pyramids, lane
    l's levels being views into the stacked levels."""
    dI, abs_grad = make_images(colors, levels)
    return [(tuple(d[i] for d in dI), tuple(a[i] for a in abs_grad))
            for i in range(colors.shape[0])]
