"""Bilinear sampling / gather primitives.

Counterpart of `sdv_loam_tpu/ops/warp.py` (reference interpolation family,
globalFuncs.h:15-163). Samplers take coordinate tensors and return a
validity mask; out-of-bounds samples return 0 with mask False.
"""

from __future__ import annotations

import torch
import torch.nn.functional as tnf


def _corner_weights(ax, ay):
    return torch.stack([(1.0 - ax) * (1.0 - ay), ax * (1.0 - ay),
                        (1.0 - ax) * ay, ax * ay], dim=-1)


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Sample `img` ((H, W) or (H, W, C)) at float coords (x, y).

    Returns (values (..., C) or (...,), valid (...,)): 0 outside, valid where
    the full 2x2 support is inside."""
    return bilinear_sample_packed(pack_bilinear(img), img.shape[0],
                                  img.shape[1], x, y)


def pack_bilinear(img: torch.Tensor) -> torch.Tensor:
    """Pack each pixel's 2x2 bilinear support into one row: (H, W) ->
    (H*W, 4); (H, W, C) -> (H*W, 4*C), corner-major [c00, c10, c01, c11] x C,
    edge rows/columns replicated."""
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    h, w, c = img.shape
    p = tnf.pad(img.permute(2, 0, 1)[None], (0, 1, 0, 1),
                mode="replicate")[0].permute(1, 2, 0)
    q = torch.stack([p[:h, :w], p[:h, 1:], p[1:, :w], p[1:, 1:]], dim=2)
    return q.reshape(h * w, 4 * c)


def bilinear_sample_packed(packed: torch.Tensor, h: int, w: int,
                           x: torch.Tensor, y: torch.Tensor):
    """`bilinear_sample` semantics from a `pack_bilinear` buffer."""
    c = packed.shape[-1] // 4
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    ax = (x - x0f).to(packed.dtype)
    ay = (y - y0f).to(packed.dtype)
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    valid = (x0 >= 0) & (x0 <= w - 2) & (y0 >= 0) & (y0 <= h - 2)
    idx = torch.clamp(y0, 0, h - 2) * w + torch.clamp(x0, 0, w - 2)
    g = packed.index_select(0, idx.reshape(-1)).reshape(x.shape + (4, c))
    w4 = _corner_weights(ax, ay)
    out = (g * w4[..., None]).sum(dim=-2)
    out = torch.where(valid[..., None], out, torch.zeros((), dtype=out.dtype,
                                                         device=out.device))
    if c == 1:
        out = out[..., 0]
    return out, valid


def gather_patches(img: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
                   offsets: torch.Tensor):
    """Bilinear-sample a fixed (P, 2) offset pattern around each center.
    Returns (N, P[, C]) samples and (N, P) validity."""
    ox = offsets[:, 0].to(torch.float32)
    oy = offsets[:, 1].to(torch.float32)
    return bilinear_sample(img, cx[:, None] + ox[None, :],
                           cy[:, None] + oy[None, :])
