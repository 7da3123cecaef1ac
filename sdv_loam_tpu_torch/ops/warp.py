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
    edge rows/columns replicated. A lane stack (L, H, W, C) packs to
    (L*H*W, 4*C), lane after lane."""
    if img.dim() == 2:
        img = img[..., None]
    if img.dim() == 3:
        img = img[None]
    n, h, w, c = img.shape
    p = tnf.pad(img.permute(0, 3, 1, 2), (0, 1, 0, 1),
                mode="replicate").permute(0, 2, 3, 1)
    q = torch.stack([p[:, :h, :w], p[:, :h, 1:], p[:, 1:, :w],
                     p[:, 1:, 1:]], dim=3)
    return q.reshape(n * h * w, 4 * c)


def bilinear_sample_packed(packed: torch.Tensor, h: int, w: int,
                           x: torch.Tensor, y: torch.Tensor, base=0):
    """`bilinear_sample` semantics from a `pack_bilinear` buffer. `base`
    (broadcastable to x) is the first row of each sample's image in a lane
    stack's pack: lane * H * W."""
    c = packed.shape[-1] // 4
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    ax = (x - x0f).to(packed.dtype)
    ay = (y - y0f).to(packed.dtype)
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    valid = (x0 >= 0) & (x0 <= w - 2) & (y0 >= 0) & (y0 <= h - 2)
    idx = base + torch.clamp(y0, 0, h - 2) * w + torch.clamp(x0, 0, w - 2)
    g = packed.index_select(0, idx.reshape(-1)).reshape(x.shape + (4, c))
    w4 = _corner_weights(ax, ay)
    out = (g * w4[..., None]).sum(dim=-2)
    out = torch.where(valid[..., None], out, torch.zeros((), dtype=out.dtype,
                                                         device=out.device))
    if c == 1:
        out = out[..., 0]
    return out, valid


def quad_from_image(img):
    """(H, W) image -> (H*W, 4) rows [I(x,y), I(x+1,y), I(x,y+1),
    I(x+1,y+1)], edge rows/columns replicated."""
    h, w = img.shape
    p = tnf.pad(img[None, None], (0, 1, 0, 1), mode="replicate")[0, 0]
    q = torch.stack([p[:h, :w], p[:h, 1:], p[1:, :w], p[1:, 1:]], dim=-1)
    return q.reshape(h * w, 4)


def quad_bilinear(quad, base, w, x, y):
    """Bilinear sample from a quad-packed buffer, one row per sample.
    Caller guarantees in-bounds. quad (T, 4) or (T, 4*C); base, w
    broadcastable to x; returns x.shape (4-wide) or x.shape + (C,)."""
    c = quad.shape[-1] // 4
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    ax = (x - x0).to(quad.dtype)
    ay = (y - y0).to(quad.dtype)
    idx = base + y0.to(torch.int64) * w + x0.to(torch.int64)
    # non-finite coordinates give out-of-range rows: they read NaN, like
    # the "fill" mode of the reference's gather
    ok = (idx >= 0) & (idx < quad.shape[0])
    g = quad.index_select(0, torch.where(ok, idx, torch.zeros_like(idx))
                          .reshape(-1)).reshape(x.shape + (4 * c,))
    w4 = torch.stack([(1 - ax) * (1 - ay), ax * (1 - ay),
                      (1 - ax) * ay, ax * ay], dim=-1)
    nan = torch.full((), float("nan"), dtype=quad.dtype, device=quad.device)
    if c == 1:
        return torch.where(ok, (g * w4).sum(dim=-1), nan)
    g = g.reshape(x.shape + (4, c))
    return torch.where(ok[..., None], (g * w4[..., None]).sum(dim=-2), nan)
