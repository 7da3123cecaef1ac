"""Pinhole camera model and pyramid calibration schedule.

Reproduces the semantics of the reference's global calib
(src/util/globalCalib.cpp:20-80): per-level sizes are exact halvings, the
number of levels used is chosen by halving until the area drops below 5000
pixels (capped at PYR_LEVELS=6), and per-level intrinsics follow

    fx[l] = fx[l-1] * 0.5
    cx[l] = (cx[0] + 0.5) / 2^l - 0.5        (globalCalib.cpp:66-70)

Instead of mutable globals, calibration is an immutable host-side object
whose per-level K values are baked into jitted stage functions as static
constants (shapes) + small device arrays (values).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sdv_loam_tpu_torch.config import PYR_LEVELS


@dataclasses.dataclass(frozen=True)
class PyramidCalib:
    """Per-level pinhole intrinsics for an image pyramid."""

    w: tuple[int, ...]          # level widths
    h: tuple[int, ...]          # level heights
    fx: tuple[float, ...]
    fy: tuple[float, ...]
    cx: tuple[float, ...]
    cy: tuple[float, ...]

    @property
    def levels(self) -> int:
        return len(self.w)

    def K(self, lvl: int) -> np.ndarray:
        return np.array(
            [
                [self.fx[lvl], 0.0, self.cx[lvl]],
                [0.0, self.fy[lvl], self.cy[lvl]],
                [0.0, 0.0, 1.0],
            ],
            dtype=np.float64,
        )

    def Ki(self, lvl: int) -> np.ndarray:
        return np.linalg.inv(self.K(lvl))

    def intrinsics_vec(self, lvl: int = 0) -> np.ndarray:
        """[fx, fy, cx, cy] — the CPARS calib state (NumType.h:31)."""
        return np.array(
            [self.fx[lvl], self.fy[lvl], self.cx[lvl], self.cy[lvl]],
            dtype=np.float64,
        )


def num_pyr_levels(w: int, h: int, max_levels: int = PYR_LEVELS) -> int:
    """Level count rule of globalCalib.cpp:22-30: halve while divisible by 2
    and area > 5000 px, up to max_levels."""
    wl, hl, levels = w, h, 1
    while wl % 2 == 0 and hl % 2 == 0 and wl * hl > 5000 and levels < max_levels:
        wl //= 2
        hl //= 2
        levels += 1
    return levels


def make_pyramid_calib(w: int, h: int, fx: float, fy: float, cx: float, cy: float,
                       max_levels: int = PYR_LEVELS) -> PyramidCalib:
    levels = num_pyr_levels(w, h, max_levels)
    ws, hs = [w], [h]
    fxs, fys, cxs, cys = [fx], [fy], [cx], [cy]
    for lvl in range(1, levels):
        ws.append(w >> lvl)
        hs.append(h >> lvl)
        fxs.append(fxs[-1] * 0.5)
        fys.append(fys[-1] * 0.5)
        cxs.append((cx + 0.5) / (1 << lvl) - 0.5)
        cys.append((cy + 0.5) / (1 << lvl) - 0.5)
    return PyramidCalib(tuple(ws), tuple(hs), tuple(fxs), tuple(fys),
                        tuple(cxs), tuple(cys))
