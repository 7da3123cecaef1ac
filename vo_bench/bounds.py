"""The yardstick of the kernels' roofline shares: one H100's published
peaks and the operations and bytes each kernel launch needs.

Copied from the port's `eval/kernel_timing.py` at the time the benchmark
was defined (the port may change; this may not): a launch's bound is the
larger of its bytes over the HBM bandwidth and its operations over the
float32 rate outside the tensor cores.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound_s(nbytes, ops):
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def track_res_gs(rows, n, lanes):
    """K3 over `rows` rows of `n` points (pools of `lanes` lanes): the
    pools read once (17 bytes a point), one 48-byte bilinear support per
    point and row, the per-row inputs and outputs; ~230 operations per
    point and row."""
    nbytes = 17 * lanes * n + 48 * rows * n + rows * (4 * 20 + 8 + 4 * 76)
    return bound_s(nbytes, 230 * rows * n)


# K4 per row: the step reads 380 bytes (H, b, lambda, T, the affine state,
# the exposures and the reference affine), writes 112, ~650 operations;
# the accept reads 24 + 300 + 72 + 45 bytes, writes 397, ~30 operations
LM_STEP = (380 + 112, 650)
LM_STEP_OWN_BYTES = 16 + 112
LM_ACCEPT = (24 + 300 + 72 + 45 + 397, 30)


def lm_update(rows, launch):
    """One K4 launch over `rows` rows: "step" (once per LM call) or
    "accept_step" (once per LM iteration: the accept, then the step from
    the carries it selected)."""
    if launch == "step":
        return bound_s(rows * LM_STEP[0], rows * LM_STEP[1])
    return bound_s(rows * (LM_ACCEPT[0] + LM_STEP_OWN_BYTES),
                   rows * (LM_ACCEPT[1] + LM_STEP[1]))


def ba_linearize(lanes, n, f):
    """K7 over `lanes` windows of `n` points and `f` frame slots: per
    residual 19 bytes read (the matcher's position, its flags and state,
    the gate's two values) and 114 written (resF, Jxi, Jc, Jd, the
    energy, the centre, the state, proj_ok), per point 20 read, per lane
    its pairs, thresholds and intrinsics; ~120 float32 operations a
    residual."""
    res = lanes * n * f
    nbytes = 133 * res + 20 * lanes * n + lanes * (96 * f * f + 4 * f + 16)
    return bound_s(nbytes, 120 * res)


def ba_accumulate(lanes, n, f):
    """K8 (its three launches) over `lanes` windows of `n` points and `f`
    frame slots: per residual its terms read once (97 bytes: Jc, Jxi, Jd,
    resF, the active flag), per point 14 read and 20 + 4 D written (Hdd,
    bd, HdiF, n_act, Vpt), per lane the adjoints read and the two (D, D)
    systems and their b written (the tiles' scratch is not counted);
    float32 operations: per residual its pair block and b (65 terms of 2
    products and 2 sums), JpJd and the point sums (42), its Vpt columns
    (144), per point the Schur entries (3 each)."""
    D = 4 + 6 * f
    res, pts = lanes * n * f, lanes * n
    nbytes = 97 * res + pts * (34 + 4 * D) + lanes * (
        288 * f * f + 8 * D * D + 8 * D)
    ops = res * (4 * 65 + 42 + 144) + pts * 3 * (D * (D + 1) // 2 + D)
    return bound_s(nbytes, ops)
