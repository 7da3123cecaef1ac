"""K7's arithmetic (csrc/ba_linearize.cu) emulated on the CPU in tensor
operations: every quantity float32, each operation rounded on its own, in
the kernel's order (the plain version's products R0 @ [x, y, 1] and the
residual's norm, which are library reductions there, summed left to
right here; a scalar over a tensor, as torch forms it, the tensor's
reciprocal times the scalar; square roots correctly rounded, as the
kernel's are), the pairs taken per residual. On the same inputs the
kernel gives these bits.

Used by tests/test_torch_ba_kernels.py's CPU tests (against the plain
version) and its card tests (the kernel against this emulation), so it
imports neither JAX nor the card.
"""

import numpy as np
import torch

RES_IN, RES_OOB, RES_OUTLIER = 0, 1, 2


def _sqrt(x):
    """The correctly rounded float32 square root (the kernel's
    __fsqrt_rn): numpy's; torch's CPU sqrt may round otherwise."""
    return torch.from_numpy(np.sqrt(x.numpy()))


def _clamp_min(x, lo):
    """torch.clamp's NaN-propagating lower bound, as the kernel forms it."""
    return torch.where(torch.isnan(x), x, torch.clamp(x, min=lo))


def linearize(pt_u, pt_v, pt_idepth, pt_host, res_active, res_state,
              matcher_px, matcher_valid, pairs, frame_energy_th, K, gate,
              w, h, huber_th=6.0, resf_at_fej=True):
    """`hopper_kernels.ba_linearize`'s results from the same arguments,
    on the CPU."""
    L, N = pt_u.shape
    F = frame_energy_th.shape[-1]
    f32 = torch.float32
    one = torch.ones((), dtype=f32)
    fx, fy, cx, cy = (K[:, i].to(f32).reshape(L, 1, 1) for i in range(4))
    fxi, fyi = one / fx, one / fy
    host = pt_host.long().clamp(0, F - 1)
    pidx = host[..., None] * F + torch.arange(F)               # (L, N, F)
    lane = torch.arange(L)[:, None, None]

    def take(key):
        return pairs[key].to(f32)[lane, pidx]

    R0, t0, Rc, tc = take("R0"), take("t0"), take("Rc"), take("tc")
    u, v, idp = (x.to(f32)[..., None] for x in (pt_u, pt_v, pt_idepth))
    k0 = (u - cx) * fxi
    k1 = (v - cy) * fyi

    def proj(R, t):
        return [((R[..., i, 0] * k0 + R[..., i, 1] * k1) + R[..., i, 2])
                + t[..., i] * idp for i in range(3)]

    ptp = proj(R0, t0)
    drescale = one / ptp[2]
    nid0 = idp * drescale
    uu = ptp[0] * drescale
    vv = ptp[1] * drescale
    Ku0 = uu * fx + cx
    Kv0 = vv * fy + cy
    wl, hl = float(w - 3), float(h - 3)
    if resf_at_fej:
        Ku, Kv, nid = Ku0, Kv0, nid0
        pok = (drescale > 0) & (Ku0 > 1.1) & (Kv0 > 1.1) & (Ku0 < wl) & \
            (Kv0 < hl)
    else:
        ptc = proj(Rc, tc)
        drc = one / ptc[2]
        nid = idp * drc
        Ku = (ptc[0] * drc) * fx + cx
        Kv = (ptc[1] * drc) * fy + cy
        pok = (drc > 0) & (Ku > 1.1) & (Kv > 1.1) & (Ku < wl) & (Kv < hl) & \
            (drescale > 0)
    oob = (~pok) | (~matcher_valid) | (res_state == RES_OOB) | (~res_active)

    dd_x = (drescale * (t0[..., 0] - t0[..., 2] * uu)) * fx
    dd_y = (drescale * (t0[..., 1] - t0[..., 2] * vv)) * fy
    dCx2 = drescale * (R0[..., 2, 0] * uu - R0[..., 0, 0])
    dCx3 = ((fx * drescale) * (R0[..., 2, 1] * uu - R0[..., 0, 1])) * fyi
    dCx0, dCx1 = k0 * dCx2, k1 * dCx3
    dCy2 = ((fy * drescale) * (R0[..., 2, 0] * vv - R0[..., 1, 0])) * fxi
    dCy3 = drescale * (R0[..., 2, 1] * vv - R0[..., 1, 1])
    dCy0, dCy1 = k0 * dCy2, k1 * dCy3
    zero = torch.zeros_like(uu)
    Jc = torch.stack([dCx0 + uu, dCx1, dCx2 + 1.0, dCx3,
                      dCy0, dCy1 + vv, dCy2, dCy3 + 1.0], -1)
    Jx = torch.stack([nid0 * fx, zero, (-nid0 * uu) * fx, (-uu * vv) * fx,
                      (1.0 + uu * uu) * fx, -vv * fx,
                      zero, nid0 * fy, (-nid0 * vv) * fy,
                      -(1.0 + vv * vv) * fy, (uu * vv) * fy, uu * fy], -1)

    r0 = Ku - matcher_px[..., 0]
    r1 = Kv - matcher_px[..., 1]
    rnorm = _sqrt(r0 * r0 + r1 * r1)
    hw2 = torch.where(rnorm < huber_th, torch.ones_like(rnorm),
                      (one / _clamp_min(rnorm, 1e-12)) * huber_th)
    energy2d = (hw2 * (rnorm * rnorm)) * (2.0 - hw2)
    hw2s = torch.where(hw2 < 1.0, _sqrt(hw2), hw2)

    th = torch.maximum(frame_energy_th[lane[..., 0], host][..., None],
                       frame_energy_th[:, None, :])
    outlier = (gate[0] > th) | (gate[1] < 2.0)
    st = torch.where(oob, RES_OOB, torch.where(outlier, RES_OUTLIER, RES_IN))
    st = torch.where(res_active, st, RES_OOB).to(torch.int8)
    zm = st == RES_IN
    z = torch.zeros((), dtype=f32)
    resF = torch.where(zm[..., None], torch.stack([r0, r1], -1)
                       * hw2s[..., None], z)
    Jd = torch.where(zm[..., None], torch.stack([dd_x, dd_y], -1)
                     * hw2s[..., None], z)
    Jxi = torch.where(zm[..., None], Jx * hw2s[..., None], z)
    Jc = torch.where(zm[..., None], Jc * hw2s[..., None], z)
    return dict(resF=resF, Jxi=Jxi.reshape(L, N, F, 2, 6),
                Jc=Jc.reshape(L, N, F, 2, 4), Jd=Jd, new_state=st,
                energy=torch.where(pok & matcher_valid & res_active,
                                   energy2d, z),
                energy_phot=gate[0], wJI2=gate[1],
                center=torch.stack([Ku, Kv, nid], -1), proj_ok=pok)


# the comparison against the plain version (its tolerances and their
# readings are stated in sdv_loam_tpu_torch/eval/kernel_timing.py)
from sdv_loam_tpu_torch.eval.kernel_timing import (  # noqa: E402
    BA_LIN_NEAR_PX as NEAR_PX, BA_LIN_NEAR_Z as NEAR_Z, BA_LIN_REL as REL,
    ba_lin_gaps as gaps, ba_lin_near as near)

__all__ = ["linearize", "NEAR_PX", "NEAR_Z", "REL", "gaps", "near"]
