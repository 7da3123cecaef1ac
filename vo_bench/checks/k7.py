"""K7 (`ba_linearize`, in the keyframe program's windowed BA): every
residual linearization against a plain reference of the kernel's
documented arithmetic (`csrc/ba_linearize.cu`, the plain version
`models/backend.linearize_residuals_lanes_plain`, copied here): per
residual (lane, point, target) the FEJ projection through the pair's (R0,
t0), the current projection through (Rc, tc) where the residual is not
taken at the FEJ point, the bounds tests, the 2-D residual against the
matcher's position, its Huber weight and energy, the Jacobians scaled by
the weight's square root, the outlier test against the host's and
target's energy thresholds and the new state; every non-IN residual's
terms zeroed.

The arithmetic: every quantity float32, each operation rounded on its
own (no fused multiply-add), in the order the specification writes it:
R0 @ [x, y, 1] + t idepth as ((R[0] x + R[1] y) + R[2]) + t idepth, a
scalar over a tensor as the tensor's reciprocal times the scalar,
quotients and square roots correctly rounded (taken in float64 and
rounded once, which gives the float32 result on any device). Beside each
quantity the reference carries its terms' magnitude in float64: sums add
their terms' magnitudes, products multiply them, a quotient a / b takes
m(a) / |b| + |a| m(b) / b^2 (so a point near the target's camera plane,
where the projection divides by a difference of terms, gets the room its
rounding needs), a square root the root of its argument's.

The photometric gate (energy_phot, wJI2: plain tensor operations of the
port, not K7) is K7's input: where the caller passes none the dispatcher
computes it before the kernel, and the reference takes it from the call's
outputs, which return it as given. It is not re-derived.

`k7_rel_err`: per residual whose state and projection flag agree, the
largest gap of resF, Jxi, Jc, Jd, the energy and the centre over its
terms' magnitude; the largest over all residuals. `k7_flags_differ`: the
residuals whose new state or projection flag differs. TF32 moves none of
this arithmetic (no matrix product), so the control's variant is the
reference itself."""

import inspect

import torch

PROGRAMS = {"kf_opt": "next"}
TAPS = (("sdv_loam_tpu_torch.models.backend", "linearize_residuals_lanes",
         "K7"),)
NUMBERS = ("k7_rel_err", "k7_flags_differ")
RES_IN, RES_OOB, RES_OUTLIER = 0, 1, 2
OUTPUTS = ("resF", "Jxi", "Jc", "Jd", "energy", "center")


class _V:
    """A float32 value `v` in the kernel's arithmetic and its terms'
    magnitude `m` (float64)."""

    __slots__ = ("v", "m")

    def __init__(self, v, m=None):
        self.v = v
        self.m = v.double().abs() if m is None else m

    def __add__(self, o):
        if isinstance(o, float):
            return _V(self.v + o, self.m + abs(o))
        return _V(self.v + o.v, self.m + o.m)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, float):
            return _V(self.v - o, self.m + abs(o))
        return _V(self.v - o.v, self.m + o.m)

    def __rsub__(self, o):
        return _V(o - self.v, self.m + abs(o))

    def __mul__(self, o):
        return _V(self.v * o.v, self.m * o.m)

    def __neg__(self):
        return _V(-self.v, self.m)


def _recip(b):
    """1 / b, correctly rounded."""
    v = (1.0 / b.v.double()).float()
    return _V(v, 1.0 / b.v.double().abs() + b.m / b.v.double() ** 2)


def _sqrt(a):
    return _V(torch.sqrt(a.v.double()).float(), torch.sqrt(a.m))


def _where(c, a, b):
    return _V(torch.where(c, a.v, b.v), torch.where(c, a.m, b.m))


def linearize(pt_u, pt_v, pt_idepth, pt_host, pt_color, pt_weights,
              res_active, res_state, matcher_px, matcher_valid, pairs,
              dI0_stack, frame_energy_th, K, w, h, huber_th=6.0, gate=None,
              resf_at_fej=True, quad12=None):
    """K7's outputs ({name: _V} for the floats, the state and projection
    flag as tensors) from `backend.linearize_residuals_lanes`'s arguments
    (points (L, N), residual grids (L, N, F), pairs (L, F F, ...)), given
    the gate."""
    L, N = pt_u.shape
    F = frame_energy_th.shape[-1]
    dev = pt_u.device
    f32 = torch.float32
    Kf = K.to(f32)
    fx, fy, cx, cy = (_V(Kf[:, i].reshape(L, 1, 1)) for i in range(4))
    fxi, fyi = _recip(fx), _recip(fy)
    host = pt_host.long().clamp(0, F - 1)
    pidx = host[..., None] * F + torch.arange(F, device=dev)
    lane = torch.arange(L, device=dev)[:, None, None]

    def take(key):
        return pairs[key].to(f32)[lane, pidx]

    R0, t0, Rc, tc = take("R0"), take("t0"), take("Rc"), take("tc")
    u, v, idp = (_V(x.to(f32)[..., None]) for x in (pt_u, pt_v, pt_idepth))
    k0 = (u - cx) * fxi
    k1 = (v - cy) * fyi

    def proj(R, t):
        return [((_V(R[..., i, 0]) * k0 + _V(R[..., i, 1]) * k1)
                 + _V(R[..., i, 2])) + _V(t[..., i]) * idp for i in range(3)]

    ptp = proj(R0, t0)
    drescale = _recip(ptp[2])
    nid0 = idp * drescale
    uu = ptp[0] * drescale
    vv = ptp[1] * drescale
    Ku0 = uu * fx + cx
    Kv0 = vv * fy + cy
    wl, hl = float(w - 3), float(h - 3)
    if resf_at_fej:
        Ku, Kv, nid = Ku0, Kv0, nid0
        pok = (drescale.v > 0) & (Ku0.v > 1.1) & (Kv0.v > 1.1) & \
            (Ku0.v < wl) & (Kv0.v < hl)
    else:
        ptc = proj(Rc, tc)
        drc = _recip(ptc[2])
        nid = idp * drc
        Ku = (ptc[0] * drc) * fx + cx
        Kv = (ptc[1] * drc) * fy + cy
        pok = (drc.v > 0) & (Ku.v > 1.1) & (Kv.v > 1.1) & (Ku.v < wl) & \
            (Kv.v < hl) & (drescale.v > 0)
    oob = (~pok) | (~matcher_valid) | (res_state == RES_OOB) | \
        (~res_active)

    def r0(i, j):
        return _V(R0[..., i, j])

    def t0_(i):
        return _V(t0[..., i])

    dd_x = (drescale * (t0_(0) - t0_(2) * uu)) * fx
    dd_y = (drescale * (t0_(1) - t0_(2) * vv)) * fy
    dCx2 = drescale * (r0(2, 0) * uu - r0(0, 0))
    dCx3 = ((fx * drescale) * (r0(2, 1) * uu - r0(0, 1))) * fyi
    dCy2 = ((fy * drescale) * (r0(2, 0) * vv - r0(1, 0))) * fxi
    dCy3 = drescale * (r0(2, 1) * vv - r0(1, 1))
    zero = _V(torch.zeros_like(uu.v))
    Jc = [k0 * dCx2 + uu, k1 * dCx3, dCx2 + 1.0, dCx3,
          k0 * dCy2, k1 * dCy3 + vv, dCy2, dCy3 + 1.0]
    Jx = [nid0 * fx, zero, (-nid0 * uu) * fx, (-uu * vv) * fx,
          (1.0 + uu * uu) * fx, -vv * fx,
          zero, nid0 * fy, (-nid0 * vv) * fy, -(1.0 + vv * vv) * fy,
          (uu * vv) * fy, uu * fy]

    mpx = matcher_px.to(f32)
    r_0 = Ku - _V(mpx[..., 0])
    r_1 = Kv - _V(mpx[..., 1])
    rnorm = _sqrt(r_0 * r_0 + r_1 * r_1)
    clamped = _V(torch.where(torch.isnan(rnorm.v), rnorm.v,
                             torch.clamp(rnorm.v, min=1e-12)), rnorm.m)
    hub = _V(torch.full_like(rnorm.v, float(huber_th)))
    one = _V(torch.ones_like(rnorm.v))
    hw2 = _where(rnorm.v < huber_th, one, _recip(clamped) * hub)
    energy2d = (hw2 * (rnorm * rnorm)) * (2.0 - hw2)
    hw2s = _where(hw2.v < 1.0, _sqrt(hw2), hw2)

    feth = frame_energy_th.to(f32)
    th = torch.maximum(feth[lane[..., 0], host][..., None],
                       feth[:, None, :])
    outlier = (gate[0] > th) | (gate[1] < 2.0)
    st = torch.where(oob, RES_OOB, torch.where(outlier, RES_OUTLIER, RES_IN))
    st = torch.where(res_active, st, RES_OOB).to(torch.int8)
    zm = st == RES_IN

    def stack(xs, shape):
        out = _V(torch.stack([x.v for x in xs], -1),
                 torch.stack([x.m for x in xs], -1))
        z = zm[..., None]
        scaled = out * _V(hw2s.v[..., None], hw2s.m[..., None])
        return _V(torch.where(z, scaled.v, 0.0).reshape(shape),
                  torch.where(z, scaled.m, 0.0).reshape(shape))

    shape = (L, N, F)
    live = pok & matcher_valid & res_active
    return dict(resF=stack([r_0, r_1], shape + (2,)),
                Jxi=stack(Jx, shape + (2, 6)), Jc=stack(Jc, shape + (2, 4)),
                Jd=stack([dd_x, dd_y], shape + (2,)),
                energy=_V(torch.where(live, energy2d.v, 0.0),
                          torch.where(live, energy2d.m, 0.0)),
                center=_V(torch.stack([Ku.v, Kv.v, nid.v], -1),
                          torch.stack([Ku.m, Kv.m, nid.m], -1)),
                new_state=st, proj_ok=pok)


_SIG = inspect.signature(linearize)


def reference(kernel, args, kwargs, out, low=False):
    """`linearize` of the call, its gate taken from the call's outputs
    where the caller passed none (the control's variant is the same)."""
    a = _SIG.bind(*args, **kwargs).arguments
    if a.get("gate") is None:
        a["gate"] = (out["energy_phot"], out["wJI2"])
    return linearize(**a)


def gaps(got, want):
    """(residuals whose state or projection flag differs, per residual
    the largest gap of the floats over their terms' magnitudes where
    both agree: two NaNs agree, NaN against a number reads inf, a zero
    magnitude admits no gap)."""
    flags = (got["new_state"] != want["new_state"]) | \
        (got["proj_ok"] != want["proj_ok"])
    worst = torch.zeros(flags.shape, dtype=torch.float64,
                        device=flags.device)
    for k in OUTPUTS:
        g, r = getattr(got[k], "v", got[k]).double(), want[k]
        gap = (g - r.v.double()).abs()
        gap = torch.where(torch.isnan(g) & torch.isnan(r.v),
                          torch.zeros_like(gap), gap)
        gap = torch.nan_to_num(gap, nan=float("inf"))
        q = torch.where(gap > 0, gap / r.m, torch.zeros_like(gap))
        q = torch.nan_to_num(q, nan=float("inf"))
        worst = torch.maximum(worst, q.reshape(flags.shape + (-1,))
                              .amax(-1))
    return int(flags.sum()), torch.where(flags, torch.zeros_like(worst),
                                         worst)


def numbers(compared):
    num = dict(k7_rel_err=0.0, k7_flags_differ=0)
    for _, _, _, out, want in compared:
        differ, rows = gaps(out, want)
        num["k7_flags_differ"] += differ
        if rows.numel():
            num["k7_rel_err"] = max(num["k7_rel_err"], float(rows.max()))
    return num
