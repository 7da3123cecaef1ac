"""The windowed BA's hand-written kernels: K7 (`hopper_kernels.ba_linearize`,
csrc/ba_linearize.cu) and K8 (`hopper_kernels.ba_accumulate`,
csrc/ba_accumulate.cu), against their plain versions
(`backend.linearize_residuals_lanes_plain`, `backend._accumulate_plain`)
and the CPU emulations of their arithmetic (tests/k7_lin.py,
tests/k8_acc.py).

On the CPU (no card): the plain versions unchanged bit for bit against the
composition they had before the kernels (`_linearize_before`,
`_accumulate_before` below), the CPU dispatch to them with the kernels'
library made unloadable, the launch counters' names, the emulations
against the plain versions, and the wrappers' refusals.

On the card (`cuda`; imports no JAX, so it runs with `--noconftest`):

    python -m pytest --noconftest -m cuda tests/test_torch_ba_kernels.py

K7 and K8 against their plain versions and bit for bit against the
emulations at the main path's shapes (default: N 4096, F 8, 1200x360;
fast: N 2048, F 7, 424x320) with L in {1, 3, 8}; two launches and a lane
alone bit for bit as among lanes; a recorded keyframe program's replay
bit for bit its eager form with both kernels inside, and their device
counters against the linearizations and accumulations it ran.

Tolerances (read on the CPU: the emulations against the plain versions
differ by at most 1.2e-7 of a value's own scale for K7 and 3.4e-7 of a
sum's terms' magnitudes for K8):
  * K7: states equal except at residuals whose projection lies within
    k7_lin.NEAR_PX of a bounds threshold, or whose point lies within
    k7_lin.NEAR_Z of the target's camera plane (`k7_lin.near`), where the
    plain version's library products may round to the other side; there
    and wherever the states differ nothing else is compared. Elsewhere
    each float within K7_REL (k7_lin.REL: a few ulps of a pixel position
    through the Huber weight) of its output's scale in the lane (its
    largest magnitude there, and for resF and the energy the lane's pixel
    positions: `k7_lin.gaps`; a residual's own magnitude is no scale where
    its terms cancel, as the depth Jacobian's do near the epipole: the
    card's plain version rounds those 1e-3 of their own size apart; the
    first card readings at 1e-5 failed at L = 8 by 1.6e-5 and 3.2e-5);
  * K8: H_top, b_top, H_sc, b_sc within K8_REL of the sum of their terms'
    magnitudes (the plain composition in float64 on the terms' absolute
    values); Vpt, Hdd, bd, HdiF element by element within K8_REL of their
    terms' magnitudes; n_act equal.
"""

import numpy as np
import pytest
import torch

import k7_lin
import k8_acc
from sdv_loam_tpu_torch.eval import kernel_timing as kt
from sdv_loam_tpu_torch.models import backend as B
from sdv_loam_tpu_torch.ops import hopper_kernels as hk

K7_REL = k7_lin.REL
K8_REL = k8_acc.REL
ACC_NAMES = k8_acc.NAMES
# the main path's shapes: (N, F, w, h)
PRESETS = {"default": (4096, 8, 1200, 360), "fast": (2048, 7, 424, 320)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

# a BA window's inputs (seeded; see there) and the linearization's
# positional arguments
_case = kt.ba_scene
_lin_args = kt.ba_lin_args


def _emu_lin(x, w, h, resf_at_fej):
    keys = ("pt_u", "pt_v", "pt_idepth", "pt_host", "res_active",
            "res_state", "matcher_px", "matcher_valid", "frame_energy_th",
            "K")
    return k7_lin.linearize(
        **{k: x[k].cpu() for k in keys},
        pairs={k: v.cpu() for k, v in x["pairs"].items()},
        gate=tuple(g.cpu() for g in x["gate"]), w=w, h=h,
        resf_at_fej=resf_at_fej)


def _to_cpu(v):
    return v.cpu() if isinstance(v, torch.Tensor) else v


# ---------------------------------------------------------------------------
# the plain versions as they were composed before the kernels
# ---------------------------------------------------------------------------

def _linearize_before(pt_u, pt_v, pt_idepth, pt_host, pt_color, pt_weights,
                      res_active, res_state, matcher_px, matcher_valid,
                      pairs, dI0_stack, frame_energy_th, K, w, h,
                      huber_th=6.0, gate=None, resf_at_fej=True,
                      quad12=None):
    """`backend.linearize_residuals_lanes` before K7, verbatim."""
    F = dI0_stack.shape[1]
    dev = pt_u.device
    fx, fy, cx, cy = (K[:, i, None] for i in range(4))
    fxi, fyi = 1.0 / fx, 1.0 / fy
    fx3, fy3 = fx[..., None], fy[..., None]
    cx3, cy3 = cx[..., None], cy[..., None]
    pair_idx = B._pair_rows(pt_host, F)
    R0 = B._take(pairs["R0"], pair_idx)
    t0 = B._take(pairs["t0"], pair_idx)
    Rc = B._take(pairs["Rc"], pair_idx)
    tc = B._take(pairs["tc"], pair_idx)
    KliP = torch.stack([(pt_u - cx) * fxi, (pt_v - cy) * fyi,
                        torch.ones_like(pt_u)], -1)
    ptp = torch.einsum("lnfij,lnj->lnfi", R0, KliP) + \
        t0 * pt_idepth[..., None, None]
    drescale = 1.0 / ptp[..., 2]
    new_idepth0 = pt_idepth[..., None] * drescale
    u = ptp[..., 0] * drescale
    v = ptp[..., 1] * drescale
    Ku0 = u * fx3 + cx3
    Kv0 = v * fy3 + cy3
    proj_ok_fej = (drescale > 0) & (Ku0 > 1.1) & (Kv0 > 1.1) & \
        (Ku0 < w - 3) & (Kv0 < h - 3)
    if resf_at_fej:
        Ku, Kv = Ku0, Kv0
        new_idepth = new_idepth0
        proj_ok = proj_ok_fej
    else:
        ptc = torch.einsum("lnfij,lnj->lnfi", Rc, KliP) + \
            tc * pt_idepth[..., None, None]
        drescale_c = 1.0 / ptc[..., 2]
        new_idepth = pt_idepth[..., None] * drescale_c
        Ku = ptc[..., 0] * drescale_c * fx3 + cx3
        Kv = ptc[..., 1] * drescale_c * fy3 + cy3
        proj_ok = (drescale_c > 0) & (Ku > 1.1) & (Kv > 1.1) & \
            (Ku < w - 3) & (Kv < h - 3) & (drescale > 0)
    oob = (~proj_ok) | (~matcher_valid) | (res_state == B.RES_OOB) | \
        (~res_active)
    dd_x = drescale * (t0[..., 0] - t0[..., 2] * u) * fx3
    dd_y = drescale * (t0[..., 1] - t0[..., 2] * v) * fy3
    fxi3, fyi3 = fxi[..., None], fyi[..., None]
    dCx2 = drescale * (R0[..., 2, 0] * u - R0[..., 0, 0])
    dCx3 = fx3 * drescale * (R0[..., 2, 1] * u - R0[..., 0, 1]) * fyi3
    dCx0 = KliP[..., None, 0] * dCx2
    dCx1 = KliP[..., None, 1] * dCx3
    dCy2 = fy3 * drescale * (R0[..., 2, 0] * v - R0[..., 1, 0]) * fxi3
    dCy3 = drescale * (R0[..., 2, 1] * v - R0[..., 1, 1])
    dCy0 = KliP[..., None, 0] * dCy2
    dCy1 = KliP[..., None, 1] * dCy3
    Jc_x = torch.stack([dCx0 + u, dCx1, dCx2 + 1.0, dCx3], -1)
    Jc_y = torch.stack([dCy0, dCy1 + v, dCy2, dCy3 + 1.0], -1)
    zu = torch.zeros_like(u)
    Jxi_x = torch.stack([new_idepth0 * fx3, zu, -new_idepth0 * u * fx3,
                         -u * v * fx3, (1 + u * u) * fx3, -v * fx3], -1)
    Jxi_y = torch.stack([zu, new_idepth0 * fy3, -new_idepth0 * v * fy3,
                         -(1 + v * v) * fy3, u * v * fy3, u * fy3], -1)
    if gate is None:
        energy_phot, wJI2 = B.photometric_gate_lanes(
            pt_u, pt_v, pt_idepth, pt_host, pt_color, pt_weights,
            pairs, dI0_stack, w=w, h=h, huber_th=huber_th, quad12=quad12)
    else:
        energy_phot, wJI2 = gate
    r2 = torch.stack([Ku, Kv], -1) - matcher_px
    rnorm = torch.linalg.vector_norm(r2, dim=-1)
    hw2 = torch.where(rnorm < huber_th, torch.ones_like(rnorm),
                      huber_th / torch.clamp(rnorm, min=1e-12))
    energy2d = hw2 * (rnorm * rnorm) * (2.0 - hw2)
    hw2s = torch.where(hw2 < 1.0, torch.sqrt(hw2), hw2)
    resF = r2 * hw2s[..., None]
    Jxi = torch.stack([Jxi_x, Jxi_y], dim=-2) * hw2s[..., None, None]
    Jc = torch.stack([Jc_x, Jc_y], dim=-2) * hw2s[..., None, None]
    Jd = torch.stack([dd_x, dd_y], dim=-1) * hw2s[..., None]
    th = torch.maximum(B._take(frame_energy_th, pt_host)[..., None],
                       frame_energy_th[:, None, :])
    is_outlier = (energy_phot > th) | (wJI2 < 2.0)
    st_in = torch.full_like(pair_idx, B.RES_IN)
    new_state = torch.where(oob, torch.full_like(st_in, B.RES_OOB),
                            torch.where(is_outlier,
                                        torch.full_like(st_in,
                                                        B.RES_OUTLIER),
                                        st_in))
    new_state = torch.where(res_active, new_state,
                            torch.full_like(st_in, B.RES_OOB)).to(torch.int8)
    zm = (new_state == B.RES_IN)
    zero = torch.zeros((), dtype=resF.dtype, device=dev)
    resF = torch.where(zm[..., None], resF, zero)
    Jxi = torch.where(zm[..., None, None], Jxi, zero)
    Jc = torch.where(zm[..., None, None], Jc, zero)
    Jd = torch.where(zm[..., None], Jd, zero)
    center = torch.stack([Ku, Kv, new_idepth], -1)
    return dict(resF=resF, Jxi=Jxi, Jc=Jc, Jd=Jd, new_state=new_state,
                energy=torch.where(proj_ok & matcher_valid & res_active,
                                   energy2d, zero),
                energy_phot=energy_phot, wJI2=wJI2, center=center,
                proj_ok=proj_ok)


def _accumulate_before(Jc, Jxi, Jd, resF, active, pt_host, pt_is_sensor,
                       pt_prior, sc_mask, pairs, F):
    """`backend._accumulate` before K8, verbatim."""
    L, N = resF.shape[:2]
    dtype = resF.dtype
    pt_host = pt_host.long()
    pair_idx = B._pair_rows(pt_host, F).reshape(L, N * F)
    Jgeo = torch.cat([Jc, Jxi], dim=-1).reshape(L, N * F, 2, 10)
    res_f = resF.reshape(L, N * F, 2)
    outer = torch.einsum("lrai,lraj->lrij", Jgeo, Jgeo).reshape(
        L, N * F, 100)
    onehot_t = B._one_hot(pair_idx, F * F).to(dtype).transpose(1, 2)
    Hpair = (onehot_t @ outer).reshape(L, F * F, 10, 10)
    bout = torch.einsum("lrai,lra->lri", Jgeo, res_f)
    bpair = onehot_t @ bout
    H_top, b_top = B._stitch(Hpair, bpair, pairs["adH"], pairs["adT"], F,
                             dtype)
    Hdd = torch.einsum("lnfa,lnfa->ln", Jd, Jd) + pt_prior
    bd = torch.einsum("lnfa,lnfa->ln", Jd, resF)
    Hcd = torch.einsum("lnfai,lnfa->lni", Jc, Jd)
    JpJd = torch.einsum("lnfai,lnfa->lnfi", Jxi, Jd)
    n_act = active.sum(-1)
    HdiF = torch.where(n_act > 0, 1.0 / torch.clamp(Hdd, min=1e-10),
                       torch.zeros_like(Hdd))
    adH_p = B._take(pairs["adH"].reshape(L, F, F, 6, 6), pt_host)
    adT_p = B._take(pairs["adT"].reshape(L, F, F, 6, 6), pt_host)
    vh = torch.einsum("lnfij,lnfj->lnfi", adH_p, JpJd)
    vt = torch.einsum("lnfij,lnfj->lnfi", adT_p, JpJd)
    host_onehot = B._one_hot(pt_host, F).to(dtype)
    Vframes = vt + host_onehot[..., None] * vh.sum(dim=2)[:, :, None, :]
    Vpt = torch.cat([Hcd, Vframes.reshape(L, N, 6 * F)], dim=-1)
    sc_ok = sc_mask & (~pt_is_sensor) & (n_act > 0)
    wsc = torch.where(sc_ok, HdiF, torch.zeros_like(HdiF))
    H_sc = (Vpt * wsc[..., None]).transpose(1, 2) @ Vpt
    b_sc = B._mv(Vpt.transpose(1, 2), wsc * bd)
    return H_top, b_top, H_sc, b_sc, Hdd, bd, HdiF, Vpt, n_act


def _same(a, b):
    return all(B.device_loop.same_bits(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def _acc_args(lin, x, F, kind):
    """The `_accumulate` arguments of build_system_lanes or
    marginalize_points_lanes on `lin`, recorded from the public call."""
    seen = []
    orig = B._accumulate

    def rec(*a):
        seen.append(a)
        return orig(*a)
    B._accumulate = rec
    try:
        if kind == "build":
            B.build_system_lanes(lin, x["pt_host"], x["pt_is_sensor"],
                                 x["pt_prior"], x["pairs"], x["frame_delta"],
                                 x["c_delta"], n_frames=F)
        else:
            B.marginalize_points_lanes(
                lin, x["pt_host"], x["pt_is_sensor"], x["pt_prior"],
                x["marg_mask"], x["frame_delta"], x["c_delta"], x["pairs"],
                n_frames=F)
    finally:
        B._accumulate = orig
    (args,) = seen
    return args


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

CPU_SHAPES = [(1, 300, 4, 320, 96), (3, 257, 8, 424, 320),
              (2, 130, 7, 1200, 360)]


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("resf_at_fej", [True, False])
def test_plain_versions_unchanged(resf_at_fej, gated):
    """On the CPU the dispatchers run the plain versions, and those are the
    composition they were before the kernels, bit for bit: the
    linearization (given its gate, or computing it on a 64x48 image
    stack), build_system_lanes' and marginalize_points_lanes'
    accumulations."""
    L, N, F, w, h = 2, 200, 5, 64, 48
    x = _case(11, L, N, F, w, h)
    rng = np.random.default_rng(12)
    stack = torch.as_tensor(rng.uniform(0, 255, (L, F, h, w, 3)),
                            dtype=torch.float32)
    color = torch.as_tensor(rng.uniform(20, 200, (L, N, 8)),
                            dtype=torch.float32)
    weights = torch.as_tensor(rng.uniform(0.5, 1, (L, N, 8)),
                              dtype=torch.float32)
    args = list(_lin_args(x, F))
    args[4], args[5], args[11] = color, weights, stack
    kw = dict(w=w, h=h, gate=x["gate"] if gated else None,
              resf_at_fej=resf_at_fej)
    got = B.linearize_residuals_lanes(*args, **kw)
    want = _linearize_before(*args, **kw)
    assert list(got) == list(want)
    assert _same(got.values(), want.values())
    for kind in ("build", "marg"):
        acc = _acc_args(got, x, F, kind)
        want_acc = _accumulate_before(*acc)
        assert _same(B._accumulate(*acc), want_acc), kind


def test_cpu_dispatch_never_loads_the_kernels(monkeypatch):
    """CPU tensors go to the plain versions: with the kernels' library made
    unloadable the linearization, the system build and the marginalization
    run, and K7's and K8's counters stay at zero."""
    def refuse():
        raise AssertionError("the kernels' library was loaded")
    monkeypatch.setattr(hk, "_load", refuse)
    L, N, F, w, h = 2, 150, 4, 320, 96
    x = _case(3, L, N, F, w, h)
    lin = B.linearize_residuals_lanes(*_lin_args(x, F), w=w, h=h,
                                      gate=x["gate"])
    sys_ = B.build_system_lanes(lin, x["pt_host"], x["pt_is_sensor"],
                                x["pt_prior"], x["pairs"], x["frame_delta"],
                                x["c_delta"], n_frames=F)
    dH, _ = B.marginalize_points_lanes(
        lin, x["pt_host"], x["pt_is_sensor"], x["pt_prior"], x["marg_mask"],
        x["frame_delta"], x["c_delta"], x["pairs"], n_frames=F)
    assert sys_["H_top"].shape == dH.shape == (L, 4 + 6 * F, 4 + 6 * F)
    got = hk.device_launches()
    assert got["ba_linearize"] == 0 and got["ba_accumulate"] == 0


def test_launch_counts_list_the_ba_kernels():
    """K7 and K8 count on the card: they are among the device-counted
    kernels and in `launch_counts()` and `device_launches()`."""
    assert {"ba_linearize", "ba_accumulate"} <= set(hk.DEVICE_COUNTED)
    assert {"ba_linearize", "ba_accumulate"} <= set(hk.launch_counts())
    assert {"ba_linearize", "ba_accumulate"} <= set(hk.device_launches())
    assert {"ba_linearize.cu", "ba_accumulate.cu"} <= set(hk.SOURCES)


@pytest.mark.parametrize("resf_at_fej", [True, False])
@pytest.mark.parametrize("shape", CPU_SHAPES)
def test_k7_emulation_matches_plain(shape, resf_at_fej):
    """K7's arithmetic (tests/k7_lin.py) against the plain version: the
    same states except near a threshold, floats within K7_REL of their
    output's scale, the gate passed through."""
    L, N, F, w, h = shape
    x = _case(20 + N, L, N, F, w, h)
    want = B.linearize_residuals_lanes_plain(*_lin_args(x, F), w=w, h=h,
                                             gate=x["gate"],
                                             resf_at_fej=resf_at_fej)
    got = _emu_lin(x, w, h, resf_at_fej)
    assert list(got) == list(want)
    bad, worst, per = k7_lin.gaps(got, want,
                                  k7_lin.near(got, x, w, h))
    assert bad == 0 and worst <= K7_REL, (bad, per)
    assert got["energy_phot"] is x["gate"][0] or torch.equal(
        got["energy_phot"], x["gate"][0])
    states = torch.bincount(got["new_state"].flatten().long(), minlength=3)
    assert bool((states > 0).all()), states


@pytest.mark.parametrize("kind", ["build", "marg"])
@pytest.mark.parametrize("shape", CPU_SHAPES)
def test_k8_emulation_matches_plain(shape, kind):
    """K8's arithmetic and order (tests/k8_acc.py) against the plain
    version, for build_system_lanes and for marginalize_points_lanes with
    a mask: every sum within K8_REL of its terms' magnitudes, n_act
    equal."""
    L, N, F, w, h = shape
    x = _case(40 + N, L, N, F, w, h)
    lin = B.linearize_residuals_lanes(*_lin_args(x, F), w=w, h=h,
                                      gate=x["gate"])
    args = _acc_args(lin, x, F, kind)
    want = B._accumulate(*args)
    got = k8_acc.accumulate(*args[:9], args[9]["adH"], args[9]["adT"], F)
    assert k8_acc.gap(got, want, k8_acc.magnitudes(args, F)) <= K8_REL


def test_k8_emulation_lane_alone_equals_lane_among_others():
    """K8's order depends on N and F alone: a lane's outputs alone equal
    its outputs among other lanes, bit for bit."""
    L, N, F, w, h = 3, 300, 6, 424, 320
    x = _case(7, L, N, F, w, h)
    lin = B.linearize_residuals_lanes(*_lin_args(x, F), w=w, h=h,
                                      gate=x["gate"])
    args = _acc_args(lin, x, F, "build")
    allx = k8_acc.accumulate(*args[:9], args[9]["adH"], args[9]["adT"], F)
    one = [a[1:2] if isinstance(a, torch.Tensor) else a for a in args[:9]]
    alone = k8_acc.accumulate(*one, args[9]["adH"][1:2],
                              args[9]["adT"][1:2], F)
    assert _same([a[1:2] for a in allx], alone)


def test_ba_wrappers_refuse_what_the_kernels_do_not_take():
    """The wrappers launch on the card only (CPU tensors are the
    dispatcher's to route), and refuse more frame slots than the kernels
    stage."""
    L, N, F, w, h = 1, 40, 4, 320, 96
    x = _case(5, L, N, F, w, h)
    with pytest.raises(ValueError):
        hk.ba_linearize(x["pt_u"], x["pt_v"], x["pt_idepth"], x["pt_host"],
                        x["res_active"], x["res_state"], x["matcher_px"],
                        x["matcher_valid"], x["pairs"], x["frame_energy_th"],
                        x["K"], x["gate"], w=w, h=h)
    lin = B.linearize_residuals_lanes(*_lin_args(x, F), w=w, h=h,
                                      gate=x["gate"])
    with pytest.raises(ValueError):
        hk.ba_accumulate(lin["Jc"], lin["Jxi"], lin["Jd"], lin["resF"],
                         lin["new_state"] == 0, x["pt_host"],
                         x["pt_is_sensor"], x["pt_prior"],
                         torch.ones_like(x["pt_is_sensor"]),
                         x["pairs"]["adH"], x["pairs"]["adT"], F)
    big = hk.BA_MAX_FRAMES + 1
    with pytest.raises(ValueError, match="frame slots"):
        hk.ba_accumulate(*(torch.zeros(1) for _ in range(11)), big)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

CARD_CASES = [(p, L) for p in PRESETS for L in (1, 3, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("resf_at_fej", [True, False])
@pytest.mark.parametrize("preset,L", CARD_CASES)
def test_k7_matches_plain_and_emulation(cuda, preset, L, resf_at_fej):
    """K7 at the main path's shapes: bit for bit its emulation, and two
    launches the same bits; against the plain version on the card the
    same states away from the thresholds (the rest are printed) and
    floats within K7_REL; with three lanes, lane 1 alone as among them."""
    N, F, w, h = PRESETS[preset]
    x = _case(100 + L, L, N, F, w, h, cuda)
    args = _lin_args(x, F)
    kw = dict(w=w, h=h, gate=x["gate"], resf_at_fej=resf_at_fej)
    hk.reset_launch_counts()
    got = B.linearize_residuals_lanes(*args, **kw)
    again = B.linearize_residuals_lanes(*args, **kw)
    plain = B.linearize_residuals_lanes_plain(*args, **kw)
    torch.cuda.synchronize()
    assert hk.device_launches()["ba_linearize"] == 2
    assert list(got) == list(plain)
    assert _same(got.values(), again.values())
    emu = _emu_lin(x, w, h, resf_at_fej)
    differ = [k for k in got if not B.device_loop.same_bits(
        _to_cpu(got[k]), emu[k])]
    assert not differ, differ
    gc = {k: v.cpu() for k, v in got.items()}
    near = k7_lin.near(gc, x, w, h)
    bad, worst, per = k7_lin.gaps(gc, {k: v.cpu() for k, v in
                                       plain.items()}, near)
    n_diff = int((gc["new_state"] != plain["new_state"].cpu()).sum())
    print(f"K7 {preset} L={L} fej={resf_at_fej}: states differing "
          f"{n_diff} (near a threshold: {int(near.sum())}), worst float "
          f"gap of its output's scale {per}")
    assert bad == 0 and worst <= K7_REL, (bad, per)
    if L == 3:
        one = {k: (v[1:2] if isinstance(v, torch.Tensor) else v)
               for k, v in x.items() if k not in ("pairs", "gate")}
        one["pairs"] = {k: (v if k in ("host", "target") else v[1:2])
                        for k, v in x["pairs"].items()}
        one["gate"] = tuple(g[1:2] for g in x["gate"])
        alone = B.linearize_residuals_lanes(*_lin_args(one, F), w=w, h=h,
                                            gate=one["gate"],
                                            resf_at_fej=resf_at_fej)
        assert _same([v[1:2] for v in got.values()], alone.values())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["build", "marg"])
@pytest.mark.parametrize("preset,L", CARD_CASES)
def test_k8_matches_plain_and_emulation(cuda, preset, L, kind):
    """K8 at the main path's shapes, for build_system_lanes and for
    marginalize_points_lanes with a mask: bit for bit its emulation, two
    calls the same bits; against the plain version on the card every sum
    within K8_REL of its terms' magnitudes, n_act equal; with three
    lanes, lane 1 alone as among them."""
    N, F, w, h = PRESETS[preset]
    x = _case(200 + L, L, N, F, w, h, cuda)
    lin = B.linearize_residuals_lanes(*_lin_args(x, F), w=w, h=h,
                                      gate=x["gate"])
    args = _acc_args(lin, x, F, kind)
    hk.reset_launch_counts()
    got = B._accumulate(*args)
    again = B._accumulate(*args)
    plain = B._accumulate_plain(*args)
    torch.cuda.synchronize()
    assert hk.device_launches()["ba_accumulate"] == 2
    assert _same(got, again)
    cpu_args = [_to_cpu(a) for a in args[:9]]
    emu = k8_acc.accumulate(*cpu_args, args[9]["adH"].cpu(),
                            args[9]["adT"].cpu(), F)
    differ = [n for n, g, e in zip(ACC_NAMES, got, emu)
              if not B.device_loop.same_bits(g.cpu(), e)]
    assert not differ, differ
    mag = k8_acc.magnitudes(args, F)
    worst = k8_acc.gap(got, plain, mag)
    print(f"K8 {preset} L={L} {kind}: worst gap {worst:.3g} of the terms' "
          f"magnitudes")
    assert worst <= K8_REL
    if L == 3:
        one = [a[1:2] if isinstance(a, torch.Tensor) else a
               for a in args[:9]]
        pairs1 = {k: (v if k in ("host", "target") else v[1:2])
                  for k, v in args[9].items()}
        alone = B._accumulate(*one, pairs1, F)
        assert _same([g[1:2] for g in got], alone)


def _kf_records(cuda, lanes=2):
    """The keyframe programs recorded on frames 2-5 of the 320x96 scene in
    the batched lockstep of `lanes` sequences."""
    from sdv_loam_tpu_torch.config import Settings
    from sdv_loam_tpu_torch.data.synthetic import make_sequence
    from sdv_loam_tpu_torch.system.full_system import FullSystem
    from sdv_loam_tpu_torch.system.multi import MultiSystem
    from sdv_loam_tpu_torch.utils import device_loop as dl

    seqs = [make_sequence(n_frames=6, w=320, h=96, lidar_stride=2,
                          yaw_rate=0.003 * b) for b in range(lanes)]
    systems = [FullSystem(s.calib, s.sensor, Settings(), device=cuda)
               for s in seqs]
    run = MultiSystem(systems, batch_track=True)
    log = []
    for i in range(6):
        frames = [s.get(i) for s in seqs]
        if i >= 2:
            with dl.recording(log, programs=True):
                run.add_frames(frames)
        else:
            run.add_frames(frames)
    return [r for r in log if r["stage"] == "kf_opt"]


@pytest.mark.cuda
def test_kf_program_with_ba_kernels_replays_its_eager_form(cuda,
                                                           monkeypatch):
    """A recorded keyframe program (two lanes) with K7 and K8 inside its
    WHILE nodes: its replay equals its stage form and its eager form bit
    for bit; the device counters of one replay equal the linearizations
    and accumulations its eager form ran (one K7 launch and one K8 call
    each); one replay's profile shows both kernels and is printed (the
    plain chain's one-hot product, gathers and batched copies are gone
    from the BA)."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._pytree import tree_flatten, tree_unflatten

    from sdv_loam_tpu_torch.utils import device_loop as dl

    recs = _kf_records(cuda)
    assert recs
    rec = recs[-1]
    res = dl.compare_program(rec)
    assert res["equal"] and res["replayed"], res

    calls = {"ba_linearize": 0, "ba_accumulate": 0}
    for name in calls:
        orig = getattr(hk, name)

        def counted(*a, _o=orig, _n=name, **k):
            calls[_n] += 1
            return _o(*a, **k)
        monkeypatch.setattr(hk, name, counted)
    torch.cuda.synchronize()
    hk.reset_launch_counts()
    with dl.reference():
        ref = rec["fn"](tree_unflatten(rec["leaves"], rec["spec"]),
                        **rec["static"])
    eager = hk.device_launches()
    assert calls["ba_linearize"] >= 4 and calls["ba_accumulate"] >= 2
    assert {k: eager[k] for k in calls} == calls, (eager, calls)

    leaves = [v.clone() if isinstance(v, torch.Tensor) else v
              for v in rec["leaves"]]
    dev = next(v.device for v in leaves if isinstance(v, torch.Tensor))
    dl._graph_program(rec["stage"], rec["fn"], leaves, rec["spec"],
                      rec["static"], dev)
    torch.cuda.synchronize()
    hk.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got, replayed = dl._graph_program(rec["stage"], rec["fn"], leaves,
                                          rec["spec"], rec["static"], dev)
        torch.cuda.synchronize()
    replay = hk.device_launches()
    assert replayed
    assert {k: replay[k] for k in calls} == calls, (replay, calls)
    a, _ = tree_flatten(got)
    b, _ = tree_flatten(ref)
    assert len(a) == len(b) and all(dl.same_bits(x, y)
                                    for x, y in zip(a, b))
    kernels = {}
    for e in prof.key_averages():
        if "CUDA" in str(e.device_type):
            kernels[e.key] = (e.count, getattr(e, "device_time_total", None)
                              or getattr(e, "cuda_time_total", 0.0))
    ours = {k: v for k, v in kernels.items()
            if any(s in k for s in ("ba_linearize_kernel",
                                    "ba_acc_tiles_kernel",
                                    "ba_acc_sum_kernel",
                                    "ba_acc_stitch_kernel"))}
    print(f"kf_opt replay: {sum(c for c, _ in kernels.values())} kernels, "
          f"K7 / K8 {ours}; the ten longest: " + repr(sorted(
              kernels.items(), key=lambda kv: -kv[1][1])[:10]))
    # the device counters above are the launches' count (the profiler may
    # miss kernels inside a graph's conditional bodies); the profile shows
    # the kernels there, K8's three launches a call
    seen = {kind: sum(c for k, (c, _) in ours.items() if kind in k)
            for kind in ("ba_linearize_kernel", "ba_acc_tiles_kernel",
                         "ba_acc_sum_kernel", "ba_acc_stitch_kernel")}
    assert all(seen.values()), seen
    assert seen["ba_acc_tiles_kernel"] == seen["ba_acc_sum_kernel"] == \
        seen["ba_acc_stitch_kernel"], seen
