"""The check sees a broken timed path: a run of the tiny cell on the CPU
with a fault planted underneath the kernels' dispatchers (the plain
versions the CPU runs in the kernels' place) comes out not correct, for
each fault this cell can have: a step that returns its state unchanged,
half of the batch left out (its rows replaced by the mean of the rest),
one lane's rows wrong while the others are right, an answer altered where
it is produced; for the BA's kernels (K7, K8) a focal length a
ten-thousandth off, a residual's state, a system's entry and a point's
count altered. (One card: no exchange between chips to leave out.)"""

import pytest
import torch

from vo_bench.tests import planted, tiny_cell

hk = pytest.importorskip("sdv_loam_tpu_torch.ops.hopper_kernels")
backend = pytest.importorskip("sdv_loam_tpu_torch.models.backend")


def _unchanged_step(orig):
    def step(H, b, lam, T, aff, exposures, ref_aff):
        _, _, aff_rel, inc = orig(H, b, lam, T, aff, exposures, ref_aff)
        return T.clone(), aff.clone(), aff_rel, torch.zeros_like(inc)
    return step


def _half_rows(orig):
    def res(*a, **kw):
        out = orig(*a, **kw)
        B = out["E"].shape[0]
        if B < 2:
            return out
        keep = B - B // 2
        return {k: torch.cat([v[:keep], v[:keep].float().mean(0, keepdim=True)
                              .to(v.dtype).expand(B - keep, *v.shape[1:])])
                for k, v in out.items()}
    return res


def _one_lane_wrong(orig):
    """The rows of a batched call's last lane a thousandth off in their
    energy and system; every other row right."""
    def res(*a, **kw):
        out = orig(*a, **kw)
        lane = kw.get("lane")
        if lane is None or int(lane.max()) == int(lane.min()):
            return out
        bad = lane == lane.max()
        return {k: torch.where(bad.reshape((-1,) + (1,) * (v.dim() - 1)),
                               v * 1.001, v)
                if k in ("E", "H", "b") else v for k, v in out.items()}
    return res


def _k5_px_moved(orig):
    """One converged candidate's position a twentieth of a pixel off."""
    def wa(*a, **kw):
        px, conv, fails = orig(*a, **kw)
        if bool(conv.any()):
            px = px.clone()
            px[int(torch.nonzero(conv)[0, 0]), 0] += 0.05
        return px, conv, fails
    return wa


def _k5_flag_flipped(orig):
    """One candidate's converged flag flipped."""
    def wa(*a, **kw):
        px, conv, fails = orig(*a, **kw)
        conv = conv.clone()
        conv[0] = ~conv[0]
        return px, conv, fails
    return wa


def _altered_k1(orig):
    def k1(idepth0, weight0, levels):
        out = list(orig(idepth0, weight0, levels))
        idp, wt = out[0]
        idp = idp.clone()
        idp.view(-1)[idp.numel() // 2] += 1e-3
        out[0] = (idp, wt)
        return tuple(out)
    return k1


def _altered_k2(orig):
    def k2(seed, iters=32):
        d = orig(seed, iters).clone()
        d.view(-1)[0] += 1.0
        return d
    return k2


FAULTS = {"step_returns_its_state": (hk, "lm_update_step_plain",
                                     _unchanged_step, ("k4_rel_err",)),
          "half_the_rows_left_out": (hk, "calc_res_gs_plain", _half_rows,
                                     ("k3_row_err",)),
          "one_lane_wrong": (hk, "calc_res_gs_plain", _one_lane_wrong,
                             ("k3_row_err",)),
          "k5_position_moved": (hk, "warp_align_plain", _k5_px_moved,
                                ("k5_px_err",)),
          "k5_flag_flipped": (hk, "warp_align_plain", _k5_flag_flipped,
                              ("k5_flags_differ",)),
          "k1_answer_altered": (hk, "dilate_pyramid_plain", _altered_k1,
                                ("k1_cells_differ",)),
          "k2_answer_altered": (hk, "distance_transform_plain", _altered_k2,
                                ("k2_cells_differ",))}
# the BA kernels' faults, planted in their dispatchers
FAULTS.update({name: (backend, attr, make, caught)
               for name, (_, attr, make, caught) in planted.FAULTS.items()})


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(fault, tmp_path, monkeypatch):
    mod, attr, make, caught = FAULTS[fault]
    monkeypatch.setattr(mod, attr, make(getattr(mod, attr)))
    root = tiny_cell.make(str(tmp_path))
    line, lines = tiny_cell.run(root)
    assert line["correct"] is False
    failed = {c["name"] for c in lines if not c["ok"]}
    assert set(caught) <= failed, line["checks"]
