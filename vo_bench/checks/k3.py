"""K3 (`track_res_gs`, in the track program): every residual evaluation
against the plain reference (`vo_bench/reference.track_res_gs`: float32
per point, sums in float64; the control's variant sums in float32).

`k3_row_err`: per row, the largest gap of H, b, E and the flows over the
sum of their terms' magnitudes, and of the saturated share; the largest
over all rows. A point whose residual lies within float32 rounding of the
cutoff may fall on either side, and each row takes the side (of up to
`MAX_NEAR` such points) nearest the kernel's. `k3_count_diff`: the
largest gap of a row's in-bound count."""

import inspect

import torch

from vo_bench import check
from vo_bench import reference as ref

PROGRAMS = {"track": "round"}
TAPS = (("sdv_loam_tpu_torch.ops.photometric", "track_res_gs", "K3"),)
NUMBERS = ("k3_row_err", "k3_count_diff")
# points near K3's cutoff whose two sides are tried, per row
MAX_NEAR = 4
# variant rows a reference call takes at once
VARIANTS_A_CALL = 256


def reference(kernel, args, kwargs, out, low=False):
    return ref.track_res_gs(*args, **kwargs,
                            **(dict(acc=torch.float32) if low else {}))


def rows_err(got, want):
    """Per row, the largest gap of a sum over the sum of its terms'
    magnitudes (H, b: the reference's H_abs, b_abs; E and the flows are
    sums of non-negative terms) and of the saturated share."""
    return torch.stack([
        check.over(got["H"], want["H"], want["H_abs"], (1, 2)),
        check.over(got["b"], want["b"], want["b_abs"], (1,)),
        *(check.over(got[k], want[k], want[k], ()) for k in
          ("E", "flow_t", "flow_rt")),
        check.over(got["sat_frac"], want["sat_frac"],
                   torch.ones_like(want["sat_frac"]), ())]).amax(0)


def _args(args, kwargs):
    """A K3 call's arguments by name, in the lane form (pool fields (L,
    N), K (L, 4), the image's pack, `hw`, `lane`)."""
    ba = inspect.signature(ref.track_res_gs).bind(*args, **kwargs)
    ba.apply_defaults()
    a = dict(ba.arguments)
    a.pop("acc"), a.pop("flip")
    B = a["T_ref_to_new"].shape[0]
    if a["hw"] is None:
        a["hw"] = tuple(a["dI_new"].shape[-3:-1])
    if a["packed"] is None:
        a["packed"] = ref.pack_bilinear(a["dI_new"])
    if a["lane"] is None:
        a["pool"] = {k: a["pool"][k][None] for k in ("u", "v", "idepth",
                                                     "color", "valid")}
        a["K"] = a["K"][None]
        a["lane"] = torch.zeros(B, dtype=torch.int64,
                                device=a["T_ref_to_new"].device)
    return a


def near_sides(args, kwargs, got, want, rows):
    """`rows` (per row the error against the reference) lowered, where a
    row has points near the cutoff, to its least over the sides those
    points may take (each subset of its first `MAX_NEAR` moved across).
    Returns (rows, rows with points near the cutoff)."""
    near = want["near"]
    k = near.sum(-1)
    with_near = torch.nonzero(k > 0).flatten().tolist()
    if not with_near:
        return rows, 0
    sel, flips = [], []
    N = near.shape[1]
    for r in with_near:
        pts = torch.nonzero(near[r]).flatten()[:MAX_NEAR]
        for c in range(1, 1 << len(pts)):
            f = torch.zeros(N, dtype=torch.bool, device=near.device)
            f[pts[[i for i in range(len(pts)) if c >> i & 1]]] = True
            sel.append(r)
            flips.append(f)
    a = _args(args, kwargs)
    B = rows.shape[0]
    rows = rows.clone()
    for i in range(0, len(sel), VARIANTS_A_CALL):
        s = torch.tensor(sel[i:i + VARIANTS_A_CALL], device=near.device)
        part = dict(a, T_ref_to_new=a["T_ref_to_new"][s],
                    aff_rel=a["aff_rel"][s], lane=a["lane"][s])
        for key in ("ref_aff_b", "cutoff"):
            x = a[key]
            if isinstance(x, torch.Tensor) and x.numel() == B:
                part[key] = x.reshape(B)[s]
        alt = ref.track_res_gs(**part,
                               flip=torch.stack(flips[i:i + VARIANTS_A_CALL]))
        err = rows_err({key: got[key][s] for key in got}, alt).to(rows.device)
        rows = rows.scatter_reduce(0, s.to(rows.device), err, "amin")
    return rows, len(with_near)


def numbers(compared):
    num = dict(k3_count_diff=0, k3_rows_near_cutoff=0)
    all_rows, worst = [], None
    for _, args, kwargs, out, want in compared:
        with ref.precision(False):
            rows, n_near = near_sides(args, kwargs, out, want,
                                      rows_err(out, want))
        num["k3_rows_near_cutoff"] += n_near
        all_rows.append(rows.cpu())
        num["k3_count_diff"] = max(num["k3_count_diff"], int(
            (out["n"].long() - want["n"].long()).abs().max()))
        j = int(rows.argmax())
        if worst is None or float(rows[j]) > worst[0]:
            worst = (float(rows[j]), j, int(want["n"][j]),
                     float(out["sat_frac"][j]), float(want["sat_frac"][j]))
    if all_rows:
        num["k3_row_err"] = float(torch.cat(all_rows).max())
        num["k3_worst_row"] = dict(zip(
            ("err", "row", "n", "sat_frac", "sat_frac_ref"), worst))
    return num
