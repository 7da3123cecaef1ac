"""Faults planted in the BA kernels' dispatchers (K7, K8), for the CPU
tests and for reading, on the card, what the check gives for a fault
that the control cannot show (TF32 moves none of K7's arithmetic):

    python3 -m vo_bench.tests.planted <fault> --workload <cell> \\
        --seed <n> --seconds <s> --trace 0

runs the cell as `vo_bench.run` does with the fault in place; it must
come out not correct."""

from __future__ import annotations

import importlib
import sys

import torch

BACKEND = "sdv_loam_tpu_torch.models.backend"
RES_IN, RES_OUTLIER = 0, 2


def k7_focal_length_off(orig):
    """The linearization run with a focal length a ten-thousandth of
    itself too long."""
    def lin(*a, **kw):
        a = list(a)
        K = (a[13] if len(a) > 13 else kw["K"]).clone()
        K[:, 0] *= 1.0 + 1e-4
        if len(a) > 13:
            a[13] = K
        else:
            kw["K"] = K
        return orig(*a, **kw)
    return lin


def k7_state_flipped(orig):
    """One IN residual's state returned as an outlier."""
    def lin(*a, **kw):
        out = orig(*a, **kw)
        st = out["new_state"]
        idx = torch.nonzero(st.reshape(-1) == RES_IN)
        if len(idx):
            st = st.clone()
            st.view(-1)[int(idx[0, 0])] = RES_OUTLIER
        return dict(out, new_state=st)
    return lin


def k8_answer_altered(orig):
    """One diagonal entry of each lane's system a ten-thousandth off."""
    def acc(*a, **kw):
        out = list(orig(*a, **kw))
        H = out[0].clone()
        H[:, 4, 4] *= 1.0 + 1e-4
        out[0] = H
        return tuple(out)
    return acc


def k8_count_altered(orig):
    """One point's count of active residuals one too high."""
    def acc(*a, **kw):
        out = list(orig(*a, **kw))
        n = out[-1].clone()
        n.view(-1)[0] += 1
        out[-1] = n
        return tuple(out)
    return acc


# fault: (module, dispatcher, wrapper, the numbers that must fail)
FAULTS = {
    "k7_focal_length_off": (BACKEND, "linearize_residuals_lanes",
                            k7_focal_length_off, ("k7_rel_err",)),
    "k7_state_flipped": (BACKEND, "linearize_residuals_lanes",
                         k7_state_flipped, ("k7_flags_differ",)),
    "k8_answer_altered": (BACKEND, "_accumulate", k8_answer_altered,
                          ("k8_rel_err",)),
    "k8_count_altered": (BACKEND, "_accumulate", k8_count_altered,
                         ("k8_counts_differ",)),
}


def plant(fault):
    """Put `fault` in place (for good: a process of its own)."""
    mod_name, attr, make, _ = FAULTS[fault]
    mod = importlib.import_module(mod_name)
    setattr(mod, attr, make(getattr(mod, attr)))


if __name__ == "__main__":
    plant(sys.argv[1])
    from vo_bench import run
    sys.exit(run.main(sys.argv[2:]))
