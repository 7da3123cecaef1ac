"""The check's control on the card: each cell run with `--control` (the
program with TF32 products, the references computed with TF32 products
in the kernels' place) on three seeds comes out not correct, K8's number
over its limit; a fault planted in K7's dispatcher, which the control
cannot show, does too. Needs a CUDA device; on the card:

    python3 -m pytest --noconftest -m cuda vo_bench/tests/test_vob_control.py
"""

import json
import subprocess
import sys

import pytest
import torch

from vo_bench.tests import tiny_cell

SEEDS = (2 ** 33 + 5, 2 ** 31 + 11, 987654321987)
WORKLOADS = ["kitti00_default.lockstep8"]


def _run(argv):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "-m", *argv], cwd=tiny_cell.REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    print(" ".join(argv), json.dumps(line["checks"]))
    return line


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(workload, seed):
    line = _run(["vo_bench.run", "--workload", workload, "--seed", str(seed),
                 "--seconds", "6", "--trace", "0", "--control"])
    assert line["correct"] is False, line["checks"]
    k8 = line["checks"]["k8_rel_err"]
    assert k8["value"] > k8["limit"], k8


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_a_k7_fault_is_not_correct(seed):
    """TF32 moves none of K7's arithmetic: K7's number is held by a fault
    planted in its dispatcher, a focal length a ten-thousandth off."""
    line = _run(["vo_bench.tests.planted", "k7_focal_length_off",
                 "--workload", WORKLOADS[0], "--seed", str(seed),
                 "--seconds", "6", "--trace", "0"])
    assert line["correct"] is False, line["checks"]
    k7 = line["checks"]["k7_rel_err"]
    assert k7["value"] > k7["limit"], k7
