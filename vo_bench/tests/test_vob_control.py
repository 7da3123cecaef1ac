"""The check's control on the card: each cell run with `--control` (the
program with TF32 products, the references computed with TF32 products
in the kernels' place) on three seeds comes out not correct. Needs a
CUDA device; on the card:

    python3 -m pytest --noconftest -m cuda vo_bench/tests/test_vob_control.py
"""

import json
import subprocess
import sys

import pytest
import torch

from vo_bench.tests import tiny_cell

SEEDS = (2 ** 33 + 5, 2 ** 31 + 11, 987654321987)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["kitti00_default.lockstep8"])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(workload, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "vo_bench.run", "--workload", workload,
         "--seed", str(seed), "--seconds", "6", "--trace", "0", "--control"],
        cwd=tiny_cell.REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    print(workload, seed, json.dumps(line["checks"]))
    assert line["correct"] is False, line["checks"]
