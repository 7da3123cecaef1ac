"""A whole run of a cell defined only in data, on the CPU (the chip's
look skipped): its result line has exactly the contract's keys, it is
correct, and its process has loaded neither JAX nor the JAX package
(whole top-level names: the port's `sdv_loam_tpu_torch` begins with
`sdv_loam_tpu`)."""

import json
import os
import subprocess
import sys

import pytest

from vo_bench.tests import tiny_cell

SCRIPT = """
import json, sys
from vo_bench import run
from vo_bench.tests import tiny_cell
line, _ = tiny_cell.run(sys.argv[1], trace=sys.argv[2] == "1")
print(json.dumps(dict(line=line, forbidden=run.forbidden_modules(),
                      loaded=sorted({m.split('.')[0] for m in sys.modules}))))
"""


@pytest.fixture(scope="module", params=[0, 1], ids=["trace0", "trace1"])
def result(request, tmp_path_factory):
    root = tiny_cell.make(str(tmp_path_factory.mktemp("cell")))
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", SCRIPT, root,
                          str(request.param)],
                         cwd=tiny_cell.REPO, env=env, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    return request.param, json.loads(out.stdout.strip().splitlines()[-1])


def test_result_line_has_the_contracts_keys(result):
    trace, r = result
    line = r["line"]
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    if trace:
        keys.append("breakdown")
    assert list(line) == keys + ["checks"]
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "stage.track_ms_per_frame" in line["metrics"]
    else:
        assert set(line["metrics"]) == {"fleet_fps", "setup_s"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_no_jax_in_the_process(result):
    _, r = result
    assert r["forbidden"] == []
    assert "sdv_loam_tpu_torch" in r["loaded"]
    assert not {"jax", "jaxlib", "flax", "sdv_loam_tpu"} & set(r["loaded"])
