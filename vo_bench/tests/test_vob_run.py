"""A whole run of a cell defined only in data, on the CPU (the chip's
look skipped): its result line has exactly the contract's keys, it is
correct, its kernels' numbers are the ones the fixed checks gave before
they became files, and its process has loaded neither JAX nor the JAX
package (whole top-level names: the port's `sdv_loam_tpu_torch` begins
with `sdv_loam_tpu`)."""

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


# K1-K5's numbers on the tiny cell at `tiny_cell.run`'s seed, from the
# six programs a window of three rounds or more records, as the harness
# computed them when its checks were a fixed list in one module: moving
# them into `vo_bench/checks/` changed no value
BEFORE = dict(k1_cells_differ=0, k2_cells_differ=0,
              k3_row_err=1.2219636828986859e-05, k3_count_diff=0,
              k4_rel_err=0.0006183098175219269, k4_decisions_differ=0,
              k5_flags_differ=0, k5_px_err=0.007358551025390625)


def test_kernel_numbers_as_before(tmp_path, monkeypatch):
    """The window is timed by a clock that ticks a second a read, so it
    runs three rounds however loaded the machine is (a loaded machine's
    shorter window records fewer programs)."""
    import itertools
    import types

    from vo_bench import fleet

    ticks = itertools.count()
    monkeypatch.setattr(fleet, "time", types.SimpleNamespace(
        perf_counter=lambda: float(next(ticks))))
    line, _ = tiny_cell.run(tiny_cell.make(str(tmp_path)))
    assert {k: line["checks"][k]["value"] for k in BEFORE} == BEFORE


def test_no_jax_in_the_process(result):
    _, r = result
    assert r["forbidden"] == []
    assert "sdv_loam_tpu_torch" in r["loaded"]
    assert not {"jax", "jaxlib", "flax", "sdv_loam_tpu"} & set(r["loaded"])
