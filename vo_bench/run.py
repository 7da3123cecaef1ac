"""The benchmark of the PyTorch / CUDA port (`sdv_loam_tpu_torch`).

    python3 -m vo_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell is one entry of `workloads` in BENCHMARK.json: a configuration
(`vo_bench/configs/`) under a traffic mix (`vo_bench/traffic/`). The last
line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (with `--trace 0` the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, each read by `vo_bench/metrics/`),
`device`, with `--trace 1` `breakdown`, and last `checks`: every number
that decided `correct`, beside its limit (also the last lines of standard
error). `--control` runs the check's control (`vo_bench/check.py`): it
must come out not correct; the benchmark's own runs never pass it.

The run needs as many CUDA devices as the cell asks for, and exits with
code 2 and no result without them. It reads and writes only inside its
checkout (the kernels' library, built once per checkout) and the caches
that `HOME`, `XDG_CACHE_HOME` and `TMPDIR` point to. No module of the JAX
package, nor JAX itself, may be loaded when the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from vo_bench import cells  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "sdv_loam_tpu")


def forbidden_modules():
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (the port's `sdv_loam_tpu_torch` is not `sdv_loam_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _caches(root):
    """The program's build and kernel caches at fixed paths in the
    checkout (the kernels' library is built into the port's own `build/`
    there)."""
    base = os.path.join(root, ".bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def execute(cell, seed, seconds, trace, device, control=False,
            t_start=T_START):
    """One run of `cell` on `device`: (result line, lines of the numbers
    compared)."""
    from vo_bench import fleet

    import torch

    out = fleet.run(cell, seed, seconds, trace, device, control=control,
                    t_start=t_start)
    ctx = out["ctx"]
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = cells.reader(m["name"], cell.root).read(ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    else:
        e2e = dict(fleet_fps=out["fleet_fps"], mib_per_seq=out["mib_per_seq"],
                   setup_s=out["setup_s"])
        metrics = {m["name"]: dict(value=e2e[m["name"]], unit=m["unit"])
                   for m in cell.end_to_end if e2e.get(m["name"]) is not None}
    cuda = torch.device(device).type == "cuda"
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(0) if cuda else "cpu",
               count=cell.chips, memory_peak_bytes=out["peak"])
    line = dict(correct=bool(out["correct"]), attempted=out["attempted"],
                failed=out["failed"], metrics=metrics, device=dev)
    if trace and ctx["trace"] is not None:
        dev.update(busy_s=ctx["trace"]["busy_s"],
                   window_s=ctx["trace"]["window_s"])
        line["breakdown"] = ctx["trace"]["breakdown"]
    run = dict(rounds=out["rounds"], window_s=out["window_s"],
               render_s=out["render_s"], host_bytes=out["host_bytes"],
               fleet_fps=out["fleet_fps"], setup_s=out["setup_s"],
               mib_per_seq=out["mib_per_seq"], mem0_bytes=out["mem0"])
    print("[vo_bench] run " + json.dumps(run), file=sys.stderr, flush=True)
    line["checks"] = {c["name"]: dict(value=c["value"], limit=c["limit"])
                      for c in out["lines"]}
    return line, out["lines"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="run the check's control (never a measurement)")
    args = ap.parse_args(argv)
    cell = cells.load(args.workload)
    _caches(cell.root)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"vo_bench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); {torch.cuda.device_count()} visible",
              file=sys.stderr)
        return 2
    line, lines = execute(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda:0", control=args.control)
    bad = forbidden_modules()
    if bad:
        print(f"vo_bench: loaded in the benchmark's process: {bad}",
              file=sys.stderr)
        return 3
    for c in lines:
        print(f"check {c['name']}: {c['value']} (limit {c['limit']})"
              f"{'' if c['ok'] else '  FAILED'}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
