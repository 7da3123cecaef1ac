"""Command-line entry point — the `sdv_loam` node equivalent.

Counterpart of `sdv_loam_tpu/run.py` (reference main.cpp:246-466
parseArgument: calib/sensor paths, preset, mode, quiet, nogui, save, ...).
ROS topics are replaced by a KITTI sequence directory (or the synthetic
scene for a datasetless smoke run). The flags are the JAX CLI's, plus
`--device`: the port runs on the card unless asked for the CPU.

Usage:
  python -m sdv_loam_tpu_torch.run --seq-dir /data/kitti/sequences/00 \\
      --calib configs/calib/00.txt --sensor configs/sensor/00.txt \\
      --result 00.txt --preset 0
  python -m sdv_loam_tpu_torch.run --synthetic 40 --result traj.txt \\
      --viewer out/ --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser():
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seq-dir", help="KITTI sequence directory "
                   "(image_0/ + velodyne/ + times.txt)")
    p.add_argument("--calib", help="DSO-format camera calib file")
    p.add_argument("--sensor", help="4-line sensor (LiDAR extrinsics) file")
    p.add_argument("--gamma", help="photometric gamma file (pcalib)")
    p.add_argument("--vignette", help="vignette image")
    p.add_argument("--synthetic", type=int, metavar="N",
                   help="run N synthetic frames instead of a dataset")
    p.add_argument("--preset", type=int, default=0, choices=[0, 1, 2, 3],
                   help="0/1 default (2000 pts), 2/3 fast (800 pts) "
                   "(main.cpp:192-241)")
    p.add_argument("--result", default="result.txt",
                   help="KITTI-format trajectory output (printResult)")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--quiet", action="store_true", default=True)
    p.add_argument("--verbose", dest="quiet", action="store_false")
    p.add_argument("--nogui", action="store_true", default=True)
    p.add_argument("--viewer", metavar="DIR",
                   help="write viewer snapshots to DIR")
    p.add_argument("--viewer3d", metavar="HTML",
                   help="write an interactive 3-D map scene (standalone "
                        "HTML; Pangolin-viewer counterpart)")
    p.add_argument("--debug-plots", metavar="DIR",
                   help="write window debug renderings per KF "
                        "(FullSystemDebugStuff parity)")
    p.add_argument("--debug-plot-mode", type=int, default=0,
                   choices=[0, 1, 3, 4, 5, 6, 7],
                   help="debugPlot point-overlay mode (freeDebugParam5)")
    p.add_argument("--record", metavar="JSONL",
                   help="record observer events to JSONL")
    p.add_argument("--log", metavar="JSONL", help="telemetry log stream")
    p.add_argument("--checkpoint", metavar="NPZ",
                   help="save the final window state")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu for a "
                        "run without a card)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from sdv_loam_tpu_torch.config import Settings
    from sdv_loam_tpu_torch.system.runner import run_sequence

    if args.preset in (0, 1):
        settings = Settings.preset_default()
    else:
        settings = Settings.preset_fast()
    settings = type(settings)(**{**settings.__dict__,
                                 "seed": args.seed,
                                 "debugout_runquiet": args.quiet})

    if args.synthetic:
        from sdv_loam_tpu_torch.data.synthetic import make_sequence
        reader = make_sequence(n_frames=args.synthetic, w=1200, h=360,
                               fx=718.856, lidar_stride=2, half_width=16.0)
    else:
        if not (args.seq_dir and args.calib and args.sensor):
            print("need --seq-dir/--calib/--sensor or --synthetic N",
                  file=sys.stderr)
            return 2
        from sdv_loam_tpu_torch.data.kitti import KittiSequence
        reader = KittiSequence.open(args.seq_dir, args.calib, args.sensor,
                                    gamma_file=args.gamma,
                                    vignette_file=args.vignette)

    observers = []
    if args.viewer:
        from sdv_loam_tpu_torch.io.viewer import MatplotlibViewer
        observers.append(MatplotlibViewer(args.viewer))
    if args.viewer3d:
        from sdv_loam_tpu_torch.io.viewer3d import Html3DViewer
        observers.append(Html3DViewer(args.viewer3d, every=5))
    if args.debug_plots:
        from sdv_loam_tpu_torch.io.debug_plots import DebugPlotWriter
        observers.append(DebugPlotWriter(args.debug_plots,
                                         mode=args.debug_plot_mode))
    if args.record:
        from sdv_loam_tpu_torch.io.observer import JsonlRecorder
        observers.append(JsonlRecorder(args.record))

    fs, summary = run_sequence(reader, settings, device=args.device,
                               observers=observers, result_path=args.result,
                               log_path=args.log, max_frames=args.max_frames)
    if args.checkpoint:
        from sdv_loam_tpu_torch.system import checkpoint
        checkpoint.save(fs, args.checkpoint)
    print(json.dumps(summary))
    return 1 if summary.get("lost") else 0


if __name__ == "__main__":
    sys.exit(main())
