"""Analyze a simulation log.

Port of ``workflows/analysis.py``: derives the analysis columns, cleans the
data, optionally computes the segmentation-based precise error (on the
device), prints statistics, writes ``analyzed.csv`` and saves the plots::

    python -m wtracker_tpu_torch.workflows.analysis --timing-config T --log bboxes.csv --output OUT \\
        [--worm-crops DIR --background background.npy] [--device cuda]

The csv and the statistics need neither matplotlib nor seaborn; the plots
need both, and without them the command says so on one line and still
writes ``analyzed.csv``.
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--timing-config", required=True)
    ap.add_argument("--log", required=True, help="bboxes.csv to analyze")
    ap.add_argument("--output", required=True, help="output folder (analyzed csv + plots)")
    ap.add_argument("--period", type=int, default=10, help="speed-measure span in frames")
    ap.add_argument("--unit", default="sec", choices=["frame", "sec"])
    ap.add_argument("--trim-cycles", action="store_true", default=True)
    ap.add_argument("--imaging-only", action="store_true")
    ap.add_argument("--remove-anomalies", action="store_true")
    ap.add_argument("--worm-crops", help="folder of worm crops (enables precise error)")
    ap.add_argument("--background", help="background.npy (enables precise error)")
    ap.add_argument("--device", default="cuda", help="torch device of the precise error (default: cuda)")
    args = ap.parse_args(argv)

    import numpy as np

    from wtracker_tpu_torch.eval import DataAnalyzer, Plotter
    from wtracker_tpu_torch.sim.config import TimingConfig
    from wtracker_tpu_torch.utils.device import resolve_device
    from wtracker_tpu_torch.utils.path_utils import create_directory, join_paths

    dev = resolve_device(args.device)
    timing = TimingConfig.load_json(args.timing_config)
    create_directory(args.output)

    an = DataAnalyzer.load(timing, args.log)
    an.initialize(period=args.period)

    if args.worm_crops and args.background:
        from wtracker_tpu_torch.utils.frame_reader import FrameReader

        an.calc_precise_error(
            FrameReader.create_from_directory(args.worm_crops),
            np.load(args.background),
            batched=True,
            device=dev,
        )

    an.clean(trim_cycles=args.trim_cycles, imaging_only=args.imaging_only)
    if args.remove_anomalies:
        an.calc_anomalies(no_preds=True, remove_anomalies=True)
    an.change_unit(args.unit)
    an.print_stats()

    an.data.to_csv(join_paths(args.output, "analyzed.csv"), index=False)

    try:
        import matplotlib  # noqa: F401
        import seaborn  # noqa: F401
    except ImportError as e:
        print(f"plots skipped: {e.name} is not installed (analyzed.csv is written)")
    else:
        plotter = Plotter.from_analyzers([an])  # the unit the analyzer applied
        for name, fn in [
            ("speed_distribution", plotter.plot_speed_distribution),
            ("error_distribution", plotter.plot_error_distribution),
            ("cycle_error", plotter.plot_cycle_error),
            ("speed_vs_error", plotter.plot_speed_vs_error),
            ("trajectory", plotter.plot_trajectory),
            ("deviation", plotter.plot_deviation),
        ]:
            try:
                g = fn()
                g.savefig(join_paths(args.output, f"{name}.png"))
            except Exception as e:  # a plot failing shouldn't kill the analysis
                print(f"plot {name} failed: {e}")
    print(f"analysis written to {args.output}")


if __name__ == "__main__":
    main()
