"""Multi-experiment sweep: replay many trajectories in one engine run.

Port of ``workflows/sweep.py``.  The reference runs experiments one at a
time; here all logs stream-batch through one engine run on one device,
writing ``OUTPUT/exp{i}/bboxes.csv`` for each experiment.

Two modes:

* homogeneous (``--frame-shape`` + ``--init-position``): all experiments
  share one geometry;
* mixed geometry (``--exp-configs``): one exp_config.json per experiment —
  exp0–exp4-style sets with different resolutions, px_per_mm and init
  positions run in one sweep (per-stream arena clamps and camera sizes),
  split into one run per quantized cycle shape when the timings differ::

    python -m wtracker_tpu_torch.workflows.sweep --worm-csvs W0.csv W1.csv \\
        --exp-configs configs/exp0_config.json configs/exp1_config.json \\
        --timing-configs configs/exp0_timing.json configs/exp1_timing.json --output OUT [--device cuda]
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--timing-config", help="shared timing config (single-regime sweeps)")
    ap.add_argument(
        "--timing-configs",
        nargs="+",
        help="one timing config per experiment (mixed-geometry mode only); experiments are grouped by "
        "quantized cycle shape and each group runs as its own sweep",
    )
    ap.add_argument("--worm-csvs", required=True, nargs="+", help="trajectory log per experiment")
    ap.add_argument("--init-position", type=int, nargs=2, help="shared init (homogeneous mode)")
    ap.add_argument("--frame-shape", type=int, nargs=2, help="shared clamp bounds h w (homogeneous mode)")
    ap.add_argument("--exp-configs", nargs="+", help="exp_config.json per experiment (mixed-geometry mode)")
    ap.add_argument("--output", required=True, help="output folder (one subfolder per experiment)")
    ap.add_argument("--mesh", action="store_true", help="shard streams across devices (not ported)")
    ap.add_argument("--device", default="cuda", help="torch device of the engine (default: cuda)")
    args = ap.parse_args(argv)

    if args.mesh:
        raise NotImplementedError(
            "--mesh is not ported yet (ROADMAP Queue 1 item 8: parallel/mesh.py); the sweep runs on one device"
        )

    import numpy as np
    import pandas as pd

    from wtracker_tpu_torch.sim.config import ExperimentConfig, TimingConfig
    from wtracker_tpu_torch.utils.device import resolve_device
    from wtracker_tpu_torch.utils.path_utils import create_directory, join_paths

    dev = resolve_device(args.device)
    tables = [pd.read_csv(p)[["wrm_x", "wrm_y", "wrm_w", "wrm_h"]].to_numpy(dtype=float) for p in args.worm_csvs]

    if args.exp_configs:
        # -- mixed geometry: per-experiment arenas/cameras in one run -------
        from wtracker_tpu_torch.sim.engine_hetero import (
            bucket_by_cycle_shape,
            csv_controller_hetero,
            geometry_from_configs,
            pad_worm_tables,
            run_sweep_hetero,
        )

        if len(args.exp_configs) != len(args.worm_csvs):
            ap.error("--exp-configs must list one config per --worm-csvs entry")
        if not args.timing_config and not args.timing_configs:
            ap.error("--timing-config or --timing-configs is required")
        exps = [ExperimentConfig.load_json(p) for p in args.exp_configs]
        if args.timing_configs:
            if len(args.timing_configs) != len(args.exp_configs):
                ap.error("--timing-configs must list one config per experiment")
            bases = [TimingConfig.load_json(p) for p in args.timing_configs]
        else:
            bases = [TimingConfig.load_json(args.timing_config)] * len(exps)
        timings = [
            TimingConfig(
                experiment_config=e,
                imaging_time_ms=b.imaging_time_ms,
                pred_time_ms=b.pred_time_ms,
                moving_time_ms=b.moving_time_ms,
                camera_size_mm=b.camera_size_mm,
                micro_size_mm=b.micro_size_mm,
            )
            for e, b in zip(exps, bases)
        ]
        # timing regimes that quantize differently cannot share one cycle
        # shape: run each bucket as its own sweep, merge in input order
        frames = [None] * len(exps)
        n_cycles = 0
        buckets = bucket_by_cycle_shape(timings)
        for bucket in buckets:
            params, geometry = geometry_from_configs([timings[i] for i in bucket], [exps[i] for i in bucket])
            ctl = csv_controller_hetero(pad_worm_tables([tables[i] for i in bucket]), params, geometry, device=dev)
            init = np.asarray([exps[i].init_position for i in bucket])
            out = run_sweep_hetero(params, geometry, ctl, init, device=dev)
            for j, i in enumerate(bucket):
                frames[i] = out[j]
            n_cycles = max(n_cycles, params.n_logged_cycles(int(geometry.num_frames.max())))
        if len(buckets) > 1:
            print(f"split into {len(buckets)} timing buckets: {buckets}")
    else:
        # -- homogeneous: one geometry shared by all streams -----------------
        from wtracker_tpu_torch.sim.engine import (
            CycleLog,
            EngineParams,
            csv_controller_streams,
            logs_to_frame,
            run_engine_streams,
        )

        if not (args.frame_shape and args.init_position):
            ap.error("either --frame-shape + --init-position or --exp-configs is required")
        if not args.timing_config:
            ap.error("--timing-config is required in homogeneous mode")
        timing = TimingConfig.load_json(args.timing_config)
        params = EngineParams.from_timing(timing, tuple(args.frame_shape))

        n = max(len(t) for t in tables)
        csvs = np.full((len(tables), n, 4), np.nan)
        for i, t in enumerate(tables):
            csvs[i, : len(t)] = t

        n_cycles = params.n_logged_cycles(n)
        ctl = csv_controller_streams(csvs, params, device=dev)
        init_pos = np.tile(np.asarray(args.init_position), (len(tables), 1))
        logs = run_engine_streams(params, ctl, init_pos, n_cycles, batched_controller=True, device=dev)
        frames = [
            logs_to_frame(params, CycleLog(positions=logs.positions[:, i], worm_bboxes=logs.worm_bboxes[:, i]))
            for i in range(len(tables))
        ]

    for i, df in enumerate(frames):
        out_dir = join_paths(args.output, f"exp{i}")
        create_directory(out_dir)
        df.to_csv(join_paths(out_dir, "bboxes.csv"), index=False)
    print(f"swept {len(tables)} experiments x {n_cycles} cycles -> {args.output}")


if __name__ == "__main__":
    main()
