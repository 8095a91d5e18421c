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

``--mesh`` shards the streams over every visible card, one host process
driving them all (``--mesh N``: N slots spread over the cards in turn, so
``--mesh 2`` on one card runs two shards on it; with ``--device cpu``, N
CPU slots).  Each run pads its streams to a multiple of the slot count by
repeating the last experiment and drops the padded logs; the files are
those of the run without ``--mesh``.
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
    ap.add_argument(
        "--mesh", nargs="?", type=int, const=0, metavar="SLOTS",
        help="shard streams across devices: every visible card, or SLOTS slots spread over them",
    )
    ap.add_argument("--device", default="cuda", help="torch device of the engine (default: cuda)")
    args = ap.parse_args(argv)

    import numpy as np
    import pandas as pd
    import torch

    from wtracker_tpu_torch.parallel.mesh import make_mesh, pad_streams, run_engine_sharded
    from wtracker_tpu_torch.sim.config import ExperimentConfig, TimingConfig
    from wtracker_tpu_torch.utils.device import resolve_device
    from wtracker_tpu_torch.utils.path_utils import create_directory, join_paths

    dev = resolve_device(args.device)
    mesh = make_mesh(devices=[dev])
    if args.mesh is not None:
        cards = torch.cuda.device_count() if dev.type == "cuda" else 0
        slots = args.mesh or max(cards, 1)
        mesh = make_mesh(devices=[f"cuda:{i % cards}" for i in range(slots)] if cards else ["cpu"] * slots)
        print(f"streams sharded over {slots} slots: {', '.join(str(d) for d in mesh.devices)}")
    tables = [pd.read_csv(p)[["wrm_x", "wrm_y", "wrm_w", "wrm_h"]].to_numpy(dtype=float) for p in args.worm_csvs]

    if args.exp_configs:
        # -- mixed geometry: per-experiment arenas/cameras in one run -------
        from wtracker_tpu_torch.sim.engine_hetero import (
            bucket_by_cycle_shape,
            csv_controller_hetero,
            geometry_from_configs,
            pad_worm_tables,
            run_sweep_hetero,
            slice_geometry,
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
            # a mesh run pads the bucket to a slot multiple by repeating its
            # last experiment (same timing, so the same cycle shape); the
            # padded streams' frames are not collected
            run = list(bucket) + [bucket[-1]] * ((-len(bucket)) % mesh.size)
            params, geometry = geometry_from_configs([timings[i] for i in run], [exps[i] for i in run])
            csvs = pad_worm_tables([tables[i] for i in run])
            init = np.asarray([exps[i].init_position for i in run])

            def ctl(d, lo, hi, csvs=csvs, params=params, geometry=geometry):
                return csv_controller_hetero(csvs[lo:hi], params, slice_geometry(geometry, lo, hi), device=d)

            out = run_sweep_hetero(params, geometry, ctl, init, mesh=mesh, device=dev)
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
        init_pos = np.tile(np.asarray(args.init_position), (len(tables), 1))
        csvs, init_pos, _ = pad_streams(csvs, init_pos, mesh.size)
        logs = run_engine_sharded(
            params, lambda d, lo, hi: csv_controller_streams(csvs[lo:hi], params, device=d), init_pos, n_cycles,
            mesh, batched_controller=True,
        )
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
