"""Closed-loop simulation over a logged trajectory (reference: simulate.ipynb).

Port of ``workflows/simulate.py``: replays a worm trajectory (an
``init_bboxes.csv``-style log with ``wrm_*`` columns) through one of the
controllers and writes the resulting ``bboxes.csv``.  ``--backend engine``
runs the replay engine; ``--backend host`` runs the hook-based simulator
(the reference's own event loop, one frame at a time on the host; the mlp
controller's predictor runs on ``--device``)::

    python -m wtracker_tpu_torch.workflows.simulate --timing-config configs/timing_config.json \\
        --exp-config configs/exp_config.json --worm-csv WORM.csv --output OUT \\
        [--controller csv|optimal|polyfit|mlp] [--backend engine|host] [--polyfit-config P.json] \\
        [--predictor P.npz] [--motor sine|step] [--device cuda]

The engine writes ``\\n`` line ends (pandas), the host simulator ``\\r\\n``
(the ``csv`` module, as the JAX package's host backend); the rows are the
same text.
"""

from __future__ import annotations

import argparse
import time


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--timing-config", required=True, help="TimingConfig json")
    ap.add_argument("--exp-config", required=True, help="ExperimentConfig json")
    ap.add_argument("--worm-csv", required=True, help="trajectory log (wrm_* columns)")
    ap.add_argument("--output", required=True, help="output folder for bboxes.csv")
    ap.add_argument("--controller", default="polyfit", choices=["csv", "optimal", "polyfit", "mlp"])
    ap.add_argument("--backend", default="engine", choices=["engine", "host"])
    ap.add_argument("--polyfit-config", help="PolyfitConfig json (controller=polyfit)")
    ap.add_argument("--predictor", help="predictor .npz checkpoint (controller=mlp)")
    ap.add_argument("--motor", default="sine", choices=["sine", "step"], help="platform motor profile")
    ap.add_argument(
        "--device", default="cuda", help="torch device of the engine, or of the host backend's predictor (default: cuda)"
    )
    args = ap.parse_args(argv)

    if args.controller == "mlp" and not args.predictor:
        ap.error("--controller mlp needs --predictor")

    from wtracker_tpu_torch.workflows.track_video import refuse_predictor_pt

    refuse_predictor_pt(args.predictor if args.controller == "mlp" else None)

    import numpy as np
    import pandas as pd

    from wtracker_tpu_torch.sim import engine
    from wtracker_tpu_torch.sim.config import ExperimentConfig, TimingConfig
    from wtracker_tpu_torch.utils.device import resolve_device
    from wtracker_tpu_torch.utils.path_utils import create_directory, join_paths

    dev = resolve_device(args.device)
    timing = TimingConfig.load_json(args.timing_config)
    exp = ExperimentConfig.load_json(args.exp_config)
    if args.backend == "host":
        _run_host(args, timing, exp, dev)
        return
    params = engine.EngineParams.from_timing(
        timing, engine.headless_frame_shape(timing, exp.orig_resolution), motor=args.motor
    )
    csv_data = pd.read_csv(args.worm_csv)[["wrm_x", "wrm_y", "wrm_w", "wrm_h"]].to_numpy(dtype=float)

    if args.controller == "csv":
        ctl = engine.csv_controller(csv_data, params, device=dev)
    elif args.controller == "optimal":
        ctl = engine.optimal_controller(csv_data, params, device=dev)
    elif args.controller == "polyfit":
        from wtracker_tpu_torch.sim.controllers import PolyfitConfig

        cfg = (
            PolyfitConfig.load_json(args.polyfit_config)
            if args.polyfit_config
            else PolyfitConfig(degree=2, sample_times=[-15, -10, -5, 0, 3])
        )
        ctl = engine.polyfit_controller(
            csv_data, params, np.array(cfg.sample_times), np.array(cfg.weights), cfg.degree, device=dev
        )
    else:
        from wtracker_tpu_torch.models.resmlp import load_predictor

        pred = load_predictor(args.predictor, device=dev)
        ctl = engine.mlp_controller(
            csv_data, params, pred, engine.mlp_max_dist_per_pred(timing, pred.io_config), device=dev
        )

    n_cycles = params.n_logged_cycles(exp.num_frames)
    logs = engine.run_engine(params, ctl, exp.init_position, n_cycles, device=dev)
    df = engine.logs_to_frame(params, logs)

    create_directory(args.output)
    out = join_paths(args.output, "bboxes.csv")
    df.to_csv(out, index=False)
    print(f"wrote {out} ({len(df)} rows, {n_cycles} cycles)")


def _run_host(args, timing, exp, dev) -> None:
    """``--backend host``: the hook-based simulator with the logging wrapper."""
    from wtracker_tpu_torch.sim.controllers import (
        CsvController,
        LogConfig,
        LoggingController,
        MLPController,
        OptimalController,
        PolyfitConfig,
        PolyfitController,
    )
    from wtracker_tpu_torch.sim.motor import SineMotorController, StepMotorController
    from wtracker_tpu_torch.sim.simulator import Simulator

    if args.controller == "csv":
        inner = CsvController(timing, args.worm_csv)
    elif args.controller == "optimal":
        inner = OptimalController(timing, args.worm_csv)
    elif args.controller == "polyfit":
        cfg = (
            PolyfitConfig.load_json(args.polyfit_config)
            if args.polyfit_config
            else PolyfitConfig(degree=2, sample_times=[-15, -10, -5, 0, 3])
        )
        inner = PolyfitController(timing, cfg, args.worm_csv)
    else:
        from wtracker_tpu_torch.models.resmlp import load_predictor

        inner = MLPController(timing, args.worm_csv, load_predictor(args.predictor, device=dev))

    motor = StepMotorController(timing) if args.motor == "step" else SineMotorController(timing)
    ctl = LoggingController(inner, LogConfig(root_folder=args.output, save_err_view=False))
    t0 = time.perf_counter()
    Simulator(timing, exp, ctl, motor_controller=motor).run(progress=False)
    loop_s = time.perf_counter() - t0
    n_cycles = (exp.num_frames - 1) // timing.cycle_frame_num
    print(f"wrote {args.output}/bboxes.csv ({n_cycles} cycles, {loop_s:.3f} s in the simulator loop)")


if __name__ == "__main__":
    main()
