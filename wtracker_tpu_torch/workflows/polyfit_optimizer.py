"""Tune polyfit sample weights with particle-swarm optimization
(reference: polyfit_optimizer.ipynb).

Port of ``workflows/polyfit_optimizer.py``: the swarm
(:func:`wtracker_tpu_torch.neural.optimize.optimize_polyfit_weights`, the
JAX package's draws and arithmetic) scores the whole population in one
batched float64 fit a step, on the device, and the tuned
``PolyfitConfig`` is written as JSON::

    python -m wtracker_tpu_torch.workflows.polyfit_optimizer --timing-config T.json \\
        --logs LOG.csv [...] --output polyfit.json [--pop 100] [--epochs 300] [--device cuda]
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--timing-config", required=True)
    ap.add_argument("--logs", required=True, nargs="+", help="bboxes.csv log(s)")
    ap.add_argument("--output", required=True, help="PolyfitConfig json output")
    ap.add_argument("--degree", type=int, default=2)
    ap.add_argument("--sample-times", type=int, nargs="+", default=[-30, -25, -20, -15, -10, -5, 0, 3])
    ap.add_argument("--pred-offset", type=int, default=None, help="target time (default: cycle+imaging/2)")
    ap.add_argument("--min-speed", type=float, default=0.0)
    ap.add_argument("--max-speed", type=float, default=float("inf"))
    ap.add_argument("--pop", type=int, default=100)
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device of the swarm (default: cuda)")
    args = ap.parse_args(argv)

    import numpy as np

    from wtracker_tpu_torch.neural.optimize import optimize_polyfit_weights
    from wtracker_tpu_torch.sim.config import TimingConfig
    from wtracker_tpu_torch.sim.controllers.polyfit import PolyfitConfig, WeightEvaluator

    timing = TimingConfig.load_json(args.timing_config)
    pred_offset = (
        args.pred_offset if args.pred_offset is not None else timing.cycle_frame_num + timing.imaging_frame_num // 2
    )
    evaluator = WeightEvaluator(
        list(args.logs),
        timing,
        input_time_offsets=np.asarray(args.sample_times),
        pred_time_offset=pred_offset,
        min_speed=args.min_speed,
        max_speed=args.max_speed,
        device=args.device,
    )

    baseline = evaluator.eval(np.ones(len(args.sample_times)), deg=args.degree)
    result = optimize_polyfit_weights(evaluator, degree=args.degree, pop_size=args.pop, epochs=args.epochs, seed=args.seed)
    print(f"MAE uniform {baseline:.4f} -> tuned {result.best_value:.4f}")

    cfg = PolyfitConfig(
        degree=args.degree,
        sample_times=list(args.sample_times),
        weights=[float(w) for w in result.best_position],
    )
    cfg.save_json(args.output)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
