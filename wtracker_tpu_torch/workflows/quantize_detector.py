"""Post-training int8 quantization of a trained detector (deployment artifact).

Port of ``workflows/quantize_detector.py``.  Calibrates per-layer activation
scales on camera views cropped from the experiment's own recording (along a
previous run's camera trajectory when its ``bboxes.csv`` is given, the
initial camera window otherwise), then folds and quantizes every conv kernel
to per-output-channel symmetric int8
(:mod:`wtracker_tpu_torch.models.yolov8_int8`).  The artifact is the JAX
package's format and goes straight into ``track_video --detector``::

    python -m wtracker_tpu_torch.workflows.quantize_detector --detector models/yolov8s_worm416.npz \\
        --frames DIR --timing-config configs/timing_config.json --exp-config configs/exp_config.json \\
        --output det_int8.npz [--bboxes-csv PREV/bboxes.csv] [--calib-frames 64] [--device cuda]
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument(
        "--detector", required=True, help="trained weights (Flax .npz, or an ultralytics-layout .pt state dict)"
    )
    ap.add_argument("--frames", required=True, help="directory of recording frames (calibration source)")
    ap.add_argument("--timing-config", required=True)
    ap.add_argument("--exp-config", required=True)
    ap.add_argument(
        "--bboxes-csv",
        help="bboxes.csv of a previous (bf16) tracking run: calibration views "
        "follow its camera trajectory instead of the initial window",
    )
    ap.add_argument("--calib-frames", type=int, default=64, help="calibration views (spread over the recording)")
    ap.add_argument("--imgsz", type=int, default=416)
    ap.add_argument("--output", required=True, help="output .npz artifact path")
    ap.add_argument("--device", default="cuda", help="torch device of the calibration forward (default: cuda)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from wtracker_tpu_torch.models.yolov8 import YoloV8Detector
    from wtracker_tpu_torch.models.yolov8_int8 import quantize_detector
    from wtracker_tpu_torch.ops.image import crop_views
    from wtracker_tpu_torch.sim.config import ExperimentConfig, TimingConfig
    from wtracker_tpu_torch.sim.engine import EngineParams
    from wtracker_tpu_torch.utils.device import resolve_device
    from wtracker_tpu_torch.utils.frame_reader import FrameReader

    dev = resolve_device(args.device)
    timing = TimingConfig.load_json(args.timing_config)
    exp = ExperimentConfig.load_json(args.exp_config)
    reader = FrameReader.create_from_directory(args.frames)
    params = EngineParams.from_timing(timing, reader.frame_size)
    H, W = reader.frame_size

    n = min(args.calib_frames, len(reader))
    idxs = np.unique(np.linspace(0, len(reader) - 1, n).astype(int))

    if args.bboxes_csv:
        import pandas as pd

        log = pd.read_csv(args.bboxes_csv).set_index("frame")
        rows = log.reindex(idxs).ffill().bfill()  # tail frames past the log reuse its last window
        tls = rows[["cam_x", "cam_y"]].to_numpy(np.float32)
    else:
        tl = np.array([exp.init_position[0] - params.cam_w // 2, exp.init_position[1] - params.cam_h // 2])
        tls = np.tile(tl.astype(np.float32), (len(idxs), 1))
    tls[:, 0] = np.clip(tls[:, 0], 0, W - params.cam_w)
    tls[:, 1] = np.clip(tls[:, 1], 0, H - params.cam_h)
    tls = np.round(tls).astype(np.int32)

    frames = reader.read_batch(idxs)
    views = crop_views(torch.from_numpy(frames), torch.from_numpy(tls), (params.cam_h, params.cam_w))

    # float32 fused weights: quantize_detector folds and rounds them itself
    det = YoloV8Detector.load(args.detector, imgsz=args.imgsz, device=dev).fuse()
    q = quantize_detector(det.model, views, (args.imgsz, args.imgsz))
    q.save(args.output)
    print(
        f"wrote {args.output}: int8 {q.scale}-scale detector, "
        f"{len(q.qweights)} quantized convs, calibrated on {len(views)} views"
    )


if __name__ == "__main__":
    main()
