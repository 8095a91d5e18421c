"""Initialize an experiment from raw frames.

Port of ``workflows/initialize_experiment.py``: computes the background
(a per-pixel median over probe frames, on the device), detects the worm in
every frame (the classical bootstrap, or a YOLOv8 detector on whole frames),
and writes ``init_bboxes.csv``, ``background.npy`` and ``exp_config.json``,
the files every later simulation replays from::

    python -m wtracker_tpu_torch.workflows.initialize_experiment --frames DIR --output OUT \\
        [--detector classical | --detector yolo --yolo-weights models/yolov8s_worm416.npz --imgsz 416] \\
        [--device cuda]
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", required=True, help="directory of frame images")
    ap.add_argument("--output", required=True, help="output experiment folder")
    ap.add_argument("--name", default="exp")
    ap.add_argument("--fps", type=float, default=60.0)
    ap.add_argument("--px-per-mm", type=float, default=90.0)
    ap.add_argument("--init-position", type=int, nargs=2, default=None, help="platform start (x y)")
    ap.add_argument("--detector", default="classical", choices=["classical", "yolo"])
    ap.add_argument("--yolo-weights", help="detector weights (.npz or ultralytics-layout .pt)")
    ap.add_argument("--imgsz", type=int, default=384)
    ap.add_argument("--bg-probes", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--device", default="cuda", help="torch device of the background and detection (default: cuda)")
    args = ap.parse_args(argv)

    import numpy as np
    import pandas as pd
    import torch

    from wtracker_tpu_torch.dataset import BGExtractor, BoxCalculator
    from wtracker_tpu_torch.sim.config import ExperimentConfig
    from wtracker_tpu_torch.utils.device import resolve_device
    from wtracker_tpu_torch.utils.frame_reader import FrameReader
    from wtracker_tpu_torch.utils.path_utils import create_directory, join_paths

    dev = resolve_device(args.device)
    reader = FrameReader.create_from_directory(args.frames)
    create_directory(args.output)

    print(f"{len(reader)} frames @ {reader.frame_size}")
    bg = BGExtractor(reader).calc_background(args.bg_probes, device=dev)
    np.save(join_paths(args.output, "background.npy"), bg)

    if args.detector == "classical":
        calc = BoxCalculator(reader, bg, device=dev)
        boxes = calc.calc_all_boxes(chunk_size=args.batch).astype(float)
        boxes[boxes[:, 2] <= 0] = np.nan  # no blob -> NaN protocol
    else:
        from wtracker_tpu_torch.models.yolov8 import YoloV8Detector

        det = YoloV8Detector.load(args.yolo_weights, imgsz=args.imgsz, device=dev)
        boxes = np.empty((len(reader), 4))
        for s in range(0, len(reader), args.batch):
            idx = range(s, min(s + args.batch, len(reader)))
            boxes[list(idx)] = det.detect(torch.from_numpy(reader.read_batch(idx)).to(dev)).cpu().numpy()

    pd.DataFrame(boxes, columns=["wrm_x", "wrm_y", "wrm_w", "wrm_h"]).to_csv(
        join_paths(args.output, "init_bboxes.csv"), index=False
    )

    finite = np.isfinite(boxes).all(axis=1)
    if args.init_position is None:
        first = boxes[np.argmax(finite)]
        args.init_position = [int(first[0] + first[2] / 2), int(first[1] + first[3] / 2)]

    exp = ExperimentConfig.from_frame_reader(
        reader,
        name=args.name,
        frames_per_sec=args.fps,
        px_per_mm=args.px_per_mm,
        init_position=tuple(args.init_position),
    )
    exp.save_json(join_paths(args.output, "exp_config.json"))
    print(
        f"wrote init_bboxes.csv ({int(finite.sum())}/{len(boxes)} detections), "
        f"background.npy, exp_config.json -> {args.output}"
    )


if __name__ == "__main__":
    main()
