"""Live tracking over a recorded experiment: the full YOLO → ResMLP closed loop.

Port of ``workflows/track_video.py``.  Streams the recording through the
card in chunks (native BMP decode on the host; crops, detection and control
on the device) and writes the 17-column ``bboxes.csv``::

    python -m wtracker_tpu_torch.workflows.track_video --frames DIR \\
        --timing-config configs/timing_config.json --exp-config configs/exp_config.json \\
        --detector models/yolov8s_worm416.npz --output OUT [--roi 480] [--device cuda]
"""

from __future__ import annotations

import argparse


def refuse_predictor_pt(predictor: str | None) -> None:
    """Predictor ``.pt`` files stay refused: the JAX package's
    ``load_torch_checkpoint`` (``resmlp.py:267``) unpickles whole upstream
    modules after putting a discovered package root on ``sys.path``, which
    can run that package's code (ROADMAP Queue 3).  Detector ``.pt`` state
    dicts load (``YoloV8Detector.load``)."""
    if predictor and predictor.endswith(".pt"):
        raise NotImplementedError(
            f"predictor {predictor}: predictor .pt files are not loaded (the JAX package's "
            "load_torch_checkpoint, resmlp.py:267, puts a discovered package root on sys.path before "
            "unpickling, ROADMAP Queue 3). Use a Flax .npz."
        )


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", required=True, help="directory of frame images")
    ap.add_argument("--timing-config", required=True)
    ap.add_argument("--exp-config", required=True)
    ap.add_argument(
        "--detector",
        required=True,
        help="YOLOv8 weights (Flax .npz of either package, or an ultralytics-layout .pt state dict), "
        "or an int8 deployment artifact from quantize_detector (either package's; detected from the file)",
    )
    ap.add_argument("--predictor", help="ResMLP checkpoint (.npz); a seeded untrained predictor if omitted")
    ap.add_argument("--output", required=True, help="output folder for bboxes.csv")
    ap.add_argument("--imgsz", type=int, default=416)
    ap.add_argument("--conf", type=float, default=0.1)
    ap.add_argument("--chunk-cycles", type=int, default=64)
    ap.add_argument(
        "--roi",
        type=int,
        default=None,
        metavar="PX",
        help="ROI streaming: read and upload only a PX-sized window per frame "
        "(speculated from the platform trajectory; missed windows replay "
        "exactly, so the output is identical to the whole-frame loop's)",
    )
    ap.add_argument("--roi-chunk-cycles", type=int, default=8)
    ap.add_argument(
        "--fused-preproc",
        action=argparse.BooleanOptionalAction,
        default=None,
        help="the crop+letterbox CUDA kernel (default: auto, on for a CUDA device with a "
        "square camera and imgsz; a folded-stem detector turns it off)",
    )
    ap.add_argument("--device", default="cuda", help="torch device of the loop (default: cuda)")
    args = ap.parse_args(argv)
    refuse_predictor_pt(args.predictor)

    from wtracker_tpu_torch.models.resmlp import load_predictor, make_rmlp_predictor
    from wtracker_tpu_torch.models.yolov8 import YoloV8Detector
    from wtracker_tpu_torch.models.yolov8_int8 import Int8Detector, QuantizedYolo, is_quantized_artifact, make_detect_fns
    from wtracker_tpu_torch.neural.config import IOConfig
    from wtracker_tpu_torch.sim.config import ExperimentConfig, TimingConfig
    from wtracker_tpu_torch.sim.engine import EngineParams, logs_to_frame
    from wtracker_tpu_torch.sim.engine_live import LiveLoopConfig
    from wtracker_tpu_torch.sim.engine_video import run_video_live
    from wtracker_tpu_torch.utils.device import resolve_device
    from wtracker_tpu_torch.utils.frame_reader import FrameReader
    from wtracker_tpu_torch.utils.path_utils import create_directory, join_paths

    dev = resolve_device(args.device)
    timing = TimingConfig.load_json(args.timing_config)
    exp = ExperimentConfig.load_json(args.exp_config)
    reader = FrameReader.create_from_directory(args.frames)

    detect_fn = detect_preprocessed_fn = None
    if args.detector.endswith(".npz") and is_quantized_artifact(args.detector):
        # the int8 graph: the folded stem where the letterbox does not pad,
        # through the crop+letterbox kernel otherwise
        q = QuantizedYolo.load(args.detector)
        qw = q.device_weights(dev)
        det_model = Int8Detector(q, qw)
        cam_hw = (timing.camera_size_px[1], timing.camera_size_px[0])
        detect_fn, detect_preprocessed_fn = make_detect_fns(q, src_hw=cam_hw, imgsz=(args.imgsz, args.imgsz), qw=qw)
    else:
        # float32, as the JAX command builds its YoloV8
        det_model = YoloV8Detector.load(args.detector, imgsz=args.imgsz, conf=args.conf, device=dev).fuse().model
    if args.predictor:
        predictor = load_predictor(args.predictor, device=dev)
    else:
        predictor = make_rmlp_predictor(IOConfig([0], [max(timing.pred_frame_num, 1)]), device=dev)

    params = EngineParams.from_timing(timing, reader.frame_size)
    max_speed_px_frame = 0.9 * (timing.px_per_mm / timing.frames_per_sec)
    cfg = LiveLoopConfig(
        imgsz=(args.imgsz, args.imgsz),
        conf=args.conf,
        ring_size=max(64, 2 * params.cycle_n),
        log_mode=True,
        max_dist_per_pred=max_speed_px_frame * max(predictor.io_config.pred_frames[0], 1),
        use_fused_preproc=args.fused_preproc,
    )

    roi_stats: dict = {}
    logs = run_video_live(
        params,
        cfg,
        lambda s, n, out=None: reader.read_batch(range(s, min(s + n, len(reader))), out=out),
        len(reader),
        det_model,
        predictor,
        exp.init_position,
        cycles_per_chunk=args.chunk_cycles,
        detect_fn=detect_fn,
        detect_preprocessed_fn=detect_preprocessed_fn,
        roi_window=args.roi,
        roi_chunk_cycles=args.roi_chunk_cycles,
        window_source=(
            lambda s, n, tls, out=None: reader.read_window_batch(range(s, s + n), tls, (args.roi, args.roi), out=out)
        )
        if args.roi
        else None,
        roi_stats=roi_stats,
        device=dev,
    )
    if roi_stats:
        # replay telemetry: a rate near 0 means the speculation holds; a high
        # worst chunk means the window is too tight for the worm's speed
        # (each replay reads and runs its chunk again)
        rate = roi_stats["replays"] / max(roi_stats["chunks"], 1)
        print(
            f"ROI streaming: {roi_stats['chunks']} chunks, {roi_stats['replays']} "
            f"replays ({rate:.2f}/chunk, worst chunk {roi_stats['max_chunk_replays']})"
        )

    df = logs_to_frame(params, logs)
    create_directory(args.output)
    out = join_paths(args.output, "bboxes.csv")
    df.to_csv(out, index=False)
    print(f"wrote {out} ({len(df)} rows)")


if __name__ == "__main__":
    main()
