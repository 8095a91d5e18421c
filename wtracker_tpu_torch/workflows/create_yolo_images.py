"""Create a YOLO training set from raw frames.

Port of ``workflows/create_yolo_images.py``: background extraction → blob
detection (on the device) → fixed-size crops around each worm, saved as PNG
for annotation and training::

    python -m wtracker_tpu_torch.workflows.create_yolo_images --frames DIR --output OUT \\
        [--count 500] [--size 384 384] [--seed 0] [--device cuda]
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", required=True, help="directory of frame images")
    ap.add_argument("--output", required=True, help="sample output folder")
    ap.add_argument("--count", type=int, default=500, help="number of samples (0 = all frames)")
    ap.add_argument("--size", type=int, nargs=2, default=[384, 384], help="crop size (w h)")
    ap.add_argument("--bg-probes", type=int, default=500)
    ap.add_argument("--diff-thresh", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device of the background and detection (default: cuda)")
    args = ap.parse_args(argv)

    from wtracker_tpu_torch.dataset import BGExtractor, BoxCalculator, SampleExtractor
    from wtracker_tpu_torch.utils.device import resolve_device
    from wtracker_tpu_torch.utils.frame_reader import FrameReader

    dev = resolve_device(args.device)
    reader = FrameReader.create_from_directory(args.frames)
    bg = BGExtractor(reader).calc_background(args.bg_probes, device=dev)
    calc = BoxCalculator(reader, bg, diff_thresh=args.diff_thresh, device=dev)
    extractor = SampleExtractor(calc)

    if args.count:
        extractor.create_samples(args.count, tuple(args.size), args.output, seed=args.seed)
    else:
        extractor.create_all_samples(tuple(args.size), args.output, seed=args.seed)
    print(f"samples written to {args.output}")


if __name__ == "__main__":
    main()
