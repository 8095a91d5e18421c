"""Replay a simulation log with overlays.

Port of ``workflows/visualize.py``: exports annotated frames (PNG or BMP,
drawn in numpy: no OpenCV needed) and/or an mp4 (OpenCV); ``--play`` opens
the interactive window (OpenCV and a display)::

    python -m wtracker_tpu_torch.workflows.visualize --timing-config T --log bboxes.csv \\
        [--frames DIR] --save-frames OUT [--start 0 --stop N] [--device cuda]

The overlays are drawn on the host; ``--device`` is checked as the other
commands check it, so a command line runs the same on every command.
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--timing-config", required=True)
    ap.add_argument("--log", required=True, help="bboxes.csv")
    ap.add_argument("--frames", help="directory of frame images (white frames if omitted)")
    ap.add_argument("--cam-type", default="plt", choices=["plt", "cam", "mic"])
    ap.add_argument("--video", help="write an mp4 here (needs OpenCV)")
    ap.add_argument("--save-frames", help="write annotated frames to this folder")
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--stop", type=int, default=None)
    ap.add_argument("--play", action="store_true", help="interactive window (needs OpenCV and a display)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda; rendering runs on the host)")
    args = ap.parse_args(argv)

    from wtracker_tpu_torch.eval import VLC
    from wtracker_tpu_torch.sim.config import TimingConfig
    from wtracker_tpu_torch.utils.device import resolve_device
    from wtracker_tpu_torch.utils.frame_reader import FrameReader

    resolve_device(args.device)
    timing = TimingConfig.load_json(args.timing_config)
    files = None
    if args.frames:
        reader = FrameReader.create_from_directory(args.frames)
        files = [f"{reader.root_folder}/{f}" for f in reader.files]

    vlc = VLC(files=files, config=timing, log_path=args.log, cam_type=args.cam_type, show_cam=True)

    if args.video:
        vlc.make_video(args.video, start=args.start, stop=args.stop)
        print(f"wrote {args.video}")
    if args.save_frames:
        vlc.save_frames(args.save_frames, start=args.start, stop=args.stop or len(vlc))
        print(f"wrote frames to {args.save_frames}")
    if args.play:
        vlc.play()


if __name__ == "__main__":
    main()
