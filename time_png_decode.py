"""Time PNG reads at the deployment frame size through the port's codec.

One seeded 1430x1671 frame of ``chip_smoke.Recording`` (noisy agar and a
worm), gray and as BGR, is written as PNG by OpenCV when it is installed,
with its default parameters (Sub rows) and at compression level 6 (libpng
then picks each row's filter: on this texture Average rows, which a
decoder undoes byte after byte), and else by the port's encoder (filter 0
rows only).  Each file is then read ``--reps`` times by
``wtracker_tpu_torch.utils.image_codec.imread`` and, where OpenCV is
installed, by ``cv2.imread``; the pixels must agree.  Prints one JSON line:
the rows of each filter type and the median seconds a read.

    python3 time_png_decode.py [--reps 5]
"""

from __future__ import annotations

import argparse
import json
import struct
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np

from chip_smoke import Recording
from wtracker_tpu_torch.utils import image_codec

HW = (1430, 1671)  # configs/exp_config.json's frame size


def row_filters(data: bytes, h: int, stride: int) -> list[int]:
    """How many rows of a non-interlaced 8-bit PNG use each of the five filters."""
    pos, idat = 8, []
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        if kind == b"IDAT":
            idat.append(data[pos + 8 : pos + 8 + length])
        pos += 12 + length
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, stride + 1)
    return np.bincount(raw[:, 0], minlength=5).tolist()


def median_s(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()
    try:
        import cv2
    except ImportError:
        cv2 = None

    gray = Recording(16, HW, seed=9).data[0]
    images = {"gray": gray, "bgr": np.stack([gray, gray[::-1], gray[:, ::-1]], axis=-1)}
    out = {"hw": list(HW), "writer": "opencv" if cv2 else "image_codec", "reps": args.reps}
    with tempfile.TemporaryDirectory() as tmp:
        writers = {"default": ()} if cv2 is None else {"default": (), "level6": (cv2.IMWRITE_PNG_COMPRESSION, 6)}
        for name, img, (written, params) in [(n, i, w) for n, i in images.items() for w in writers.items()]:
            name = f"{name}_{written}"
            path = str(Path(tmp) / f"{name}.png")
            if cv2 is None:
                image_codec.imwrite(path, img)
            else:
                cv2.imwrite(path, img, list(params))
            got = image_codec.imread(path, image_codec.IMREAD_UNCHANGED)
            if not np.array_equal(got, img):
                raise AssertionError(f"image_codec.imread gave other pixels for the {name} PNG")
            row = {
                "bytes": Path(path).stat().st_size,
                "row_filters": row_filters(Path(path).read_bytes(), HW[0], img[0].size),
                "image_codec_s": median_s(lambda: image_codec.imread(path, image_codec.IMREAD_UNCHANGED), args.reps),
                "opencv_s": None,
            }
            if cv2:
                row["opencv_s"] = median_s(lambda: cv2.imread(path, cv2.IMREAD_UNCHANGED), args.reps)
            out[name] = row
    print(json.dumps({"png_decode": out}))


if __name__ == "__main__":
    main()
