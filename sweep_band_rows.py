#!/usr/bin/env python3
"""Times the crop+letterbox kernel at each band height it was tried with.

The kernel (``wtracker_tpu_torch/csrc/crop_letterbox.cu``) writes
``kBandRows`` output rows of one view per block.  This script builds a copy
of the source for each height in ``BAND_ROWS_TRIED``, with that one constant
changed, loads it with the shipped entry point's C signature, checks that
its output equals the shipped kernel's, and times every copy in turns at the
video loop's two view counts (N = 12 and N = 3, cam 360 -> 416, bf16 out,
the L2 flushed before each launch, as ``chip_smoke.py`` times the kernel).
The shipped library and the main path are not touched.

Needs one CUDA card, ``nvcc`` and the checkout; run it from the checkout's
root as ``python3 sweep_band_rows.py``.  Prints the card line, then one JSON
line of kernel ms (median of 50 launches per round, two rounds) and the
compiler's register count per height.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from chip_smoke import SEED, card_line, time_ms

BAND_ROWS_TRIED = (2, 4, 8, 16)
H, W, CAM, IMGSZ = 1430, 1671, 360, 416  # the deployment's frame, camera and detector sizes
CHUNK_FRAMES = 240


def build_variant(band_rows: int, out_dir: Path) -> tuple[ctypes.CDLL, int]:
    """The kernel library with ``kBandRows = band_rows``, and the most
    registers ``ptxas`` gives either of its two kernels."""
    from wtracker_tpu_torch.ops import _build

    src = (_build.CSRC / "crop_letterbox.cu").read_text()
    shipped = "constexpr int kBandRows = 4;"
    if src.count(shipped) != 1:
        raise RuntimeError(f"crop_letterbox.cu no longer declares `{shipped}` once")
    cu = out_dir / f"crop_letterbox_r{band_rows}.cu"
    cu.write_text(src.replace(shipped, f"constexpr int kBandRows = {band_rows};"))
    lib = out_dir / f"libcrop_letterbox_r{band_rows}.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)], capture_output=True, text=True, timeout=600
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for kBandRows = {band_rows}:\n{proc.stdout}{proc.stderr}")
    # ptxas reports one "Used N registers" line per kernel: the float and the bfloat16 one
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", proc.stdout + proc.stderr)]
    dll = ctypes.CDLL(str(lib))
    dll.crop_letterbox.argtypes, dll.crop_letterbox.restype = _build.SIGNATURES["crop_letterbox"]
    return dll, max(regs)


def band_src_rows(band_rows: int) -> int:
    """The most crop rows a band of ``band_rows`` output rows reads."""
    from wtracker_tpu_torch.ops.preproc import tap_table

    idx, _ = tap_table(CAM, IMGSZ)
    starts = np.arange(0, IMGSZ, band_rows)
    ends = np.minimum(starts + band_rows, IMGSZ) - 1
    return int((idx[ends, 1] - idx[starts, 0]).max()) + 1


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_band_rows: no CUDA card is visible", file=sys.stderr)
        return 2
    from wtracker_tpu_torch.ops.preproc import _device_taps, crop_letterbox_views

    rng = np.random.default_rng(SEED)
    frames = torch.from_numpy(rng.integers(0, 256, (CHUNK_FRAMES, H, W), dtype=np.uint8)).cuda()
    taps = _device_taps(CAM, IMGSZ, frames.device)
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        variants = {r: build_variant(r, Path(tmp)) for r in BAND_ROWS_TRIED}
        result = {"registers": {str(r): regs for r, (_, regs) in variants.items()}}
        for n in (12, 3):
            idx = torch.from_numpy(rng.integers(0, CHUNK_FRAMES, n).astype(np.int32)).cuda()
            tls = torch.from_numpy(
                np.stack([rng.integers(0, W - CAM + 1, n), rng.integers(0, H - CAM + 1, n)], axis=1).astype(np.int32)
            ).cuda()
            want = crop_letterbox_views(frames, idx, tls, CAM, IMGSZ)[..., 0]
            calls = {}
            for r, (dll, _) in variants.items():
                out = torch.empty((n, IMGSZ, IMGSZ), dtype=torch.bfloat16, device="cuda")

                def call(r=r, dll=dll, out=out, src_rows=band_src_rows(r)):
                    err = dll.crop_letterbox(
                        frames.data_ptr(), idx.data_ptr(), tls.data_ptr(), taps.data_ptr(), out.data_ptr(),
                        n, CHUNK_FRAMES, H, W, CAM, IMGSZ, src_rows, 1, stream,
                    )
                    if err:
                        raise RuntimeError(f"kBandRows = {r} launch failed with CUDA error {err}")

                call()
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise AssertionError(f"kBandRows = {r} differs from the shipped kernel")
                calls[r] = call
            order = [*BAND_ROWS_TRIED, *reversed(BAND_ROWS_TRIED)]  # two rounds, in turns
            ms = {str(r): [] for r in BAND_ROWS_TRIED}
            for r in order:
                ms[str(r)].append(time_ms(calls[r]))
            result[f"ms_n{n}"] = ms
    print(card_line())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
