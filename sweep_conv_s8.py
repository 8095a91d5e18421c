#!/usr/bin/env python3
"""Times the int8 convolution kernel (K2) against variants of itself.

The kernel (``wtracker_tpu_torch/csrc/conv_s8.cu``) is an implicit GEMM on
the int8 tensor cores fed by a ring of ``kStages`` TMA stages.  This
script builds a copy of the source for each variant below, with one change
each, loads it with the shipped entry point's C signature, and times it
beside the shipped kernel:

- ``stages3``, ``stages6``: the ring's depth (the kernel has 4); held bit
  for bit to the plain version at every shape of the 12-view forward;
- ``loads_only``: the main loop only waits for and refills the ring (no
  product); ``no_loads``: it loads no stage after the first ones; ``no_mma``:
  it issues no wgmma.  These three are timing ablations: their outputs are
  wrong by construction and are not checked.

and two launch plans for the shipped kernel, set through the wrapper's
``SMS``: ``split_full_wave`` (split-K aimed at a whole wave of blocks, not
half) and ``no_split``.

Two tables: every convolution shape of the int8 forward at 12 and at 360
views (walked from YOLOv8s's layer list; seeded int8 data made on the
card), each timed with a spin before the call and the L2 left warm
(``chip_smoke.time_ms(flush_bytes=0)``), summed over the forward and by
class; and a one-wave sweep, 132 or 264 tiles of 16 x 8 pixels x 128
channels (a 1x1 convolution over 16 x 8 views, ``acc``), K = 64 to 4,096
bytes, which separates a launch's fixed cost from a K step's.  The shipped library and the main path
are not touched.

Needs one CUDA card, ``nvcc`` and the checkout; run it from the checkout's
root as ``python3 sweep_conv_s8.py``.  Prints the card line, then one JSON
line per table.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from chip_smoke import SEED, card_line, conv_class, time_ms

WAIT = "    mbar_wait(&full[slot], (it / kStages) & 1);\n"
BARRIER = "    __syncthreads();  // step it's A is written, and step it - 1's wgmma are done with their slot\n"
LOAD_NEXT = "    if (next < nsteps) load_stage(next % kStages, next);\n"
MMA = "        wgmma_s8<BN>(acc, TMA_A ? desc_sw32(a) : desc_plain(a), desc_sw32(b));"
LOADS_ONLY = """    {
      const int next = it + kStages - 1;
      if (next < nsteps) load_stage(next % kStages, next);
      continue;
    }
"""
VARIANTS = {  # name: (substitutions, checked against the plain version)
    "shipped": ((), True),
    "stages3": ((("constexpr int kStages = 4;", "constexpr int kStages = 3;"),), True),
    "stages6": ((("constexpr int kStages = 4;", "constexpr int kStages = 6;"),), True),
    "loads_only": (((BARRIER, BARRIER + LOADS_ONLY),), False),
    "no_loads": (((WAIT, "    if (it < kStages - 1) " + WAIT.lstrip()), (LOAD_NEXT, "")), False),
    "no_mma": (((MMA, MMA.replace("wgmma_s8", "if (false) wgmma_s8")),), False),
}
PLANS = {"split_full_wave": 264, "no_split": 1}  # the wrapper's SMS for each launch plan
FORWARD_VIEWS = (12, 360)


def build(name: str, subs, out_dir: Path) -> tuple[subprocess.Popen, Path]:
    """Starts ``nvcc`` on a copy of the kernel with ``subs`` applied."""
    from wtracker_tpu_torch.ops import _build

    src = (_build.CSRC / "conv_s8.cu").read_text()
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"conv_s8.cu no longer holds `{old.strip()}` once")
        src = src.replace(old, new)
    cu, lib = out_dir / f"conv_s8_{name}.cu", out_dir / f"libconv_s8_{name}.so"
    cu.write_text(src)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


@contextlib.contextmanager
def using(lib: ctypes.CDLL, sms: int | None = None):
    """Within the block the wrapper launches ``lib`` (and plans with ``sms``)."""
    from wtracker_tpu_torch.ops import _build
    from wtracker_tpu_torch.ops import conv_s8 as k2

    load, saved_sms = _build.load, k2.SMS
    _build.load = lambda name: lib
    k2.SMS = sms or saved_sms
    k2.plan.cache_clear()
    try:
        yield
    finally:
        _build.load, k2.SMS = load, saved_sms
        k2.plan.cache_clear()


def conv_data(shape, gen):
    n, h, w, cin, cout, k, _ = shape
    x = torch.randint(-127, 128, (n, h, w, cin), generator=gen, device="cuda", dtype=torch.int8)
    wt = torch.randint(-127, 128, (k, k, cin, cout), generator=gen, device="cuda", dtype=torch.int8)
    sw = (torch.rand(cout, generator=gen, device="cuda") + 0.5) * 9 / ((k * k * cin) ** 0.5 * 127**2)
    b = torch.randn(cout, generator=gen, device="cuda") * 2
    return x, wt, sw.float(), b.float()


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_conv_s8: no CUDA card is visible", file=sys.stderr)
        return 2
    from wtracker_tpu_torch.models.yolov8 import YoloV8
    from wtracker_tpu_torch.models.yolov8_int8 import conv_shapes
    from wtracker_tpu_torch.ops import _build
    from wtracker_tpu_torch.ops.conv_s8 import conv_s8, conv_s8_reference, pack_weights

    print(card_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    with tempfile.TemporaryDirectory(prefix="sweep_conv_s8_") as tmp:
        procs = {name: build(name, subs, Path(tmp)) for name, (subs, _) in VARIANTS.items()}
        libs, registers = {}, {}
        for name, (proc, lib) in procs.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{log}")
            registers[name] = sorted({int(r) for r in re.findall(r"Used (\d+) registers", log)})
            libs[name] = ctypes.CDLL(str(lib))
            libs[name].conv_s8.argtypes, libs[name].conv_s8.restype = _build.SIGNATURES["conv_s8"]
        runs = [(name, libs[name], None) for name in VARIANTS] + [(p, libs["shipped"], sms) for p, sms in PLANS.items()]

        model = YoloV8(nc=1, scale="s")
        forward = {name: {} for name, _, _ in runs}
        for views in FORWARD_VIEWS:
            convs = conv_shapes(model, views, (416, 416))
            counts = {}
            for c in convs:
                counts[c] = counts.get(c, 0) + 1
            for (shape, epi), count in counts.items():
                x, wt, sw, b = conv_data(shape, gen)
                wp = pack_weights(wt)
                call = lambda: conv_s8(x, wt, shape[-1], epi, sw, b, 0.037, wp=wp)
                want = conv_s8_reference(x, wt, shape[-1], epi, sw, b, 0.037) if views == 12 else None
                for name, lib, sms in runs:
                    with using(lib, sms):
                        if want is not None and VARIANTS.get(name, ((), True))[1]:
                            if not torch.equal(call(), want):
                                raise AssertionError(f"{name} differs from the plain version at {shape} {epi}")
                        ms = time_ms(call, reps=10 if views == 12 else 5, flush_bytes=0)
                    row = forward[name].setdefault(views, {"ms": 0.0, "classes": {}})
                    row["ms"] += ms * count
                    cls = conv_class({"epilogue": epi, "w": [shape[5]], "stride": shape[6]})
                    row["classes"][cls] = row["classes"].get(cls, 0.0) + ms * count
                del x, wt, wp, want
            torch.cuda.empty_cache()
        print(json.dumps({"forward_ms": forward, "registers": registers}), flush=True)

        wave = []
        for tiles_per_sm in (1, 2):
            for cin in (64, 256, 1024, 4096):
                shape = (132 * tiles_per_sm, 16, 8, cin, 128, 1, 1)  # a view a tile
                x, wt, sw, b = conv_data(shape, gen)
                wp = pack_weights(wt)
                row = {"tiles_per_sm": tiles_per_sm, "k": cin}
                for name, lib, sms in runs:
                    if sms is None:
                        with using(lib):
                            row[name] = time_ms(lambda: conv_s8(x, wt, 1, "acc", wp=wp), reps=10, flush_bytes=0)
                wave.append(row)
        print(json.dumps({"one_wave_ms": wave}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
