"""ctypes bindings and on-demand build of the native BMP frame loader.

Counterpart of :mod:`wtracker_tpu.runtime.native`.  ``frame_loader.cpp`` (a
copy of the JAX package's, plus the PNG row unfiltering of the port's image
codec and a header-only BMP layout probe) is compiled with ``g++ -O3`` at first use into
``wtracker_tpu_torch/_build/`` (listed in ``.gitignore``) under a name that
carries a hash of the source.  The BMP path of the frame reader has no other
decoder (a GPU host need not have OpenCV), so a failed build or load raises
with the compiler's or the loader's message instead of returning ``None``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from functools import cache
from pathlib import Path

import numpy as np

from wtracker_tpu_torch.ops._build import BUILD_DIR

_SRC = Path(__file__).with_name("frame_loader.cpp")
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
# (argtypes, restype) of each entry point; buffers and path arrays are c_void_p
_SIGNATURES = {
    "wt_probe_bmp": ([ctypes.c_char_p, _P, _P, _P], _I),
    "wt_bmp_layout": ([ctypes.c_char_p, _P, _P, _P, _P], _I),
    "wt_png_unfilter": ([_P, _I, _L, _I, _P], _I),
    "wt_load_batch_bmp": ([_P, _I, _P, _L, _I, _I, _I, _I], _I),
    "wt_load_batch_bmp_window": ([_P, _I, _P, _L, _I, _I, _P, _P, _I, _I, _I, _I], _I),
}


BMP_OPEN_FAILED = 1  # the loader's code for a file it cannot open
BMP_SHAPE_MISMATCH = 8  # the loader's code for a frame of another size than asked


class BmpShapeError(ValueError):
    """A BMP of another size than the batch's frame shape."""


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libframe_loader-{digest.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", tmp], capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"cannot run g++ to build the native frame loader: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed to build the native frame loader:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing


@cache
def get_lib() -> ctypes.CDLL:
    """The loaded native library, built first if needed; raises on failure."""
    path = library_path()
    if not path.exists():
        _build(path)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"cannot load the native frame loader {path}: {e}") from e
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def native_available() -> bool:
    """Whether the native loader builds and loads on this host."""
    try:
        get_lib()
    except RuntimeError:
        return False
    return True


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _paths(paths: list[str]):
    return (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])


def _out(out: np.ndarray | None, shape: tuple[int, ...]) -> np.ndarray:
    if out is None:
        return np.empty(shape, dtype=np.uint8)
    if out.shape != shape or out.dtype != np.uint8 or not out.flags["C_CONTIGUOUS"]:
        raise ValueError(f"out must be a C-contiguous uint8 array of shape {shape}, got {out.shape} {out.dtype}")
    return out


def _threads(n_threads: int | None) -> int:
    return min(os.cpu_count() or 1, 16) if n_threads is None else n_threads


def probe_bmp(path: str) -> tuple[int, int, int]:
    """(h, w, channels) of a BMP file."""
    hwc = np.zeros(3, dtype=np.intc)
    base = hwc.ctypes.data
    step = hwc.itemsize
    rc = get_lib().wt_probe_bmp(os.fsencode(path), base, base + step, base + 2 * step)
    if rc != 0:
        raise ValueError(f"failed to probe BMP {path} (code {rc})")
    return int(hwc[0]), int(hwc[1]), int(hwc[2])


def bmp_layout(path: str) -> tuple[int, int, int, bool]:
    """(h, w, bits a pixel, color palette) of a BMP, from its headers alone:
    an 8-bit file with a gray palette reads unconverted as one channel.
    Raises ``FileNotFoundError`` when the file cannot be opened and
    ``ValueError`` for a layout the loader does not decode."""
    vals = np.zeros(4, dtype=np.intc)
    base, step = vals.ctypes.data, vals.itemsize
    rc = get_lib().wt_bmp_layout(os.fsencode(path), base, base + step, base + 2 * step, base + 3 * step)
    if rc == BMP_OPEN_FAILED:
        raise FileNotFoundError(f"cannot open BMP {path}")
    if rc != 0:
        raise ValueError(f"BMP {path} has a layout the native loader does not decode (code {rc})")
    return int(vals[0]), int(vals[1]), int(vals[2]), bool(vals[3])


def png_unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the row filters of a non-interlaced 8-bit PNG: ``raw`` is the
    inflated image data, (h, 1 + stride) uint8 (each row's filter type, then
    its bytes); returns the (h, stride) samples."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    h, stride = raw.shape[0], raw.shape[1] - 1
    out = np.empty((h, stride), dtype=np.uint8)
    rc = get_lib().wt_png_unfilter(_ptr(raw), h, stride, bpp, _ptr(out))
    if rc != 0:
        raise ValueError(f"PNG row {rc - 1} has filter type {int(raw[rc - 1, 0])}")
    return out


def load_batch_bmp(
    paths: list[str],
    h: int,
    w: int,
    gray: bool = True,
    n_threads: int | None = None,
    out: np.ndarray | None = None,
) -> np.ndarray:
    """Decode many BMPs in parallel into one contiguous uint8 array.

    Args:
        paths: BMP file paths; all frames must be (h, w).
        gray: single-channel output (OpenCV-exact BGR→gray weights).
        n_threads: decoder threads (default: cpu count, capped at 16).
        out: optional preallocated output of the right shape.
    """
    lib = get_lib()
    n = len(paths)
    out = _out(out, (n, h, w) if gray else (n, h, w, 3))
    frame_stride = h * w * (1 if gray else 3)
    rc = lib.wt_load_batch_bmp(_paths(paths), n, _ptr(out), frame_stride, h, w, int(gray), _threads(n_threads))
    if rc == BMP_SHAPE_MISMATCH:
        raise BmpShapeError(f"a BMP among the {n} asked for is not {h}x{w}")
    if rc != 0:
        raise ValueError(f"BMP batch decode failed (code {rc})")
    return out


def load_batch_bmp_window(
    paths: list[str],
    full_h: int,
    full_w: int,
    top_lefts: np.ndarray,
    win_h: int,
    win_w: int,
    gray: bool = True,
    n_threads: int | None = None,
    out: np.ndarray | None = None,
) -> np.ndarray:
    """Decode one ``(win_h, win_w)`` window per BMP in parallel (ROI streaming).

    BMP rows are contiguous on disk, so each window costs one seek and one
    read of ``win_h`` full rows.

    Args:
        paths: BMP file paths; all frames must be (full_h, full_w).
        top_lefts: (N, 2) int window origins in (x, y) order, one per frame;
            windows must lie fully inside the frame.
        gray: single-channel output (OpenCV-exact BGR→gray weights).
        out: optional preallocated output of shape (N, win_h, win_w[, 3]).
    """
    lib = get_lib()
    n = len(paths)
    tls = np.asarray(top_lefts, dtype=np.intc).reshape(n, 2)
    x0s, y0s = np.ascontiguousarray(tls[:, 0]), np.ascontiguousarray(tls[:, 1])
    out = _out(out, (n, win_h, win_w) if gray else (n, win_h, win_w, 3))
    frame_stride = win_h * win_w * (1 if gray else 3)
    rc = lib.wt_load_batch_bmp_window(
        _paths(paths), n, _ptr(out), frame_stride, full_h, full_w, _ptr(x0s), _ptr(y0s),
        win_h, win_w, int(gray), _threads(n_threads),
    )
    if rc != 0:
        raise ValueError(f"BMP window batch decode failed (code {rc})")
    return out
