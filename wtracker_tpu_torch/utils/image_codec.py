"""PNG and BMP files without OpenCV.

The card's host has no OpenCV, and the dataset and evaluation tools write
and read their images as PNG or BMP.  This module encodes and decodes the
layouts those tools (and OpenCV's ``imwrite``) use:

* PNG: 8-bit gray and 8-bit RGB (BGR arrays, as OpenCV holds them),
  non-interlaced; written with filter 0 and ``zlib`` at level 1; read with
  all five row filters undone by the native loader
  (:func:`wtracker_tpu_torch.runtime.native.png_unfilter`: Average and
  Paeth rows depend on the byte to their left);
* BMP: written byte for byte as OpenCV writes them (8-bit gray with a
  256-entry gray palette, 24-bit BGR, rows padded to 4 bytes, the optional
  header fields 0); read by the native frame loader, the port's one BMP
  decoder (8-bit with a palette, 24- and 32-bit, with OpenCV's gray
  weights).

PNG files differ from OpenCV's in their bytes (another deflate stream and
other row filters); what matches is the decoded pixels.  :func:`imwrite` and :func:`imread` take
OpenCV's arguments and return values: other extensions, and layouts this
module does not decode, go to OpenCV, imported when needed.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from wtracker_tpu_torch.runtime import native

IMREAD_UNCHANGED = -1  # cv2.IMREAD_UNCHANGED
IMREAD_GRAYSCALE = 0  # cv2.IMREAD_GRAYSCALE
IMREAD_COLOR = 1  # cv2.IMREAD_COLOR

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
PNG_COMPRESSION = 1  # zlib level; OpenCV's default PNG compression is 1 as well


class UnsupportedImage(ValueError):
    """A file whose layout this module does not decode (OpenCV may)."""


def _cv2(path: str):
    try:
        import cv2
    except ImportError as e:
        ext = os.path.splitext(path)[1] or "extension-less"
        raise ImportError(
            f"{ext!r} frames ({path}) needs OpenCV (cv2), which is not installed; PNG and BMP files need "
            "no OpenCV, but for a color PNG read as gray"
        ) from e
    return cv2


def _check_image(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] in (1, 3))):
        raise ValueError(f"expected a (H, W) or (H, W, 3) uint8 image, got {img.shape} {img.dtype}")
    return img[..., 0] if img.ndim == 3 and img.shape[2] == 1 else img


# -- PNG -------------------------------------------------------------------


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def encode_png(img: np.ndarray) -> bytes:
    """A (H, W) gray or (H, W, 3) BGR uint8 image as PNG bytes."""
    img = _check_image(img)
    h, w = img.shape[:2]
    color = img.ndim == 3
    rows = np.zeros((h, 1 + w * (3 if color else 1)), np.uint8)  # each row: filter type 0, then its bytes
    rows[:, 1:] = (img[..., ::-1] if color else img).reshape(h, -1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if color else 0, 0, 0, 0)
    return (
        PNG_SIGNATURE
        + _png_chunk(b"IHDR", ihdr)
        + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), PNG_COMPRESSION))
        + _png_chunk(b"IEND", b"")
    )


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → (H, W) gray or (H, W, 3) BGR uint8 (8-bit gray or RGB,
    non-interlaced)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, color_type, _, _, interlace = header
    if depth != 8 or color_type not in (0, 2) or interlace != 0:
        raise UnsupportedImage(f"PNG of bit depth {depth}, color type {color_type}, interlace {interlace}")
    bpp = 3 if color_type == 2 else 1
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected {h * (stride + 1)}")
    out = native.png_unfilter(raw.reshape(h, stride + 1), bpp)
    return out.reshape(h, w, 3)[..., ::-1].copy() if bpp == 3 else out


# -- BMP -------------------------------------------------------------------


def encode_bmp(img: np.ndarray) -> bytes:
    """A (H, W) gray image as an 8-bit BMP with a gray palette, or a (H, W, 3)
    BGR image as a 24-bit BMP: 54 bytes of headers, rows bottom-up, each
    padded to a multiple of 4 bytes (OpenCV's ``imwrite`` bytes)."""
    img = _check_image(img)
    h, w = img.shape[:2]
    color = img.ndim == 3
    row_bytes = (w * (3 if color else 1) + 3) // 4 * 4
    palette = b""
    if not color:
        entries = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 4, axis=1)
        entries[:, 3] = 0
        palette = entries.tobytes()
    offset = 14 + 40 + len(palette)
    header = (
        b"BM" + struct.pack("<IHHI", offset + row_bytes * h, 0, 0, offset)
        + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24 if color else 8, 0, 0, 0, 0, 0, 0)
    )
    rows = np.zeros((h, row_bytes), np.uint8)
    rows[:, : w * (3 if color else 1)] = img[::-1].reshape(h, -1)
    return header + palette + rows.tobytes()


# -- OpenCV-style entry points ------------------------------------------------

_ENCODERS = {".png": encode_png, ".bmp": encode_bmp}


def _read_png(path: str, flags: int) -> np.ndarray | None:
    try:
        with open(path, "rb") as f:
            img = decode_png(f.read())
    except OSError:
        return None
    if flags == IMREAD_GRAYSCALE and img.ndim == 3:
        raise UnsupportedImage("a color PNG read as gray: OpenCV's own gray weights")
    return np.repeat(img[..., None], 3, axis=2) if flags == IMREAD_COLOR and img.ndim == 2 else img


def _read_bmp(path: str, flags: int) -> np.ndarray | None:
    try:
        h, w, bits, color_palette = native.bmp_layout(path)
    except FileNotFoundError:
        return None
    except ValueError as e:
        raise UnsupportedImage(str(e)) from e
    if flags == IMREAD_UNCHANGED:
        if bits == 32 or w <= 0 or h <= 0:
            raise UnsupportedImage(f"BMP of {bits} bits a pixel, size {w}x{h}, read unconverted")
        gray = bits == 8 and not color_palette
    else:
        gray = flags == IMREAD_GRAYSCALE
    return native.load_batch_bmp([path], h, w, gray=gray, n_threads=1)[0]


_READERS = {".png": _read_png, ".bmp": _read_bmp}


def imwrite(path: str, img: np.ndarray) -> bool:
    """``cv2.imwrite``: write ``img`` by the path's extension; False when the
    file cannot be opened (a missing directory, say)."""
    encode = _ENCODERS.get(os.path.splitext(path)[1].lower())
    if encode is None:
        return bool(_cv2(path).imwrite(path, img))
    data = encode(img)
    try:
        with open(path, "wb") as f:
            f.write(data)
    except OSError:
        return False
    return True


def imread(path: str, flags: int = IMREAD_COLOR) -> np.ndarray | None:
    """``cv2.imread`` for ``flags`` -1, 0 or 1: None when the file cannot be
    read.  A color PNG asked for in gray goes to OpenCV (its gray weights are
    libpng's), as does a layout this module does not decode."""
    read = _READERS.get(os.path.splitext(path)[1].lower())
    if read is not None and flags in (IMREAD_UNCHANGED, IMREAD_GRAYSCALE, IMREAD_COLOR):
        try:
            return read(path, flags)
        except UnsupportedImage:
            pass
    return _cv2(path).imread(path, flags)
