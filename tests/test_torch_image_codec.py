"""The port's PNG and BMP codec (``utils/image_codec.py``) against OpenCV:
round trips; PNGs and BMPs that OpenCV writes decode to OpenCV's pixels;
PNG rows built by hand with each of the five row filters; the port's files
decode in OpenCV to the same pixels; ``imread``'s flags, and the cases it
leaves to OpenCV.  Images come from numpy seeds."""

import struct
import sys
import zlib

import cv2
import numpy as np
import pytest

from wtracker_tpu_torch.utils import image_codec as ic

SHAPES = [(1, 1), (5, 3), (17, 29), (48, 61)]  # widths that pad BMP rows by 0-3 bytes


def _image(seed: int, hw, color: bool) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (*hw, 3) if color else hw, dtype=np.uint8)


@pytest.mark.parametrize("ext", ["png", "bmp"])
@pytest.mark.parametrize("color", [False, True], ids=["gray", "bgr"])
@pytest.mark.parametrize("hw", SHAPES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_round_trip_and_opencv_reads_the_port_files(tmp_path, ext, color, hw):
    img = _image(hw[0] * 100 + hw[1], hw, color)
    path = str(tmp_path / f"img.{ext}")
    assert ic.imwrite(path, img)
    np.testing.assert_array_equal(ic.imread(path, ic.IMREAD_UNCHANGED), img)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    # the port's file, read by OpenCV, and OpenCV's file, read by the port
    assert cv2.imwrite(str(tmp_path / f"cv.{ext}"), img)
    np.testing.assert_array_equal(ic.imread(str(tmp_path / f"cv.{ext}"), ic.IMREAD_UNCHANGED), img)
    for flags in (ic.IMREAD_GRAYSCALE, ic.IMREAD_COLOR):
        if color and flags == ic.IMREAD_GRAYSCALE:
            continue  # OpenCV's own gray weights: the port hands this case to OpenCV
        np.testing.assert_array_equal(ic.imread(path, flags), cv2.imread(path, flags))
        np.testing.assert_array_equal(ic.imread(str(tmp_path / f"cv.{ext}"), flags), cv2.imread(path, flags))


def test_the_bmp_bytes_are_opencvs(tmp_path):
    """Gray: 14 + 40 header bytes, a 1024-byte gray palette, rows padded to
    4 bytes; BGR: 54 header bytes and 3 bytes a pixel; the file is OpenCV's."""
    for color, header in ((False, 14 + 40 + 1024), (True, 54)):
        for hw in SHAPES:
            img = _image(1, hw, color)
            data = ic.encode_bmp(img)
            row = (hw[1] * (3 if color else 1) + 3) // 4 * 4
            assert len(data) == header + hw[0] * row
            assert cv2.imwrite(str(tmp_path / "cv.bmp"), img)
            assert (tmp_path / "cv.bmp").read_bytes() == data


def _png_with_filters(img: np.ndarray, filters) -> bytes:
    """A PNG whose row y is stored with filter ``filters[y % len(filters)]``,
    computed by the PNG specification's formulas."""
    h, w = img.shape[:2]
    bpp = 3 if img.ndim == 3 else 1
    raw = (img[..., ::-1] if bpp == 3 else img).reshape(h, w * bpp).astype(np.int64)
    out = []
    for y in range(h):
        kind = filters[y % len(filters)]
        cur, prior = raw[y], raw[y - 1] if y else np.zeros_like(raw[y])
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if kind == 0:
            f = cur
        elif kind == 1:
            f = cur - left
        elif kind == 2:
            f = cur - prior
        elif kind == 3:
            f = cur - (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            f = cur - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        out.append(bytes([kind]) + (f % 256).astype(np.uint8).tobytes())
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if bpp == 3 else 0, 0, 0, 0)
    return ic.PNG_SIGNATURE + ic._png_chunk(b"IHDR", ihdr) + ic._png_chunk(b"IDAT", zlib.compress(b"".join(out))) \
        + ic._png_chunk(b"IEND", b"")


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0)], ids=str)
@pytest.mark.parametrize("color", [False, True], ids=["gray", "bgr"])
def test_each_png_row_filter_decodes(tmp_path, filters, color):
    img = _image(7, (9, 14), color)
    img[3] = 255  # rows whose sums wrap past 255
    data = _png_with_filters(img, filters)
    np.testing.assert_array_equal(ic.decode_png(data), img)
    (tmp_path / "f.png").write_bytes(data)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "f.png"), cv2.IMREAD_UNCHANGED), img)


@pytest.mark.parametrize("color", [False, True], ids=["gray", "bgr"])
def test_opencv_pngs_at_every_compression_decode(tmp_path, color):
    """libpng picks its row filters adaptively: smooth images take Sub, Up,
    Average and Paeth rows."""
    yy, xx = np.mgrid[:40, :53]
    img = ((xx * 3 + yy * 5) % 256).astype(np.uint8)
    if color:
        img = np.stack([img, img[::-1], (img // 2 + 40).astype(np.uint8)], -1)
    for level in (0, 1, 6, 9):
        path = str(tmp_path / f"c{level}.png")
        assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
        np.testing.assert_array_equal(ic.imread(path, ic.IMREAD_UNCHANGED), img)


def test_a_color_palette_bmp_decodes_to_bgr(tmp_path):
    img = _image(3, (6, 9), color=False) // 64  # indices 0-3
    palette = np.array([[0, 0, 255, 0], [0, 255, 0, 0], [255, 0, 0, 0], [9, 99, 199, 0]], np.uint8)
    data = bytearray(ic.encode_bmp(img))
    struct.pack_into("<I", data, 46, 4)  # four colors used
    data = bytes(data[:54]) + palette.tobytes() + bytes(data[54 + 1024 :])
    data = data[:10] + struct.pack("<I", 54 + 16) + data[14:]
    (tmp_path / "p.bmp").write_bytes(data)
    want = cv2.imread(str(tmp_path / "p.bmp"), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(ic.imread(str(tmp_path / "p.bmp"), ic.IMREAD_UNCHANGED), want)
    np.testing.assert_array_equal(want, palette[img, :3])


def test_what_the_codec_leaves_to_opencv(tmp_path, monkeypatch):
    gray, color = _image(0, (8, 10), False), _image(1, (8, 10), True)
    assert cv2.imwrite(str(tmp_path / "a.tiff"), gray)
    assert ic.imwrite(str(tmp_path / "c.png"), color)
    np.testing.assert_array_equal(ic.imread(str(tmp_path / "a.tiff"), -1), gray)  # another type: OpenCV
    np.testing.assert_array_equal(ic.imread(str(tmp_path / "c.png"), 0), cv2.imread(str(tmp_path / "c.png"), 0))
    assert ic.imread(str(tmp_path / "missing.png"), -1) is None
    assert not ic.imwrite(str(tmp_path / "no" / "dir.png"), gray)
    with pytest.raises(ValueError, match="uint8"):
        ic.encode_png(gray.astype(np.uint16))

    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 now raises ImportError
    np.testing.assert_array_equal(ic.imread(str(tmp_path / "c.png"), 1), color)  # PNG and BMP need no OpenCV
    assert ic.imwrite(str(tmp_path / "g.bmp"), gray)
    with pytest.raises(ImportError, match="needs OpenCV"):
        ic.imread(str(tmp_path / "a.tiff"), -1)
    with pytest.raises(ImportError, match="needs OpenCV"):
        ic.imread(str(tmp_path / "c.png"), 0)


def test_an_unknown_png_filter_type_raises():
    img = _image(5, (4, 6), color=False)
    data = _png_with_filters(img, (1,))
    ihdr_end = 8 + 12 + 13
    (length,) = struct.unpack(">I", data[ihdr_end : ihdr_end + 4])
    raw = bytearray(zlib.decompress(data[ihdr_end + 8 : ihdr_end + 8 + length]))
    raw[2 * (6 + 1)] = 5  # row 2's filter type
    idat = ic._png_chunk(b"IDAT", zlib.compress(bytes(raw)))
    with pytest.raises(ValueError, match="row 2 has filter type 5"):
        ic.decode_png(data[:ihdr_end] + idat + ic._png_chunk(b"IEND", b""))


@pytest.mark.parametrize("flags", [ic.IMREAD_UNCHANGED, ic.IMREAD_GRAYSCALE, ic.IMREAD_COLOR])
def test_bmp_reads_are_opencvs_for_every_flag(tmp_path, flags):
    """BMPs go through the native loader for each flag, a 24-bit file read
    as gray too (OpenCV's fixed-point weights); a 32-bit file read
    unconverted is left to OpenCV."""
    for name, img in (("g", _image(8, (7, 13), False)), ("c", _image(9, (7, 13), True))):
        path = str(tmp_path / f"{name}.bmp")
        assert cv2.imwrite(path, img)
        np.testing.assert_array_equal(ic.imread(path, flags), cv2.imread(path, flags))
    bgra = _image(10, (5, 6), True)
    data = bytearray(ic.encode_bmp(bgra))
    rows = np.concatenate([bgra[::-1], np.full((5, 6, 1), 255, np.uint8)], axis=2)
    struct.pack_into("<H", data, 28, 32)  # 32 bits a pixel, rows of 24 bytes
    (tmp_path / "a.bmp").write_bytes(bytes(data[:54]) + rows.tobytes())
    np.testing.assert_array_equal(ic.imread(str(tmp_path / "a.bmp"), flags),
                                  cv2.imread(str(tmp_path / "a.bmp"), flags))
    assert ic.imread(str(tmp_path / "missing.bmp"), flags) is None
