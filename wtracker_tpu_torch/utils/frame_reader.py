"""Frame IO: random-access directory readers, streaming cursor, synthetic frames.

Port of :mod:`wtracker_tpu.utils.frame_reader`: ``FrameReader`` (with the
batch decode ``read_batch`` and the ROI-streaming ``read_window_batch``),
``FrameStream``, ``DummyReader`` and ``ArrayReader``.

BMP frames, the recordings' format, decode through the native loader
(:mod:`wtracker_tpu_torch.runtime.native`), byte for byte what OpenCV's
``imread`` gives; a failure there raises.  ``read_format`` takes OpenCV's
``imread`` flags, defined here with cv2's values; with any other flag than
the native loader's two (e.g. ``IMREAD_UNCHANGED``), and for PNG files, the
port's own codec (:mod:`wtracker_tpu_torch.utils.image_codec`, whose BMPs
the native loader decodes too) reads.  Other image types need OpenCV,
imported when such a file is first read, so this module imports without it
(GPU hosts may have none).  A single frame of another size than the
reader's decodes at its own size, as ``cv2.imread`` does (worm crops are
ragged); a batch takes the reader's frame shape.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from wtracker_tpu_torch.runtime import native
from wtracker_tpu_torch.utils import image_codec
from wtracker_tpu_torch.utils.image_codec import IMREAD_COLOR, IMREAD_GRAYSCALE
from wtracker_tpu_torch.utils.path_utils import join_paths
_NATIVE_FORMATS = (IMREAD_GRAYSCALE, IMREAD_COLOR)


def _sorted_dir_files(root_folder: str, pattern: str) -> list[str]:
    """Names under ``root_folder`` matching ``pattern``, files only, sorted."""
    names = glob.glob(pattern, root_dir=root_folder)
    return sorted(n for n in names if os.path.isfile(join_paths(root_folder, n)))


def _is_bmp(path: str) -> bool:
    return path.lower().endswith(".bmp")


def _cv_imread(path: str, read_format: int) -> np.ndarray:
    """``imread`` of a frame the native loader does not serve: the port's
    codec for PNG and BMP, OpenCV for anything else; raises when the file
    cannot be read (or OpenCV is needed and absent)."""
    frame = image_codec.imread(path, read_format)
    if frame is None:
        raise ValueError(f"cannot read frame {path}")
    return frame


class FrameReader:
    """Random-access reader over an ordered list of image files in a directory.

    Args:
        root_folder: directory holding the frame files.
        frame_files: ordered file names (relative to ``root_folder``).
        read_format: an OpenCV imread flag; grayscale by default.
    """

    def __init__(self, root_folder: str, frame_files: list[str], read_format: int = IMREAD_GRAYSCALE):
        if not os.path.exists(root_folder):
            raise FileNotFoundError(f"frame directory {root_folder} does not exist")
        if not frame_files:
            raise ValueError(f"no frame files in {root_folder}")

        self._root_folder = root_folder
        self._files = frame_files
        self._read_format = read_format
        self._frame_shape = self._extract_frame_shape()

    # -- construction helpers ---------------------------------------------------

    @classmethod
    def create_from_template(
        cls, root_folder: str, name_format: str, read_format: int = IMREAD_GRAYSCALE
    ) -> "FrameReader":
        """Build a reader from a ``name.format()``-style file template."""
        names = _sorted_dir_files(root_folder, name_format.format("[0-9]*"))
        return cls(root_folder, names, read_format)

    @classmethod
    def create_from_directory(cls, root_folder: str, read_format: int = IMREAD_GRAYSCALE) -> "FrameReader":
        """Build a reader from every file in a directory (sorted by name)."""
        return cls(root_folder, _sorted_dir_files(root_folder, "*.*"), read_format)

    # -- decode ------------------------------------------------------------------

    def _path_of(self, idx: int) -> str:
        return join_paths(self._root_folder, self._files[idx])

    def _native(self, paths: list[str]) -> bool:
        """Whether these frames decode through the native loader."""
        return self._read_format in _NATIVE_FORMATS and all(_is_bmp(p) for p in paths)

    @property
    def _gray(self) -> bool:
        return self._read_format == IMREAD_GRAYSCALE

    def _extract_frame_shape(self) -> tuple[int, ...]:
        # Overridable probe: synthetic readers report a shape without decoding.
        path = self._path_of(0)
        if self._native([path]):
            h, w, _ = native.probe_bmp(path)
            return (h, w) if self._gray else (h, w, 3)
        return _cv_imread(path, self._read_format).shape

    def __getitem__(self, idx: int) -> np.ndarray:
        if not 0 <= idx < len(self._files):
            raise IndexError("index out of bounds")
        path = self._path_of(idx)
        if self._native([path]):
            h, w = self._frame_shape[:2]
            try:
                return native.load_batch_bmp([path], h, w, gray=self._gray, n_threads=1)[0]
            except native.BmpShapeError:
                pass  # a frame of its own size: the codec probes it
        return _cv_imread(path, self._read_format).astype(np.uint8, copy=False)

    def read_batch(
        self, indices: np.ndarray | list[int] | None = None, out: np.ndarray | None = None
    ) -> np.ndarray:
        """Decode many frames into one contiguous uint8 array ``(N, *frame_shape)``.

        BMP sources decode in one parallel native call into the batch buffer.
        ``out`` optionally receives the frames in place (shape
        ``(len(indices), *frame_shape)``); streaming callers reuse a buffer.
        """
        picks = list(range(len(self))) if indices is None else [int(i) for i in indices]
        shape = (len(picks), *self._frame_shape)
        if out is not None and out.shape != shape:
            raise ValueError(f"out shape {out.shape} != {shape}")
        paths = [self._path_of(i) for i in picks]
        if paths and self._native(paths):
            h, w = self._frame_shape[:2]
            return native.load_batch_bmp(paths, h, w, gray=self._gray, out=out)

        if out is None:
            out = np.empty(shape, dtype=np.uint8)
        for slot, idx in enumerate(picks):
            out[slot] = self[idx]
        return out

    def read_window_batch(
        self,
        indices: np.ndarray | list[int],
        top_lefts: np.ndarray,
        window_hw: tuple[int, int],
        out: np.ndarray | None = None,
    ) -> np.ndarray:
        """Decode one fixed-size window per frame (ROI streaming).

        BMP sources read only the rows the window covers: one seek and one
        contiguous read per frame through the native loader.

        Args:
            top_lefts: (N, 2) int window origins in (x, y) order; every window
                must lie fully inside the frame.
            window_hw: (win_h, win_w) shared window size.
            out: optional preallocated ``(N, win_h, win_w[, C])`` uint8 target.
        """
        picks = [int(i) for i in indices]
        win_h, win_w = window_hw
        tls = np.asarray(top_lefts, dtype=np.int32).reshape(len(picks), 2)
        full_h, full_w = self._frame_shape[:2]
        if tls.min(initial=0) < 0 or (tls[:, 0] + win_w > full_w).any() or (tls[:, 1] + win_h > full_h).any():
            raise ValueError("window out of frame bounds")
        shape = (len(picks), win_h, win_w, *self._frame_shape[2:])
        if out is not None and out.shape != shape:
            raise ValueError(f"out shape {out.shape} != {shape}")
        paths = [self._path_of(i) for i in picks]
        if paths and self._native(paths):
            return native.load_batch_bmp_window(
                paths, full_h, full_w, tls, win_h, win_w, gray=self._gray, out=out
            )

        if out is None:
            out = np.empty(shape, dtype=np.uint8)
        for slot, (idx, (x0, y0)) in enumerate(zip(picks, tls)):
            out[slot] = self[idx][y0 : y0 + win_h, x0 : x0 + win_w]
        return out

    # -- introspection --------------------------------------------------------------

    @property
    def root_folder(self) -> str:
        return self._root_folder

    @property
    def files(self) -> list[str]:
        return self._files

    @property
    def read_format(self) -> int:
        return self._read_format

    @property
    def frame_shape(self) -> tuple[int, ...]:
        """Full frame shape, ``(h, w)`` or ``(h, w, c)``."""
        return self._frame_shape

    @property
    def frame_size(self) -> tuple[int, int]:
        """Spatial frame size ``(h, w)``."""
        return self._frame_shape[:2]

    def __len__(self) -> int:
        return len(self._files)

    # -- streaming ---------------------------------------------------------------------

    def __iter__(self) -> "FrameStream":
        return FrameStream(self)

    def make_stream(self) -> "FrameStream":
        """A fresh streaming cursor over this reader."""
        return FrameStream(self)


class FrameStream:
    """A seekable iterator/cursor over a :class:`FrameReader`.

    The cursor starts *before* the first frame (index -1); ``progress()`` or
    iteration advances it.  ``read()`` memoizes the current frame until the
    cursor moves.
    """

    def __init__(self, frame_reader: FrameReader):
        self._frame_reader = frame_reader
        self._idx = -1
        self.frame: np.ndarray | None = None

    @property
    def index(self) -> int:
        """Index of the current frame."""
        return self._idx

    def __len__(self) -> int:
        return len(self._frame_reader)

    def __iter__(self) -> "FrameStream":
        return self

    def __next__(self) -> np.ndarray:
        if not self.progress():
            raise StopIteration()
        return self.read()

    def can_read(self) -> bool:
        return 0 <= self._idx < len(self._frame_reader)

    def seek(self, idx: int) -> bool:
        """Move the cursor to ``idx``; returns whether a frame can be read there."""
        self._idx = idx
        self.frame = None
        return self.can_read()

    def progress(self, n: int = 1) -> bool:
        """Advance the cursor by ``n`` frames."""
        return self.seek(self._idx + n)

    def read(self) -> np.ndarray:
        """The frame at the cursor (memoized until the cursor moves)."""
        if not self.can_read():
            raise IndexError("index out of bounds")
        if self.frame is None:
            self.frame = self._frame_reader[self._idx]
        return self.frame

    def reset(self) -> None:
        """Rewind to before the first frame."""
        self.seek(-1)


class DummyReader(FrameReader):
    """Synthetic reader producing constant white frames: the no-data backend
    that lets the simulator stack run with no video at all."""

    def __init__(self, num_frames: int, resolution: tuple[int, int], colored: bool = True):
        self.colored = colored
        self._resolution = resolution
        shape = (*resolution, 3) if colored else resolution
        self._frame = np.full(shape, fill_value=255, dtype=np.uint8)
        super().__init__(".", frame_files=[str(i) for i in range(num_frames)])

    def _extract_frame_shape(self) -> tuple[int, ...]:
        return self._frame.shape

    def __getitem__(self, idx: int) -> np.ndarray:
        if not 0 <= idx < len(self):
            raise IndexError("index out of bounds")
        return self._frame.copy()

    def read_batch(self, indices=None) -> np.ndarray:
        n = len(self) if indices is None else len(indices)
        return np.broadcast_to(self._frame, (n, *self._frame.shape)).copy()


class ArrayReader(FrameReader):
    """Reader over an in-memory ``(N, H, W[, C])`` uint8 array (pre-decoded
    frames, or a memory-mapped ``.npy``)."""

    def __init__(self, frames: np.ndarray):
        if frames.ndim not in (3, 4):
            raise ValueError(f"frames must be (N, H, W[, C]), got {frames.shape}")
        self._frames = frames
        super().__init__(".", frame_files=[str(i) for i in range(frames.shape[0])])

    def _extract_frame_shape(self) -> tuple[int, ...]:
        return tuple(self._frames.shape[1:])

    def __getitem__(self, idx: int) -> np.ndarray:
        if not 0 <= idx < len(self):
            raise IndexError("index out of bounds")
        return np.asarray(self._frames[idx])

    @property
    def array(self) -> np.ndarray:
        return self._frames

    def read_batch(self, indices=None) -> np.ndarray:
        if indices is None:
            return np.asarray(self._frames)
        return np.asarray(self._frames[np.asarray(indices, dtype=int)])
