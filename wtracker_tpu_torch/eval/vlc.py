"""Headless or interactive replay of simulation logs with overlays.

Port of :mod:`wtracker_tpu.eval.vlc`: ``HotKey``, ``StreamViewer`` and
``VLC`` seek and play a logged experiment, draw the worm, microscope and
camera boxes and the platform centre from the log rows, toggle overlays
with hotkeys, and export annotated frames or an mp4.

The overlays are drawn in numpy (:func:`draw_rectangle`, :func:`draw_cross`),
with the pixels of OpenCV's ``rectangle`` (thickness 1) and ``drawMarker``
(``MARKER_CROSS``, size 7), so ``render_frame`` and ``save_frames`` need no
OpenCV (the card's host has none); frames are written as PNG or BMP by the
port's codec.  ``make_video`` and the interactive window (``StreamViewer``,
``VLC.play``) need OpenCV, imported when they run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import pandas as pd

from wtracker_tpu_torch.sim.config import TimingConfig
from wtracker_tpu_torch.utils.frame_reader import DummyReader, FrameReader
from wtracker_tpu_torch.utils.image_codec import IMREAD_UNCHANGED, imwrite
from wtracker_tpu_torch.utils.path_utils import create_directory, join_paths


def _cv2(what: str):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{what} needs OpenCV (cv2), which is not installed; render_frame and save_frames "
                          "work without it") from e
    return cv2


def _hline(img: np.ndarray, xa: int, xb: int, y: int, color) -> None:
    """Pixels (xa..xb, y), both ends included, clipped to the image."""
    h, w = img.shape[:2]
    lo, hi = max(min(xa, xb), 0), min(max(xa, xb), w - 1)
    if 0 <= y < h and lo <= hi:
        img[y, lo : hi + 1] = color


def _vline(img: np.ndarray, x: int, ya: int, yb: int, color) -> None:
    """Pixels (x, ya..yb), both ends included, clipped to the image."""
    h, w = img.shape[:2]
    lo, hi = max(min(ya, yb), 0), min(max(ya, yb), h - 1)
    if 0 <= x < w and lo <= hi:
        img[lo : hi + 1, x] = color


def draw_rectangle(img: np.ndarray, pt1: tuple[int, int], pt2: tuple[int, int], color) -> None:
    """``cv2.rectangle(img, pt1, pt2, color, 1)``: the four edges of the
    rectangle with corners ``pt1`` and ``pt2`` (both included), clipped."""
    (x1, y1), (x2, y2) = pt1, pt2
    _hline(img, x1, x2, y1, color)
    _hline(img, x1, x2, y2, color)
    _vline(img, x1, y1, y2, color)
    _vline(img, x2, y1, y2, color)


def draw_cross(img: np.ndarray, pos: tuple[int, int], color, size: int = 7) -> None:
    """``cv2.drawMarker(img, pos, color, cv2.MARKER_CROSS, size)``: a
    horizontal and a vertical segment of ``size // 2`` pixels each side."""
    x, y = pos
    r = size // 2
    _hline(img, x - r, x + r, y, color)
    _vline(img, x, y - r, y + r, color)


@dataclass
class HotKey:
    """A keyboard binding: key → callback(key), with a description line."""

    key: str
    func: Callable[[str], None]
    description: str = ""

    def __post_init__(self):
        self.key = self.key.lower()


class StreamViewer:
    """A thin interactive window wrapper (OpenCV, imported when a window is
    used) with hotkey dispatch."""

    def __init__(self, window_name: str = "streamer"):
        self.window_name = window_name
        self.window = None
        self.hotkeys: list[HotKey] = []
        self.register_hotkey(HotKey("q", self.close, "close the window"))

    def register_hotkey(self, hotkey: HotKey) -> None:
        self.hotkeys.append(hotkey)

    def create_trackbar(self, name: str, val: int, maxval: int, onChange=lambda x: x) -> None:
        _cv2("StreamViewer").createTrackbar(name, self.window_name, val, maxval, onChange)

    def update_trackbar(self, name: str, val: int) -> None:
        _cv2("StreamViewer").setTrackbarPos(name, self.window_name, val)

    def set_title(self, title: str) -> None:
        _cv2("StreamViewer").setWindowTitle(self.window_name, title)

    def open(self) -> None:
        cv = _cv2("StreamViewer")
        self.close()
        self.window = cv.namedWindow(self.window_name, flags=cv.WINDOW_GUI_EXPANDED)
        cv.setWindowProperty(self.window_name, cv.WND_PROP_TOPMOST, 1)

    def close(self, key: str | None = None) -> None:
        if self.window is not None:
            _cv2("StreamViewer").destroyWindow(self.window_name)
            self.window = None

    def __enter__(self):
        self.open()
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        self.close()

    def update(self, image: np.ndarray, wait: int = 1) -> None:
        """Show a frame and dispatch any pressed hotkey."""
        _cv2("StreamViewer").imshow(self.window_name, image)
        self.waitKey(wait)

    def waitKey(self, timeout: int = 0) -> None:
        key = _cv2("StreamViewer").waitKey(timeout)
        if key < 0:
            return
        key = chr(key).lower()
        for hotkey in self.hotkeys:
            if key == hotkey.key:
                hotkey.func(key)

    def print_hotkeys(self) -> None:
        print("Hotkeys:")
        for hk in self.hotkeys:
            print(f" - {hk.key} : {hk.description}")


class VLC:
    """Log replayer: overlays logged boxes on experiment frames.

    Args:
        files: iterable of frame file paths (or ``None`` for white frames).
        config: the experiment's timing configuration.
        log_path: path to the bboxes.csv produced by the logging controller.
        cam_type: which view the frame files show — "plt" (full arena),
            "cam" (camera view) or "mic" (micro view); overlay coordinates are
            shifted into that view's frame of reference.
        show_pred: draw the worm (prediction) box.
        show_micro: draw the microscope box.
        show_cam: draw the camera box.
    """

    def __init__(
        self,
        files: list[str] | None,
        config: TimingConfig,
        log_path: str,
        cam_type: str = "plt",
        show_pred: bool = True,
        show_micro: bool = True,
        show_cam: bool = False,
    ) -> None:
        assert cam_type in ("plt", "cam", "mic")
        self.config = config
        self.cam_type = cam_type
        self.show_pred = show_pred
        self.show_micro = show_micro
        self.show_cam = show_cam
        self.index = 0
        self.exit = False
        self.delay = round(config.ms_per_frame)

        self.log = pd.read_csv(log_path)

        if files is not None:
            self.reader = FrameReader(".", list(files), read_format=IMREAD_UNCHANGED) if isinstance(files, list) and files and isinstance(files[0], str) else files
        else:
            if cam_type == "plt":
                # white full-arena frames sized to cover the camera track
                w = int(self.log["cam_x"].max() + self.log["cam_w"].max())
                h = int(self.log["cam_y"].max() + self.log["cam_h"].max())
            elif cam_type == "cam":
                w, h = int(self.log["cam_w"].iloc[0]), int(self.log["cam_h"].iloc[0])
            else:
                w, h = int(self.log["mic_w"].iloc[0]), int(self.log["mic_h"].iloc[0])
            self.reader = DummyReader(len(self.log), (h, w), colored=True)

        self.streamer = StreamViewer(window_name="VLC")
        self._register_default_hotkeys()

    # -- core rendering (pure, headless-safe) ------------------------------

    def __len__(self) -> int:
        return min(len(self.reader), len(self.log))

    def get_attribute(self, col_name: str):
        return self.log[col_name].iloc[self.index]

    def _origin(self) -> tuple[float, float]:
        """Top-left of the displayed view in arena coordinates."""
        if self.cam_type == "plt":
            return 0.0, 0.0
        prefix = self.cam_type
        return self.get_attribute(f"{prefix}_x"), self.get_attribute(f"{prefix}_y")

    def _draw_box(self, img, x, y, w, h, color):
        if not np.isfinite([x, y, w, h]).all():
            return
        draw_rectangle(img, (int(x), int(y)), (int(x + w), int(y + h)), color)

    def render_frame(self, index: int | None = None) -> np.ndarray:
        """The frame at ``index`` with all enabled overlays drawn."""
        if index is not None:
            self.index = index
        frame = self.reader[self.index]
        if frame.ndim == 2:
            frame = np.repeat(frame[..., None], 3, axis=2)  # cv2.COLOR_GRAY2BGR
        else:
            frame = frame.copy()

        ox, oy = self._origin()

        if self.show_pred:
            self._draw_box(
                frame,
                self.get_attribute("wrm_x") - ox,
                self.get_attribute("wrm_y") - oy,
                self.get_attribute("wrm_w"),
                self.get_attribute("wrm_h"),
                (0, 0, 255),
            )
        if self.show_micro:
            self._draw_box(
                frame,
                self.get_attribute("mic_x") - ox,
                self.get_attribute("mic_y") - oy,
                self.get_attribute("mic_w"),
                self.get_attribute("mic_h"),
                (0, 255, 0),
            )
        if self.show_cam:
            self._draw_box(
                frame,
                self.get_attribute("cam_x") - ox,
                self.get_attribute("cam_y") - oy,
                self.get_attribute("cam_w"),
                self.get_attribute("cam_h"),
                (255, 0, 0),
            )
        # platform center marker
        cx, cy = self.get_attribute("plt_x") - ox, self.get_attribute("plt_y") - oy
        if np.isfinite([cx, cy]).all():
            draw_cross(frame, (int(cx), int(cy)), (255, 0, 255), 7)
        return frame

    # -- headless exports --------------------------------------------------

    def save_frames(self, save_folder: str, name_format: str = "frame_{:09d}.png", start: int = 0, stop: int | None = None) -> None:
        """Render and save annotated frames to a folder."""
        create_directory(save_folder)
        stop = len(self) if stop is None else stop
        for i in range(start, stop):
            path = join_paths(save_folder, name_format.format(i))
            if not imwrite(path, self.render_frame(i)):
                raise ValueError(f"Failed to save frame {path}")

    def make_video(self, save_path: str, fps: float | None = None, start: int = 0, stop: int | None = None) -> None:
        """Render the replay into an mp4 (cv2.VideoWriter, no ffmpeg spawn)."""
        cv = _cv2("make_video")
        stop = len(self) if stop is None else stop
        fps = fps if fps is not None else self.config.frames_per_sec
        first = self.render_frame(start)
        h, w = first.shape[:2]
        writer = cv.VideoWriter(save_path, cv.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        try:
            writer.write(first)
            for i in range(start + 1, stop):
                writer.write(self.render_frame(i))
        finally:
            writer.release()

    # -- interactive layer -------------------------------------------------

    def _register_default_hotkeys(self) -> None:
        s = self.streamer
        s.register_hotkey(HotKey("q", self._quit, "quit"))
        s.register_hotkey(HotKey("d", lambda k: self.seek(self.index + 1), "next frame"))
        s.register_hotkey(HotKey("a", lambda k: self.seek(self.index - 1), "previous frame"))
        s.register_hotkey(HotKey("p", self._toggle_play, "play/pause"))
        s.register_hotkey(HotKey("h", lambda k: self._toggle("show_pred"), "toggle worm box"))
        s.register_hotkey(HotKey("m", lambda k: self._toggle("show_micro"), "toggle micro box"))
        s.register_hotkey(HotKey("c", lambda k: self._toggle("show_cam"), "toggle camera box"))
        self._playing = False

    def _quit(self, key=None):
        self.exit = True

    def _toggle_play(self, key=None):
        self._playing = not self._playing

    def _toggle(self, attr: str):
        setattr(self, attr, not getattr(self, attr))

    def seek(self, index: int) -> None:
        self.index = int(np.clip(index, 0, len(self) - 1))

    def play(self) -> None:
        """Open the interactive window and run the replay loop (needs a GUI)."""
        self.streamer.print_hotkeys()
        with self.streamer as s:
            s.create_trackbar("frame", 0, len(self) - 1, lambda v: self.seek(v))
            s.create_trackbar("delay", self.delay, 250, lambda v: setattr(self, "delay", max(v, 1)))
            while not self.exit:
                s.update(self.render_frame(), wait=self.delay if self._playing else 50)
                if self._playing:
                    self.seek(self.index + 1)
                s.update_trackbar("frame", self.index)
