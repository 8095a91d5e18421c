"""Platform view geometry: world padding, position clamping, camera/micro crops.

Port of :mod:`wtracker_tpu.sim.view`, host side (numpy):

* the world is the raw frame plus replicate padding of ``camera_size // 2``
  on each side, so the camera view always lies inside the padded world;
* the platform-centre position is clamped to the *unpadded* frame bounds;
* views are centre-anchored: top-left = position − size // 2;
* the crop is ``frame[y:y+h, x:x+w]`` (the reference swaps w and h there,
  which only square views, the ones it uses, hide).
"""

from __future__ import annotations

import numpy as np

from wtracker_tpu_torch.utils.frame_reader import FrameReader, FrameStream


def clamp_position(x, y, frame_shape: tuple[int, ...]):
    """Clamp a platform-centre position to the frame bounds ``(h, w, ...)``."""
    x = np.clip(x, 0, frame_shape[1] - 1)
    y = np.clip(y, 0, frame_shape[0] - 1)
    return x, y


def pad_world(frame: np.ndarray, padding: tuple[int, int]) -> np.ndarray:
    """Replicate-pad a frame by ``padding = (pad_x, pad_y)`` on each side."""
    pad_x, pad_y = padding
    widths = [(pad_y, pad_y), (pad_x, pad_x)] + [(0, 0)] * (frame.ndim - 2)
    return np.pad(frame, widths, mode="edge")


def view_bbox(position: tuple[int, int], padding: tuple[int, int], w: int, h: int) -> tuple[int, int, int, int]:
    """Bbox of a centre-anchored view inside the *padded* world, (x, y, w, h)."""
    x = position[0] + padding[0] - w // 2
    y = position[1] + padding[1] - h // 2
    return x, y, w, h


def crop_view(world: np.ndarray, bbox: tuple[int, int, int, int]) -> np.ndarray:
    """Slice a view out of the padded world."""
    x, y, w, h = bbox
    return world[y : y + h, x : x + w]


class ViewController(FrameStream):
    """A frame-stream cursor that tracks the platform position and yields views.

    Args:
        frame_reader: source of raw frames.
        camera_size: camera view size (w, h) in pixels.
        micro_size: microscope view size (w, h) in pixels.
        init_position: initial platform-centre position (x, y).
    """

    def __init__(
        self,
        frame_reader: FrameReader,
        camera_size: tuple[int, int] = (251, 251),
        micro_size: tuple[int, int] = (45, 45),
        init_position: tuple[int, int] = (0, 0),
    ):
        super().__init__(frame_reader)
        if camera_size[0] < micro_size[0] or camera_size[1] < micro_size[1]:
            raise ValueError(f"camera {camera_size} is smaller than the microscope view {micro_size}")

        self._padding_size: tuple[int, int] = (camera_size[0] // 2, camera_size[1] // 2)
        self._camera_size = camera_size
        self._micro_size = micro_size
        self._position = init_position
        self.set_position(*init_position)

    def read(self) -> np.ndarray:
        """The current frame with replicate world padding."""
        return pad_world(super().read(), self._padding_size)

    @property
    def position(self) -> tuple[int, int]:
        """Platform-centre position (x, y), in unpadded frame coordinates."""
        return self._position

    @property
    def camera_size(self) -> tuple[int, int]:
        return self._camera_size

    @property
    def micro_size(self) -> tuple[int, int]:
        return self._micro_size

    @property
    def camera_position(self) -> tuple[int, int, int, int]:
        """Camera-view bbox (x, y, w, h) in unpadded frame coordinates."""
        w, h = self._camera_size
        return (self._position[0] - w // 2, self._position[1] - h // 2, w, h)

    @property
    def micro_position(self) -> tuple[int, int, int, int]:
        """Micro-view bbox (x, y, w, h) in unpadded frame coordinates."""
        w, h = self._micro_size
        return (self._position[0] - w // 2, self._position[1] - h // 2, w, h)

    def set_position(self, x: int, y: int) -> None:
        """Set the platform centre, clamped to the frame bounds."""
        self._position = clamp_position(x, y, self._frame_reader.frame_shape)

    def move_position(self, dx: int, dy: int) -> None:
        """Move the platform centre by (dx, dy), clamped to the frame bounds."""
        self.set_position(self._position[0] + dx, self._position[1] + dy)

    def _calc_view_bbox(self, w: int, h: int) -> tuple[int, int, int, int]:
        """Bbox of a (w, h) view around the position, in padded-world coordinates."""
        return view_bbox(self._position, self._padding_size, w, h)

    def _custom_view(self, w: int, h: int) -> np.ndarray:
        return crop_view(self.read(), self._calc_view_bbox(w, h))

    def camera_view(self) -> np.ndarray:
        """The camera's current view of the world."""
        return self._custom_view(*self._camera_size)

    def micro_view(self) -> np.ndarray:
        """The microscope's current view of the world."""
        return self._custom_view(*self._micro_size)

    def visualize_world(self, line_width: int = 4, timeout: int = 1) -> None:
        """Show the padded world with the camera and micro boxes (needs
        OpenCV and a display)."""
        import cv2 as cv

        x_mid, y_mid, _, _ = self._calc_view_bbox(0, 0)
        x_cam, y_cam, w_cam, h_cam = self._calc_view_bbox(*self._camera_size)
        x_mic, y_mic, w_mic, h_mic = self._calc_view_bbox(*self._micro_size)

        world = self.read()
        if world.ndim == 2:
            world = cv.cvtColor(world, cv.COLOR_GRAY2BGR)

        cv.rectangle(world, (x_cam, y_cam), (x_cam + w_cam, y_cam + h_cam), (0, 0, 255), line_width)
        cv.rectangle(world, (x_mic, y_mic), (x_mic + w_mic, y_mic + h_mic), (0, 255, 0), line_width)
        cv.circle(world, (x_mid, y_mid), 1, (255, 0, 0), line_width)

        cv.imshow("World View", world)
        cv.waitKey(timeout)
