"""Training-sample extraction: crop fixed-size images around detected worms.

Port of :mod:`wtracker_tpu.dataset.sample_extractor`: a fixed-size window
is placed so that each detected worm lands at a uniformly random offset
inside it (``np.random.default_rng(seed)``, drawn as the JAX package draws),
the window is shifted fully inside the frame, and the crops are saved on a
worker thread (:class:`~wtracker_tpu_torch.utils.io_utils.FrameSaver`).
Used to build YOLO training sets.
"""

from __future__ import annotations

from typing import Collection

import numpy as np

from wtracker_tpu_torch.dataset.box_calculator import BoxCalculator
from wtracker_tpu_torch.utils.io_utils import FrameSaver


def clamp_windows(windows: np.ndarray, frame_wh: tuple[int, int]) -> np.ndarray:
    """Translate crop windows (xywh) so each lies fully inside ``frame_wh``.

    Windows are only moved, never resized; a window larger than the frame is
    an error.
    """
    bound = np.asarray(frame_wh, dtype=windows.dtype)
    xy, wh = windows[:, :2], windows[:, 2:]
    shifted = np.clip(xy, 0, bound - wh)
    if (bound < wh).any() or (shifted < 0).any():
        raise ValueError("sample window does not fit inside the frame")
    return np.concatenate([shifted, wh], axis=1)


class SampleExtractor:
    """Extracts fixed-size training samples centred near detected worms."""

    def __init__(self, bbox_calculator: BoxCalculator):
        self._bbox_calculator = bbox_calculator
        self._frame_reader = bbox_calculator._frame_reader

    def move_bboxes_into_bounds(self, bboxes: np.ndarray, frame_size: tuple[int, int]) -> np.ndarray:
        """Shift crop windows so they lie inside ``frame_size`` (w, h)."""
        return clamp_windows(bboxes, frame_size)

    def _jittered_windows(self, detections: np.ndarray, target_wh: tuple[int, int], rng) -> np.ndarray:
        """Fixed-size windows placed so each worm lands at a uniformly random
        offset inside its window, clamped into the frame."""
        tw, th = target_wh
        jitter = np.stack(
            [
                rng.integers(0, tw - detections[:, 2] + 1),
                rng.integers(0, th - detections[:, 3] + 1),
            ],
            axis=-1,
        )
        corner = detections[:, :2] - jitter
        sizes = np.broadcast_to(np.asarray([tw, th], corner.dtype), corner.shape)
        windows = np.concatenate([corner, sizes], axis=1)

        h, w = self._frame_reader.frame_size
        return clamp_windows(windows, (w, h))

    def create_specified_samples(
        self,
        frame_indices: Collection[int],
        target_size: tuple[int, int],
        save_folder: str,
        name_format: str = "img_{:09d}.png",
        num_workers: int | None = None,
        chunk_size: int = 256,
        seed: int | None = None,
    ) -> None:
        """Extract one sample per given frame and save them asynchronously.

        Args:
            frame_indices: frames to sample from.
            target_size: crop size (w, h).
            save_folder: output directory.
            name_format: file name template (formatted with the sample index).
            seed: RNG seed for the crop jitter (None = nondeterministic).
        """
        detections = self._bbox_calculator.calc_specified_boxes(
            frame_indices=frame_indices, num_workers=num_workers, chunk_size=chunk_size
        )
        windows = self._jittered_windows(detections, target_size, np.random.default_rng(seed))

        with FrameSaver(self._frame_reader, root_path=save_folder, tqdm=False) as saver:
            for i, (frame_idx, window) in enumerate(zip(frame_indices, windows)):
                saver.schedule_save(int(frame_idx), tuple(int(v) for v in window), name_format.format(i))

    def create_samples(
        self,
        count: int,
        target_size: tuple[int, int],
        save_folder: str,
        name_format: str = "img_{:09d}.png",
        num_workers: int | None = None,
        chunk_size: int = 256,
        seed: int | None = None,
    ) -> None:
        """Extract samples from ``count`` randomly chosen frames."""
        available = len(self._frame_reader)
        picks = np.random.default_rng(seed).choice(available, size=min(available, count), replace=False)
        self.create_specified_samples(picks, target_size, save_folder, name_format, num_workers, chunk_size, seed)

    def create_all_samples(
        self,
        target_size: tuple[int, int],
        save_folder: str,
        name_format: str = "img_{:09d}.png",
        num_workers: int | None = None,
        chunk_size: int = 256,
        seed: int | None = None,
    ) -> None:
        """Extract one sample from every frame."""
        self.create_specified_samples(
            range(len(self._frame_reader)), target_size, save_folder, name_format, num_workers, chunk_size, seed
        )
