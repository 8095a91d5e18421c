"""Classical bbox bootstrap: detect the worm without a trained model.

Port of :mod:`wtracker_tpu.dataset.box_calculator`: per frame, absdiff
against the background → threshold → 5×5 opening → 11×11 dilation → bbox of
the largest blob (:func:`wtracker_tpu_torch.ops.morphology.worm_bboxes_batch`
on the device, chunks of frames decoded on the host); results are memoized
in an all-frames array with (-1, -1, -1, -1) sentinels, and a frame without
a blob gets the zero box.
"""

from __future__ import annotations

from typing import Collection

import numpy as np
import torch

from wtracker_tpu_torch.ops.morphology import worm_bboxes_batch
from wtracker_tpu_torch.utils.device import resolve_device
from wtracker_tpu_torch.utils.frame_reader import FrameReader


def bgr_to_gray(image: np.ndarray) -> np.ndarray:
    """BGR → gray with OpenCV's weights, rounded (the JAX package's formula)."""
    return (0.114 * image[..., 0] + 0.587 * image[..., 1] + 0.299 * image[..., 2]).round().astype(np.uint8)


class BoxCalculator:
    """Computes worm bounding boxes for frames of an experiment.

    Args:
        frame_reader: the experiment's frames.
        background: background image matching the frame shape.
        diff_thresh: foreground threshold on |frame − background|.
        device: where the detection runs.
    """

    def __init__(
        self,
        frame_reader: FrameReader,
        background: np.ndarray,
        diff_thresh: int = 20,
        device: str | torch.device = "cuda",
    ) -> None:
        if diff_thresh <= 0:
            raise ValueError("Difference threshold must be greater than 0.")
        if background.ndim == 3 and background.shape[2] == 3:
            background = bgr_to_gray(background)
        if background.ndim != 2:
            raise ValueError("background must be either a gray or a color image.")
        if frame_reader.frame_size != background.shape[:2]:
            raise ValueError("Background shape must match frame shape.")

        self._frame_reader = frame_reader
        self._background = background
        self._diff_thresh = diff_thresh
        self._device = resolve_device(device)
        self._background_dev = torch.from_numpy(np.ascontiguousarray(background)).to(self._device)
        self._all_bboxes = np.full((len(frame_reader), 4), -1, dtype=int)

    def all_bboxes(self) -> np.ndarray:
        """All computed boxes, (N, 4) xywh; uncomputed rows are -1."""
        return self._all_bboxes

    def get_bbox(self, frame_idx: int) -> np.ndarray:
        """Bbox for one frame (computed on demand, then memoized)."""
        if self._all_bboxes[frame_idx, 0] == -1:
            self.calc_specified_boxes([frame_idx])
        return self._all_bboxes[frame_idx]

    def calc_specified_boxes(
        self,
        frame_indices: Collection[int],
        num_workers: int | None = None,
        chunk_size: int = 256,
    ) -> np.ndarray:
        """Compute boxes for the given frames, ``chunk_size`` frames a device
        batch.  ``num_workers`` is accepted for the JAX package's signature;
        the device batch replaces a process pool."""
        indices = np.asarray(list(frame_indices), dtype=int)
        todo = indices[self._all_bboxes[indices, 0] == -1]

        for s in range(0, len(todo), chunk_size):
            chunk = todo[s : s + chunk_size]
            frames = self._frame_reader.read_batch(chunk)
            if frames.ndim == 4 and frames.shape[-1] == 3:
                frames = bgr_to_gray(frames)
            boxes, found = worm_bboxes_batch(torch.from_numpy(frames).to(self._device), self._background_dev,
                                             self._diff_thresh)
            boxes = boxes.cpu().numpy()
            boxes[~found.cpu().numpy()] = 0  # no blob -> zero box, like the reference
            self._all_bboxes[chunk] = boxes

        return self._all_bboxes[indices, :]

    def calc_all_boxes(self, num_workers: int | None = None, chunk_size: int = 256) -> np.ndarray:
        """Compute boxes for every frame."""
        return self.calc_specified_boxes(range(len(self._frame_reader)), num_workers, chunk_size)
