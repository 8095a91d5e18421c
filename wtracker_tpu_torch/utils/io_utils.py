"""Async image/frame saving and pickle helpers.

Port of :mod:`wtracker_tpu.utils.io_utils`: ``ImageSaver`` and
``FrameSaver`` write on a :class:`~wtracker_tpu_torch.utils.threading_utils.TaskScheduler`
worker thread, so disk writes never block the caller; a failed write retries
once after creating the parent directory.  PNG and BMP files are written
by the port's codec (:mod:`wtracker_tpu_torch.utils.image_codec`); other
formats need OpenCV, imported only when such a file is written (the card's
machine has no OpenCV).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from wtracker_tpu_torch.utils.frame_reader import FrameReader
from wtracker_tpu_torch.utils.image_codec import imwrite
from wtracker_tpu_torch.utils.path_utils import create_directory, create_parent_directory, join_paths
from wtracker_tpu_torch.utils.threading_utils import TaskScheduler


class _DiskImageSink(TaskScheduler):
    """A root directory plus a write-with-retry on the worker thread."""

    def __init__(self, task_func, root_path: str, maxsize: int, tqdm: bool, **tqdm_kwargs):
        super().__init__(task_func, maxsize, tqdm, **tqdm_kwargs)
        self._root_path = root_path
        create_directory(root_path)

    def _write(self, rel_name: str, img: np.ndarray) -> None:
        target = join_paths(self._root_path, rel_name)
        if imwrite(target, img):
            return
        # a first failure is usually a missing subdirectory
        create_parent_directory(target)
        if not imwrite(target, img):
            raise ValueError(f"Failed to save image {target}")


class ImageSaver(_DiskImageSink):
    """Save in-memory image arrays to disk asynchronously."""

    def __init__(self, root_path: str = "", maxsize: int = 100, tqdm: bool = True, **tqdm_kwargs):
        super().__init__(self._save_image, root_path, maxsize, tqdm, **tqdm_kwargs)

    def schedule_save(self, img: np.ndarray, img_name: str) -> None:
        """Queue saving of ``img`` under ``img_name`` (relative to the root)."""
        super().schedule_save(img, img_name)

    def _save_image(self, params: tuple[np.ndarray, str]) -> None:
        img, img_name = params
        self._write(img_name, img)


class FrameSaver(_DiskImageSink):
    """Save crops cut from a :class:`FrameReader` by index and box, asynchronously."""

    def __init__(
        self,
        frame_reader: FrameReader,
        root_path: str = "",
        maxsize: int = 100,
        tqdm: bool = True,
        **tqdm_kwargs,
    ):
        super().__init__(self._save_frame, root_path, maxsize, tqdm, **tqdm_kwargs)
        self._frame_reader = frame_reader

    def schedule_save(self, img_index: int, crop_dims: tuple[int, int, int, int], img_name: str) -> None:
        """Queue saving of frame ``img_index`` cropped to ``(x, y, w, h)``."""
        super().schedule_save(img_index, crop_dims, img_name)

    def _save_frame(self, params: tuple[int, tuple[int, int, int, int], str]) -> None:
        img_index, (x, y, w, h), img_name = params
        frame = self._frame_reader[img_index]
        self._write(img_name, frame[y : y + h, x : x + w])


def pickle_load_object(file_path: str):
    """Load a pickled object, naming the file in any error.  Unpickling runs
    the file's code: load only files this project wrote."""
    if not os.path.isfile(file_path):
        raise FileNotFoundError(f"file does not exist: {file_path}")
    try:
        with open(file_path, "rb") as f:
            return pickle.load(f)
    except Exception as e:
        raise ValueError(f"error loading object from pickle file {file_path}: {e}") from e


def pickle_save_object(obj, file_path: str) -> None:
    """Pickle an object to ``file_path``, creating parent directories."""
    try:
        create_parent_directory(file_path)
        with open(file_path, "wb") as f:
            pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)
    except Exception as e:
        raise ValueError(f"error saving object to pickle file {file_path}: {e}") from e
