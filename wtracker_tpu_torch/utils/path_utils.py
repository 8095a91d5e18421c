"""Filesystem path helpers for the frame reader and the command-line tools.

The part of :mod:`wtracker_tpu.utils.path_utils` that the port's entry points
use.  Paths are posix-style strings, since they end up in JSON configs and
CSV logs.
"""

from __future__ import annotations

import os
from pathlib import PurePath


def join_paths(*path_segments: str) -> str:
    """Join path segments into a single posix-style path string."""
    return PurePath(*path_segments).as_posix()


def create_directory(dir_path: str) -> None:
    """Ensure the directory exists (creating intermediate levels as needed).

    An empty path means the current directory.
    """
    os.makedirs(dir_path or ".", exist_ok=True)
