"""Filesystem path helpers and a sorted-directory iterator.

Port of :mod:`wtracker_tpu.utils.path_utils`: ``join_paths`` and directory
creation, ``bulk_rename`` and the ``Files`` scandir iterator with a
caller-supplied sorting key.  Paths are posix-style strings, since they end
up in JSON configs and CSV logs.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path, PurePath
from typing import Callable, Iterator, Union


def absolute_path(file_path: str) -> str:
    """Absolute, posix-style path for a file."""
    return Path(file_path).resolve().as_posix()


def join_paths(*path_segments: str) -> str:
    """Join path segments into a single posix-style path string."""
    return PurePath(*path_segments).as_posix()


def create_directory(dir_path: str) -> None:
    """Ensure the directory exists (creating intermediate levels as needed).

    An empty path means the current directory.
    """
    os.makedirs(dir_path or ".", exist_ok=True)


def create_parent_directory(file_path: str) -> None:
    """Ensure the directory that will hold ``file_path`` exists."""
    parent = os.path.dirname(file_path)
    if parent:
        os.makedirs(parent, exist_ok=True)


def bulk_rename(dir_path: str, rename_fn: Callable[[str], str]) -> None:
    """Rename every file (not subdirectory) in ``dir_path`` via ``rename_fn``."""
    # a snapshot first: a lazily iterated scandir can yield a renamed entry again
    for entry in list(os.scandir(dir_path)):
        if entry.is_file():
            os.rename(entry.path, os.path.join(dir_path, rename_fn(entry.name)))


class Files:
    """Iterate the files of a directory in a caller-defined order.

    A filtered ``os.scandir`` snapshot with a seekable cursor; the cursor
    drives ``get_filename``/``get_path``/``copy`` on the entry yielded last.

    Args:
        directory: directory to scan.
        extension: keep only entries whose (lowercased) name ends with this.
        scan_dirs: include subdirectories in the results.
        return_full_path: yield full paths instead of bare names.
        sorting_key: maps a file *name* to its sort key (e.g. the frame
            number of ``frame_000123.bmp``).
    """

    def __init__(
        self,
        directory: str,
        extension: str = "",
        scan_dirs: bool = False,
        return_full_path: bool = True,
        sorting_key: Callable[[str], Union[int, str]] = lambda name: name,
    ) -> None:
        self.root = directory
        self.extension = extension.lower()
        self.scan_dirs = scan_dirs
        self.return_full_path = return_full_path
        self.sorting_func = sorting_key
        self.results: list[os.DirEntry] = []
        self._pos = -1
        self._scan()

    def _admit(self, entry: os.DirEntry) -> bool:
        if entry.is_dir():
            return self.scan_dirs
        return entry.name.lower().endswith(self.extension)

    def _scan(self) -> None:
        snapshot = [e for e in os.scandir(self.root) if self._admit(e)]
        snapshot.sort(key=lambda e: self.sorting_func(e.name))
        self.results = snapshot
        self._pos = -1

    def __len__(self) -> int:
        return len(self.results)

    def __getitem__(self, index: int) -> os.DirEntry:
        return self.results[index]

    def __contains__(self, key: str) -> bool:
        return any(key == entry.name for entry in self.results)

    def __iter__(self) -> Iterator[str]:
        self._pos = -1
        return self

    def __next__(self) -> str:
        self._pos += 1
        try:
            entry = self.results[self._pos]
        except IndexError:
            raise StopIteration from None
        return entry.path if self.return_full_path else entry.name

    def seek(self, pos: int) -> str:
        """Jump the cursor so the next yield is entry ``pos``; return it."""
        if not 0 <= pos < len(self):
            raise IndexError(f"position {pos} outside 0..{len(self) - 1}")
        self._pos = pos - 1
        return next(self)

    def get_filename(self) -> str:
        return self.results[self._pos].name

    def get_path(self) -> str:
        return self.results[self._pos].path

    def copy(self, dst_root: str) -> None:
        """Copy the current file (with metadata) into ``dst_root``."""
        shutil.copy2(self.get_path(), dst=dst_root)
