"""Dataclass configuration base with JSON persistence.

Port of :mod:`wtracker_tpu.utils.config_base` (JSON round-trip only).  The two
quirks that persisted files depend on are kept:

* ``save_json`` serializes ``__dict__``, so derived fields computed in
  ``__post_init__`` are stored in the JSON;
* ``load_json`` bypasses ``__init__``/``__post_init__`` (``cls.__new__`` +
  ``__dict__.update``), so round-tripped configs keep their stored derived
  fields verbatim.

The JAX package opens a file dialog when no path is given; the port always
needs a path.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import TypeVar

T = TypeVar("T", bound="ConfigBase")


@dataclass
class ConfigBase:
    """Base class for all persistable configuration dataclasses."""

    @classmethod
    def load_json(cls: type[T], path: str) -> T:
        with open(path, "r") as f:
            data = json.load(f)
        obj = cls.__new__(cls)
        obj.__dict__.update(data)
        return obj

    def save_json(self, path: str) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.__dict__, f, indent=4)
