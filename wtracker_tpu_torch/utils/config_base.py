"""Dataclass configuration base with JSON and pickle persistence.

Port of :mod:`wtracker_tpu.utils.config_base`.  The two quirks that persisted
files depend on are kept:

* ``save_json`` serializes ``__dict__``, so derived fields computed in
  ``__post_init__`` are stored in the JSON;
* ``load_json`` bypasses ``__init__``/``__post_init__`` (``cls.__new__`` +
  ``__dict__.update``), so round-tripped configs keep their stored derived
  fields verbatim.

A missing ``path`` opens a file dialog
(:class:`~wtracker_tpu_torch.utils.gui_utils.UserPrompt`, tkinter imported
then), as in the JAX package; without a display that raises a clear error.
"""

from __future__ import annotations

import json
from dataclasses import MISSING, dataclass, fields, is_dataclass
from pathlib import Path
from typing import TypeVar

T = TypeVar("T", bound="ConfigBase")


def _resolve_path(path: str | None, title: str, save: bool) -> str:
    if path is not None:
        return path
    from wtracker_tpu_torch.utils.gui_utils import UserPrompt  # tkinter is optional

    if save:
        return UserPrompt.save_file(title=title, file_types=[("json", ".json")], defaultextension=".json")
    return UserPrompt.open_file(title=title, file_types=[("json", ".json")])


@dataclass
class ConfigBase:
    """Base class for all persistable configuration dataclasses."""

    @classmethod
    def load_json(cls: type[T], path: str | None = None) -> T:
        path = _resolve_path(path, f"Open {cls.__name__} File", save=False)
        with open(path, "r") as f:
            data = json.load(f)
        obj = cls.__new__(cls)
        obj.__dict__.update(data)
        return obj

    def save_json(self, path: str | None = None) -> None:
        path = _resolve_path(path, f"Save {type(self).__name__} As", save=True)
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.__dict__, f, indent=4)

    @classmethod
    def load_pickle(cls: type[T], path: str | None = None) -> T:
        from wtracker_tpu_torch.utils.io_utils import pickle_load_object

        return pickle_load_object(_resolve_path(path, f"Open {cls.__name__} File", save=False))

    def save_pickle(self, path: str | None = None) -> None:
        from wtracker_tpu_torch.utils.io_utils import pickle_save_object

        pickle_save_object(self, _resolve_path(path, f"Save {type(self).__name__} As", save=True))


def print_initialization(cls, include_default: bool = True, init_fields_only: bool = True) -> str:
    """Print (and return) a fill-in-the-blanks constructor call for a config
    dataclass."""
    if not is_dataclass(cls):
        raise TypeError(f"{cls.__name__} is not a dataclass")

    lines = [f"{cls.__name__}("]
    for f in fields(cls):
        if init_fields_only and f.init is False:
            continue
        has_default = f.default is not MISSING
        val = f.default if (include_default and has_default) else None
        if isinstance(val, str):
            val = f'"{val}"'
        lines.append(f"    {f.name} = {val}, # {f.type}")
    lines.append(")")
    text = "\n".join(lines)
    print(text)
    return text
