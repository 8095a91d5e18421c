"""Optional GUI file dialogs (tkinter), headless-safe.

Port of :mod:`wtracker_tpu.utils.gui_utils`: ``UserPrompt`` and
``FocusedWindow``.  tkinter is imported when a dialog opens; on a machine
without a display or without tkinter the prompts raise a clear
``RuntimeError``, so every code path that takes an explicit path works
without a GUI.
"""

from __future__ import annotations

import os
from typing import Iterable


def _require_tk():
    if not (os.environ.get("DISPLAY") or os.name == "nt"):
        raise RuntimeError(
            "GUI file dialogs need a display; pass an explicit `path` argument "
            "when running headless."
        )
    try:
        import tkinter
        from tkinter import filedialog
    except Exception as e:  # pragma: no cover - depends on system install
        raise RuntimeError(f"tkinter is unavailable: {e}")
    return tkinter, filedialog


class FocusedWindow:
    """A hidden, top-most tk root window used to keep dialogs in front."""

    def __init__(self):
        tkinter, _ = _require_tk()
        self.root = tkinter.Tk()
        self.hide()

    def __enter__(self):
        return self.focus()

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.hide()

    def focus(self):
        root = self.root
        root.eval("tk::PlaceWindow %s center" % root.winfo_pathname(root.winfo_id()))
        root.deiconify()
        root.lift()
        root.focus_force()
        root.attributes("-topmost", True)
        root.after_idle(root.attributes, "-topmost", False)
        root.withdraw()
        return root

    def hide(self):
        self.root.withdraw()

    def close(self):
        self.root.destroy()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class UserPrompt:
    """File/directory pickers; every method supports full tkinter kwargs."""

    @staticmethod
    def open_file(
        title: str | None = None,
        file_types: Iterable[tuple[str, str]] | None = None,
        multiple: bool = False,
        **kwargs,
    ):
        _, filedialog = _require_tk()
        file_types = list(file_types or []) + [("all files", "*.*")]
        with FocusedWindow() as parent:
            if multiple:
                return list(
                    filedialog.askopenfilenames(parent=parent, title=title, filetypes=file_types, **kwargs)
                )
            return filedialog.askopenfilename(parent=parent, title=title, filetypes=file_types, **kwargs)

    @staticmethod
    def save_file(title: str | None = None, file_types: Iterable[tuple[str, str]] | None = None, **kwargs):
        _, filedialog = _require_tk()
        file_types = list(file_types or []) + [("all files", "*.*")]
        with FocusedWindow() as parent:
            return filedialog.asksaveasfilename(parent=parent, title=title, filetypes=file_types, confirmoverwrite=True, **kwargs)

    @staticmethod
    def open_directory(title: str | None = None, **kwargs):
        _, filedialog = _require_tk()
        with FocusedWindow() as parent:
            return filedialog.askdirectory(parent=parent, title=title, mustexist=True, **kwargs)
