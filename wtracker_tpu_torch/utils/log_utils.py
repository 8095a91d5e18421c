"""Streaming CSV logging.

Port of :mod:`wtracker_tpu.utils.log_utils`: a header-on-open, explicitly
flushable CSV sink taking dict or positional rows.  The simulator's
17-column ``bboxes.csv`` is written through it, so the bytes are the JAX
package's: the ``csv`` module's default dialect (``\\r\\n`` line ends) with
``escapechar=','``, the header written and flushed on construction, Python
and numpy floats as ``str`` gives them.
"""

from __future__ import annotations

import csv
from typing import Iterable, Mapping, Sequence


class CSVLogger:
    """Append-oriented CSV sink bound to a fixed column schema.

    Usable as a context manager; ``close()`` is idempotent.
    """

    def __init__(self, path: str, col_names: Sequence[str], mode: str = "w+"):
        self.path = path
        self.col_names = list(col_names)
        self._sink = open(path, mode, newline="")
        self._emit = csv.writer(self._sink, escapechar=",").writerow
        self._emit(self.col_names)
        self.flush()

    def __enter__(self) -> "CSVLogger":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()

    def flush(self) -> None:
        self._sink.flush()

    def close(self) -> None:
        if self._sink.closed:
            return
        self._sink.flush()
        self._sink.close()

    def _ordered(self, row: Mapping | Iterable) -> tuple:
        """A row as a value tuple in schema order: dict rows column by column
        (missing keys give empty cells), positional rows as given."""
        if isinstance(row, Mapping):
            unknown = set(row) - set(self.col_names)
            if unknown:
                raise ValueError(f"row contains fields not in the schema: {sorted(unknown)}")
            return tuple(row.get(c, "") for c in self.col_names)
        vals = tuple(row)
        if len(vals) != len(self.col_names):
            raise ValueError(f"positional row has {len(vals)} cells, schema has {len(self.col_names)}")
        return vals

    def write(self, row: Mapping | Iterable) -> None:
        """Emit one row, given as a column-keyed mapping or ordered values."""
        self._emit(self._ordered(row))

    def writerows(self, rows: Sequence[Mapping | Iterable]) -> None:
        """Emit a batch of rows (at least one)."""
        if len(rows) == 0:
            raise ValueError("writerows needs at least one row")
        for row in rows:
            self._emit(self._ordered(row))
