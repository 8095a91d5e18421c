"""Async task offload: one worker thread draining a queue.

Port of :mod:`wtracker_tpu.utils.threading_utils`: the ``adjust_num_workers``
sizing rule, a queue that drives a progress bar, and the queue + worker
scheduler the image savers run on.  ``tqdm`` is imported only when a
progress bar is asked for.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable


def adjust_num_workers(num_tasks: int, chunk_size: int, num_workers: int | None = None) -> int:
    """A worker count for ``num_tasks`` split into ``chunk_size`` chunks.

    ``None`` sizes to ``round(min(cpus/2, tasks/(2*chunk)))``; a request > 0
    gets at least one worker; a request <= 0 (or a size of 0) means no
    parallelism.  Never more than the CPU count or the number of full chunks.
    """
    cpus = os.cpu_count() or 1
    requested = num_workers if num_workers is not None else round(min(cpus / 2, num_tasks / (2 * chunk_size)))
    if requested <= 0:
        return 0
    return max(1, min(requested, num_tasks // chunk_size, cpus))


class TqdmQueue(queue.Queue):
    """A ``queue.Queue`` whose puts and ``task_done`` calls drive a tqdm bar:
    the total grows as items are queued, the position as they are done;
    ``join()`` closes the bar."""

    def __init__(self, maxsize: int = 0, **tqdm_kwargs):
        from tqdm.auto import tqdm

        super().__init__(maxsize=maxsize)
        self.total = 0
        self.pbar = tqdm(total=1, **tqdm_kwargs)

    def _repaint(self) -> None:
        self.pbar.total = self.total
        self.pbar.refresh()

    def _put(self, item) -> None:
        # called under the queue's mutex
        super()._put(item)
        self.total += 1
        self._repaint()

    def task_done(self) -> None:
        super().task_done()
        self.pbar.update(1)
        self._repaint()

    def join(self) -> None:
        queue.Queue.join(self)
        self.pbar.close()


class TaskScheduler:
    """Run ``task_func`` on queued work items in a dedicated worker thread.

    ``close()`` joins the queue, posts a ``None`` sentinel and joins the
    thread, so every scheduled task completes first.  A task's exception is
    kept and raised again from ``close()`` (a dead worker would leave
    ``queue.join()`` waiting for ever).
    """

    def __init__(self, task_func: Callable, maxsize: int = 0, tqdm: bool = True, **tqdm_kwargs):
        self._task_func = task_func
        self._errors: list[Exception] = []
        self._queue: queue.Queue = TqdmQueue(maxsize, **tqdm_kwargs) if tqdm else queue.Queue(maxsize)
        self._worker_thread = threading.Thread(target=self._drain, daemon=True, name="wtracker-io-worker")

    def start(self) -> None:
        self._worker_thread.start()

    def __enter__(self) -> "TaskScheduler":
        self.start()
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()

    def close(self) -> None:
        """Drain the queue, stop the worker, join it; raise a task's error."""
        self._queue.join()
        self._queue.put(None)
        self._worker_thread.join()
        if self._errors:
            raise RuntimeError(
                f"{len(self._errors)} task(s) failed; first error: {self._errors[0]!r}"
            ) from self._errors[0]

    def schedule_save(self, *params) -> None:
        """Queue one work item (blocks while the queue is full)."""
        self._queue.put(params, block=True)

    def _drain(self) -> None:
        for work in iter(self._queue.get, None):
            try:
                self._task_func(work)
            except Exception as e:  # keep draining; raise on close
                self._errors.append(e)
            finally:
                self._queue.task_done()
