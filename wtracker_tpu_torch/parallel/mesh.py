"""Scale-out over several devices: streams for the closed loop, data for
training.

Port of :mod:`wtracker_tpu.parallel.mesh`.  The JAX package names two axes,
and so does the port:

* **streams** — independent worm streams shard over the mesh's devices for
  the closed-loop engine.  One host process drives every device
  (:func:`run_engine_sharded`): each device gets a contiguous slice of the
  streams and its own controller, and each cycle launches every device's
  step in turn without waiting for any of them, so the devices run side by
  side; no collective runs inside the cycle loop.
* **data** — a training batch shards over the mesh, one process per device
  over ``torch.distributed`` (NCCL when every rank has its own card, gloo
  on the CPU or when ranks share a card).  A data-parallel step computes
  the same step as one device on the whole batch: the gradients are summed
  over the ranks, and train-mode BatchNorm normalises with the statistics
  of the whole batch (:func:`wtracker_tpu_torch.models.batchnorm.synced_batch_norm`).

A :class:`Mesh` lists its devices explicitly.  A device may appear more
than once: two slots on one card run two shards of the streams (or two
ranks of a data-parallel step) on that card, which is how one H100 runs
the multi-device paths.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Callable, Sequence

import numpy as np
import torch

from wtracker_tpu_torch.sim.engine import (
    CycleController,
    CycleLog,
    EngineParams,
    _make_per_stream_step,
    _rebuild,
    init_stream_carry,
    make_batched_cycle_step,
    make_delayed_cycle_step,
)
from wtracker_tpu_torch.utils.device import resolve_device

ControllerFactory = Callable[[torch.device, int, int], CycleController]


@dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D mesh: an ordered tuple of device slots and the axis name.

    ``devices`` is a 1-D numpy object array of ``torch.device`` (so
    ``mesh.devices.size`` is the slot count, as in JAX)."""

    devices: np.ndarray
    axis: str = "streams"

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def distinct_devices(self) -> list[torch.device]:
        """The mesh's devices, each once, in slot order."""
        return list(dict.fromkeys(self.devices.tolist()))


def make_mesh(
    n_devices: int | None = None,
    axis: str = "streams",
    devices: Sequence[str | torch.device] | None = None,
) -> Mesh:
    """A 1-D mesh over explicit ``devices`` (e.g. ``["cpu", "cpu"]``, or
    ``["cuda:0", "cuda:0"]`` for two slots on one card), or by default over
    every visible CUDA device; ``n_devices`` keeps the first ``n``."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass devices=[...] (e.g. ['cpu', 'cpu'])")
        devices = [f"cuda:{i}" for i in range(count)]
    devs = [resolve_device(d) for d in devices]
    if n_devices is not None:
        if not 0 < n_devices <= len(devs):
            raise ValueError(f"n_devices={n_devices} but the mesh has {len(devs)} devices")
        devs = devs[:n_devices]
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr, axis)


def pad_streams(arrays, init_positions: np.ndarray, n_devices: int):
    """Pad a stream batch to a multiple of ``n_devices`` by repeating the
    last stream; returns ``(padded_arrays, padded_init, real_count)``.

    ``arrays`` is a tree (dicts, tuples, lists) of (S, ...) numpy leaves
    (e.g. stacked worm tables or trajectories).  Logs for slots >=
    ``real_count`` are duplicates to drop.  This is the padding
    :func:`run_engine_sharded`'s divisibility error points at, explicit so
    the caller knows which log rows are real."""
    s = int(np.asarray(init_positions).shape[0])
    pad = (-s) % n_devices
    if pad == 0:
        return arrays, init_positions, s

    def _pad(leaf):
        leaf = np.asarray(leaf)
        return np.concatenate([leaf, np.repeat(leaf[-1:], pad, axis=0)], axis=0)

    def _map(tree):
        if isinstance(tree, dict):
            return {k: _map(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return _rebuild(tree, [_map(v) for v in tree])
        return _pad(tree)

    return _map(arrays), _pad(init_positions), s


@dataclass(frozen=True)
class Sharding:
    """How a leaf is placed over a mesh: ``split=True`` cuts its leading
    (stream) axis into contiguous per-slot slices, ``split=False`` copies it
    to every slot."""

    mesh: Mesh
    split: bool

    def bounds(self, n: int) -> list[tuple[int, int]]:
        """The ``[lo, hi)`` rows of each slot for a leading axis of ``n``."""
        k = self.mesh.size
        if self.split and n % k:
            raise ValueError(f"a leading axis of {n} does not split over {k} slots")
        step = n // k if self.split else n
        return [(i * step, (i + 1) * step) if self.split else (0, n) for i in range(k)]

    def place(self, leaf) -> list:
        """``leaf`` on every slot: its slot's rows (split) or all of it."""
        t = torch.as_tensor(leaf)
        return [t[lo:hi].to(dev) for (lo, hi), dev in zip(self.bounds(t.shape[0] if t.ndim else 1), self.mesh.devices)]


def stream_sharding(mesh: Mesh, axis: str = "streams") -> Sharding:
    """The placement that splits the leading (stream or batch) axis over the
    mesh, in contiguous slices."""
    return Sharding(mesh, split=True)


def replicated(mesh: Mesh) -> Sharding:
    """The placement that copies a leaf to every slot."""
    return Sharding(mesh, split=False)


# ---------------------------------------------------------------------------
# the stream axis: the sharded closed loop
# ---------------------------------------------------------------------------


def _device_scope(dev: torch.device):
    """The slot's device as the current CUDA device (the hand kernels launch
    on the current device's stream), or nothing on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _slice_tree(tree, n_streams: int, lo: int, hi: int):
    """``tree`` with every tensor of leading axis ``n_streams`` cut to rows
    ``[lo, hi)``; other leaves shared."""
    if isinstance(tree, dict):
        return {k: _slice_tree(v, n_streams, lo, hi) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return _rebuild(tree, [_slice_tree(v, n_streams, lo, hi) for v in tree])
    if isinstance(tree, torch.Tensor) and tree.ndim >= 1 and tree.shape[0] == n_streams:
        return tree[lo:hi]
    return tree


def _tensor_devices(tree) -> set:
    if isinstance(tree, dict):
        return set().union(*(_tensor_devices(v) for v in tree.values())) if tree else set()
    if isinstance(tree, (tuple, list)):
        return set().union(*(_tensor_devices(v) for v in tree)) if tree else set()
    return {tree.device} if isinstance(tree, torch.Tensor) else set()


def _slot_controllers(
    controller, mesh: Mesh, bounds: list[tuple[int, int]], n_streams: int, batched: bool
) -> list[CycleController]:
    """One controller per slot, over that slot's streams on its device.  A
    plain controller's ``init()`` state is cut to the slot's rows (its
    leading axis is the stream axis by contract); its ``consts`` only when
    it is batched (a per-stream controller gets its consts whole, as every
    stream does)."""
    if isinstance(controller, (list, tuple)) and not isinstance(controller, CycleController):
        if len(controller) != mesh.size:
            raise ValueError(f"{len(controller)} controllers for a mesh of {mesh.size} slots")
        return list(controller)
    if not isinstance(controller, CycleController):  # a factory
        return [controller(dev, lo, hi) for dev, (lo, hi) in zip(mesh.devices, bounds)]
    if mesh.size == 1:
        return [controller]
    devs = set(mesh.distinct_devices())
    if len(devs) > 1 or not _tensor_devices(controller.consts) <= devs:
        raise ValueError(
            "a plain CycleController runs only on a mesh whose slots share its one device; pass a factory "
            "(device, lo, hi) -> CycleController that builds each slot's controller on its own device"
        )
    state = controller.init()
    return [
        controller._replace(
            init=lambda s=_slice_tree(state, n_streams, lo, hi): s,
            consts=_slice_tree(controller.consts, n_streams, lo, hi) if batched else controller.consts,
        )
        for lo, hi in bounds
    ]


def run_engine_sharded(
    params: EngineParams,
    controller: CycleController | ControllerFactory | Sequence[CycleController],
    init_positions: np.ndarray,
    n_cycles: int,
    mesh: Mesh,
    axis: str = "streams",
    batched_controller: bool = False,
    delayed_log: bool = False,
    start_cycle: int = 0,
    carry: list | None = None,
    return_carry: bool = False,
):
    """Run the stream-batched engine with the streams sharded over the mesh.

    Slot ``k`` of a mesh of ``K`` slots runs streams ``[k·S/K, (k+1)·S/K)``
    on its device with its own controller, carry and logs.  Every cycle
    launches each slot's step in turn, with no synchronisation between them
    and no collective: on several cards the steps run side by side.

    ``controller`` is one of:

    * a factory ``(device, lo, hi) -> CycleController`` building the
      controller of streams ``[lo, hi)`` on ``device`` (e.g. a closure over
      :func:`~wtracker_tpu_torch.sim.engine_live.make_stream_batch_fused`
      with the stream slice of its trajectories).  The port's controllers
      close over tensors on the device they were built for (camera
      constants, detector weights) and over their stream count, so this is
      the general form;
    * a list of such controllers, one per slot (built once, e.g. for a host
      loop that swaps each slot's ``consts`` every chunk);
    * a plain ``CycleController`` over all S streams, accepted on a mesh of
      one slot, or on a mesh whose slots all share the device of its tensors:
      each slot then gets the rows ``[lo, hi)`` of every ``init()`` tensor
      whose leading axis is S and, for a batched controller, of every such
      ``consts`` tensor, and shares the rest (a per-stream controller's
      consts are the same for every stream, whatever their length).  That is
      right for controllers whose functions take the stream count from their
      inputs (the csv playback family, a per-stream controller); a batched
      controller that closes over (S, ...) tensors needs a factory.

    ``start_cycle``/``carry``/``return_carry`` resume as in
    :func:`~wtracker_tpu_torch.sim.engine.run_engine`; the carry is the list
    of per-slot carries, each on its slot's device.

    Contract: S must be a multiple of the mesh size (pad with
    :func:`pad_streams` and drop the extra logs); a ``ValueError`` says so
    otherwise.  The logs come back concatenated along the stream axis in
    stream order, with leading axes ``(n_cycles, S, cycle_n)``, on the first
    slot's device.
    """
    if delayed_log and not batched_controller:
        raise ValueError(
            "delayed_log=True requires a batched controller: the delayed cycle "
            "step hands the controller stacked (S, ...) inputs, which a "
            "vmap-style per-stream controller cannot handle"
        )
    init_positions = np.asarray(init_positions)
    n_streams = int(init_positions.shape[0])
    n_dev = mesh.size
    if n_streams % n_dev != 0:
        raise ValueError(
            f"stream count {n_streams} is not a multiple of the mesh size {n_dev}; "
            "pad the stream batch (repeat a stream) and drop the extra logs"
        )
    bounds = stream_sharding(mesh, axis).bounds(n_streams)
    ctls = _slot_controllers(controller, mesh, bounds, n_streams, batched_controller or delayed_log)
    if delayed_log:
        steps = [make_delayed_cycle_step(params, c) for c in ctls]
    elif batched_controller:
        steps = [make_batched_cycle_step(params, c) for c in ctls]
    else:
        steps = [_make_per_stream_step(params, c) for c in ctls]
    if carry is None:
        carry = []
        for c, dev, (lo, hi) in zip(ctls, mesh.devices, bounds):
            with _device_scope(dev):
                carry.append(init_stream_carry(params, c, init_positions[lo:hi], dev))
    elif len(carry) != n_dev:
        raise ValueError(f"a carry of {len(carry)} slots for a mesh of {n_dev}")
    carry = list(carry)

    cycles = range(start_cycle, start_cycle + n_cycles + (1 if delayed_log else 0))
    positions = [[] for _ in range(n_dev)]
    bboxes = [[] for _ in range(n_dev)]
    with torch.inference_mode():
        for cycle in cycles:
            for k in range(n_dev):
                with _device_scope(mesh.devices[k]):
                    carry[k], log = steps[k](ctls[k].consts, carry[k], cycle)
                positions[k].append(log.positions)
                bboxes[k].append(log.worm_bboxes)
        first = 1 if delayed_log else 0  # the delayed step's first row is cycle -1's
        dev0 = mesh.devices[0]
        logs = CycleLog(
            positions=torch.cat([torch.stack(p[first:]).to(dev0) for p in positions], dim=1),
            worm_bboxes=torch.cat([torch.stack(b[first:]).to(dev0) for b in bboxes], dim=1),
        )
    return (logs, carry) if return_carry else logs


def replicate_module(module: torch.nn.Module, device: torch.device, cache: dict | None = None) -> torch.nn.Module:
    """``module`` itself if its weights are on ``device``, else a copy moved
    there (kept in ``cache``, keyed by device, when one is given)."""
    from wtracker_tpu_torch.sim.engine_live import _model_device

    if _model_device(module) == device:
        return module
    if cache is not None and device in cache:
        return cache[device]
    import copy

    copy_ = copy.deepcopy(module).to(device)
    if cache is not None:
        cache[device] = copy_
    return copy_


# ---------------------------------------------------------------------------
# the data axis: one process per device over torch.distributed
# ---------------------------------------------------------------------------


def dp_backend(mesh: Mesh) -> str:
    """NCCL when every rank has a card of its own, gloo on the CPU or when
    ranks share a card (NCCL refuses two ranks on one GPU; gloo takes CUDA
    tensors)."""
    devs = mesh.devices.tolist()
    if all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs):
        return "nccl"
    return "gloo"


def init_data_parallel(mesh: Mesh, rank: int, init_method: str, timeout_s: float = 600.0) -> torch.device:
    """Join this process to the mesh's data-parallel group as ``rank`` (one
    process per slot), through ``init_method`` (``file://`` or
    ``tcp://localhost:<port>``); returns the rank's device."""
    import torch.distributed as dist

    dev = mesh.devices[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        dp_backend(mesh), init_method=init_method, rank=rank, world_size=mesh.size,
        timeout=timedelta(seconds=timeout_s),
    )
    return dev


def dp_rank(mesh: Mesh) -> int:
    """This process's rank in the mesh's data-parallel group."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("data-parallel training needs torch.distributed: call init_data_parallel first")
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"the process group has {dist.get_world_size()} ranks, the mesh {mesh.size} slots")
    return dist.get_rank()


def dp_rows(mesh: Mesh, batch: int) -> slice:
    """This rank's contiguous rows of a global batch of ``batch``."""
    if batch % mesh.size != 0:
        raise ValueError(
            f"batch size {batch} is not a multiple of the mesh size "
            f"{mesh.size}; an uneven split would silently pad "
            "device shards — pick a divisible batch"
        )
    per = batch // mesh.size
    r = dp_rank(mesh)
    return slice(r * per, (r + 1) * per)


def all_reduce_gradients(parameters) -> None:
    """Sum every parameter's gradient over the ranks, in one collective over
    a flat buffer."""
    import torch.distributed as dist
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return
    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat)
    for g, reduced in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(reduced)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks (a new tensor, no autograd)."""
    import torch.distributed as dist

    out = t.detach().clone()
    dist.all_reduce(out)
    return out


def make_dp_train_step(model: torch.nn.Module, tx, loss_fn, mesh: Mesh, axis: str = "data"):
    """A data-parallel train step: the batch shards over the mesh, one rank
    a slot, the weights replicate.

    Each rank holds ``model`` and its optimizer ``tx`` (over
    ``model.parameters()``) on its own slot's device, in a process joined
    with :func:`init_data_parallel`.  Returns ``step(X, y) -> loss``: every
    rank passes the whole batch, takes its contiguous rows, and runs the
    forward in train mode (BatchNorm over the whole batch's statistics),
    ``loss_fn(preds, y)`` (a mean over the batch's rows, e.g. ``((p −
    y)**2).mean()``), the backward, the sum of the gradients over the ranks
    and the optimizer's update; the result is the step of one device on the
    whole batch, and the returned loss is the whole batch's.  The JAX
    package's ``step(params, opt_state, X, y)`` threads the weights and the
    optimizer state; here the module and the optimizer hold them.
    """
    from wtracker_tpu_torch.models.batchnorm import synced_batch_norm

    world = mesh.size
    dev = mesh.devices[dp_rank(mesh)]

    def step(X, y) -> torch.Tensor:
        rows = dp_rows(mesh, int(X.shape[0]))
        X_r = torch.as_tensor(np.asarray(X) if not isinstance(X, torch.Tensor) else X)[rows].to(dev)
        y_r = torch.as_tensor(np.asarray(y) if not isinstance(y, torch.Tensor) else y)[rows].to(dev)
        model.train()
        with synced_batch_norm():
            preds = model(X_r)
        local = loss_fn(preds, y_r) / world  # the whole batch's mean is the mean of equal slices' means
        tx.zero_grad(set_to_none=True)
        local.backward()
        all_reduce_gradients(model.parameters())
        tx.step()
        return all_reduce_sum(local)

    return step


def spawn_env(rank: int, devices: Sequence[str | torch.device], init_method: str) -> dict:
    """The environment of rank ``rank`` of a data-parallel command launched
    by :func:`launch_ranks` (read back by :func:`rank_from_env`)."""
    return {
        "WTRACKER_DP_RANK": str(rank),
        "WTRACKER_DP_DEVICES": ",".join(str(d) for d in devices),
        "WTRACKER_DP_INIT": init_method,
    }


def rank_from_env() -> tuple[int, list[str], str] | None:
    """``(rank, devices, init_method)`` in a rank launched by
    :func:`launch_ranks`, else ``None``."""
    if "WTRACKER_DP_RANK" not in os.environ:
        return None
    return (
        int(os.environ["WTRACKER_DP_RANK"]),
        os.environ["WTRACKER_DP_DEVICES"].split(","),
        os.environ["WTRACKER_DP_INIT"],
    )


def launch_ranks(module: str, argv: list[str], devices: Sequence[str | torch.device]) -> int:
    """Run ``python -m module argv`` once per device as the ranks of one
    data-parallel group, meeting through a ``file://`` store in a temporary
    directory (no network).  Rank 0 writes to this process's output, the
    others' output is dropped.  If a rank fails the others are stopped.
    Returns the first non-zero exit code, else 0."""
    import subprocess
    import sys
    import tempfile
    import time

    with tempfile.TemporaryDirectory(prefix="wtracker_dp_") as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        procs = []
        try:
            # the ranks import the package the launcher runs
            root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
            path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH", "")) if p)
            for r in range(len(devices)):
                env = {**os.environ, **spawn_env(r, devices, init), "PYTHONPATH": path}
                out = None if r == 0 else subprocess.DEVNULL
                procs.append(subprocess.Popen([sys.executable, "-m", module, *argv], env=env, stdout=out))
            while True:
                codes = [p.poll() for p in procs]
                failed = [c for c in codes if c not in (None, 0)]
                if failed:
                    return failed[0]
                if all(c == 0 for c in codes):
                    return 0
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
