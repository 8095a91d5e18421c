"""Closed-loop cycle engine: the simulation as a loop over cycles.

Port of the core of :mod:`wtracker_tpu.sim.engine`.  A controller is a set of
functions ``(consts, state, ctx) -> (state, (dx, dy))``; one call of the
cycle step simulates one full cycle: the movement decision, the sine motor's
residual-carrying integer steps with the per-step clamp, and the per-frame
log rows.  The JAX package runs the cycles as one ``lax.scan``; here
:func:`run_engine` is a Python loop over the same carry, and the carry stays
on the controller's device (no host round trip per cycle).

Reference semantics kept exactly:

* positions logged at a moving frame are *pre-step*;
* the platform clamps to frame bounds after every motor step;
* the sine motor rounds in float64, half to even (``torch.round``, like
  ``jnp.round``), carrying the residual into the next step;
* the final (possibly partial) cycle is never logged.

:func:`run_engine_streams` runs S independent streams: a controller that owns
the stream axis (``batched_controller``, ``delayed_log``) sees stacked
``(S, ...)`` inputs; any other controller steps each stream over its slice of
the stacked state in turn, which gives what the JAX package's ``vmap`` gives.

The playback controllers (csv, optimal, polyfit, mlp and the stream-batched
csv) replay a logged worm trajectory; their float64 control math follows the
JAX module expression for expression, so their logs equal the JAX engine's
byte for byte.  A value the JAX package selects with ``jnp.where`` is
selected with ``torch.where`` here, never by a branch on a device value (one
host sync a cycle); only the cycle index, a host integer, picks branches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from wtracker_tpu_torch.ops.polyfit import polyfit, polyval
from wtracker_tpu_torch.sim.config import TimingConfig
from wtracker_tpu_torch.sim.motor import integer_motor_steps, sine_step_weights, step_weights
from wtracker_tpu_torch.utils.device import resolve_device
from wtracker_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class EngineParams:
    """Static description of the closed loop."""

    imaging_n: int
    pred_n: int
    moving_n: int
    cam_w: int
    cam_h: int
    mic_w: int
    mic_h: int
    frame_w: int
    frame_h: int
    motor_weights: tuple[float, ...]

    @property
    def cycle_n(self) -> int:
        return self.imaging_n + self.moving_n

    @staticmethod
    def from_timing(
        timing: TimingConfig,
        frame_shape_hw: tuple[int, int],
        motor: str = "sine",
        move_after_ratio: float = 0.5,
    ) -> "EngineParams":
        """Engine params from a TimingConfig and the (h, w) frame bounds the
        platform position is clamped to.

        ``motor`` selects the movement profile: "sine" (the simulator's
        default) or "step" (the whole move after ``move_after_ratio`` of the
        phase); both run through the same residual rounding.
        """
        if motor == "sine":
            weights = sine_step_weights(timing.moving_frame_num)
        elif motor == "step":
            weights = step_weights(timing.moving_frame_num, move_after_ratio)
        else:
            raise ValueError(f"unknown motor profile: {motor}")
        return EngineParams(
            imaging_n=timing.imaging_frame_num,
            pred_n=timing.pred_frame_num,
            moving_n=timing.moving_frame_num,
            cam_w=timing.camera_size_px[0],
            cam_h=timing.camera_size_px[1],
            mic_w=timing.micro_size_px[0],
            mic_h=timing.micro_size_px[1],
            frame_h=int(frame_shape_hw[0]),
            frame_w=int(frame_shape_hw[1]),
            motor_weights=tuple(weights.tolist()),
        )

    def n_logged_cycles(self, num_frames: int) -> int:
        """Complete cycles that end up in the log (the trailing partial cycle
        is dropped, like the reference's logging schedule)."""
        return (num_frames - 1) // self.cycle_n


def headless_frame_shape(timing: TimingConfig, orig_resolution_hw: tuple[int, int]) -> tuple[int, int]:
    """Frame bounds of the simulator's headless (no-video) mode.

    The host simulator builds its dummy reader at the padded resolution
    ``orig + camera//2·2`` — the reference zips the (w, h) camera padding
    onto the (h, w) resolution (simulator.py:41-43), benign for square
    cameras; reproduced verbatim for parity.
    """
    h, w = orig_resolution_hw
    return (h + timing.camera_size_px[0] // 2 * 2, w + timing.camera_size_px[1] // 2 * 2)


class DecideCtx(NamedTuple):
    """Everything a controller may consult at decision time (one stream's,
    or stacked ``(S, ...)`` for a controller that owns the stream axis)."""

    cycle: int  # current cycle index (host integer: the loop runs on the host)
    position: torch.Tensor  # (2,) int32 — platform center during imaging
    prev_positions: torch.Tensor  # (cycle_n, 2) int32 — last cycle's per-frame positions


class CycleController(NamedTuple):
    """A controller expressed as functions over a carried state.

    ``init``        — () -> state (tensors on the controller's device).
    ``decide``      — (consts, state, DecideCtx) -> (state, (2,) int32 move).
    ``predict_all`` — (consts, state, cycle, positions (cycle_n, 2)) ->
                      (cycle_n, 4) float64 worm bboxes in absolute frame
                      coordinates (NaN = none).
    ``consts``      — loop-invariant data (e.g. the resident frame chunk).
    """

    init: Callable[[], Any]
    decide: Callable[[Any, Any, DecideCtx], tuple[Any, torch.Tensor]]
    predict_all: Callable[[Any, Any, int, torch.Tensor], torch.Tensor]
    consts: Any = ()


class CycleLog(NamedTuple):
    """Stacked per-frame outputs (leading axes ``(n_cycles, cycle_n)``)."""

    positions: torch.Tensor  # (..., cycle_n, 2) int32
    worm_bboxes: torch.Tensor  # (..., cycle_n, 4) float64, absolute, NaN = no prediction


def _clamp(pos: torch.Tensor, params: EngineParams) -> torch.Tensor:
    return torch.stack(
        [pos[..., 0].clamp(0, params.frame_w - 1), pos[..., 1].clamp(0, params.frame_h - 1)],
        dim=-1,
    )


def _move(params: EngineParams, pos: torch.Tensor, dxdy: torch.Tensor, clamp) -> tuple[torch.Tensor, torch.Tensor]:
    """The motor over one cycle, for (2,) or stacked (S, 2) positions:
    residual-carrying integer rounding in float64 over the (small) moving
    phase, with ``clamp`` after every step.  Returns the final position and
    the cycle's per-frame positions (..., cycle_n, 2)."""
    with span("wt.motor"):
        moving_positions = []
        p = pos
        for s in integer_motor_steps(params.motor_weights, dxdy).unbind(0):
            moving_positions.append(p)  # logged before this step's move
            p = clamp(p + s.to(pos.dtype))
        imaging = pos.unsqueeze(-2).expand(*pos.shape[:-1], params.imaging_n, 2)
        return p, torch.cat([imaging, torch.stack(moving_positions, dim=-2)], dim=-2)


def make_cycle_step(params: EngineParams, controller: CycleController):
    """Build the step simulating one full cycle:
    ``cycle_step(consts, (pos, prev_positions, state), cycle) -> (carry, CycleLog)``.
    """

    def cycle_step(consts, carry, cycle_idx: int):
        pos, prev_positions, state = carry

        ctx = DecideCtx(cycle=cycle_idx, position=pos, prev_positions=prev_positions)
        state, dxdy = controller.decide(consts, state, ctx)
        p, positions = _move(params, pos, dxdy, lambda q: _clamp(q, params))
        worm_bboxes = controller.predict_all(consts, state, cycle_idx, positions)
        return (p, positions, state), CycleLog(positions=positions, worm_bboxes=worm_bboxes)

    return cycle_step


def init_carry(
    params: EngineParams,
    controller: CycleController,
    init_position,
    device: str | torch.device = "cuda",
) -> tuple:
    """Fresh engine carry (platform position, last-cycle positions, state)."""
    dev = resolve_device(device)
    pos0 = _clamp(torch.as_tensor(init_position, dtype=torch.int32).to(dev), params)
    prev0 = pos0.expand(params.cycle_n, 2).clone()
    return (pos0, prev0, controller.init())


def run_engine(
    params: EngineParams,
    controller: CycleController,
    init_position,
    n_cycles: int,
    *,
    start_cycle: int = 0,
    carry: tuple | None = None,
    return_carry: bool = False,
    device: str | torch.device = "cuda",
):
    """Run the closed loop for ``n_cycles`` complete cycles.

    Resume: pass ``return_carry=True`` to get the final carry back, and
    later ``carry=`` + ``start_cycle=`` to continue from it.  The carry is
    never updated in place, so a kept carry stays valid.

    Returns stacked logs with leading axes ``(n_cycles, cycle_n)``, on the
    controller's device (and the final carry when requested).
    """
    with span("wt.run"):
        if carry is None:
            carry = init_carry(params, controller, init_position, device)
        step = make_cycle_step(params, controller)
        carry, logs = _scan(step, controller.consts, carry, range(start_cycle, start_cycle + n_cycles))
    return (logs, carry) if return_carry else logs


def _scan(step, consts, carry, cycles) -> tuple[tuple, CycleLog]:
    """``step`` over ``cycles`` from ``carry``: the final carry and the logs
    stacked along a new leading axis.  Each step call is one ``wt.cycle``
    span."""
    positions, bboxes = [], []
    with torch.inference_mode():
        for cycle in cycles:
            with span("wt.cycle"):
                carry, log = step(consts, carry, cycle)
            positions.append(log.positions)
            bboxes.append(log.worm_bboxes)
    return carry, CycleLog(positions=torch.stack(positions), worm_bboxes=torch.stack(bboxes))


# ---------------------------------------------------------------------------
# multi-stream runner
# ---------------------------------------------------------------------------


def _rebuild(like, items: list):
    """A tuple, named tuple or list of ``like``'s type holding ``items``."""
    return type(like)(*items) if hasattr(like, "_fields") else type(like)(items)


def _tree_map(fn, tree):
    """``fn`` over the tensors of a state made of dicts, tuples and lists."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return _rebuild(tree, [_tree_map(fn, v) for v in tree])
    return fn(tree)


def _tree_stack(trees: list):
    """Stack per-stream states (same structure) along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        return _rebuild(first, [_tree_stack(list(parts)) for parts in zip(*trees)])
    return torch.stack(trees)


def _has_stream_bounds(controller: CycleController) -> bool:
    """Heterogeneous-geometry sweeps put per-stream (w, h) clamp bounds into
    ``consts["stream_bounds"]`` — each stream then clamps to its own arena."""
    return isinstance(controller.consts, dict) and "stream_bounds" in controller.consts


def _make_stream_motor(params: EngineParams):
    """Per-stream motor: residual-carrying integer rounding with a per-stream
    (w, h) clamp bound, over stacked (S, 2) positions, moves and bounds.
    Returns ``motor(pos, dxdy, bound) -> (final (S, 2), positions (S, cycle_n, 2))``."""

    def motor(pos, dxdy, bound):
        return _move(params, pos, dxdy, lambda q: torch.minimum(q.clamp_min(0), bound - 1))

    return motor


def _stream_bounds_of(params: EngineParams, controller: CycleController, consts, pos: torch.Tensor) -> torch.Tensor:
    if _has_stream_bounds(controller):
        return consts["stream_bounds"]
    common = torch.tensor([params.frame_w, params.frame_h], dtype=pos.dtype, device=pos.device)
    return common.expand(pos.shape)


def make_batched_cycle_step(params: EngineParams, controller: CycleController):
    """Cycle step where the *controller* owns the stream axis.

    ``decide``/``predict_all`` receive stacked (S, ...) inputs and return
    stacked outputs, so they can form flat S·frames device batches; the
    motor and clamp run over the stacked positions.
    """
    motor = _make_stream_motor(params)

    def cycle_step(consts, carry, cycle_idx: int):
        pos, prev_positions, state = carry
        ctx = DecideCtx(cycle=cycle_idx, position=pos, prev_positions=prev_positions)
        state, dxdy = controller.decide(consts, state, ctx)
        p, positions = motor(pos, dxdy, _stream_bounds_of(params, controller, consts, pos))
        worm_bboxes = controller.predict_all(consts, state, cycle_idx, positions)
        return (p, positions, state), CycleLog(positions=positions, worm_bboxes=worm_bboxes)

    return cycle_step


def make_delayed_cycle_step(params: EngineParams, controller: CycleController):
    """Batched cycle step with a one-cycle log delay.

    For controllers that fold the *previous* cycle's trailing work (e.g.
    moving-phase detection) into the current decision batch — one detector
    batch per cycle instead of two.  ``predict_all(consts, state, cycle,
    prev_positions)`` must return the rows of cycle ``cycle − 1``; the step
    emits them with the previous cycle's positions.  The runner runs one
    extra cycle and drops the first (cycle −1) output row.
    """
    motor = _make_stream_motor(params)

    def cycle_step(consts, carry, cycle_idx: int):
        pos, prev_positions, state = carry
        ctx = DecideCtx(cycle=cycle_idx, position=pos, prev_positions=prev_positions)
        state, dxdy = controller.decide(consts, state, ctx)
        prev_rows = controller.predict_all(consts, state, cycle_idx, prev_positions)
        p, positions = motor(pos, dxdy, _stream_bounds_of(params, controller, consts, pos))
        return (p, positions, state), CycleLog(positions=prev_positions, worm_bboxes=prev_rows)

    return cycle_step


def _restack(stacked, slices: list, outs: list):
    """Stack per-stream outputs; a leaf that every stream returned as the
    very slice it was given (a trajectory table) stays the stacked tensor,
    uncopied."""
    if isinstance(stacked, dict):
        return {k: _restack(stacked[k], [s[k] for s in slices], [o[k] for o in outs]) for k in stacked}
    if isinstance(stacked, (tuple, list)):
        return _rebuild(stacked, [_restack(*t) for t in zip(stacked, zip(*slices), zip(*outs))])
    if all(o is s for o, s in zip(outs, slices)):
        return stacked
    return torch.stack(outs)


def _make_per_stream_step(params: EngineParams, controller: CycleController):
    """Cycle step of a single-stream controller over stacked streams: each
    stream steps over its slice of the carry in turn (the JAX package
    ``vmap``s the single-stream step)."""
    step = make_cycle_step(params, controller)

    def cycle_step(consts, carry, cycle_idx: int):
        slices = [_tree_map(lambda x: x[s], carry) for s in range(carry[0].shape[0])]
        outs = [step(consts, c, cycle_idx) for c in slices]
        return _restack(carry, slices, [c for c, _ in outs]), _tree_stack([log for _, log in outs])

    return cycle_step


def run_engine_streams(
    params: EngineParams,
    controller: CycleController,
    init_positions,
    n_cycles: int,
    batched_controller: bool = False,
    delayed_log: bool = False,
    device: str | torch.device = "cuda",
) -> CycleLog:
    """Run S independent worm streams.

    ``controller.init()`` must return per-stream state (leading axis S);
    stream-specific data (trajectories, detection rings) lives in that state.
    With ``batched_controller=True`` the controller's decide/predict_all
    receive the full (S, ...) batch themselves; with ``delayed_log=True`` the
    controller logs with a one-cycle delay (see :func:`make_delayed_cycle_step`).
    Returns logs with leading axes ``(n_cycles, S, cycle_n)``, on the
    controller's device.
    """
    if delayed_log:
        step = make_delayed_cycle_step(params, controller)
    elif batched_controller:
        step = make_batched_cycle_step(params, controller)
    else:
        step = _make_per_stream_step(params, controller)
    with span("wt.run"):
        carry = init_stream_carry(params, controller, init_positions, device)
        _, logs = _scan(step, controller.consts, carry, range(n_cycles + 1) if delayed_log else range(n_cycles))
    if delayed_log:  # the first row is cycle −1's
        logs = CycleLog(positions=logs.positions[1:], worm_bboxes=logs.worm_bboxes[1:])
    return logs


def init_stream_carry(
    params: EngineParams,
    controller: CycleController,
    init_positions,
    device: str | torch.device = "cuda",
) -> tuple:
    """Fresh carry of S streams: (S, 2) clamped start positions, their
    (S, cycle_n, 2) last-cycle positions and the controller's state."""
    dev = resolve_device(device)
    init = torch.as_tensor(np.asarray(init_positions), dtype=torch.int32).to(dev)
    if _has_stream_bounds(controller):
        pos0 = torch.minimum(init.clamp_min(0), controller.consts["stream_bounds"].to(torch.int32) - 1)
    else:
        pos0 = _clamp(init, params)
    prev0 = pos0[:, None, :].expand(pos0.shape[0], params.cycle_n, 2).clone()
    return (pos0, prev0, controller.init())


# ---------------------------------------------------------------------------
# log assembly (host side)
# ---------------------------------------------------------------------------


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def logs_to_frame(
    params: EngineParams,
    logs: CycleLog,
    cam_size: tuple[int, int] | None = None,
    mic_size: tuple[int, int] | None = None,
) -> "pd.DataFrame":
    """Flatten engine logs into the 17-column bboxes.csv schema.

    Applies the reference's missing-detection quirk: non-finite worm bboxes
    are written as 0.0.  ``cam_size``/``mic_size`` override the params' view
    sizes.
    """
    import pandas as pd

    cam_w, cam_h = cam_size if cam_size is not None else (params.cam_w, params.cam_h)
    mic_w, mic_h = mic_size if mic_size is not None else (params.mic_w, params.mic_h)

    positions = _host(logs.positions)
    n_cycles, L, _ = positions.shape
    pos = positions.reshape(n_cycles * L, 2)
    wrm = _host(logs.worm_bboxes).astype(float).reshape(n_cycles * L, 4)
    wrm = np.where(np.isfinite(wrm).all(axis=1, keepdims=True), wrm, 0.0)

    frame = np.arange(n_cycles * L)
    cycle = frame // L
    step = frame % L

    return pd.DataFrame(
        {
            "frame": frame,
            "cycle": cycle,
            "phase": np.where(step < params.imaging_n, "imaging", "moving"),
            "plt_x": pos[:, 0],
            "plt_y": pos[:, 1],
            "cam_x": pos[:, 0] - cam_w // 2,
            "cam_y": pos[:, 1] - cam_h // 2,
            "cam_w": cam_w,
            "cam_h": cam_h,
            "mic_x": pos[:, 0] - mic_w // 2,
            "mic_y": pos[:, 1] - mic_h // 2,
            "mic_w": mic_w,
            "mic_h": mic_h,
            "wrm_x": wrm[:, 0],
            "wrm_y": wrm[:, 1],
            "wrm_w": wrm[:, 2],
            "wrm_h": wrm[:, 3],
        }
    )


# ---------------------------------------------------------------------------
# controller factories (ground-truth playback family)
# ---------------------------------------------------------------------------


def _gather_rows(table: torch.Tensor, idx: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """NaN-padded gather along ``dim`` (0, or 1 for an (S, N, 4) stack):
    out-of-range indices of the 1-D ``idx`` yield NaN rows."""
    n = table.shape[dim]
    valid = (idx >= 0) & (idx < n)
    rows = table.index_select(dim, idx.clamp(0, n - 1))
    return torch.where(valid[:, None], rows, torch.nan)


class _FrameOffsets:
    """Frame offsets of a gather (the cycle's frames, polyfit sample times,
    MLP input frames), kept on the host and on the device.

    The cycle index is a host integer, so :meth:`rows` knows on the host
    which of ``base + offsets`` fall inside the table: a run of consecutive
    frames inside it is a view (no launch), other frames inside it one
    ``index_select``, and only near the table's ends the masked
    :func:`_gather_rows`.  All three give the same rows.
    """

    def __init__(self, offsets, device: torch.device):
        self.host = np.asarray(offsets, dtype=np.int64).reshape(-1)
        self.device = torch.as_tensor(self.host, device=device)
        self.run = bool(np.array_equal(self.host, self.host[0] + np.arange(len(self.host))))

    def rows(self, table: torch.Tensor, base: int, dim: int = 0) -> torch.Tensor:
        """``table``'s rows at frames ``base + offsets`` along ``dim``, NaN
        where a frame is out of range."""
        idx = base + self.host
        if idx.min() >= 0 and idx.max() < table.shape[dim]:
            if self.run:
                return table.narrow(dim, int(idx[0]), len(idx))
            return table.index_select(dim, self.device + base)
        return _gather_rows(table, self.device + base, dim)


def _cam_consts(params: EngineParams, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(2,) int32 half camera size ``(w // 2, h // 2)`` and (2,) float64
    camera middle ``(w / 2, h / 2)``."""
    half = torch.tensor([params.cam_w // 2, params.cam_h // 2], dtype=torch.int32, device=device)
    mid = torch.tensor([params.cam_w / 2, params.cam_h / 2], dtype=torch.float64, device=device)
    return half, mid


def _csv_predict_all(params: EngineParams, cam_half, device: torch.device, dim: int = 0):
    """predict_all for the playback family: the cycle's ground-truth rows
    (``dim=1``: of every stream of an (S, N, 4) table).  ``cam_half`` is the
    half camera size, or a function of ``consts`` giving it (per-stream
    sizes read from ``consts``, so a stream slice of them stays consistent).

    The host path shifts rows into camera coordinates and back before
    logging; the subtract/add round trip costs an ulp on some values, and is
    kept for bit-identical logs (eager torch does not fold it away, so it
    needs no counterpart of the JAX package's optimization barrier).
    """
    frames = _FrameOffsets(np.arange(params.cycle_n), device)

    def predict_all(consts, state, cycle_idx, positions):
        rows = frames.rows(consts["csv"], cycle_idx * params.cycle_n, dim)
        half = cam_half(consts) if callable(cam_half) else cam_half
        cam_tl = (positions - half).to(torch.float64)
        rel = rows[..., :2] - cam_tl  # keep the ulp
        return torch.cat([rel + cam_tl, rows[..., 2:]], dim=-1)

    return predict_all


def _decision_cam_topleft(params: EngineParams, ctx: DecideCtx, cam_half: torch.Tensor) -> torch.Tensor:
    """Camera top-left used by CsvController.predict(relative=True) at
    decision time — reproduces the deque ring indexing (csv_controller.py:42).

    The entry at index ``(f - pred_n) % L`` of a full deque maps to the
    frame at cycle step ``2·imaging_n − pred_n + 1 − L`` of the current
    cycle; when that offset is negative the bbox comes from the previous
    cycle's moving phase (except in cycle 0, whose deque is not yet full and
    resolves to the stationary imaging phase).
    """
    g_offset = 2 * params.imaging_n - params.pred_n + 1 - params.cycle_n
    if g_offset >= 0 or ctx.cycle == 0:
        pos = ctx.position  # current imaging phase — stationary
    else:
        pos = ctx.prev_positions[..., params.cycle_n + g_offset, :]
    return pos - cam_half


def _table(data, device: torch.device) -> torch.Tensor:
    """A float64 copy of ``data`` on ``device``."""
    return torch.tensor(np.asarray(data, dtype=np.float64), device=device)


def csv_controller(csv_data: np.ndarray, params: EngineParams, device: str | torch.device = "cuda") -> CycleController:
    """Ground-truth playback controller (engine twin of CsvController):
    centre the worm box logged ``pred_n`` frames before the imaging phase
    ends.  ``csv_data`` is the (N, 4) xywh worm table (NaN = no box)."""
    dev = resolve_device(device)
    consts = {"csv": _table(csv_data, dev)}
    cam_half, cam_mid = _cam_consts(params, dev)
    query = _FrameOffsets([0], dev)

    def decide(consts, state, ctx: DecideCtx):
        f = ctx.cycle * params.cycle_n + params.imaging_n
        bbox = query.rows(consts["csv"], f - params.pred_n)[0]
        cam_tl = _decision_cam_topleft(params, ctx, cam_half)

        # match host arithmetic order: shift into camera coords, then center
        rel_xy = bbox[:2] - cam_tl
        center = rel_xy + bbox[2:] / 2
        target = center - cam_mid

        valid = torch.isfinite(bbox).all()
        return state, torch.where(valid, torch.round(target), 0.0).to(torch.int32)

    return CycleController(
        init=lambda: (), decide=decide, predict_all=_csv_predict_all(params, cam_half, dev), consts=consts
    )


def _nanmedian0(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian(x, axis=0)`` as JAX computes it: NaNs sorted last,
    the position ``0.5·(count − 1)`` among the ``count`` finite values, and
    the mean of the values at its floor and ceiling (JAX's midpoint method;
    all NaN gives NaN).  ``torch.nanmedian`` takes the lower of the two
    middle values instead, which differs for an even count."""
    s = torch.sort(x, dim=0).values  # NaN sorts last
    counts = (~torch.isnan(s)).sum(dim=0, dtype=x.dtype)
    q = 0.5 * (counts - 1)
    low = torch.minimum(q.floor(), counts - 1).clamp_min(0).long()
    high = torch.minimum(q.ceil(), counts - 1).clamp_min(0).long()
    return (s.gather(0, low[None])[0] + s.gather(0, high[None])[0]) * 0.5


def optimal_controller(
    csv_data: np.ndarray, params: EngineParams, device: str | torch.device = "cuda"
) -> CycleController:
    """Oracle controller (engine twin of OptimalController): centre the
    median worm position of the next imaging phase."""
    dev = resolve_device(device)
    csv = _table(csv_data, dev)
    consts = {"csv": csv, "centers": csv[:, :2] + csv[:, 2:] / 2}
    cam_half, cam_mid = _cam_consts(params, dev)
    imaging = _FrameOffsets(np.arange(params.imaging_n), dev)

    def decide(consts, state, ctx: DecideCtx):
        nxt = imaging.rows(consts["centers"], (ctx.cycle + 1) * params.cycle_n)  # (imaging_n, 2)
        med = _nanmedian0(nxt)
        target = med - ((ctx.position - cam_half).to(torch.float64) + cam_mid)
        valid = torch.isfinite(med).all()
        return state, torch.where(valid, torch.round(target), 0.0).to(torch.int32)

    return CycleController(
        init=lambda: (), decide=decide, predict_all=_csv_predict_all(params, cam_half, dev), consts=consts
    )


def polyfit_controller(
    csv_data: np.ndarray,
    params: EngineParams,
    sample_times: np.ndarray,
    fit_weights: np.ndarray,
    degree: int,
    device: str | torch.device = "cuda",
) -> CycleController:
    """Polynomial-extrapolation controller (engine twin of PolyfitController).

    Fits the worm centres at ``sample_times`` (frames from the cycle start,
    sorted here as the JAX package sorts them; ``fit_weights`` keep their
    order) and extrapolates to the middle of the next imaging phase.  Invalid
    samples are excluded with zero fit weights; the fit runs through the
    float64 Jacobi solver of :mod:`wtracker_tpu_torch.ops.polyfit`.
    """
    dev = resolve_device(device)
    times = np.sort(np.asarray(sample_times, dtype=np.float64))
    consts = {
        "csv": _table(csv_data, dev),
        "times": _table(times, dev),
        "fit_w": _table(fit_weights, dev),
        "x_eval": _table(params.cycle_n + params.imaging_n // 2, dev),  # the next imaging phase's middle
    }
    cam_half, cam_mid = _cam_consts(params, dev)
    samples = _FrameOffsets(times.astype(np.int32), dev)

    def decide(consts, state, ctx: DecideCtx):
        bboxes = samples.rows(consts["csv"], ctx.cycle * params.cycle_n)  # (k, 4) absolute
        cam_tl = (ctx.position - cam_half).to(torch.float64)
        pos = (bboxes[:, :2] - cam_tl) + bboxes[:, 2:] / 2  # centers, camera-relative

        mask = torch.isfinite(pos).all(dim=1)
        w = torch.where(mask, consts["fit_w"], 0.0)
        y = torch.where(mask[:, None], pos, 0.0)

        coeffs = polyfit(consts["times"], y, degree, w)  # (deg+1, 2)
        pred = polyval(consts["x_eval"], coeffs)

        target = pred - cam_mid
        return state, torch.where(mask.any(), torch.round(target), 0.0).to(torch.int32)

    return CycleController(
        init=lambda: (), decide=decide, predict_all=_csv_predict_all(params, cam_half, dev), consts=consts
    )


def mlp_max_dist_per_pred(timing: TimingConfig, io_config, max_speed: float = 0.9) -> float:
    """The MLP controller's clip bound in px: ``max_speed`` (mm/s) in px a
    frame, times the first prediction offset (MLPController, mlp.py:42-45,
    in the same float64 operation order)."""
    max_speed_px_frame = max_speed * (timing.px_per_mm / timing.frames_per_sec)
    return max_speed_px_frame * io_config.pred_frames[0]


def mlp_controller(
    csv_data: np.ndarray,
    params: EngineParams,
    predictor,
    max_speed_px_frame_total: float,
    device: str | torch.device = "cuda",
) -> CycleController:
    """Neural controller (engine twin of MLPController).

    Args:
        predictor: a :class:`~wtracker_tpu_torch.models.resmlp.WormPredictor`
            on ``device``.
        max_speed_px_frame_total: clip bound in px (:func:`mlp_max_dist_per_pred`).
    """
    dev = resolve_device(device)
    model = predictor.model
    if next(model.parameters()).device != dev:
        raise ValueError(f"predictor is on {next(model.parameters()).device}, expected {dev}")
    consts = {"csv": _table(csv_data, dev)}
    cam_half, cam_mid = _cam_consts(params, dev)
    inputs = _FrameOffsets(predictor.io_config.input_frames, dev)
    max_speed = float(np.float32(max_speed_px_frame_total))  # the JAX package clips at a float32 bound

    def decide(consts, state, ctx: DecideCtx):
        f = ctx.cycle * params.cycle_n + params.imaging_n
        bboxes = inputs.rows(consts["csv"], f - params.pred_n)  # (k, 4) absolute
        cam_center = (ctx.position - cam_half).to(torch.float64) + cam_mid
        valid = torch.isfinite(bboxes).all()

        rel = bboxes[0, :2] - cam_center
        origin = bboxes[0, :2]
        feats = torch.cat([bboxes[:, :2] - origin, bboxes[:, 2:]], dim=1).reshape(1, -1)
        feats = torch.where(valid, feats, 0.0)  # keep the network NaN-free

        pred = model(feats.to(torch.float32))
        # clip in float32 (the host clips the float32 model output before widening)
        pred = pred.reshape(-1).clamp(-max_speed, max_speed).to(torch.float64)

        target = pred[:2] + rel
        return state, torch.where(valid, torch.round(target), 0.0).to(torch.int32)

    return CycleController(
        init=lambda: (), decide=decide, predict_all=_csv_predict_all(params, cam_half, dev), consts=consts
    )


# ---------------------------------------------------------------------------
# stream-batched playback (multi-experiment sweeps)
# ---------------------------------------------------------------------------


def csv_controller_streams(
    csv_data: np.ndarray, params: EngineParams, device: str | torch.device = "cuda"
) -> CycleController:
    """Stream-batched ground-truth playback: ``csv_data`` is (S, N, 4).

    For ``run_engine_streams(..., batched_controller=True)``: S parallel
    CsvController experiments in one batch (the reference runs these
    serially).  Like the JAX package's, its decision reads the camera at the
    current position (no deque quirk).
    """
    dev = resolve_device(device)
    consts = {"csv": _table(csv_data, dev)}
    cam_half, cam_mid = _cam_consts(params, dev)
    query = _FrameOffsets([0], dev)

    def decide(consts, state, ctx: DecideCtx):
        f = ctx.cycle * params.cycle_n + params.imaging_n
        bbox = query.rows(consts["csv"], f - params.pred_n, dim=1)[:, 0]  # (S, 4)
        cam_tl = (ctx.position - cam_half).to(torch.float64)
        rel_xy = bbox[:, :2] - cam_tl
        center = rel_xy + bbox[:, 2:] / 2
        target = center - cam_mid
        valid = torch.isfinite(bbox).all(dim=1)
        return state, torch.where(valid[:, None], torch.round(target), 0.0).to(torch.int32)

    return CycleController(
        init=lambda: (), decide=decide, predict_all=_csv_predict_all(params, cam_half, dev, dim=1), consts=consts
    )
