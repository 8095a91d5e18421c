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

The playback controllers of the JAX module (csv, optimal, polyfit, mlp) and
its multi-stream runners are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from wtracker_tpu_torch.sim.config import TimingConfig
from wtracker_tpu_torch.sim.motor import sine_step_weights
from wtracker_tpu_torch.utils.device import resolve_device


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
    def from_timing(timing: TimingConfig, frame_shape_hw: tuple[int, int]) -> "EngineParams":
        """Engine params from a TimingConfig and the (h, w) frame bounds the
        platform position is clamped to, with the sine motor (the simulator's
        default; the step motor is not ported yet)."""
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
            motor_weights=tuple(sine_step_weights(timing.moving_frame_num).tolist()),
        )

    def n_logged_cycles(self, num_frames: int) -> int:
        """Complete cycles that end up in the log (the trailing partial cycle
        is dropped, like the reference's logging schedule)."""
        return (num_frames - 1) // self.cycle_n


class DecideCtx(NamedTuple):
    """Everything a controller may consult at decision time."""

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


def make_cycle_step(params: EngineParams, controller: CycleController):
    """Build the step simulating one full cycle:
    ``cycle_step(consts, (pos, prev_positions, state), cycle) -> (carry, CycleLog)``.
    """
    weights = tuple(float(w) for w in params.motor_weights)

    def cycle_step(consts, carry, cycle_idx: int):
        pos, prev_positions, state = carry

        ctx = DecideCtx(cycle=cycle_idx, position=pos, prev_positions=prev_positions)
        state, dxdy = controller.decide(consts, state, ctx)

        # Motor: residual-carrying integer rounding in float64 over the (small)
        # moving phase, with the per-step position clamp.
        d = dxdy.to(torch.float64)
        resid = torch.zeros_like(d)
        moving_positions = []
        p = pos
        for w in weights:
            moving_positions.append(p)  # logged before this step's move
            raw = w * d + resid
            s = torch.round(raw)
            resid = raw - s
            p = _clamp(p + s.to(pos.dtype), params)

        positions = torch.cat(
            [pos.expand(params.imaging_n, 2), torch.stack(moving_positions, dim=0)], dim=0
        )
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
    step = make_cycle_step(params, controller)
    if carry is None:
        carry = init_carry(params, controller, init_position, device)
    positions, bboxes = [], []
    with torch.inference_mode():
        for cycle in range(start_cycle, start_cycle + n_cycles):
            carry, log = step(controller.consts, carry, cycle)
            positions.append(log.positions)
            bboxes.append(log.worm_bboxes)
    logs = CycleLog(positions=torch.stack(positions), worm_bboxes=torch.stack(bboxes))
    return (logs, carry) if return_carry else logs


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
