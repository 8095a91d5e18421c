"""Post-hoc analysis of simulation logs.

Port of :mod:`wtracker_tpu.eval.data_analyzer`: column derivations
(centres, speed, deviation, bbox error), cleaning (imaging only, bounds,
cycle trimming), anomaly detection and removal, unit conversion (frame/px ↔
sec/µm), the precise error and summary statistics.  Pandas on the host, as
in the JAX package: the derived columns and their insertion order are the
contract.

``calc_precise_error(..., batched=True)`` runs the precise error on the
device (:func:`~wtracker_tpu_torch.eval.error_calculator.precise_error_tiles`):
worm crops are tiled to one shape on the host, the background is uploaded
once and its windows are gathered on the device, and every chunk is sent
before any result is fetched.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from wtracker_tpu_torch.eval.error_calculator import ErrorCalculator, precise_error_tiles
from wtracker_tpu_torch.sim.config import TimingConfig
from wtracker_tpu_torch.utils import bbox as bb
from wtracker_tpu_torch.utils.bbox import BoxFormat
from wtracker_tpu_torch.utils.device import resolve_device
from wtracker_tpu_torch.utils.frame_reader import FrameReader

WORM_BOX = ["wrm_x", "wrm_y", "wrm_w", "wrm_h"]
MICRO_BOX = ["mic_x", "mic_y", "mic_w", "mic_h"]

# Column groups scaled by the distance factor on unit conversion.
_DISTANCE_COLUMNS = (
    ["plt_x", "plt_y"],
    WORM_BOX,
    MICRO_BOX,
    ["cam_x", "cam_y", "cam_w", "cam_h"],
    ["wrm_center_x", "wrm_center_y"],
    ["mic_center_x", "mic_center_y"],
    ["worm_deviation_x", "worm_deviation_y", "worm_deviation"],
)
_VELOCITY_COLUMNS = ["wrm_speed_x", "wrm_speed_y", "wrm_speed"]


class DataAnalyzer:
    """Analyzes a single experiment log (one bboxes.csv)."""

    def __init__(self, time_config: TimingConfig, log_data: pd.DataFrame):
        self.time_config = time_config
        self.data = log_data.copy()
        self._orig_data = log_data
        self._unit = "frame"

    @property
    def unit(self) -> str:
        return self._unit

    @staticmethod
    def load(time_config: TimingConfig, csv_path: str) -> "DataAnalyzer":
        """Create an analyzer from a log CSV (analyzed or raw)."""
        return DataAnalyzer(time_config, pd.read_csv(csv_path))

    def save(self, path: str) -> None:
        """Persist the full (analyzed) data."""
        self._orig_data.to_csv(path, index=False)

    # -- column derivation (the parity contract; insertion order matters) ----

    def initialize(self, period: int = 10) -> None:
        """Derive the analysis columns; call once on raw log data.

        Args:
            period: span (in frames) over which speed is measured.
        """
        data = self._orig_data
        data["time"] = data["frame"]
        data["cycle_step"] = data["frame"] % self.time_config.cycle_frame_num

        # centers
        data["wrm_center_x"] = data["wrm_x"] + data["wrm_w"] / 2
        data["wrm_center_y"] = data["wrm_y"] + data["wrm_h"] / 2
        data["mic_center_x"] = data["mic_x"] + data["mic_w"] / 2
        data["mic_center_y"] = data["mic_y"] + data["mic_h"] / 2

        # speed over `period` frames
        dt = data["time"].diff(period).to_numpy()
        data["wrm_speed_x"] = data["wrm_center_x"].diff(period) / dt
        data["wrm_speed_y"] = data["wrm_center_y"].diff(period) / dt
        data["wrm_speed"] = np.sqrt(data["wrm_speed_x"] ** 2 + data["wrm_speed_y"] ** 2)

        # deviation of the worm from the microscope center
        data["worm_deviation_x"] = data["wrm_center_x"] - data["mic_center_x"]
        data["worm_deviation_y"] = data["wrm_center_y"] - data["mic_center_y"]
        data["worm_deviation"] = np.sqrt(data["worm_deviation_x"] ** 2 + data["worm_deviation_y"] ** 2)

        # error metrics
        data["bbox_error"] = ErrorCalculator.calculate_bbox_error(
            data[WORM_BOX].to_numpy(), data[MICRO_BOX].to_numpy()
        )
        data["precise_error"] = np.nan

        self._orig_data = data.round(5)
        self.data = self._orig_data.copy()

    # -- filtering ---------------------------------------------------------

    def remove_cycle(self, cycles: int | list[int]) -> None:
        """Drop the given cycle(s) from the working data."""
        drop = {cycles} if isinstance(cycles, int) else set(cycles)
        self.data = self.data[~self.data["cycle"].isin(drop)]

    @staticmethod
    def _within_bounds(data: pd.DataFrame, prefix: str, bounds: tuple) -> np.ndarray:
        x0, y0, x1, y1 = bounds
        x, y = data[f"{prefix}_x"], data[f"{prefix}_y"]
        w, h = data[f"{prefix}_w"], data[f"{prefix}_h"]
        return ((x >= x0) & (x + w <= x1) & (y >= y0) & (y + h <= y1)).to_numpy()

    def clean(
        self,
        trim_cycles: bool = False,
        imaging_only: bool = False,
        bounds: tuple[float, float, float, float] | None = None,
    ) -> None:
        """Filter rows: imaging phase only, inside arena bounds, trim the
        first/last cycles.

        Bounds filtering judges frames *with* a worm detection by the worm
        bbox and frames *without* one by the microscope bbox (the platform is
        the only position known there).
        """
        data = self.data

        if imaging_only:
            data = data[data["phase"] == "imaging"]

        if bounds is not None:
            detected = np.isfinite(data[WORM_BOX].to_numpy()).all(axis=1)
            keep = np.where(
                detected,
                detected & self._within_bounds(data, "wrm", bounds),
                self._within_bounds(data, "mic", bounds),
            )
            data = data[keep]

        if trim_cycles:
            data = data[(data["cycle"] != 0) & (data["cycle"] != data["cycle"].max())]

        self.data = data

    def reset_changes(self) -> None:
        """Restore the working data (unit resets to frames/px)."""
        self.data = self._orig_data.copy()
        self._unit = "frame"

    def column_names(self) -> list[str]:
        return self.data.columns.to_list()

    # -- unit conversion ---------------------------------------------------

    def change_unit(self, unit: str) -> None:
        """Convert between ("frame", px) and ("sec", µm) units."""
        assert unit in ["frame", "sec"]
        if self._unit == unit:
            return

        if unit == "sec":
            dist_factor = self.time_config.mm_per_px * 1000
            time_factor = self.time_config.ms_per_frame / 1000
        else:
            dist_factor = self.time_config.px_per_mm / 1000
            time_factor = self.time_config.frames_per_sec

        data = self.data
        data["time"] *= time_factor
        for group in _DISTANCE_COLUMNS:
            data[group] *= dist_factor
        data[_VELOCITY_COLUMNS] *= dist_factor / time_factor

        self._unit = unit
        self.data = data

    # -- precise error -----------------------------------------------------

    def calc_precise_error(
        self,
        worm_reader: FrameReader,
        background: np.ndarray,
        diff_thresh: float = 20,
        batched: bool = False,
        device: str | torch.device = "cuda",
    ) -> None:
        """Compute the segmentation-based error for every frame of the log.

        Args:
            worm_reader: yields, per frame number, the worm view cropped to the
                discretized worm bbox of that frame.
            background: full-arena background image.
            diff_thresh: foreground threshold.
            batched: run the batched device path instead of the per-frame
                host loop.
            device: where the batched path runs.
        """
        frames = self._orig_data["frame"].to_numpy().astype(np.int32, copy=False)
        wrm_bboxes = self._orig_data[WORM_BOX].to_numpy()
        mic_bboxes = self._orig_data[MICRO_BOX].to_numpy()

        if batched:
            errors = self._precise_batched(background, wrm_bboxes, mic_bboxes, frames, worm_reader, diff_thresh,
                                           resolve_device(device))
        else:
            errors = ErrorCalculator.calculate_precise(
                background=background,
                worm_bboxes=wrm_bboxes,
                mic_bboxes=mic_bboxes,
                frame_nums=frames,
                worm_reader=worm_reader,
                diff_thresh=diff_thresh,
            )

        self._orig_data["precise_error"] = errors
        idx = self.data["frame"].to_numpy(dtype=int, copy=False)
        self.data["precise_error"] = errors[idx]

    def calc_precise_error_experimental(
        self,
        worm_reader: FrameReader,
        background: np.ndarray,
        diff_thresh: float = 20,
        num_workers: int | None = None,
        chunk_size: int = 2000,
        device: str | torch.device = "cuda",
    ) -> None:
        """The JAX package's alias of the reference's threaded variant: the
        batched device path (``num_workers``/``chunk_size`` accepted for its
        signature)."""
        self.calc_precise_error(worm_reader, background, diff_thresh, batched=True, device=device)

    @staticmethod
    def _gather_worm_tiles(worm_reader, frame_ids, boxes_d, tile_hw) -> np.ndarray:
        """Stack ragged per-frame worm crops into zero-padded (N, H, W) tiles.

        Readers exposing a uniform in-memory array (``ArrayReader`` over
        pre-padded crops) are copied in one vectorized slab; anything else
        falls back to one reader access per frame (the crops are ragged, so a
        generic batch decode can't apply).
        """
        H, W = tile_hw
        n = len(frame_ids)
        tiles = np.zeros((n, H, W), dtype=np.uint8)

        source = getattr(worm_reader, "array", None)
        if source is not None and source.ndim == 3 and source.shape[1] <= H and source.shape[2] <= W:
            hs, ws = source.shape[1:3]
            tiles[:, :hs, :ws] = source[frame_ids]
            # no zeroing beyond each frame's (h, w): the device math masks
            # every pixel outside the crop's own extent (_precise_tile_math)
            return tiles

        for slot, (fid, (x, y, w, h)) in enumerate(zip(frame_ids, boxes_d)):
            crop = worm_reader[int(fid)]
            tiles[slot, :h, :w] = crop[:h, :w]
        return tiles

    @staticmethod
    def _precise_batched(background, wrm_bboxes, mic_bboxes, frames, worm_reader, diff_thresh, device):
        """Batched precise error on ``device``: the host gathers only the worm
        crops; the background windows are gathered on the device."""
        bounds = background.shape[:2]
        wrm_d, is_legal = bb.discretize(wrm_bboxes, bounds=bounds, box_format=BoxFormat.XYWH)
        mic_d, _ = bb.discretize(mic_bboxes, bounds=bounds, box_format=BoxFormat.XYWH)

        errors = np.full(len(frames), np.nan)
        keep = np.flatnonzero(is_legal)
        if keep.size == 0:
            return errors

        wrm_d, mic_d = wrm_d[keep], mic_d[keep]
        # tile: the largest crop rounded up to multiples of 8
        H = -8 * (-int(wrm_d[:, 3].max()) // 8)
        W = -8 * (-int(wrm_d[:, 2].max()) // 8)

        # micro∩worm rectangle, expressed in worm-view coordinates
        wrm_xyxy = bb.to_xyxy(wrm_d, BoxFormat.XYWH)
        mic_xyxy = bb.to_xyxy(mic_d, BoxFormat.XYWH)
        int_tl = np.maximum(wrm_xyxy[:, :2], mic_xyxy[:, :2])
        int_br = np.minimum(wrm_xyxy[:, 2:], mic_xyxy[:, 2:])
        int_rect = np.concatenate([int_tl - wrm_xyxy[:, :2], np.maximum(int_br - int_tl, 0)], axis=1)

        # send every chunk before fetching any: a fetch per chunk would wait
        # on the device each time, serialising host assembly and device work
        chunk = 2048
        bg_dev = torch.from_numpy(np.ascontiguousarray(background)).to(device)  # the arena once, not per chunk
        pending = []
        for s in range(0, keep.size, chunk):
            sel = slice(s, min(s + chunk, keep.size))
            tiles = DataAnalyzer._gather_worm_tiles(worm_reader, frames[keep[sel]], wrm_d[sel], (H, W))
            pending.append((sel, precise_error_tiles(bg_dev, tiles, wrm_d[sel], int_rect[sel], diff_thresh, device)))
        for sel, dev_errs in pending:
            errors[keep[sel]] = dev_errs.cpu().numpy()
        return errors

    # -- anomalies & stats -------------------------------------------------

    def calc_anomalies(
        self,
        no_preds: bool = True,
        min_bbox_error: float = np.inf,
        min_dist_error: float = np.inf,
        min_speed: float = np.inf,
        min_size: float = np.inf,
        remove_anomalies: bool = False,
    ) -> pd.DataFrame:
        """Flag (and optionally drop) outlier frames by several criteria.

        Returns the flagged rows with one boolean column per criterion.
        """
        data = self.data
        detected = np.isfinite(data[WORM_BOX].to_numpy()).all(axis=1)

        criteria = {
            "speed_anomaly": (data["wrm_speed"] >= min_speed).to_numpy(),
            "bbox_error_anomaly": (data["bbox_error"] >= min_bbox_error).to_numpy(),
            "dist_error_anomaly": (data["worm_deviation"] >= min_dist_error).to_numpy(),
            "width_anomaly": (data["wrm_w"] >= min_size).to_numpy(),
            "height_anomaly": (data["wrm_h"] >= min_size).to_numpy(),
            "no_pred_anomaly": no_preds & ~detected,
        }
        flagged = np.logical_or.reduce(list(criteria.values()))

        anomalies = data[flagged].copy()
        for name, criterion in criteria.items():
            anomalies[name] = criterion[flagged]

        if remove_anomalies:
            self.data = data[~flagged]
        return anomalies

    def describe(
        self,
        columns: list[str] | None = None,
        num: int = 3,
        percentiles: list[float] | None = None,
    ) -> pd.DataFrame:
        """Descriptive statistics of selected columns."""
        if columns is None:
            columns = self.column_names()
        if percentiles is None:
            percentiles = np.linspace(start=0, stop=1.0, num=num + 2)[1:-1]
        return self.data[columns].describe(percentiles)

    def print_stats(self) -> None:
        """Print removal/no-pred/cycle/imperfect-prediction statistics."""
        total = len(self.data.index)
        original = len(self._orig_data.index)

        def as_pct(part: float, whole: float) -> float:
            return round(100 * part / whole, 3)

        removed = original - total
        print(f"Count of Removed Frames: {removed} ({as_pct(removed, original)}%)")

        missing = int(self.data[WORM_BOX].isna().any(axis=1).sum())
        print(f"Count of No-Pred Frames: {missing} ({as_pct(missing, total)}%)")

        print(f"Total Num of Cycles: {self.data['cycle'].nunique()}")

        imperfect = (self.data["bbox_error"] > 1e-7).sum()
        print(f"Non Perfect Predictions: {as_pct(imperfect, total)}%")
