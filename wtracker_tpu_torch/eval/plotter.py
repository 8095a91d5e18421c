"""Seaborn plotting over analyzed experiment logs.

Port of :mod:`wtracker_tpu.eval.plotter`: multi-log concatenation with a
``log_num`` column, unit-aware axis labels, the domain plots (speed
distribution, error distribution, per-cycle-step error, speed vs error,
trajectory, head size, deviation) and the generic dist/cat/joint plot
builders with a row-filter ``condition`` and a dataframe ``transform``.
matplotlib (headless ``Agg`` backend) and seaborn are imported when a plot
is made, so the module imports without them.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import pandas as pd


def _seaborn():
    """seaborn, with matplotlib on its headless backend unless one was chosen."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import seaborn

    return seaborn


class Plotter:
    """Plots one or more analyzed logs (e.g. ``DataAnalyzer.data`` frames).

    Args:
        data_list: analyzed dataframes; each gets a ``log_num`` id column.
        plot_height: seaborn facet height.
        palette: seaborn color palette.
        units: explicit (time, distance) unit names for axis labels. ``None``
            auto-detects like the reference (plotter.py:47-61): in frame units
            the ``time`` column equals ``frame`` exactly; anything else is
            seconds/µm. Prefer :meth:`from_analyzers`, which reads the unit
            the analyzer actually applied instead of inferring.
    """

    def __init__(
        self,
        data_list: list[pd.DataFrame],
        plot_height: int = 7,
        palette: str = "viridis",
        units: tuple[str, str] | None = None,
    ) -> None:
        self.plot_height = plot_height
        self.palette = palette

        data_list = [d.copy() for d in data_list]
        for i, data in enumerate(data_list):
            data["log_num"] = i
        self.data = pd.concat(data_list, ignore_index=True)
        self.units = units

    @classmethod
    def from_analyzers(cls, analyzers, plot_height: int = 7, palette: str = "viridis") -> "Plotter":
        """Build a plotter from :class:`~wtracker_tpu_torch.eval.data_analyzer.DataAnalyzer`
        objects, taking the unit from the analyzers (no inference)."""
        analyzers = list(analyzers)
        units = {a.unit for a in analyzers}
        if len(units) > 1:
            raise ValueError(f"analyzers disagree on units: {sorted(units)}; convert them first")
        time_unit = units.pop() if analyzers else "frame"
        dist_unit = {"frame": "px", "sec": "μm"}[time_unit]
        return cls(
            [a.data for a in analyzers],
            plot_height=plot_height,
            palette=palette,
            units=(time_unit, dist_unit),
        )

    def _unit_labels(self) -> tuple[str, str]:
        """(time, distance) unit names: explicit if given, else detected."""
        if self.units is not None:
            return self.units
        head = self.data.iloc[:5]
        if np.array_equal(head["frame"].round(3), head["time"].round(3)):
            return "frame", "px"
        return "sec", "μm"

    # -- domain plots ------------------------------------------------------

    def plot_speed_distribution(self, log_wise: bool = False, condition=None, **kwargs) -> sns.FacetGrid:
        """Distribution of worm speed."""
        t, d = self._unit_labels()
        g = self.create_distplot(
            x_col="wrm_speed",
            kind="hist",
            log_wise=log_wise,
            condition=condition,
            kde=True,
            stat="density",
            **kwargs,
        )
        g.set_xlabels(f"speed ({d}/{t})")
        return g

    def plot_error_distribution(self, error_kind: str = "bbox", log_wise: bool = False, condition=None, **kwargs):
        """Distribution of the tracking error ("bbox" or "precise")."""
        g = self.create_distplot(
            x_col=f"{error_kind}_error",
            kind="hist",
            log_wise=log_wise,
            condition=condition,
            kde=True,
            stat="density",
            **kwargs,
        )
        g.set_xlabels(f"{error_kind} error")
        return g

    def plot_cycle_error(self, error_kind: str = "bbox", log_wise: bool = False, condition=None, **kwargs):
        """Tracking error as a function of the step within the cycle."""
        return self.create_catplot(
            x_col="cycle_step",
            y_col=f"{error_kind}_error",
            kind="violin",
            log_wise=log_wise,
            condition=condition,
            **kwargs,
        )

    def plot_speed_vs_error(self, error_kind: str = "bbox", cycle_wise: bool = False, condition=None, **kwargs):
        """Joint distribution of worm speed and tracking error."""
        data = self.data
        if cycle_wise:
            grouped = data.groupby(["log_num", "cycle"])[["wrm_speed", f"{error_kind}_error"]].max()
            data = grouped.reset_index()
        t, d = self._unit_labels()
        g = self.create_jointplot(
            x_col="wrm_speed",
            y_col=f"{error_kind}_error",
            kind="hist",
            condition=condition,
            data=data,
            **kwargs,
        )
        g.set_axis_labels(f"speed ({d}/{t})", f"{error_kind} error")
        return g

    def plot_trajectory(self, hue_col: str = "log_num", condition=None, **kwargs):
        """Worm center trajectory over the arena."""
        g = self.create_jointplot(
            x_col="wrm_center_x",
            y_col="wrm_center_y",
            kind="scatter",
            hue_col=hue_col,
            condition=condition,
            **kwargs,
        )
        g.ax_joint.invert_yaxis()
        return g

    def plot_head_size(self, condition=None, **kwargs):
        """Joint distribution of worm-head bbox width and height."""
        return self.create_jointplot(
            x_col="wrm_w", y_col="wrm_h", kind="hist", condition=condition, **kwargs
        )

    def plot_deviation(self, log_wise: bool = False, condition=None, **kwargs):
        """Distribution of worm deviation from the microscope center."""
        t, d = self._unit_labels()
        g = self.create_distplot(
            x_col="worm_deviation",
            kind="hist",
            log_wise=log_wise,
            condition=condition,
            kde=True,
            stat="density",
            **kwargs,
        )
        g.set_xlabels(f"deviation ({d})")
        return g

    # -- generic builders --------------------------------------------------

    def _prepare(self, data, condition, transform):
        data = self.data if data is None else data
        if condition is not None:
            data = data[condition(data)]
        if transform is not None:
            data = transform(data)
        return data

    def create_distplot(
        self,
        x_col: str,
        y_col: str | None = None,
        hue_col: str | None = None,
        log_wise: bool = False,
        kind: str = "hist",
        condition: Callable[[pd.DataFrame], pd.Series] | None = None,
        transform: Callable[[pd.DataFrame], pd.DataFrame] | None = None,
        data: pd.DataFrame | None = None,
        **kwargs,
    ) -> sns.FacetGrid:
        """Generic ``sns.displot`` over the (filtered/transformed) data."""
        data = self._prepare(data, condition, transform)
        return _seaborn().displot(
            data=data,
            x=x_col,
            y=y_col,
            hue=hue_col,
            col="log_num" if log_wise else None,
            kind=kind,
            height=self.plot_height,
            palette=self.palette if hue_col else None,
            **kwargs,
        )

    def create_catplot(
        self,
        x_col: str,
        y_col: str | None = None,
        hue_col: str | None = None,
        log_wise: bool = False,
        kind: str = "strip",
        condition: Callable[[pd.DataFrame], pd.Series] | None = None,
        transform: Callable[[pd.DataFrame], pd.DataFrame] | None = None,
        data: pd.DataFrame | None = None,
        **kwargs,
    ) -> sns.FacetGrid:
        """Generic ``sns.catplot`` over the (filtered/transformed) data."""
        data = self._prepare(data, condition, transform)
        return _seaborn().catplot(
            data=data,
            x=x_col,
            y=y_col,
            hue=hue_col,
            col="log_num" if log_wise else None,
            kind=kind,
            height=self.plot_height,
            palette=self.palette if hue_col else None,
            **kwargs,
        )

    def create_jointplot(
        self,
        x_col: str,
        y_col: str,
        hue_col: str | None = None,
        kind: str = "scatter",
        condition: Callable[[pd.DataFrame], pd.Series] | None = None,
        transform: Callable[[pd.DataFrame], pd.DataFrame] | None = None,
        data: pd.DataFrame | None = None,
        **kwargs,
    ) -> sns.JointGrid:
        """Generic ``sns.jointplot`` over the (filtered/transformed) data."""
        data = self._prepare(data, condition, transform)
        return _seaborn().jointplot(
            data=data,
            x=x_col,
            y=y_col,
            hue=hue_col,
            kind=kind,
            height=self.plot_height,
            palette=self.palette if hue_col else None,
            **kwargs,
        )
