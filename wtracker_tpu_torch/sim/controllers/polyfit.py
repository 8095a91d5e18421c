"""The polyfit controller's configuration.

Port of :class:`wtracker_tpu.sim.controllers.polyfit.PolyfitConfig` (the
reference's ``PolyfitConfig``; saved JSONs round-trip between the packages).
The engine twin of the controller is
:func:`wtracker_tpu_torch.sim.engine.polyfit_controller`.
"""

from __future__ import annotations

from dataclasses import dataclass

from wtracker_tpu_torch.utils.config_base import ConfigBase


@dataclass
class PolyfitConfig(ConfigBase):
    """Fit recipe: polynomial degree + sample grid + per-sample weights.

    ``sample_times`` are frames relative to the cycle start (negatives reach
    into previous cycles) and are kept sorted; the weights keep the order
    they were given in; omitted weights mean uniform.
    """

    degree: int
    sample_times: list[int]
    weights: list[float] = None

    def __post_init__(self):
        self.sample_times = sorted(self.sample_times)
        if self.weights is None:
            self.weights = [1.0] * len(self.sample_times)
        if len(self.weights) != len(self.sample_times):
            raise ValueError(f"{len(self.weights)} weights for {len(self.sample_times)} sample times")
