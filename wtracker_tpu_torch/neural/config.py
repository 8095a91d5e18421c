"""Predictor IO contract.

Port of :class:`wtracker_tpu.neural.config.IOConfig` (without the optax
optimizer registry of that module).  ``in_dim = BBOX_FEATURES·|input_frames|``
and ``out_dim = CENTER_FEATURES·|pred_frames|`` are persisted into JSON.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from wtracker_tpu_torch.utils.config_base import ConfigBase

# feature widths per frame offset: a full bbox going in, a center coming out
BBOX_FEATURES = 4
CENTER_FEATURES = 2


@dataclass
class IOConfig(ConfigBase):
    """Input/output contract of the predictor network.

    Frame offsets are relative to the prediction frame (0); negative offsets
    look into the past.
    """

    input_frames: list[int]
    pred_frames: list[int]

    in_dim: int = field(init=False)
    out_dim: int = field(init=False)

    def __post_init__(self):
        if 0 not in self.input_frames:
            # the reference warns on stdout rather than raising
            print(
                "WARNING::IOConfig::input_frames doesn't contain 0 (the prediction frame). "
                "Please verify your parameters."
            )
        self.in_dim = BBOX_FEATURES * len(self.input_frames)
        self.out_dim = CENTER_FEATURES * len(self.pred_frames)
