"""Dataset-creation layer: background, classical detection, sample crops."""

from wtracker_tpu_torch.dataset.bg_extractor import BGExtractor
from wtracker_tpu_torch.dataset.box_calculator import BoxCalculator
from wtracker_tpu_torch.dataset.sample_extractor import SampleExtractor

__all__ = ["BGExtractor", "BoxCalculator", "SampleExtractor"]
