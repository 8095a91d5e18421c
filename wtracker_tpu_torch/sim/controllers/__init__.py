"""Controller configurations of the port (the host controllers themselves
are not ported; the engine's controller factories replace them)."""

from wtracker_tpu_torch.sim.controllers.polyfit import PolyfitConfig

__all__ = ["PolyfitConfig"]
