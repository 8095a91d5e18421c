"""Native runtime components (C++ via ctypes): parallel BMP frame decoding."""

from wtracker_tpu_torch.runtime.native import load_batch_bmp, native_available, probe_bmp

__all__ = ["load_batch_bmp", "native_available", "probe_bmp"]
