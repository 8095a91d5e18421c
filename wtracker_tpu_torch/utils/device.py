"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """Return ``torch.device(device)``, refusing a CUDA device that is absent.

    Entry points default to ``"cuda"``; on a machine without a card they raise
    here instead of carrying on silently on the CPU.  For a CUDA device this
    also turns TF32 off for matmuls and cuDNN convolutions: TF32 keeps about
    three decimal digits, while the float32 paths are held to the JAX
    package's float32 results (detector logits at 1e-4, integer platform
    moves exactly).
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} was requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:  # "cuda" means the current card: name it, so devices compare equal
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
