"""PyTorch/CUDA port of :mod:`wtracker_tpu` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its module layout
and public names so each module's counterpart is easy to find.  It imports
``torch``, numpy and pandas only — never ``jax`` or ``wtracker_tpu``.

Unlike the JAX package, importing this package changes no global numeric
setting: control math is ``torch.float64`` where the code says so, model math
is float32 or bfloat16 where the code says so.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; asking for the card on a machine without one raises.
"""
