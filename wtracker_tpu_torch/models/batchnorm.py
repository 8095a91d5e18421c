"""BatchNorm in train mode, as Flax computes it.

The JAX package's models normalise with Flax's ``nn.BatchNorm``.  In train
mode its running variance is updated with the *biased* batch variance,
where torch's ``BatchNorm1d/2d`` uses the unbiased one (``n/(n−1)``
larger); the normalisation itself uses the biased variance in both.

:func:`flax_batch_norm` lets torch's fused ``F.batch_norm`` normalise with
the batch's statistics and update the running mean (torch's update is
Flax's) and a copy of the running variance, then takes the unbiased
variance back out of that copy per channel: with ``m`` torch's momentum,
``v₀`` the old running variance and ``v_t = (1 − m)·v₀ + m·n/(n−1)·σ²``
torch's new one, Flax's ``(1 − m)·v₀ + m·σ²`` is
``((n − 1)·v_t + (1 − m)·v₀)/n``.  Eval mode stays torch's ``BatchNorm``
call (the same numbers from the running statistics).  torch stores
``momentum`` as the weight of the new value, Flax as the weight of the old
one: Flax's momentum is ``1 − bn.momentum``.

Flax computes the variance as ``E[x²] − E[x]²`` in the input's precision;
torch's fused kernels take a two-pass variance, which is the more exact of
the two in float32 (the tests compare the packages in float64, where both
are exact).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def flax_batch_norm(x: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm) -> torch.Tensor:
    """Normalise ``x`` (channels on axis 1) with its batch statistics and
    update ``bn``'s running mean and variance in place, as Flax's train-mode
    ``BatchNorm`` does."""
    n = x.numel() // x.shape[1]
    # torch's update goes to a copy (autograd keeps the variance it was
    # given, so the buffer itself must not change after the call)
    var_t = bn.running_var.clone()
    y = F.batch_norm(x, bn.running_mean, var_t, bn.weight, bn.bias, training=True, momentum=bn.momentum, eps=bn.eps)
    with torch.no_grad():
        bn.running_var.mul_(1 - bn.momentum).add_(var_t, alpha=n - 1).div_(n)
    return y
