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

Data parallelism (:mod:`wtracker_tpu_torch.parallel.mesh`): inside
:func:`synced_batch_norm` the train-mode statistics are those of the whole
batch over every rank, as they are when XLA partitions the JAX package's
step (:class:`_SyncedBatchNorm`: one all-reduce of the ranks' statistics
forward, one of their gradient sums backward).  The running variance
stays Flax's biased one (``torch.nn.SyncBatchNorm`` keeps the unbiased one
and does not run on CPU tensors).
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch import nn

_SYNC = threading.local()  # set inside synced_batch_norm, for this thread's forwards


@contextlib.contextmanager
def synced_batch_norm():
    """Within the block, train-mode :func:`flax_batch_norm` normalises with
    the statistics of the whole batch over the ranks of the default
    ``torch.distributed`` group, each rank holding an equal slice."""
    prev = getattr(_SYNC, "on", False)
    _SYNC.on = True
    try:
        yield
    finally:
        _SYNC.on = prev


class _SyncedBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the whole batch of every rank (equal
    slices), two collectives a call.

    Forward: each rank's per-channel mean and sum of squared deviations go
    into its row of a (world, 2C) buffer that one all-reduce fills on every
    rank, and Chan's formula combines the rows into the whole batch's mean
    and biased variance (as exact as one device's two-pass statistics).
    Backward: the standard BatchNorm gradient
    ``dx = w/σ·(dy − mean(dy) − x̂·mean(dy·x̂))`` with both means over the
    whole batch (one all-reduce of the per-rank sums); the weight and bias
    get this rank's share, which the data-parallel step sums over the ranks
    with the other gradients."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum: float, eps: float):
        import torch.distributed as dist

        world, rank = dist.get_world_size(), dist.get_rank()
        dims = [0, *range(2, x.ndim)]
        shape = [1, x.shape[1]] + [1] * (x.ndim - 2)
        n = x.numel() // x.shape[1]
        m = x.mean(dims)
        m2 = ((x - m.reshape(shape)) ** 2).sum(dims)
        rows = x.new_zeros((world, 2, x.shape[1]))
        rows[rank, 0], rows[rank, 1] = m, m2
        dist.all_reduce(rows)
        mean = rows[:, 0].mean(0)
        var = (rows[:, 1] + n * (rows[:, 0] - mean) ** 2).sum(0) / (n * world)
        invstd = torch.rsqrt(var + eps)
        xhat = (x - mean.reshape(shape)) * invstd.reshape(shape)
        y = xhat * weight.reshape(shape) + bias.reshape(shape)
        running_mean.mul_(1 - momentum).add_(mean, alpha=momentum)
        running_var.mul_(1 - momentum).add_(var, alpha=momentum)
        ctx.save_for_backward(xhat, weight, invstd)
        ctx.n_total = n * world
        return y

    @staticmethod
    def backward(ctx, dy):
        import torch.distributed as dist

        xhat, weight, invstd = ctx.saved_tensors
        dims = [0, *range(2, dy.ndim)]
        shape = [1, dy.shape[1]] + [1] * (dy.ndim - 2)
        local = torch.stack([dy.sum(dims), (dy * xhat).sum(dims)])
        total = local.clone()
        dist.all_reduce(total)
        mean_dy, mean_dy_xhat = (total / ctx.n_total).reshape(2, *shape).unbind(0)
        dx = (weight * invstd).reshape(shape) * (dy - mean_dy - xhat * mean_dy_xhat)
        return dx, local[1], local[0], None, None, None, None


def flax_batch_norm(x: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm) -> torch.Tensor:
    """Normalise ``x`` (channels on axis 1) with its batch statistics and
    update ``bn``'s running mean and variance in place, as Flax's train-mode
    ``BatchNorm`` does (over every rank's slice inside
    :func:`synced_batch_norm`)."""
    if getattr(_SYNC, "on", False):
        return _SyncedBatchNorm.apply(x, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.momentum, bn.eps)
    n = x.numel() // x.shape[1]
    # torch's update goes to a copy (autograd keeps the variance it was
    # given, so the buffer itself must not change after the call)
    var_t = bn.running_var.clone()
    y = F.batch_norm(x, bn.running_mean, var_t, bn.weight, bn.bias, training=True, momentum=bn.momentum, eps=bn.eps)
    with torch.no_grad():
        bn.running_var.mul_(1 - bn.momentum).add_(var_t, alpha=n - 1).div_(n)
    return y
