"""The port's default predictor against the JAX package's.

Reference: ``wtracker_tpu.models.resmlp.make_rmlp_predictor``, which draws
Flax's default init from ``PRNGKey(seed)``.  The key operations of
``wtracker_tpu_torch.utils.flax_init`` must give JAX's bits exactly; the
uniform draws exactly; the weights within 1e-6 absolute (XLA's float32
``erf_inv`` takes its ``log1p`` from another implementation, so about 1 % of
the truncated-normal draws differ by one or two float32 ulps); and the
predictors' outputs within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wtracker_tpu.models.resmlp import make_rmlp_predictor as jax_make_rmlp_predictor
from wtracker_tpu.neural.config import IOConfig as JaxIOConfig
from wtracker_tpu_torch.convert import resmlp_from_flax
from wtracker_tpu_torch.models.resmlp import make_rmlp_predictor
from wtracker_tpu_torch.neural.config import IOConfig
from wtracker_tpu_torch.utils import flax_init

WEIGHT_ATOL = 1e-6
OUTPUT_ATOL = 1e-5
OUTPUT_RTOL = 1e-5


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**33 + 5])
def test_key_operations_give_jax_bits(seed):
    k = jax.random.PRNGKey(seed)
    mine = flax_init.key(seed)
    np.testing.assert_array_equal(mine, np.asarray(k))
    np.testing.assert_array_equal(flax_init.fold_in(mine, 0xDEADBEEF), np.asarray(jax.random.fold_in(k, 0xDEADBEEF)))
    np.testing.assert_array_equal(flax_init.split(mine, 5), np.asarray(jax.random.split(k, 5)))
    np.testing.assert_array_equal(
        flax_init.random_bits(mine, (3, 7)), np.asarray(jax.random.bits(k, (3, 7), jnp.uint32))
    )
    a, b = np.float32(-0.9544997), np.float32(0.9544997)
    np.testing.assert_array_equal(
        flax_init.uniform(mine, (64, 10), a, b), np.asarray(jax.random.uniform(k, (64, 10), jnp.float32, a, b))
    )


@pytest.mark.parametrize("shape", [(3, 40), (40, 10), (10, 4), (40, 2)])
def test_lecun_normal_matches_jax(shape):
    k = jax.random.PRNGKey(sum(shape))
    want = np.asarray(jax.nn.initializers.lecun_normal()(k, shape, jnp.float32))
    got = flax_init.lecun_normal(flax_init.key(sum(shape)), shape)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_allclose(got, want, rtol=0, atol=WEIGHT_ATOL)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("frames", [([0], [3]), ([0, -3, -6, -9, -12], [3]), ([0, -2, -4], [1])], ids=["k1", "k5", "k3"])
def test_default_predictor_is_flax_init(seed, frames):
    jpred = jax_make_rmlp_predictor(JaxIOConfig(*frames), seed=seed)
    pred = make_rmlp_predictor(IOConfig(*frames), seed=seed, device="cpu")
    want = resmlp_from_flax(jax.tree.map(np.asarray, jpred.variables))
    got = pred.model.state_dict()
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=0, atol=WEIGHT_ATOL, err_msg=name)
    # the kernels are not all zero and not torch's uniform init
    assert float(pred.model.output.weight.abs().max()) > 0.1
    x = np.random.default_rng(seed).normal(0, 20, (16, len(frames[0]) * 4)).astype(np.float32)
    np.testing.assert_allclose(pred(torch.from_numpy(x)).numpy(), np.asarray(jpred(x)), rtol=OUTPUT_RTOL, atol=OUTPUT_ATOL)
