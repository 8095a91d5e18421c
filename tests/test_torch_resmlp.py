"""The port's ResMLP predictor against the JAX package's.

Reference: ``wtracker_tpu/models/resmlp.py`` (``RMLP``, ``make_rmlp_predictor``,
``save_predictor``, ``load_predictor``).  A Flax predictor saved by the JAX
package loads into the port and gives the same outputs to 1e-5; the port's
own ``.npz`` loads back into the JAX package.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wtracker_tpu.models import resmlp as jr
from wtracker_tpu.neural.config import IOConfig as JaxIOConfig
from wtracker_tpu_torch.convert import resmlp_from_flax
from wtracker_tpu_torch.models import resmlp as tr
from wtracker_tpu_torch.neural.config import IOConfig

torch.set_num_threads(2)

FRAMES = [0, -3, -6, -9, -12]

TOPOLOGIES = {
    "reference": dict(),  # block_in_dim 40, dims (10, 4, 10, 40), 4 blocks, relu
    "tanh-nobn": dict(block_in_dim=16, block_dims=(8, 16), n_blocks=2, nonlin="tanh", batch_norm=False),
}


def _with_stats(variables: dict, seed: int) -> dict:
    """Non-trivial BatchNorm running statistics (fresh ones are 0 and 1)."""
    rng = np.random.default_rng(seed)
    if "batch_stats" not in variables:
        return variables
    stats = jax.tree.map(lambda a: jnp.asarray(rng.uniform(0.5, 2.0, a.shape), jnp.float32), variables["batch_stats"])
    return {**variables, "batch_stats": stats}


@pytest.fixture(params=list(TOPOLOGIES), scope="module")
def jax_predictor(request):
    p = jr.make_rmlp_predictor(JaxIOConfig(FRAMES, [3]), seed=7, **TOPOLOGIES[request.param])
    return jr.WormPredictor(model=p.model, variables=_with_stats(p.variables, 8), io_config=p.io_config)


def _features(n=6, seed=9):
    return np.random.default_rng(seed).normal(0, 20, (n, 4 * len(FRAMES))).astype(np.float32)


def test_load_jax_saved_predictor(tmp_path, jax_predictor):
    path = str(tmp_path / "pred.npz")
    jr.save_predictor(jax_predictor, path)
    port = tr.load_predictor(path, device="cpu")
    assert vars(port.io_config) == vars(jax_predictor.io_config)
    x = _features()
    np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(), np.asarray(jax_predictor(x)), atol=1e-5)


def test_resmlp_from_flax_matches(jax_predictor):
    m = jax_predictor.model
    model = tr.RMLP(m.block_in_dim, m.block_dims, m.block_nonlins, m.n_blocks, m.out_dim, m.in_dim, m.batch_norm)
    model.load_state_dict(resmlp_from_flax(jax.tree.map(np.asarray, jax_predictor.variables)))
    x = _features(seed=10)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_predictor(x)), atol=1e-5)


def test_port_saved_predictor_loads_in_jax(tmp_path):
    """The port's seeded predictor (the reference topology) round-trips
    through the shared ``.npz`` format."""
    port = tr.make_rmlp_predictor(IOConfig(FRAMES, [3]), seed=3, device="cpu")
    path = str(tmp_path / "port.npz")
    tr.save_predictor(port, path)
    back = jr.load_predictor(path)
    want = resmlp_from_flax(jax.tree.map(np.asarray, back.variables))
    for name, value in port.model.state_dict().items():
        assert torch.equal(value, want[name]), name
    x = _features(seed=11)
    # outputs reach tens of pixels: XLA and torch sum in other orders, a few ulps
    np.testing.assert_allclose(np.asarray(back(x)), port(torch.from_numpy(x)).numpy(), rtol=1e-6, atol=1e-5)
    again = tr.load_predictor(path, device="cpu")
    torch.testing.assert_close(again(torch.from_numpy(x)), port(torch.from_numpy(x)), rtol=0, atol=0)


def test_seeded_predictor_is_deterministic():
    a = tr.make_rmlp_predictor(IOConfig(FRAMES, [3]), seed=5, device="cpu")
    b = tr.make_rmlp_predictor(IOConfig(FRAMES, [3]), seed=5, device="cpu")
    c = tr.make_rmlp_predictor(IOConfig(FRAMES, [3]), seed=6, device="cpu")
    x = torch.from_numpy(_features(seed=12))
    assert torch.equal(a(x), b(x)) and not torch.equal(a(x), c(x))
    assert a(x).dtype == torch.float32 and a(x).shape == (6, 2)


def test_entry_points_refuse_missing_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.make_rmlp_predictor(IOConfig(FRAMES, [3]))
