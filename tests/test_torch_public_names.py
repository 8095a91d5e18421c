"""The port's package-level names, the augmentation's public functions and
the reference ``.pt`` loader, against the JAX package.

* Every name in each JAX ``__init__.py``'s ``__all__`` is in the port's
  counterpart package, with the same ``__all__`` (no exemption).
* ``spatial_augment``, ``mosaic_augment`` and ``photometric_augment`` from
  a JAX key give JAX's batch (images atol 1e-5, boxes atol 1e-4, masks and
  classes exactly), and ``augment_batch`` is their composition bit for bit.
* ``load_torch_checkpoint`` reads a whole-module ``.pt`` pickled from a
  stand-in upstream ``wtracker`` package written under ``tmp_path``: the
  JAX loader (``reference_root=``, in a child process, since it imports the
  stand-in) and the port's restricted loader give the same predictions
  (1e-5), and the port imports nothing of the stand-in (whose import
  writes a marker file) and leaves ``sys.path`` alone; a pickle naming any
  other global is refused.
"""

import ast
import importlib
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wtracker_tpu.neural import yolo_recipe as jrec
from wtracker_tpu_torch.neural import yolo_recipe as trec

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
JAX_INITS = sorted((ROOT / "wtracker_tpu").rglob("__init__.py"))


def _all_of(init: Path) -> list[str]:
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    return []


@pytest.mark.parametrize(
    "init", [p for p in JAX_INITS if _all_of(p)], ids=lambda p: str(p.parent.relative_to(ROOT / "wtracker_tpu"))
)
def test_every_jax_public_name_is_in_the_port(init):
    names = _all_of(init)
    package = ".".join(("wtracker_tpu_torch", *init.parent.relative_to(ROOT / "wtracker_tpu").parts))
    mod = importlib.import_module(package)
    missing = [n for n in names if not hasattr(mod, n)]
    assert not missing, f"{package} lacks {missing}"
    assert list(mod.__all__) == names


def test_the_last_modules_and_native_loader_exist():
    from wtracker_tpu_torch.runtime import native_available

    for name in ("wtracker_tpu_torch.parallel.mesh", "wtracker_tpu_torch.utils.profiling"):
        importlib.import_module(name)
    assert native_available() is True  # g++ builds the loader here


# ---------------------------------------------------------------------------
# the augmentation's public functions
# ---------------------------------------------------------------------------


def _batch(B=6, size=64, G=2, channels=1, seed=4):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 0.3, (B, size, size, channels)).astype(np.float32)
    c = rng.uniform(12, size - 12, (B, G, 2))
    wh = rng.uniform(8, 16, (B, G, 2))
    gt = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    cls = rng.integers(0, 2, (B, G)).astype(np.int32)
    mask = rng.random((B, G)) < 0.8
    return images, gt, cls, mask


@pytest.mark.parametrize("channels", [1, 3])
def test_augment_functions_equal_jax(channels):
    images, gt, cls, mask = _batch(channels=channels)
    cfg_j, cfg_t = jrec.AugmentConfig(), trec.AugmentConfig()
    key = jax.random.PRNGKey(7)
    t = [torch.from_numpy(a) for a in (images, gt, cls, mask)]

    w_img, w_gt, w_mask = (np.asarray(a) for a in jrec.spatial_augment(key, jnp.asarray(images), jnp.asarray(gt), jnp.asarray(mask), cfg_j))
    g_img, g_gt, g_mask = trec.spatial_augment(np.asarray(key), t[0], t[1], t[3], cfg_t)
    np.testing.assert_allclose(g_img.numpy(), w_img, atol=1e-5)
    np.testing.assert_array_equal(g_mask.numpy(), w_mask)
    np.testing.assert_allclose(g_gt.numpy()[w_mask], w_gt[w_mask], atol=1e-4)

    want = [np.asarray(a) for a in jrec.mosaic_augment(key, *(jnp.asarray(a) for a in (images, gt, cls, mask)), 0.6)]
    got = [a.numpy() for a in trec.mosaic_augment(np.asarray(key), *t, 0.6)]
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    np.testing.assert_allclose(got[1], want[1], atol=1e-4)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    assert 0 < np.asarray(want[3]).sum()

    want = np.asarray(jrec.photometric_augment(key, jnp.asarray(images), cfg_j))
    np.testing.assert_allclose(trec.photometric_augment(np.asarray(key), t[0], cfg_t).numpy(), want, atol=1e-5)


def test_augment_batch_is_the_composition():
    """``augment_batch`` = mosaic, spatial and photometric from the three
    keys of ``split(key, 3)``, bit for bit."""
    from wtracker_tpu_torch.utils import flax_init

    images, gt, cls, mask = (torch.from_numpy(a) for a in _batch())
    cfg = trec.AugmentConfig(mosaic=0.6)
    key = np.asarray(jax.random.PRNGKey(11))
    k_m, k_s, k_p = flax_init.split(key, 3)
    m_img, m_gt, m_cls, m_mask = trec.mosaic_augment(k_m, images, gt, cls, mask, cfg.mosaic)
    s_img, s_gt, s_mask = trec.spatial_augment(k_s, m_img, m_gt, m_mask, cfg)
    composed = (trec.photometric_augment(k_p, s_img, cfg), s_gt, m_cls, s_mask)
    for a, b in zip(trec.augment_batch(key, images, gt, cls, mask, cfg), composed):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the reference's whole-module .pt
# ---------------------------------------------------------------------------

STAND_IN = '''
import os
from dataclasses import dataclass

from torch import nn

open(os.environ["WTRACKER_STAND_IN_MARKER"], "a").write("imported\\n")


@dataclass
class IOConfig:
    input_frames: list
    pred_frames: list


class MLPLayer(nn.Module):
    def __init__(self, in_dim, out_dim, bn=True):
        super().__init__()
        layers = [nn.Linear(in_dim, out_dim)] + ([nn.BatchNorm1d(out_dim)] if bn else []) + [nn.ReLU()]
        self.mlp_layer = nn.Sequential(*layers)

    def forward(self, x):
        return self.mlp_layer(x)


class MlpBlock(nn.Module):
    def __init__(self, in_dim, dims, bn=True):
        super().__init__()
        layers, d = [], in_dim
        for o in dims:
            layers.append(MLPLayer(d, o, bn))
            d = o
        self.sequence = nn.Sequential(*layers)

    def forward(self, x):
        return self.sequence(x)


class RMLP(nn.Module):
    def __init__(self, in_dim, block_in_dim, block_dims, n_blocks, out_dim, bn=True):
        super().__init__()
        self.input = MLPLayer(in_dim, block_in_dim, bn)
        self.blocks = nn.ModuleList([MlpBlock(block_in_dim, block_dims, bn) for _ in range(n_blocks)])
        self.output = nn.Linear(block_in_dim, out_dim)

    def forward(self, x):
        x = self.input(x)
        for b in self.blocks:
            x = x + b(x)
        return self.output(x)


class WormPredictor(nn.Module):
    def __init__(self, model, io_config):
        super().__init__()
        self.model = model
        self.io_config = io_config

    def forward(self, x):
        return self.model(x)
'''

# writes the .pt from the stand-in, then loads it with the JAX package's
# loader and prints its predictions on the inputs as JSON
CHILD = '''
import json, sys
import numpy as np
import torch
root, pt = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
from wtracker.neural.mlp import RMLP, IOConfig, WormPredictor
torch.manual_seed(0)
net = RMLP(8, 6, (5, 6), 2, 2)
net.train()
net(torch.randn(32, 8))  # running statistics away from their start
net.eval()
torch.save(WormPredictor(net, IOConfig([0, -3], [3])), pt)
sys.path.remove(root)
import jax
jax.config.update("jax_platforms", "cpu")
from wtracker_tpu.models.resmlp import load_torch_checkpoint
p = load_torch_checkpoint(pt, reference_root=root)
x = np.asarray(json.loads(sys.argv[3]), np.float32)
print(json.dumps(np.asarray(p.model.apply(p.variables, x, train=False), np.float64).tolist()))
'''


def test_load_torch_checkpoint_reads_the_reference_pickle(tmp_path):
    from wtracker_tpu_torch.models.resmlp import load_torch_checkpoint

    ref = tmp_path / "reference"
    (ref / "wtracker" / "neural").mkdir(parents=True)
    (ref / "wtracker" / "__init__.py").write_text("")
    (ref / "wtracker" / "neural" / "__init__.py").write_text("")
    (ref / "wtracker" / "neural" / "mlp.py").write_text(STAND_IN)
    marker, pt = tmp_path / "imported.txt", tmp_path / "predictor.pt"
    x = np.random.default_rng(0).normal(size=(5, 8)).astype(np.float32)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "WTRACKER_STAND_IN_MARKER": str(marker), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", CHILD, str(ref), str(pt), json.dumps(x.tolist())],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = np.asarray(json.loads(proc.stdout.strip().splitlines()[-1]))
    marker.unlink()  # the child imported the stand-in twice (to save, and in JAX's loader)

    path_before = list(sys.path)
    predictor = load_torch_checkpoint(str(pt), reference_root=str(ref))
    assert not marker.exists() and "wtracker" not in sys.modules and sys.path == path_before
    assert list(predictor.io_config.input_frames) == [0, -3] and list(predictor.io_config.pred_frames) == [3]
    m = predictor.model
    assert (m.in_dim, m.block_in_dim, m.block_dims, m.n_blocks, m.out_dim, m.batch_norm) == (8, 6, (5, 6), 2, 2, True)
    np.testing.assert_allclose(predictor(torch.from_numpy(x)).numpy(), want, rtol=1e-5, atol=1e-6)

    class Payload:  # any global outside the allowed ones is refused
        def __reduce__(self):
            return (os.system, ("true",))

    bad = tmp_path / "bad.pt"
    torch.save({"model": Payload()}, bad)
    with pytest.raises(pickle.UnpicklingError, match="refusing to load"):
        load_torch_checkpoint(str(bad))
