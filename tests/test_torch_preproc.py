"""The port's crop+letterbox wrapper against the JAX Pallas kernel.

Reference: ``wtracker_tpu/ops/pallas_preproc.py::crop_letterbox_views`` run in
Pallas interpret mode, and its plain ``crop_letterbox_reference``.  On the
CPU the port's wrapper takes its plain version; the CUDA kernel itself is
held against that plain version on the card
(``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``).  Tolerances are the JAX tests' own: float32 2e-6,
bfloat16 0.01.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from wtracker_tpu.ops.pallas_preproc import crop_letterbox_reference as jax_reference
from wtracker_tpu.ops.pallas_preproc import crop_letterbox_views as jax_views
from wtracker_tpu_torch.ops.preproc import crop_letterbox_reference, crop_letterbox_views

torch.set_num_threads(2)

C, H, W = 6, 128, 160


def _inputs(seed, cam):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, size=(C, H, W), dtype=np.uint8)
    # random crops plus the two corners: (0, 0) and (W - cam, H - cam), where
    # the far interpolation tap sits on the last row/column of the frame
    tls = np.concatenate(
        [
            np.stack([rng.integers(0, W - cam + 1, 5), rng.integers(0, H - cam + 1, 5)], axis=1),
            [[0, 0], [W - cam, H - cam], [W - cam, 0], [0, H - cam]],
        ]
    ).astype(np.int32)
    idx = rng.integers(0, C, size=len(tls)).astype(np.int32)
    idx[1] = C - 1
    return frames, idx, tls


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


DTYPES = [(jnp.float32, torch.float32, 2e-6), (jnp.bfloat16, torch.bfloat16, 0.01)]


@pytest.mark.parametrize("cam, imgsz", [(48, 64), (30, 64), (36, 36)], ids=["up", "up-odd", "same"])
@pytest.mark.parametrize("jdt, tdt, atol", DTYPES, ids=["f32", "bf16"])
def test_wrapper_matches_pallas_kernel(cam, imgsz, jdt, tdt, atol):
    frames, idx, tls = _inputs(cam + imgsz, cam)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_views(jnp.asarray(frames), jnp.asarray(idx), jnp.asarray(tls), cam, imgsz, jdt))
    got = crop_letterbox_views(*_torch(frames, idx, tls), cam, imgsz, out_dtype=tdt)
    assert got.shape == (len(idx), imgsz, imgsz, 3) and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), atol=atol)


@pytest.mark.parametrize("jdt, tdt, atol", DTYPES, ids=["f32", "bf16"])
def test_plain_version_matches_jax_reference(jdt, tdt, atol):
    frames, idx, tls = _inputs(7, 48)
    want = np.asarray(jax_reference(jnp.asarray(frames), jnp.asarray(idx), jnp.asarray(tls), 48, 64, jdt))
    got = crop_letterbox_reference(*_torch(frames, idx, tls), 48, 64, out_dtype=tdt)
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), atol=atol)


def test_cpu_wrapper_launches_no_kernel():
    frames, idx, tls = _inputs(3, 48)
    before = crop_letterbox_views.launches
    crop_letterbox_views(*_torch(frames, idx, tls), 48, 64)
    assert crop_letterbox_views.launches == before


def test_wrapper_refuses_bad_inputs():
    frames, idx, tls = _torch(*_inputs(5, 48))
    with pytest.raises(ValueError, match="int32"):
        crop_letterbox_views(frames, idx.long(), tls, 48, 64)
    with pytest.raises(ValueError, match="top_lefts"):
        crop_letterbox_views(frames, idx, tls[:, :1].contiguous(), 48, 64)
    with pytest.raises(ValueError, match="uint8"):
        crop_letterbox_views(frames.float(), idx, tls, 48, 64)
    with pytest.raises(ValueError, match="contiguous"):
        crop_letterbox_views(frames.transpose(1, 2).contiguous().transpose(1, 2), idx, tls, 48, 64)
    with pytest.raises(ValueError, match="fit"):
        crop_letterbox_views(frames, idx, tls, H + 1, 64)
    with pytest.raises(ValueError, match="out_dtype"):
        crop_letterbox_views(frames, idx, tls, 48, 64, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="no kernel"):
        crop_letterbox_views(frames.to("meta"), idx.to("meta"), tls.to("meta"), 48, 64)

