"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and ``nvcc`` (the kernels are built at first
use) and skip elsewhere.  The file imports nothing of JAX, so it also runs
on a machine without it: ``python -m pytest --noconftest
tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

from wtracker_tpu_torch.ops.preproc import crop_letterbox_reference, crop_letterbox_views

H, W, CAM, IMGSZ = 1430, 1671, 360, 416  # the video loop's frame, camera and detector sizes


@pytest.mark.cuda
@pytest.mark.parametrize("n", [12, 3], ids=["imaging", "moving"])
@pytest.mark.parametrize("dtype, atol", [(torch.float32, 2e-6), (torch.bfloat16, 0.01)], ids=["f32", "bf16"])
def test_crop_letterbox_matches_plain_version(n, dtype, atol):
    """At the loop's shapes, crops at both far corners of the frame included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(n)
    frames = torch.from_numpy(rng.integers(0, 256, (32, H, W), dtype=np.uint8)).cuda()
    tls = np.stack([rng.integers(0, W - CAM + 1, n), rng.integers(0, H - CAM + 1, n)], axis=1)
    tls[0], tls[-1] = (0, 0), (W - CAM, H - CAM)
    idx = torch.from_numpy(rng.integers(0, 32, n).astype(np.int32)).cuda()
    tls = torch.from_numpy(tls.astype(np.int32)).cuda()

    before = crop_letterbox_views.launches
    got = crop_letterbox_views(frames, idx, tls, CAM, IMGSZ, out_dtype=dtype)
    torch.cuda.synchronize()
    assert crop_letterbox_views.launches == before + 1
    assert got.shape == (n, IMGSZ, IMGSZ, 3) and got.dtype == dtype
    want = crop_letterbox_reference(frames, idx, tls, CAM, IMGSZ, out_dtype=dtype)
    assert (got.float() - want.float()).abs().max().item() <= atol


@pytest.mark.cuda
def test_crop_letterbox_refuses_what_it_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    frames = torch.zeros((2, 64, 64), dtype=torch.uint8, device="cuda")
    idx = torch.zeros(1, dtype=torch.int32, device="cuda")
    tls = torch.zeros((1, 2), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="one device"):
        crop_letterbox_views(frames, idx.cpu(), tls, 32, 48)
    with pytest.raises(ValueError, match="contiguous"):
        crop_letterbox_views(frames[:, :, :48], idx, tls, 32, 48)
