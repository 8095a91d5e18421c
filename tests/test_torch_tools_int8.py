"""The port's trained int8 drift gate (``tools/gates.py::drift_boxes``) against
the JAX package's ``tests/test_trained_detector.py::test_trained_int8_drift``
on the same views, on the CPU.

The port quantizes the trained checkpoint on 4 rendered views and hands the
artifact to JAX; on 4 held-out views both packages' int8 (folded stem) top-1
boxes agree within 1e-3 px, JAX running op by op (its jit fuses the
epilogue into a fused multiply-add: 0.3 px apart on these views).  The bf16
top-1 boxes agree within 0.5 px (bf16 convolutions round in another order
in XLA and oneDNN: 0.2 px was measured at 416 px), and so the drift numbers.
Cut to 96 px views at 128 px: JAX's op-by-op forward compiles each of its
~370 operations once (~30 s), and its cost grows with the views.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from wtracker_tpu.models import yolov8 as jy
from wtracker_tpu.models import yolov8_int8 as ji
from wtracker_tpu.sim.synthetic import SyntheticScene as JaxScene
from wtracker_tpu_torch.models.yolov8 import YoloV8Detector
from wtracker_tpu_torch.models.yolov8_int8 import quantize_detector
from wtracker_tpu_torch.sim.synthetic import make_trajectory
from wtracker_tpu_torch.tools import gates

torch.set_num_threads(2)

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "models", "yolov8s_worm416.npz")
BOX_ATOL = 1e-3
BF16_BOX_ATOL = 0.5


def test_trained_int8_drift_boxes_equal_jax(tmp_path):
    cam, imgsz, calib, held = 96, 128, 4, 4
    traj = make_trajectory(64, gates.ARENA, seed=21)
    xy = jnp.asarray(traj[: calib + held], jnp.float32)
    tls = jnp.clip(xy - cam / 2, 0, jnp.asarray([gates.ARENA[1] - cam, gates.ARENA[0] - cam], jnp.float32))
    views = np.array(JaxScene().render_views(xy, tls, (cam, cam), jnp.arange(calib + held)), np.float32)
    port_views = gates.drift_views(21, calib + held, cam, "cpu").numpy()
    np.testing.assert_allclose(port_views, views, atol=1e-3)  # the renderers agree to sin/cos ulps

    model32 = YoloV8Detector.load(CKPT, imgsz=imgsz, device="cpu").fuse().model
    q = quantize_detector(model32, torch.from_numpy(views[:calib]), (imgsz, imgsz))
    ref, got = gates.drift_boxes(model32, q, torch.from_numpy(views[calib:]), imgsz)

    q.save(tmp_path / "q.npz")
    jq = ji.QuantizedYolo.load(tmp_path / "q.npz")
    jmodel = jy.YoloV8(nc=1, scale="s", compute_dtype=jnp.bfloat16, fused=True)
    jvars = jy.fuse_conv_bn(jy.YoloV8Detector.load(CKPT, imgsz=(imgsz, imgsz)).variables)
    frames = jnp.asarray(views[calib:])
    want_ref = np.asarray(jax.jit(lambda v, x: jy.detect_top1(jmodel, v, x, (imgsz, imgsz), 0.0))(jvars, frames))
    detect_int8, _ = ji.make_detect_fns(jq, src_hw=(cam, cam), imgsz=(imgsz, imgsz))
    with jax.disable_jit():
        want_got = np.asarray(detect_int8(jmodel, jq.device_weights(), frames, (imgsz, imgsz), 0.0))

    assert got.shape == ref.shape == (held, 4)
    assert np.isfinite(got).all() and np.isfinite(want_got).all()
    np.testing.assert_allclose(got, want_got, atol=BOX_ATOL)
    np.testing.assert_allclose(ref, want_ref, atol=BF16_BOX_ATOL)
    port, jax_numbers = gates.drift_numbers(ref, got), gates.drift_numbers(want_ref, want_got)
    for key in ("median_drift_px", "max_drift_px"):
        assert abs(port[key] - jax_numbers[key]) <= BF16_BOX_ATOL
    assert port["within_8px_share"] == jax_numbers["within_8px_share"] == 1.0
