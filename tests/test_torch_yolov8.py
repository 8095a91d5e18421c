"""The port's YOLOv8 against the JAX package's.

Reference: ``wtracker_tpu/models/yolov8.py`` (``YoloV8``, ``fuse_conv_bn``,
``decode_top1``, ``detect_top1``, ``YoloV8Detector.load``) and
``wtracker_tpu/ops/image.py::letterbox``.  Flax variables go through
``yolov8_from_flax``; both sides compute in float32.  Per-level logits are
held to 1e-4, boxes in source pixels to 1e-3, and the trained checkpoint's
top-1 boxes to IoU >= 0.99.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wtracker_tpu.models import yolov8 as jy
from wtracker_tpu.ops.image import letterbox as jax_letterbox
from wtracker_tpu_torch.convert import yolov8_from_flax
from wtracker_tpu_torch.models import yolov8 as ty
from wtracker_tpu_torch.ops.image import letterbox

torch.set_num_threads(2)

CHECKPOINT = "models/yolov8s_worm416.npz"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _decisive_class_head(variables: dict) -> dict:
    """Random-init class logits are the -4.595 prior plus a spread of ~1e-4:
    the top-1 anchor is a near-tie that float32 noise flips.  A zero bias and
    a 1000x class kernel spread the logits far beyond that noise."""
    head = dict(variables["params"]["head"])
    for name in [k for k in head if k.startswith("cv3_") and k.endswith("_2")]:
        head[name] = {"kernel": head[name]["kernel"] * 1000.0, "bias": jnp.zeros_like(head[name]["bias"])}
    return {**variables, "params": {**variables["params"], "head": head}}


@pytest.fixture(scope="module")
def small():
    """Scale "n" at 64 px, random init with real BatchNorm statistics."""
    jmodel = jy.YoloV8(nc=1, scale="n")
    jvars = jax.jit(lambda k: jmodel.init(k, jnp.zeros((1, 64, 64, 3), jnp.float32), train=False))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    stats = jax.tree.map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape) if a.ndim else a, jnp.float32), jvars["batch_stats"]
    )
    jvars = _decisive_class_head({**jvars, "batch_stats": stats})
    tmodel = ty.YoloV8(nc=1, scale="n")
    tmodel.load_state_dict(yolov8_from_flax(_np(jvars)))
    return jmodel, jvars, tmodel.eval()


def _apply(jmodel, jvars, x):
    """The Flax forward pass, compiled (eager Flax is slow on the CPU)."""
    return jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(jvars, jnp.asarray(x))


def _logits_close(jout, tout, atol):
    for jl, tl in zip(jout[0] + jout[1], tout[0] + tout[1]):
        assert tuple(tl.shape) == jl.shape
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol)


@pytest.mark.parametrize("fused", [False, True], ids=["bn", "fused"])
def test_logits_match(small, fused):
    jmodel, jvars, tmodel = small
    if fused:
        jmodel, jvars = jy.YoloV8(nc=1, scale="n", fused=True), jy.fuse_conv_bn(jvars)
        tmodel = ty.fuse_conv_bn(tmodel)
        assert tmodel.fused and not any(".bn." in k for k in tmodel.state_dict())
    x = np.random.default_rng(2).random((2, 64, 64, 3), dtype=np.float32)
    with torch.no_grad():
        tout = tmodel(torch.from_numpy(x))
    _logits_close(_apply(jmodel, jvars, x), tout, 1e-4)


def test_fuse_conv_bn_weights_match(small):
    _, jvars, tmodel = small
    want = yolov8_from_flax(_np(jy.fuse_conv_bn(jvars)))
    got = ty.fuse_conv_bn(tmodel).state_dict()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("hw", [(64, 64), (50, 72)], ids=["square", "padded"])
def test_detect_top1_matches(small, hw):
    jmodel, jvars, tmodel = small
    frames = np.random.default_rng(3).integers(0, 256, (3, *hw), dtype=np.uint8)
    want = np.asarray(jax.jit(lambda v, f: jy.detect_top1(jmodel, v, f, (64, 64), 0.0))(jvars, jnp.asarray(frames)))
    with torch.no_grad():
        got = ty.detect_top1(tmodel, torch.from_numpy(frames), (64, 64), 0.0)
    assert got.dtype == torch.float32 and got.shape == (3, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    # a confidence above every score masks the rows with NaN
    with torch.no_grad():
        assert torch.isnan(ty.detect_top1(tmodel, torch.from_numpy(frames), (64, 64), 1.01)).all()


def test_decode_top1_tie_breaks():
    """First maximum wins within a level and across levels, as in the JAX
    package (argmax over the concatenation order)."""
    rng = np.random.default_rng(4)
    shapes = [(2, 8, 8), (2, 4, 4), (2, 2, 2)]
    box = [rng.normal(size=(*s, 64)).astype(np.float32) for s in shapes]
    cls = [np.zeros((*s, 1), np.float32) for s in shapes]
    cls[0][0, 3, 5] = cls[0][0, 6, 1] = cls[1][0, 0, 0] = 2.0  # sample 0: level 0, first of two
    cls[1][1, 2, 3] = cls[2][1, 1, 1] = 3.0  # sample 1: tie across levels -> level 1
    jb, js = jy.decode_top1([jnp.asarray(b) for b in box], [jnp.asarray(c) for c in cls], (64, 64))
    tb, ts = ty.decode_top1([torch.from_numpy(b) for b in box], [torch.from_numpy(c) for c in cls], (64, 64))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


def test_make_anchors_and_letterbox_params_equal():
    for size in [(64, 64), (416, 416), (96, 64)]:
        for a, b in zip(ty.make_anchors(size), jy.make_anchors(size)):
            np.testing.assert_array_equal(a, b)
    for src in [(360, 360), (300, 200), (99, 108)]:
        assert ty.letterbox_params(src, (416, 416)) == jy.letterbox_params(src, (416, 416))


@pytest.mark.parametrize(
    "jdt, tdt, atol", [(jnp.float32, torch.float32, 1e-6), (jnp.bfloat16, torch.bfloat16, 1e-2)], ids=["f32", "bf16"]
)
@pytest.mark.parametrize("shape", [(2, 50, 72), (2, 40, 30, 3)], ids=["gray", "rgb"])
def test_letterbox_matches(jdt, tdt, atol, shape):
    frames = np.random.default_rng(5).integers(0, 256, shape, dtype=np.uint8)
    want, wgeom = jax_letterbox(jnp.asarray(frames), (64, 64), dtype=jdt)
    got, geom = letterbox(torch.from_numpy(frames), (64, 64), dtype=tdt)
    assert geom == wgeom and got.dtype == tdt and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol)


def _iou(a, b):
    """IoU of (N, 4) xywh boxes, row by row."""
    lo = np.maximum(a[:, :2], b[:, :2])
    hi = np.minimum(a[:, :2] + a[:, 2:], b[:, :2] + b[:, 2:])
    inter = np.prod(np.clip(hi - lo, 0, None), axis=1)
    return inter / (a[:, 2] * a[:, 3] + b[:, 2] * b[:, 3] - inter)


def _worm_views(centers, hw=(360, 360), seed=0):
    """Noisy background plus an elongated Gaussian worm blob per view."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0 : hw[0], 0 : hw[1]].astype(np.float32)
    out = []
    for cx, cy in centers:
        blob = 160.0 * np.exp(-0.5 * (((xs - cx) / 5.0) ** 2 + ((ys - cy) / 3.0) ** 2))
        out.append(np.clip(rng.normal(40, 6, hw) + blob, 0, 255).astype(np.uint8))
    return np.stack(out)


def test_trained_checkpoint_matches():
    """The committed s/416 checkpoint, BN-fused at load, on two 360 px views."""
    jdet = jy.YoloV8Detector.load(CHECKPOINT, imgsz=416).fuse()
    tdet = ty.YoloV8Detector.load(CHECKPOINT, imgsz=416, device="cpu").fuse()
    assert tdet.model.fused and tdet.model.scale == "s" and tdet.model.nc == 1
    assert sum(p.numel() for p in tdet.model.parameters()) == sum(
        a.size for a in jax.tree.leaves(_np(jdet.variables))
    )
    centers = [(100.3, 150.7), (250.0, 60.2)]
    views = _worm_views(centers)

    x, geom = ty.preprocess_batch(torch.from_numpy(views), (416, 416))
    with torch.no_grad():
        tout = tdet.model(x)
        got = tdet.detect(torch.from_numpy(views)).numpy()
    _logits_close(_apply(jdet.model, jdet.variables, x.numpy()), tout, 1e-4)

    want = np.asarray(jdet.detect(views))
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert (_iou(got, want) >= 0.99).all()
    # and the detector finds the worm: box centres within 2 px of the blobs
    np.testing.assert_allclose(got[:, :2] + got[:, 2:] / 2, centers, atol=2.0)
