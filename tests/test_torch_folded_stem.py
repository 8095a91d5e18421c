"""The port's folded stem against the JAX package's.

Reference: ``wtracker_tpu/models/yolov8.py`` (``fold_stem_matrices``,
``stem_apply``, ``can_fold_stem``, ``make_folded_detect``).  The matrices
must be equal; the stem output ``z`` within 1e-5 in float32, and in
bfloat16 within one bf16 ulp everywhere and equal in at least 99 % of the
elements; boxes within 1e-3 px.  The bfloat16 case runs on the trained
checkpoint cast to bf16 in the port, where a stem kernel summed from
bf16-rounded weights would miss the bar.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_yolov8 import CHECKPOINT, _decisive_class_head, _worm_views
from wtracker_tpu.models import yolov8 as jy
from wtracker_tpu_torch.convert import yolov8_from_flax
from wtracker_tpu_torch.models import yolov8 as ty

torch.set_num_threads(2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def fused_small():
    """Scale "n" at 64 px, random init, BN-fused in both packages."""
    jraw = jy.YoloV8(nc=1, scale="n")
    jvars = jax.jit(lambda k: jraw.init(k, jnp.zeros((1, 64, 64, 3), jnp.float32), train=False))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    stats = jax.tree.map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape) if a.ndim else a, jnp.float32), jvars["batch_stats"]
    )
    jvars = _decisive_class_head({**jvars, "batch_stats": stats})
    tmodel = ty.YoloV8(nc=1, scale="n")
    tmodel.load_state_dict(yolov8_from_flax(_np(jvars)))
    return jy.YoloV8(nc=1, scale="n", fused=True), jy.fuse_conv_bn(jvars), ty.fuse_conv_bn(tmodel.eval()), tmodel


@pytest.mark.parametrize("src, imgsz", [((48, 48), (64, 64)), ((360, 360), (416, 416))], ids=["48-64", "360-416"])
@pytest.mark.parametrize("jdt, tdt", [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)], ids=["f32", "bf16"])
def test_fold_stem_matrices_equal(src, imgsz, jdt, tdt):
    want = jy.fold_stem_matrices(src, imgsz, dtype=jdt)
    got = ty.fold_stem_matrices(src, imgsz, dtype=tdt, device="cpu")
    assert got.geometry == want.geometry == (imgsz[0] / src[0], 0, 0)
    for g, w in ((got.by, want.by), (got.bx, want.bx)):
        assert g.dtype == tdt and tuple(g.shape) == w.shape == (3, imgsz[0] // 2, src[0])
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))


@pytest.mark.parametrize("src, imgsz", [((48, 40), (64, 64)), ((63, 63), (63, 63)), ((50, 50), (65, 65))])
def test_fold_stem_matrices_decline(src, imgsz):
    """A padded letterbox or an odd target does not fold, in both packages."""
    assert jy.fold_stem_matrices(src, imgsz) is None
    assert ty.fold_stem_matrices(src, imgsz, device="cpu") is None
    assert ty.make_folded_detect(ty.YoloV8(nc=1, scale="n", fused=True), src, imgsz) is None


def test_can_fold_stem(fused_small):
    _, _, tfused, traw = fused_small
    assert not ty.can_fold_stem(traw)  # unfused: no stem bias to fold
    assert ty.can_fold_stem(tfused) and ty.can_fold_stem(copy.deepcopy(tfused).to(torch.bfloat16))


def test_cast_model_keeps_the_float32_stem(fused_small):
    """A bf16 cast keeps b0's float32 values; loading weights into the cast
    model drops them, so the fold raises instead of using stale values."""
    _, _, tfused, _ = fused_small
    want = {k: v.clone() for k, v in tfused.stem_float32().items()}
    half = ty.fuse_conv_bn(tfused).to(torch.bfloat16)
    assert half.b0.conv.weight.dtype == torch.bfloat16 and half.compute_dtype == torch.bfloat16
    for k in ("weight", "bias"):
        got = half.stem_float32()[k]
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want[k], rtol=0, atol=0)
    assert half.to("cpu").stem_float32()["weight"].dtype == torch.float32  # a move keeps the copy
    assert half.float().stem_float32()["weight"].dtype == torch.float32
    half = ty.fuse_conv_bn(tfused).to(torch.bfloat16)
    half.load_state_dict(half.state_dict())
    with pytest.raises(ValueError, match="float32 values are unknown"):
        half.stem_float32()


def test_cast_round_trip_restores_the_float32_stem(fused_small):
    """bf16 -> float32 puts b0's kept values back, not the upcast rounded
    ones, so a second bf16 cast keeps the true float32 values again."""
    _, _, tfused, _ = fused_small
    want = {k: v.clone() for k, v in tfused.stem_float32().items()}
    back = copy.deepcopy(tfused).to(torch.bfloat16).float()
    assert back.b1.conv.weight.dtype == torch.float32
    for k in ("weight", "bias"):
        torch.testing.assert_close(getattr(back.b0.conv, k).detach(), want[k], rtol=0, atol=0)
    again = back.to(torch.bfloat16).stem_float32()
    for k in ("weight", "bias"):
        torch.testing.assert_close(again[k], want[k], rtol=0, atol=0)


@pytest.mark.parametrize("source", ["unfused", "fused"])
def test_fuse_cast_model_uses_the_float32_stem(fused_small, source):
    """fuse_conv_bn of a bf16 model fuses b0 from its float32 values: the
    same stem as fusing in float32 and then casting."""
    _, _, tfused, traw = fused_small
    want = tfused.stem_float32()
    model = copy.deepcopy(traw if source == "unfused" else tfused).to(torch.bfloat16)
    got = ty.fuse_conv_bn(model)
    assert got.compute_dtype == torch.bfloat16
    for k in ("weight", "bias"):
        torch.testing.assert_close(got.stem_float32()[k], want[k], rtol=0, atol=0)
    model.load_state_dict(model.state_dict())  # cast, then loaded: no float32 values left
    with pytest.raises(ValueError, match="float32 values are unknown"):
        ty.fuse_conv_bn(model)


@pytest.mark.parametrize("views_dtype", [np.uint8, np.float32], ids=["uint8", "float32"])
def test_stem_output_matches_f32(fused_small, views_dtype):
    _, jvars, tfused, _ = fused_small
    rng = np.random.default_rng(2)
    views = rng.uniform(0, 255, (5, 48, 48)).astype(views_dtype)
    want = jy.stem_apply(jy.fold_stem_matrices((48, 48), (64, 64), dtype=jnp.float32), jvars["params"]["b0"]["conv"], jnp.asarray(views))
    folded = ty.fold_stem_matrices((48, 48), (64, 64), dtype=torch.float32, device="cpu")
    with torch.no_grad():
        got = ty.stem_apply(folded, tfused.stem_float32(), torch.from_numpy(views))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (5, 32, 32, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """Spacing of bfloat16 values at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def test_stem_output_matches_bf16_trained():
    """The trained checkpoint, BN-fused, cast to bf16 in the port, at the
    loop's 360 -> 416 geometry, against the JAX package's bf16 fold of the
    same float32 weights."""
    jdet = jy.YoloV8Detector.load(CHECKPOINT, imgsz=416).fuse()
    tdet = ty.YoloV8Detector.load(CHECKPOINT, imgsz=416, device="cpu").fuse().to(torch.bfloat16)
    views = _worm_views([(100.3, 150.7), (250.0, 60.2)])
    want = np.asarray(
        jy.stem_apply(jy.fold_stem_matrices((360, 360), (416, 416)), jdet.variables["params"]["b0"]["conv"], jnp.asarray(views)),
        np.float32,
    )
    folded = ty.fold_stem_matrices((360, 360), (416, 416), dtype=torch.bfloat16, device="cpu")
    stem = tdet.model.stem_float32()

    def close(z: torch.Tensor) -> tuple[float, bool]:
        z = z.float().numpy()
        assert z.shape == want.shape == (2, 208, 208, 32)
        return (z == want).mean(), bool((np.abs(z - want) <= _bf16_ulp(want)).all())

    with torch.no_grad():
        equal, within_ulp = close(ty.stem_apply(folded, stem, torch.from_numpy(views)))
        assert within_ulp and equal >= 0.99, (equal, within_ulp)
        # the bar is tight enough to catch a kernel summed from bf16-rounded weights
        rounded = ty.stem_weff(tdet.model.b0.conv.weight)
        equal_r, within_r = close(ty.stem_apply_weff(folded, rounded, tdet.model.b0.conv.bias, torch.from_numpy(views)))
        assert not (within_r and equal_r >= 0.99), (equal_r, within_r)


def test_folded_detect_matches_jax(fused_small):
    jmodel, jvars, tfused, _ = fused_small
    views = np.random.default_rng(3).integers(0, 255, (6, 48, 48), dtype=np.uint8)
    jdetect = jy.make_folded_detect(jmodel, (48, 48), (64, 64))
    want = np.asarray(jax.jit(lambda v, x: jdetect(jmodel, v, x, (64, 64), 0.0))(jvars, jnp.asarray(views)))
    detect = ty.make_folded_detect(tfused, (48, 48), (64, 64))
    assert detect.folds_preproc
    with torch.no_grad():
        got = detect(tfused, torch.from_numpy(views), (64, 64), 0.0)
        standard = ty.detect_top1(tfused, torch.from_numpy(views), (64, 64), 0.0)
    assert got.dtype == torch.float32 and got.shape == (6, 4) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    np.testing.assert_allclose(got.numpy(), standard.numpy(), atol=1e-3)  # the fold is exact math
