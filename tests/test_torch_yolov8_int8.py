"""The port's int8 serving form against the JAX package's.

Reference: ``wtracker_tpu/models/yolov8_int8.py`` at the sizes of its own
tests (``tests/test_yolov8_int8.py``): a BN-fused YOLOv8 "n" at 64 px, random
init, calibrated on rendered scene views.  What is held, and how closely:

- the bf16 walker against the port's YoloV8 cast to bf16, and against the
  JAX walker: every logit within 5 % of its level's largest (the JAX test's
  bar: bf16 convolutions sum in other orders);
- calibration is a bf16 forward, so ``absmax`` agrees within 2 % relative;
- given JAX's ``absmax`` and its fused weights carried across, the build
  gives JAX's ``qweights`` exactly;
- at every convolution of the forward, on JAX's own inputs, the plain
  ``conv_s8`` accumulators equal ``jax.lax.conv_general_dilated``'s, and its
  int8 / bf16 outputs equal JAX's op by op;
- on a JAX artifact, ``detect_top1_int8`` folded and unfolded gives JAX's
  top-1 boxes at IoU >= 0.99 (BASELINE.md's bar), and within 1e-3 px;
- artifacts load across the two packages, both ways.

The int8 loops are held against JAX's in ``tests/test_torch_int8_loops.py``.

The JAX side runs op by op where it is compared exactly: XLA's jit fuses the
epilogue into a fused multiply-add, which moves results by an ulp
(``tests/test_torch_conv_s8.py`` bounds that case).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wtracker_tpu.models import yolov8 as jy
from wtracker_tpu.models import yolov8_int8 as ji
from wtracker_tpu_torch.convert import yolov8_from_flax
from wtracker_tpu_torch.models import yolov8 as ty
from wtracker_tpu_torch.models import yolov8_int8 as ti
from wtracker_tpu_torch.ops.conv_s8 import conv_s8

torch.set_num_threads(2)

IMGSZ = (64, 64)
WALKER_REL = 0.05
ABSMAX_REL = 0.02
MIN_IOU = 0.99
BOX_ATOL = 1e-3


class _Names:
    """A walker engine that only lists the convolutions, in forward order."""

    def __init__(self):
        self.convs = []

    def input(self, x):
        return x

    def convbn(self, name, x, stride=1):
        self.convs.append((name, "silu_q", stride))
        return x

    def plain_conv(self, name, x):
        self.convs.append((name, "logits", 1))
        return x

    def add(self, name, a, b):
        return a

    def concat(self, parts):
        return parts[0]

    def split2(self, x, c):
        return x, x

    def maxpool(self, x, k=5):
        return x

    def upsample(self, x):
        return x


_NAMES = _Names()
ti._forward(_NAMES, None, 1, "n")
CONVS = _NAMES.convs


@pytest.fixture(scope="module")
def nano():
    """The JAX test's fused nano detector, the same weights in the port, and
    rendered scene views (24, 64, 64) float32 in [0, 255]."""
    from wtracker_tpu.sim.synthetic import SyntheticScene, make_trajectory

    raw = jy.YoloV8Detector.init_random(nc=1, scale="n", imgsz=IMGSZ, compute_dtype=jnp.bfloat16, seed=3)
    jmodel = jy.YoloV8(nc=1, scale="n", compute_dtype=jnp.bfloat16, fused=True)
    jvars = jy.fuse_conv_bn(raw.variables)
    tmodel = ty.YoloV8(nc=1, scale="n", fused=True)
    tmodel.load_state_dict(yolov8_from_flax(jax.tree.map(np.asarray, jvars)))
    traj = make_trajectory(64, (160, 160), seed=7)
    xy = jnp.asarray(traj[:24], jnp.float32)
    views = SyntheticScene().render_views(xy, jnp.clip(xy - 32, 0, 160 - 64), (64, 64), jnp.arange(24))
    return jmodel, jvars, tmodel.eval(), np.asarray(views, np.float32)


@pytest.fixture(scope="module")
def artifacts(nano):
    """JAX's and the port's quantization of the same detector on the same
    16 calibration views."""
    jmodel, jvars, tmodel, views = nano
    jq = ji.quantize_detector(jmodel, jvars, views[:16], IMGSZ)
    tq = ti.quantize_detector(tmodel, views[:16], IMGSZ)
    return jq, tq


def _port_of(jq) -> ti.QuantizedYolo:
    return ti.QuantizedYolo(jq.nc, jq.scale, dict(jq.absmax), jq.qweights, jq.reg_max)


def _iou(a, b):
    lo = np.maximum(a[:, :2], b[:, :2])
    hi = np.minimum(a[:, :2] + a[:, 2:], b[:, :2] + b[:, 2:])
    inter = np.prod(np.clip(hi - lo, 0, None), axis=1)
    return inter / (a[:, 2] * a[:, 3] + b[:, 2] * b[:, 3] - inter)


def test_walker_matches_the_models(nano):
    jmodel, jvars, tmodel, views = nano
    x = views[:8, ..., None].repeat(3, axis=-1) / 255.0
    got = ti.forward_bf16_reference(tmodel, torch.from_numpy(x).to(torch.bfloat16))
    with torch.no_grad():
        ref = copy.deepcopy(tmodel).to(torch.bfloat16)(torch.from_numpy(x).to(torch.bfloat16))
    jax_walker = ji.forward_bf16_reference(jvars, jnp.asarray(x, jnp.bfloat16), nc=1, scale="n")
    for g, r, j in zip([*got[0], *got[1]], [*ref[0], *ref[1]], [*jax_walker[0], *jax_walker[1]]):
        g, r, j = g.float().numpy(), r.float().numpy(), np.asarray(j, np.float32)
        scale = max(np.abs(r).max(), 1e-3)
        assert g.shape == r.shape == j.shape
        assert np.abs(g - r).max() <= WALKER_REL * scale
        assert np.abs(g - j).max() <= WALKER_REL * scale


def test_absmax_agrees_within_bf16_tolerance(artifacts):
    jq, tq = artifacts
    assert set(tq.absmax) == set(jq.absmax) and len(jq.absmax) == 64
    for name, want in jq.absmax.items():
        assert abs(tq.absmax[name] - want) <= ABSMAX_REL * want, name
    assert tq.absmax["__input__"] == jq.absmax["__input__"]  # the same letterboxed input, before any layer


def test_qweights_are_jax_given_its_absmax(nano, artifacts):
    _, _, tmodel, _ = nano
    jq, _ = artifacts
    build = ti._BuildOps(tmodel, jq.absmax)
    ti._forward(build, ti._ScaleVec(np.zeros(3)), 1, "n")
    assert list(build.qweights) == list(jq.qweights) == [name for name, _, _ in CONVS]
    for name, node in jq.qweights.items():
        for k in ("w", "sw", "b"):
            got = build.qweights[name][k]
            assert got.dtype == node[k].dtype and got.shape == node[k].shape
            np.testing.assert_array_equal(got, node[k], err_msg=f"{name}|{k}")


@pytest.fixture(scope="module")
def layer_inputs(nano, artifacts):
    """Each convolution's int8 input as JAX's eager int8 forward feeds it,
    and JAX's output, on 4 held-out views."""
    _, _, _, views = nano
    jq, _ = artifacts
    seen = {}

    class Recording(ji._ApplyOps):
        def convbn(self, name, x, stride=1):
            out = super().convbn(name, x, stride)
            seen[name] = (np.asarray(x.data), np.asarray(out.data), np.asarray(x.scales))
            return out

        def plain_conv(self, name, x):
            out = super().plain_conv(name, x)
            seen[name] = (np.asarray(x.data), np.asarray(out, np.float32), np.asarray(x.scales))
            return out

    build = ji._BuildOps.__new__(ji._BuildOps)
    build.absmax, build.qweights = jq.absmax, jq.qweights
    x, _ = jy.preprocess_batch(jnp.asarray(views[16:20]), IMGSZ, dtype=jnp.bfloat16)
    with jax.disable_jit():
        ji._forward(Recording(jq.device_weights(), build), x, 1, "n")
    return seen


@pytest.mark.parametrize("name, epilogue, stride", CONVS, ids=[c[0] for c in CONVS])
def test_every_layer_equals_jax(layer_inputs, artifacts, name, epilogue, stride):
    jq, _ = artifacts
    x, want_out, _ = layer_inputs[name]
    node = {k: torch.from_numpy(v) for k, v in jq.qweights[name].items()}
    xt = torch.from_numpy(x)
    acc = conv_s8(xt, node["w"], stride, "acc")
    np.testing.assert_array_equal(acc.numpy(), np.asarray(ji._conv_s8(jnp.asarray(x), jnp.asarray(jq.qweights[name]["w"]), stride)))
    s_out = max(jq.absmax[name], 1e-6) / 127.0 if epilogue == "silu_q" else None
    got = conv_s8(xt, node["w"], stride, epilogue, node["sw"], node["b"], s_out)
    np.testing.assert_array_equal(got.float().numpy(), want_out.astype(np.float32))


@pytest.mark.parametrize("folded", [False, True], ids=["unfolded", "folded"])
def test_detect_top1_int8_matches_jax(nano, artifacts, folded):
    jmodel, _, _, views = nano
    jq, _ = artifacts
    q = _port_of(jq)
    frames = views[16:20]
    src = (64, 64) if folded else None
    jdetect, _ = ji.make_detect_fns(jq, src_hw=src, imgsz=IMGSZ if folded else None)
    detect, _ = ti.make_detect_fns(q, src_hw=src, imgsz=IMGSZ if folded else None, device="cpu")
    assert getattr(detect, "folds_preproc", False) == getattr(jdetect, "folds_preproc", False) == folded
    want = np.asarray(jdetect(jmodel, jq.device_weights(), jnp.asarray(frames), IMGSZ, 0.0))
    got = detect(None, torch.from_numpy(frames), IMGSZ, 0.0).numpy()
    assert got.shape == want.shape == (4, 4) and np.isfinite(got).all()
    assert (_iou(got, want) >= MIN_IOU).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=BOX_ATOL)
    if not folded:
        direct = ti.detect_top1_int8(q, q.device_weights("cpu"), torch.from_numpy(frames), IMGSZ, 0.0).numpy()
        np.testing.assert_array_equal(direct, got)


def test_preprocessed_int8_matches_end_to_end(nano, artifacts):
    """The crop+letterbox kernel's pairing: detection on a letterboxed tensor
    equals detection on the raw frames."""
    _, _, _, views = nano
    q = _port_of(artifacts[0])
    qw = q.device_weights("cpu")
    frames = torch.from_numpy(views[16:])
    x, geometry = ty.preprocess_batch(frames, IMGSZ, dtype=torch.bfloat16)
    a = ti.detect_top1_int8(q, qw, frames, IMGSZ, 0.0)
    b = ti.detect_top1_preprocessed_int8(q, qw, x, geometry, IMGSZ, 0.0)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_artifacts_load_across_packages(nano, artifacts, tmp_path):
    jmodel, _, _, views = nano
    jq, tq = artifacts
    jq.save(tmp_path / "jax.npz")
    tq.save(tmp_path / "port.npz")
    assert ti.is_quantized_artifact(tmp_path / "jax.npz") and ji.is_quantized_artifact(tmp_path / "port.npz")

    mine = ti.QuantizedYolo.load(tmp_path / "jax.npz")
    theirs = ji.QuantizedYolo.load(tmp_path / "port.npz")
    for a, b in ((mine, jq), (theirs, tq)):
        assert (a.nc, a.scale, a.reg_max, a.absmax) == (b.nc, b.scale, b.reg_max, b.absmax)
        assert list(a.qweights) == list(b.qweights)
        for name in b.qweights:
            for k in ("w", "sw", "b"):
                np.testing.assert_array_equal(a.qweights[name][k], b.qweights[name][k])
    # each package detects with the other's artifact
    frames = views[16:20]
    want = np.asarray(ji.detect_top1_int8(theirs, theirs.device_weights(), jnp.asarray(frames), IMGSZ, 0.0))
    got = ti.detect_top1_int8(tq, tq.device_weights("cpu"), torch.from_numpy(frames), IMGSZ, 0.0).numpy()
    assert (_iou(got, want) >= MIN_IOU).all()
    got = ti.detect_top1_int8(mine, mine.device_weights("cpu"), torch.from_numpy(frames), IMGSZ, 0.0).numpy()
    want = np.asarray(ji.detect_top1_int8(jq, jq.device_weights(), jnp.asarray(frames), IMGSZ, 0.0))
    assert (_iou(got, want) >= MIN_IOU).all()


def test_is_quantized_artifact_tells_weight_files_apart(nano, tmp_path):
    raw = jy.YoloV8Detector.init_random(nc=1, scale="n", imgsz=IMGSZ, compute_dtype=jnp.bfloat16, seed=0)
    raw.save(tmp_path / "w.npz")
    assert not ti.is_quantized_artifact(tmp_path / "w.npz")
    assert not ti.is_quantized_artifact(tmp_path / "missing.npz")


def test_quantize_refuses_a_cast_or_unfused_model(nano):
    _, _, tmodel, views = nano
    with pytest.raises(ValueError, match="float32 fused weights"):
        ti.quantize_detector(copy.deepcopy(tmodel).to(torch.bfloat16), views[:2], IMGSZ)
    with pytest.raises(ValueError, match="BN-fused"):
        ti.quantize_detector(ty.YoloV8(nc=1, scale="n"), views[:2], IMGSZ)


def test_stem_weff_and_folding_match_jax(artifacts):
    jq, _ = artifacts
    q = _port_of(jq)
    np.testing.assert_array_equal(
        q.stem_weff(q.device_weights("cpu")).numpy(), np.asarray(jq.stem_weff(jq.device_weights()))
    )
    detect, _ = ti.make_detect_fns(q, src_hw=(48, 64), imgsz=IMGSZ, device="cpu")
    assert not getattr(detect, "folds_preproc", False)  # the letterbox pads: the standard path
