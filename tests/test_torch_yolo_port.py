"""Detector persistence and the ultralytics weight port against the JAX package.

Reference: ``wtracker_tpu/models/yolo_port.py`` (``export_state_dict``,
``save_torch_state_dict``, ``port_state_dict``) and
``wtracker_tpu/models/yolov8.py`` (``YoloV8Detector.init_random``,
``save``, ``load``, ``raw``, ``decode_predictions``).  Held here:

* a ``.pt`` the JAX package wrote loads in the port and gives JAX's logits
  (float32, atol 1e-4, the bar of ``resolve_device``);
* ``export_state_dict`` of the trained checkpoint equals JAX's key for key
  and bit for bit; a ``.pt`` the port wrote loads in JAX;
* an ``.npz`` the port saves loads in JAX with identical variables;
* the independent ultralytics-layout network of ``tests/torch_yolo_ref.py``
  loads through ``port_state_dict`` and gives that network's logits;
* a whole-module pickle and other non-state-dict files refuse;
* ``decode_predictions`` and ``raw`` equal JAX's (float32 sums in another
  order: atol 1e-4 on pixel boxes, 1e-6 on scores);
* ``init_random(seed)`` is within 2.4e-7 of Flax's init (the bar of the
  ResMLP's init, ``tests/test_torch_resmlp_init.py``: XLA's ``erf_inv``
  takes its ``log1p`` from another implementation).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_yolo_ref import TorchYoloV8
from wtracker_tpu.models import yolo_port as jyp
from wtracker_tpu.models.yolov8 import YoloV8Detector as JaxDetector
from wtracker_tpu.models.yolov8 import decode_predictions as jax_decode
from wtracker_tpu_torch.convert import yolov8_from_flax
from wtracker_tpu_torch.models import yolo_port as typ
from wtracker_tpu_torch.models.yolov8 import YoloV8Detector, decode_predictions

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CHECKPOINT = ROOT / "models" / "yolov8s_worm416.npz"
LOGIT_ATOL = 1e-4
INIT_ATOL = 2.4e-7


def _images(n: int, size: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, (n, size, size, 3)).astype(np.float32)


def _logits_close(got, want) -> None:
    for g, w in zip([*got[0], *got[1]], [*want[0], *want[1]]):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0, atol=LOGIT_ATOL)


def _jax_variables_np(det: JaxDetector) -> dict:
    return jax.tree.map(np.asarray, det.variables)


@pytest.mark.parametrize("seed", [3, 11])
def test_jax_written_pt_gives_jax_logits(tmp_path, seed):
    jdet = JaxDetector.init_random(nc=1, scale="n", imgsz=(64, 64), conf=0.0, seed=seed)
    path = str(tmp_path / "det.pt")
    jyp.save_torch_state_dict(jdet, path)

    det = YoloV8Detector.load(path, imgsz=64, conf=0.0, device="cpu")
    assert (det.model.nc, det.model.scale, det.model.fused) == (1, "n", False)
    x = _images(2, 64, seed)
    with torch.no_grad():
        got = det.model(torch.from_numpy(x))
    _logits_close(got, jdet.model.apply(jdet.variables, jnp.asarray(x), train=False))

    frames = np.random.default_rng(seed).integers(0, 256, (3, 64, 64), dtype=np.uint8)
    np.testing.assert_allclose(
        det.detect(torch.from_numpy(frames)).numpy(), np.asarray(jdet.detect(frames)), rtol=0, atol=LOGIT_ATOL
    )


def test_export_state_dict_of_trained_checkpoint_equals_jax(tmp_path):
    jdet = JaxDetector.load(str(CHECKPOINT), imgsz=416)
    want = jyp.export_state_dict(jdet.variables, reg_max=jdet.model.reg_max)
    det = YoloV8Detector.load(str(CHECKPOINT), imgsz=416, device="cpu")
    got = typ.export_state_dict(det.model.state_dict(), reg_max=det.model.reg_max)
    assert list(sorted(got)) == list(sorted(want))
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype and got[k].shape == np.asarray(want[k]).shape, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)

    # the port's .pt of it loads in JAX, and round-trips in the port bit for bit
    path = str(tmp_path / "trained.pt")
    typ.save_torch_state_dict(det, path)
    back = jyp.load_ultralytics_checkpoint(path, imgsz=(416, 416))
    for (pa, va), (pb, vb) in zip(
        jax.tree_util.tree_leaves_with_path(_jax_variables_np(jdet)),
        jax.tree_util.tree_leaves_with_path(_jax_variables_np(back)),
    ):
        assert pa == pb
        np.testing.assert_array_equal(va, vb)
    mine = YoloV8Detector.load(path, imgsz=416, device="cpu").model.state_dict()
    for k, v in det.model.state_dict().items():
        assert torch.equal(mine[k], v), k


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_port_saved_npz_loads_in_jax(tmp_path, fuse):
    det = YoloV8Detector.init_random(nc=1, scale="n", imgsz=64, seed=4, device="cpu")
    if fuse:
        det = det.fuse()
    path = str(tmp_path / "det.npz")
    det.save(path)
    jdet = JaxDetector.load(path, imgsz=64)
    assert (jdet.model.nc, jdet.model.scale) == (1, "n")
    state = yolov8_from_flax(_jax_variables_np(jdet))
    mine = {k: v for k, v in det.model.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert set(mine) == {k for k in state if not k.endswith("num_batches_tracked")}
    for k, v in mine.items():
        assert torch.equal(state[k], v), k
    # and the port reads its own file back as it wrote it
    again = YoloV8Detector.load(path, imgsz=64, device="cpu").model
    assert again.fused == fuse
    for k, v in det.model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def _reference_network(seed: int) -> TorchYoloV8:
    """The independent ultralytics-layout network with random weights and
    BatchNorm statistics."""
    torch.manual_seed(seed)
    ref = TorchYoloV8(nc=1, scale="n").eval()
    with torch.no_grad():
        for mod in ref.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.weight.uniform_(0.5, 1.5)
                mod.bias.normal_(0, 0.1)
                mod.running_mean.normal_(0, 0.1)
                mod.running_var.uniform_(0.5, 1.5)
    return ref


@pytest.mark.parametrize("layout", ["plain", "model_key", "model_model_prefix"])
def test_reference_network_loads_through_port_state_dict(tmp_path, layout):
    ref = _reference_network(5)
    sd = ref.state_dict()  # "model.{i}.*"
    obj = {
        "plain": sd,
        "model_key": {"model": sd},
        "model_model_prefix": {f"model.{k}": v for k, v in sd.items()},
    }[layout]
    path = str(tmp_path / "ref.pt")
    torch.save(obj, path)
    det = YoloV8Detector.load(path, imgsz=64, device="cpu")

    x = _images(2, 64, 6)
    with torch.no_grad():
        want_box, want_cls = ref(torch.from_numpy(x).permute(0, 3, 1, 2))
        got_box, got_cls = det.model(torch.from_numpy(x))
    for g, w in zip([*got_box, *got_cls], [*want_box, *want_cls]):
        np.testing.assert_allclose(g.numpy(), w.permute(0, 2, 3, 1).numpy(), rtol=0, atol=LOGIT_ATOL)

    # port_state_dict itself: the same keys as the model, the JAX mapping
    state = typ.port_state_dict(sd)
    assert set(state) == set(det.model.state_dict())
    want = yolov8_from_flax(jax.tree.map(np.asarray, jyp.port_state_dict({k: v.numpy() for k, v in sd.items()})))
    for k, v in want.items():
        assert torch.equal(state[k], v), k


def test_whole_module_pickle_and_other_objects_refuse(tmp_path):
    module_pt = tmp_path / "whole.pt"
    torch.save(_reference_network(0), module_pt)
    with pytest.raises(ValueError, match=r"whole\.pt.*not a plain state dict"):
        YoloV8Detector.load(str(module_pt), device="cpu")
    wrapped = tmp_path / "wrapped.pt"
    torch.save({"model": _reference_network(0), "epoch": 3}, wrapped)
    with pytest.raises(ValueError, match="wrapped.pt"):
        YoloV8Detector.load(str(wrapped), device="cpu")
    mixed = tmp_path / "mixed.pt"
    torch.save({"model.0.conv.weight": torch.zeros(1), "note": 3}, mixed)
    with pytest.raises(ValueError, match="expected a state dict"):
        YoloV8Detector.load(str(mixed), device="cpu")


def test_export_refuses_fused_weights():
    det = YoloV8Detector.init_random(nc=1, scale="n", imgsz=64, device="cpu").fuse()
    with pytest.raises(ValueError, match="unfused"):
        typ.export_state_dict(det.model.state_dict())


@pytest.mark.parametrize("imgsz", [64, 96])
def test_decode_predictions_equals_jax(imgsz):
    rng = np.random.default_rng(imgsz)
    box = [rng.normal(0, 2, (2, imgsz // s, imgsz // s, 64)).astype(np.float32) for s in (8, 16, 32)]
    cls = [rng.normal(0, 2, (2, imgsz // s, imgsz // s, 1)).astype(np.float32) for s in (8, 16, 32)]
    want_b, want_s = jax_decode([jnp.asarray(b) for b in box], [jnp.asarray(c) for c in cls], (imgsz, imgsz))
    got_b, got_s = decode_predictions([torch.from_numpy(b) for b in box], [torch.from_numpy(c) for c in cls], (imgsz, imgsz))
    assert got_b.shape == want_b.shape and got_s.shape == want_s.shape
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0, atol=1e-6)


def test_raw_equals_jax(tmp_path):
    jdet = JaxDetector.init_random(nc=1, scale="n", imgsz=(64, 64), seed=2)
    path = str(tmp_path / "det.npz")
    jdet.save(path)
    det = YoloV8Detector.load(path, imgsz=64, device="cpu")
    frames = np.random.default_rng(2).integers(0, 256, (2, 50, 60), dtype=np.uint8)
    want_b, want_s = jdet.raw(frames)
    got_b, got_s = det.raw(torch.from_numpy(frames))
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 7])
def test_init_random_is_flax_init(seed):
    jdet = JaxDetector.init_random(nc=1, scale="n", imgsz=(64, 64), seed=seed)
    want = yolov8_from_flax(_jax_variables_np(jdet))
    det = YoloV8Detector.init_random(nc=1, scale="n", imgsz=64, seed=seed, device="cpu")
    got = det.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=INIT_ATOL, err_msg=k)
    # the kernels are Flax's draws, not zeros or torch's uniform init
    assert float(got["b0.conv.weight"].abs().max()) > 0.3
    assert float(got["head.cv3_0_2.bias"][0]) == float(np.float32(-4.595))
    x = _images(1, 64, seed)
    with torch.no_grad():
        out = det.model(torch.from_numpy(x))
    _logits_close(out, jdet.model.apply(jdet.variables, jnp.asarray(x), train=False))
