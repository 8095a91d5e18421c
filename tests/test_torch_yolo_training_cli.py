"""The port's ``yolo_training`` command against the JAX package's script.

Reference: ``workflows/yolo_training.py``, whose ``main()`` runs
in-process with a patched ``sys.argv``; the port's command runs as a
subprocess (``PYTHONPATH`` set, ``--device cpu``).  YOLOv8n at 64 px over
ten PNGs, 2 epochs with augmentation on (mosaic in both): the written
``.npz`` against JAX's, and the files the run leaves.  Both run in float32,
from each package's own fresh init (the port's is Flax's init to 2.4e-7),
so the weights carry XLA:CPU's float32 BatchNorm-sum error
(``tests/test_torch_yolo_training.py``) and Adam's sign steps on gradients
that cancel to near zero: they are held to rtol 1e-4 and an atol of half
an Adam step at lr 1e-3 (measured: 2.6e-4 beyond rtol·|w| at most).  The
script's ``model.init`` runs under ``jax.jit`` here (26 s eagerly on the
CPU against 5 s compiled; the draws are the same threefry).
"""

import json
from pathlib import Path

import numpy as np

import flax.linen as nn
import jax

from tests.test_torch_training_cli import _assert_npz_close, _jax_main, _port
from wtracker_tpu.models.yolov8 import YoloV8
from wtracker_tpu_torch.utils import image_codec

DETECTOR_ATOL = 5e-4


def _blob_dataset(root: Path, n: int = 10, size: int = 64):
    rng = np.random.default_rng(8)
    (root / "images").mkdir()
    (root / "labels").mkdir()
    for i in range(n):
        img = rng.integers(0, 50, (size, size), dtype=np.uint8)
        cx, cy = rng.integers(14, size - 14, size=2)
        w, h = rng.integers(8, 18, size=2)
        img[cy - h // 2 : cy + h // 2, cx - w // 2 : cx + w // 2] = 220
        image_codec.imwrite(str(root / "images" / f"im{i:02d}.png"), img)
        (root / "labels" / f"im{i:02d}.txt").write_text(f"0 {cx / size} {cy / size} {(w // 2) * 2 / size} {(h // 2) * 2 / size}\n")


def _jitted_init(self, rngs, *args, **kwargs):
    return jax.jit(lambda r, *a: nn.Module.init(self, r, *a, **kwargs))(rngs, *args)


def test_yolo_training_cli(tmp_path, monkeypatch):
    _blob_dataset(tmp_path)
    monkeypatch.setattr(YoloV8, "init", _jitted_init)
    args = ["--images", str(tmp_path / "images"), "--labels", str(tmp_path / "labels"), "--scale", "n",
            "--imgsz", "64", "--epochs", "2", "--batch", "4", "--close-mosaic", "0", "--seed", "1"]
    _jax_main("yolo_training", [*args, "--output", str(tmp_path / "jax" / "det.npz")], monkeypatch)
    out = _port("yolo_training", [*args, "--output", str(tmp_path / "port" / "det.npz"),
                                  "--export-torch", str(tmp_path / "port" / "det.pt")])
    assert "weights saved" in out
    for name in ("det.npz", "best.npz", "last.npz", "train_state.json"):
        assert (tmp_path / "port" / name).exists(), name
    _assert_npz_close(tmp_path / "port" / "det.npz", tmp_path / "jax" / "det.npz", rtol=1e-4, atol=DETECTOR_ATOL)
    meta = json.loads((tmp_path / "port" / "train_state.json").read_text())
    assert meta == {**json.loads((tmp_path / "jax" / "train_state.json").read_text()), "best_map": meta["best_map"]}
