"""The port's ``yolo_training --dp`` command on the CPU.

Reference: ``workflows/yolo_training.py --dp`` trains over every device of
a JAX mesh, and its result is the one-device run's (XLA partitions the
global step).  The port's command starts its ranks itself (``--dp-ranks
2``: two gloo ranks on the CPU) and must give what it gives without
``--dp``: YOLOv8n at 64 px over ten PNGs (8 to train, batch 4: two steps an
epoch), 2 epochs with augmentation and mosaic on, the written ``.npz``
against the one-process run's at ``tests/test_torch_yolo_training_cli.py``'s
float32 bars (rtol 1e-4, half an Adam step: the two runs round their
float32 sums apart, and Adam's first step moves a weight whose gradient
cancels to near zero by ``lr`` either way), each epoch logged once (rank 0
alone reports), the same files written.  Every process runs on two
threads.
"""

import re

from tests.test_torch_training_cli import _assert_npz_close, _port
from tests.test_torch_yolo_training_cli import DETECTOR_ATOL, _blob_dataset


def test_yolo_training_dp_equals_one_process(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    _blob_dataset(tmp_path)
    args = ["--images", str(tmp_path / "images"), "--labels", str(tmp_path / "labels"), "--scale", "n",
            "--imgsz", "64", "--epochs", "2", "--batch", "4", "--close-mosaic", "0", "--seed", "1"]
    one = _port("yolo_training", [*args, "--output", str(tmp_path / "one" / "det.npz")])
    dp = _port("yolo_training", [*args, "--output", str(tmp_path / "dp" / "det.npz"), "--dp", "--dp-ranks", "2"])
    assert "data-parallel over 2 ranks on cpu, cpu" in dp
    assert [m.group(1) for m in re.finditer(r"^epoch (\d+): loss", dp, re.M)] == ["0", "1"]
    for name in ("det.npz", "best.npz", "last.npz", "train_state.json", "train_state.pt"):
        assert (tmp_path / "dp" / name).exists(), name
    _assert_npz_close(tmp_path / "dp" / "det.npz", tmp_path / "one" / "det.npz", rtol=1e-4, atol=DETECTOR_ATOL)
    assert "epoch 0: loss" in one
