"""The command's refusals: without a CUDA card it prints no result and exits
non-zero; so it does in a directory that holds only ``BENCHMARK.json`` and
the benchmark's files (the port absent)."""

import shutil
import subprocess
import sys

import pytest
from tiny_cell import REPO

CMD = [sys.executable, "-m", "benchmark.run", "--workload", "loop-s96.yolov8s-416-bf16", "--seed", str(2**33 + 1),
       "--seconds", "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run(CMD, capture_output=True, text=True, cwd=cwd, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    out = _run(REPO)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_benchmark_files_alone_fail(tmp_path):
    """Past the card's check (a run on the CPU), the run needs the port and
    the checkpoint, which such a directory lacks."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import json, sys; from benchmark import run; c = run.cell_files(sys.argv[1]);"
            " print(json.dumps(run.run_cell(*c, 1, 1.0, False, device='cpu')))")
    out = subprocess.run([sys.executable, "-c", code, CMD[4]], capture_output=True, text=True, cwd=tmp_path,
                         timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "ModuleNotFoundError" in out.stderr or "FileNotFoundError" in out.stderr


@pytest.mark.cuda
def test_a_run_on_the_card(tmp_path):
    """On the card: a short run of the first cell prints its result line."""
    import json

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(CMD[:-3] + ["5", "--trace", "0"], capture_output=True, text=True, cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
