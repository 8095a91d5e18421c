"""The port stands alone: no module of ``wtracker_tpu_torch`` (nor
``chip_smoke.py``, ``sweep_band_rows.py`` and ``sweep_conv_s8.py``) imports JAX, Flax, Optax or the JAX package, neither in
its source nor when imported; and importing the port loads no OpenCV, which
a GPU host need not have.  OpenCV and tqdm (the card's host has neither) are
imported only inside the functions that write an image or show a progress
bar, and every module imports on a Python where both are missing."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "wtracker_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "wtracker_tpu")
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__") for p in PKG.rglob("*.py")
)


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_package_has_the_slice_modules():
    want = {
        "wtracker_tpu_torch", "wtracker_tpu_torch.convert", "wtracker_tpu_torch.utils.config_base",
        "wtracker_tpu_torch.sim.config", "wtracker_tpu_torch.sim.motor", "wtracker_tpu_torch.neural.config",
        "wtracker_tpu_torch.ops.image", "wtracker_tpu_torch.ops.preproc", "wtracker_tpu_torch.ops._build",
        "wtracker_tpu_torch.models.yolov8", "wtracker_tpu_torch.models.resmlp", "wtracker_tpu_torch.sim.engine",
        "wtracker_tpu_torch.sim.engine_live", "wtracker_tpu_torch.sim.engine_video",
        "wtracker_tpu_torch.sim.synthetic", "wtracker_tpu_torch.runtime.native",
        "wtracker_tpu_torch.utils.frame_reader", "wtracker_tpu_torch.utils.path_utils",
        "wtracker_tpu_torch.workflows.track_video", "wtracker_tpu_torch.ops.polyfit",
        "wtracker_tpu_torch.utils.bbox", "wtracker_tpu_torch.sim.engine_hetero",
        "wtracker_tpu_torch.sim.controllers", "wtracker_tpu_torch.sim.controllers.polyfit",
        "wtracker_tpu_torch.workflows.simulate", "wtracker_tpu_torch.workflows.sweep",
        "wtracker_tpu_torch.ops.conv_s8", "wtracker_tpu_torch.models.yolov8_int8",
        "wtracker_tpu_torch.workflows.quantize_detector", "wtracker_tpu_torch.utils.flax_init",
        "wtracker_tpu_torch.models.yolo_port", "wtracker_tpu_torch.sim.simulator", "wtracker_tpu_torch.sim.view",
        "wtracker_tpu_torch.sim.controllers.csv", "wtracker_tpu_torch.sim.controllers.optimal",
        "wtracker_tpu_torch.sim.controllers.logging", "wtracker_tpu_torch.sim.controllers.mlp",
        "wtracker_tpu_torch.sim.controllers.yolo", "wtracker_tpu_torch.utils.log_utils",
        "wtracker_tpu_torch.utils.threading_utils", "wtracker_tpu_torch.utils.io_utils",
    }
    assert want <= set(MODULES)
    assert (PKG / "csrc" / "crop_letterbox.cu").is_file()
    assert (PKG / "csrc" / "conv_s8.cu").is_file()
    assert (PKG / "runtime" / "frame_loader.cpp").is_file()


@pytest.mark.parametrize(
    "path", [*sorted(PKG.rglob("*.py")), *(ROOT / f for f in ("chip_smoke.py", "sweep_band_rows.py", "sweep_conv_s8.py"))],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad = [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            bad = [node.module] if node.level == 0 and node.module and _forbidden(node.module) else []
        else:
            continue
        assert not bad, f"{path.relative_to(ROOT)}:{node.lineno} imports {bad}"


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r} + ('cv2',))\n"
        "print('LOADED', bad)\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LOADED []" in out.stdout


OPTIONAL = ("cv2", "tqdm")


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT)))
def test_optional_packages_are_imported_inside_functions(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in tree.body:  # module level only: imports inside functions are lazy
        if isinstance(node, ast.Import):
            bad = [a.name for a in node.names if a.name.split(".")[0] in OPTIONAL]
        elif isinstance(node, ast.ImportFrom):
            bad = [node.module] if node.module and node.module.split(".")[0] in OPTIONAL else []
        else:
            continue
        assert not bad, f"{path.relative_to(ROOT)}:{node.lineno} imports {bad} at module level"


def test_every_module_imports_without_opencv_and_tqdm():
    code = (
        "import importlib, sys\n"
        f"for m in {OPTIONAL!r}: sys.modules[m] = None  # import of it raises ImportError\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "print('IMPORTED')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "IMPORTED" in out.stdout
