"""Nothing the benchmark runs imports JAX, Flax or the JAX package, and the
plain reference imports nothing of the port.  Module names are compared by
their whole top-level name: ``wtracker_tpu_torch`` begins with
``wtracker_tpu`` and must not count as it."""

import subprocess
import sys
import textwrap

from tiny_cell import REPO

from benchmark.run import FORBIDDEN, forbidden_modules


def _child(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True, text=True, cwd=REPO,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO / "benchmark" / "tests")})
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_top_level_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "wtracker_tpu_torch_lookalike", sys)
    assert "wtracker_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert forbidden_modules() == ["jaxlib"]
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "wtracker_tpu"}


def test_a_run_loads_no_jax():
    """A whole run of each configuration's loop (tiny, on the CPU), then the
    process's modules."""
    line = _child("""
        import tiny_cell
        for cell in ("loop-s96.yolov8s-416-bf16", "loop-s96.yolov8s-416-int8", "mixed-s90.yolov8s-416-bf16"):
            tiny_cell.run_tiny(cell)
        import sys
        from benchmark.run import forbidden_modules
        print(sorted(forbidden_modules()), "wtracker_tpu_torch" in sys.modules)
    """)
    assert line == "[] True"


def test_reference_imports_nothing_of_the_port():
    line = _child("""
        import tiny_cell, sys
        import benchmark.check, benchmark.reference.loop, benchmark.reference.render, benchmark.reference.yolo
        print(sorted({m.split(".")[0] for m in sys.modules} & {"wtracker_tpu_torch", "wtracker_tpu", "jax"}))
    """)
    assert line == "[]"
