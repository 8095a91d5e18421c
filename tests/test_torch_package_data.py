"""An installed port carries the sources it compiles at first use.

``ops/_build.py`` compiles ``csrc/<name>.cu`` for each kernel of its
``SIGNATURES`` and ``runtime/native.py`` compiles ``frame_loader.cpp``; a
wheel holds a non-Python file only where a ``[tool.setuptools.package-data]``
glob of ``pyproject.toml`` matches it, so each of those files must be
matched."""

import tomllib
from fnmatch import fnmatchcase
from pathlib import Path

import pytest

from wtracker_tpu_torch.ops import _build
from wtracker_tpu_torch.runtime import native

ROOT = Path(__file__).resolve().parent.parent
SOURCES = sorted(
    {_build.CSRC / f"{name}.cu" for name in _build.SIGNATURES}
    | {native._SRC}
    | {p for p in _build.CSRC.iterdir() if p.suffix in (".cu", ".cuh", ".h")}
)


def _package_data() -> dict[str, list[str]]:
    with open(ROOT / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["tool"]["setuptools"]["package-data"]


def _covered(path: Path, package_data: dict[str, list[str]]) -> bool:
    rel = path.relative_to(ROOT)
    for package, globs in package_data.items():
        pkg_dir = Path(*package.split("."))
        if pkg_dir not in rel.parents:
            continue
        inside = rel.relative_to(pkg_dir).as_posix()
        if any(fnmatchcase(inside, g) for g in globs):
            return True
    return False


def test_the_build_reads_the_kernels_it_signs():
    names = {p.stem for p in SOURCES if p.suffix == ".cu"}
    assert {"crop_letterbox", "conv_s8"} <= names
    assert set(_build.SIGNATURES) <= names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_every_compiled_source_is_package_data(path):
    assert path.is_file()
    assert _covered(path, _package_data()), f"no package-data glob of pyproject.toml matches {path.relative_to(ROOT)}"


def test_an_unlisted_file_is_not_covered():
    """The matcher itself: a source outside every glob is reported."""
    assert not _covered(ROOT / "wtracker_tpu_torch" / "runtime" / "native.py", _package_data())
    assert not _covered(native._SRC, {"wtracker_tpu_torch": ["csrc/*.cu"]})
