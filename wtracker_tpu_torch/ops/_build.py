"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``.  Libraries go to
``wtracker_tpu_torch/_build/`` (listed in ``.gitignore``) under a name that
carries a hash of the source, the headers and the flags, so an edited source
or header is rebuilt and an unchanged one is built once per checkout.  Building happens at first use, never at
import: machines without ``nvcc`` import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from functools import cache
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signature of each kernel's entry point: (argtypes, restype).  Pointers and
# the stream are c_void_p: the default int conversion would cut them to 32 bits.
SIGNATURES = {
    "crop_letterbox": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P], _I),
    "conv_s8": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _I, _I, _I, _I, _I, _F, _I, _I, _P], _I),
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library goes: the name carries a hash of its
    source, of every header in ``csrc/`` (any of them may be included) and
    of the compiler flags, include paths among them."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names=tuple(SIGNATURES)) -> dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Returns each built source's compiler output (``-Xptxas -v``
    register and shared-memory report); raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    logs, failed = {}, []
    for name, (proc, tmp) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}:\n{logs[name]}")
        else:
            os.replace(tmp, library_path(name))  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


@cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    path = library_path(name)
    if not path.exists():
        build_all((name,))
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = SIGNATURES[name]
    return lib
