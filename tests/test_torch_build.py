"""The kernel libraries' names follow everything a build reads.

``ops/_build.py`` names each library by a hash, so that a checkout rebuilds
what changed and reuses what did not: the hash must change with the
kernel's source, with any header in ``csrc/`` and with the compiler flags
(include paths among them), and with nothing else."""

import re

from wtracker_tpu_torch.ops import _build
from wtracker_tpu_torch.ops.bias_silu import MAX_CHANNELS


def _sources(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "tile.cuh"\n')
    (csrc / "tile.cuh").write_text("constexpr int kTile = 64;\n")
    (csrc / "other.cu").write_text("// another kernel\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    return csrc


def test_library_path_follows_source_headers_and_flags(tmp_path, monkeypatch):
    csrc = _sources(tmp_path, monkeypatch)
    first = _build.library_path("k")
    assert first == _build.library_path("k") and first.parent == tmp_path / "_build"
    (csrc / "other.cu").write_text("// edited\n")
    assert _build.library_path("k") == first  # another kernel's source is not read
    (csrc / "tile.cuh").write_text("constexpr int kTile = 128;\n")
    after_header = _build.library_path("k")
    assert after_header != first
    (csrc / "k.cu").write_text('#include "tile.cuh"\n// edited\n')
    after_source = _build.library_path("k")
    assert after_source not in (first, after_header)
    monkeypatch.setattr(_build, "NVCC_FLAGS", [*_build.NVCC_FLAGS, "-I/usr/local/cutlass/include"])
    assert _build.library_path("k") != after_source


def test_a_new_header_rebuilds(tmp_path, monkeypatch):
    csrc = _sources(tmp_path, monkeypatch)
    first = _build.library_path("k")
    (csrc / "extra.cuh").write_text("// new\n")
    assert _build.library_path("k") != first


def test_every_kernel_has_a_signature_and_a_source():
    for name, (argtypes, restype) in _build.SIGNATURES.items():
        assert (_build.CSRC / f"{name}.cu").is_file()
        assert argtypes[-1] is _build._P and restype is _build._I  # the stream last; the CUDA error back
    # conv_s8: x, wp, sw, bias, out, then shape, strides, options, the plan (bn, split), the stream
    assert len(_build.SIGNATURES["conv_s8"][0]) == 21


def test_a_sources_own_flags_name_only_its_library(tmp_path, monkeypatch):
    """``EXTRA_FLAGS`` (K3's ``--fmad=false``) go into that kernel's command
    line and hash, and into no other kernel's."""
    _sources(tmp_path, monkeypatch)
    k, other = _build.library_path("k"), _build.library_path("other")
    monkeypatch.setattr(_build, "EXTRA_FLAGS", {"k": ["--fmad=false"]})
    assert _build.flags("k")[-1] == "--fmad=false" and "--fmad=false" not in _build.flags("other")
    assert _build.library_path("k") != k and _build.library_path("other") == other


def test_polyfit_kernel_rounds_every_product_on_its_own():
    assert "--fmad=false" in _build.flags("polyfit_f64")
    # the form, x, y, w, out, then batch, n, m, k, the plan (tile, tiles), the cutoff factor (a double), the
    # general form's workspace, the wave form's table, its rows and entries and the held columns, the stream
    args = _build.SIGNATURES["polyfit_f64"][0]
    assert args[0] is _build._I and args[11] is _build._D and len(args) == 18
    assert args[12:14] == [_build._P] * 2 and args[14:17] == [_build._I] * 3 and args[17] is _build._P
    assert 'extern "C" int polyfit_f64(int form,' in (_build.CSRC / "polyfit_f64.cu").read_text()


def test_bias_silu_entry_and_its_mirrored_limit():
    """x, bias, the element count (64-bit), C, H*W, the layout, the dtype, the
    SM count, the stream; the wrapper's channel limit mirrors the source's."""
    args, restype = _build.SIGNATURES["bias_silu"]
    assert args == [_build._P, _build._P, _build._L] + [_build._I] * 5 + [_build._P] and restype is _build._I
    src = (_build.CSRC / "bias_silu.cu").read_text()
    assert 'extern "C" int bias_silu(void* x, const void* bias, long long n, int C, int HW,' in src
    assert int(re.search(r"constexpr int kMaxChannels = (\d+);", src).group(1)) == MAX_CHANNELS
    # the accurate tanhf, not the approximate instruction: same mathematics, not lower precision
    assert "tanhf(h)" in src and 'asm(' not in src and "--use_fast_math" not in _build.flags("bias_silu")
