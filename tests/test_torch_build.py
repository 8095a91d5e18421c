"""The kernel libraries' names follow everything a build reads.

``ops/_build.py`` names each library by a hash, so that a checkout rebuilds
what changed and reuses what did not: the hash must change with the
kernel's source, with any header in ``csrc/`` and with the compiler flags
(include paths among them), and with nothing else."""

from wtracker_tpu_torch.ops import _build


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
