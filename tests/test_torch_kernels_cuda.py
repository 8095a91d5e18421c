"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and ``nvcc`` (the kernels are built at first
use) and skip elsewhere.  The file imports nothing of JAX, so it also runs
on a machine without it: ``python -m pytest --noconftest
tests/test_torch_kernels_cuda.py``.
"""

import ctypes
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from wtracker_tpu_torch.ops.preproc import crop_letterbox_reference, crop_letterbox_views

H, W, CAM, IMGSZ = 1430, 1671, 360, 416  # the video loop's frame, camera and detector sizes
C = 32
DTYPES = [(torch.float32, 2e-6), (torch.bfloat16, 0.01)]


@pytest.fixture(scope="module")
def chunk():
    """A seeded (C, H, W) uint8 chunk on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(0, 256, (C, H, W), dtype=np.uint8)).cuda()


def _views(rng, n, cam, c=C):
    """n crop origins whose x covers every residue mod 16, with the first view
    at (0, 0) and the last on the chunk's last frame at (W - cam, H - cam),
    which reads the chunk's last byte."""
    x = rng.integers(0, W - cam + 1, n)
    x = np.clip(x - x % 16 + np.arange(n) % 16, 0, W - cam)
    tls = np.stack([x, rng.integers(0, H - cam + 1, n)], axis=1)
    idx = rng.integers(0, c, n)
    tls[0] = (0, 0)
    tls[-1], idx[-1] = (W - cam, H - cam), c - 1
    return torch.from_numpy(idx.astype(np.int32)).cuda(), torch.from_numpy(tls.astype(np.int32)).cuda()


def _check(frames, idx, tls, cam, imgsz, dtype, atol):
    before = crop_letterbox_views.launches
    got = crop_letterbox_views(frames, idx, tls, cam, imgsz, out_dtype=dtype)
    torch.cuda.synchronize()
    assert crop_letterbox_views.launches == before + 1
    assert got.shape == (len(idx), imgsz, imgsz, 3) and got.dtype == dtype
    want = crop_letterbox_reference(frames, idx, tls, cam, imgsz, out_dtype=dtype)
    assert (got.float() - want.float()).abs().max().item() <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("n", [12, 3], ids=["imaging", "moving"])
@pytest.mark.parametrize("dtype, atol", DTYPES, ids=["f32", "bf16"])
def test_crop_letterbox_matches_plain_version(chunk, n, dtype, atol):
    """At the loop's shapes, crops at both far corners of the frame included."""
    _check(chunk, *_views(np.random.default_rng(n), n, CAM), CAM, IMGSZ, dtype, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("cam, imgsz", [(360, 416), (48, 64), (480, 416)], ids=["deploy", "up", "down"])
@pytest.mark.parametrize("n", [1, 3, 12, 64])
@pytest.mark.parametrize("dtype, atol", DTYPES, ids=["f32", "bf16"])
def test_crop_letterbox_shapes_counts_and_residues(chunk, cam, imgsz, n, dtype, atol):
    """Every crop origin residue mod 16 (each source row has its own shift
    into its 16-byte-aligned staging), and the chunk's last byte."""
    _check(chunk, *_views(np.random.default_rng(n + cam), n, cam), cam, imgsz, dtype, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 7, 15])
@pytest.mark.parametrize("dtype, atol", DTYPES, ids=["f32", "bf16"])
def test_crop_letterbox_on_a_chunk_view_not_16_byte_aligned(chunk, offset, dtype, atol):
    """``frames`` as a view that starts ``offset`` bytes into an allocation:
    the 16-byte copies that would cross its ends are read byte by byte."""
    flat = chunk.view(-1)
    frames = flat[offset : offset + (C - 1) * H * W].view(C - 1, H, W)
    assert frames.data_ptr() % 16 != 0
    _check(frames, *_views(np.random.default_rng(offset), 16, CAM, c=C - 1), CAM, IMGSZ, dtype, atol)


@pytest.mark.cuda
def test_crop_letterbox_refuses_what_it_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    frames = torch.zeros((2, 64, 64), dtype=torch.uint8, device="cuda")
    idx = torch.zeros(1, dtype=torch.int32, device="cuda")
    tls = torch.zeros((1, 2), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="one device"):
        crop_letterbox_views(frames, idx.cpu(), tls, 32, 48)
    with pytest.raises(ValueError, match="contiguous"):
        crop_letterbox_views(frames[:, :, :48], idx, tls, 32, 48)


def _guarded_chunk(c: int) -> torch.Tensor:
    """A (c, H, W) uint8 chunk on the card whose last byte is the last byte
    of mapped device memory: the page after it is reserved and never mapped,
    so any read past the chunk's end is an illegal address.  Mapped with
    cuMemAddressReserve, cuMemCreate and cuMemMap; the process keeps the
    mapping until it exits."""
    cu = ctypes.CDLL("libcuda.so.1")
    torch.zeros(1, device="cuda")  # makes the primary context current
    dev = torch.cuda.current_device()

    class Location(ctypes.Structure):
        _fields_ = [("type", ctypes.c_int), ("id", ctypes.c_int)]

    class Prop(ctypes.Structure):  # CUmemAllocationProp
        _fields_ = [
            ("type", ctypes.c_int), ("handle_types", ctypes.c_int), ("location", Location),
            ("win32_meta", ctypes.c_void_p), ("compression", ctypes.c_ubyte), ("rdma", ctypes.c_ubyte),
            ("usage", ctypes.c_ushort), ("reserved", ctypes.c_ubyte * 4),
        ]

    class Access(ctypes.Structure):  # CUmemAccessDesc
        _fields_ = [("location", Location), ("flags", ctypes.c_int)]

    def check(rc, what):
        if rc:
            raise RuntimeError(f"{what} failed with CUresult {rc}")

    device_loc = Location(1, dev)  # CU_MEM_LOCATION_TYPE_DEVICE
    prop = Prop(type=1, location=device_loc)  # CU_MEM_ALLOCATION_TYPE_PINNED
    gran = ctypes.c_size_t()
    check(cu.cuMemGetAllocationGranularity(ctypes.byref(gran), ctypes.byref(prop), 0), "cuMemGetAllocationGranularity")
    nbytes = c * H * W
    mapped = -(-nbytes // gran.value) * gran.value
    va, handle = ctypes.c_uint64(), ctypes.c_uint64()
    check(cu.cuMemAddressReserve(ctypes.byref(va), ctypes.c_size_t(mapped + gran.value), ctypes.c_size_t(0),
                                 ctypes.c_uint64(0), ctypes.c_uint64(0)), "cuMemAddressReserve")
    check(cu.cuMemCreate(ctypes.byref(handle), ctypes.c_size_t(mapped), ctypes.byref(prop), ctypes.c_uint64(0)),
          "cuMemCreate")
    check(cu.cuMemMap(va, ctypes.c_size_t(mapped), ctypes.c_size_t(0), handle, ctypes.c_uint64(0)), "cuMemMap")
    access = Access(device_loc, 3)  # CU_MEM_ACCESS_FLAGS_PROT_READWRITE
    check(cu.cuMemSetAccess(va, ctypes.c_size_t(mapped), ctypes.byref(access), ctypes.c_size_t(1)), "cuMemSetAccess")

    chunk = _uint8_at(va.value + mapped - nbytes, (c, H, W))
    assert chunk.data_ptr() == va.value + mapped - nbytes
    return chunk


def _uint8_at(ptr: int, shape: tuple) -> torch.Tensor:
    """A uint8 tensor over device memory at ``ptr``, not copied."""
    interface = {"shape": shape, "typestr": "|u1", "data": (ptr, False), "version": 3, "strides": None}
    return torch.as_tensor(type("DeviceBytes", (), {"__cuda_array_interface__": interface})(), device="cuda")


def _guard_run(mode: str) -> int:
    """Child process of the test below: crops of each checked shape and both
    output types on the guarded chunk, the last view at (W - cam, H - cam)
    of its last frame, against the plain version on a copy.  ``control``
    hands the kernel a chunk that starts 16 bytes later, so that its last 16
    bytes lie past the mapping: that run must fault."""
    c = 4
    chunk = _guarded_chunk(c)
    rng = np.random.default_rng(1)
    chunk.copy_(torch.from_numpy(rng.integers(0, 256, (c, H, W), dtype=np.uint8)))
    copy = chunk.clone()
    if mode == "control":
        chunk = _uint8_at(chunk.data_ptr() + 16, (c, H, W))
    for cam, imgsz in [(360, 416), (48, 64), (480, 416)]:
        for dtype, atol in DTYPES:
            idx, tls = _views(rng, 16, cam, c=c)
            got = crop_letterbox_views(chunk, idx, tls, cam, imgsz, out_dtype=dtype)
            torch.cuda.synchronize()
            want = crop_letterbox_reference(copy, idx, tls, cam, imgsz, out_dtype=dtype)
            err = (got.float() - want.float()).abs().max().item()
            if not err <= atol:
                raise AssertionError(f"{cam}->{imgsz} {dtype}: max error {err}")
    print("guarded chunk: no fault, outputs match")
    return 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["kernel", "control"])
def test_crop_letterbox_reads_nothing_past_the_chunk(mode):
    """The kernel on a chunk whose end is the end of mapped memory does not
    fault, while the control, the kernel told that the chunk reaches 16 bytes
    further, does.  Run in a child process: a fault ends the process's CUDA
    context."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [str(root), os.environ.get("PYTHONPATH")]))}
    proc = subprocess.run([sys.executable, __file__, mode], env=env, capture_output=True, text=True, timeout=600)
    if mode == "kernel":
        assert proc.returncode == 0, proc.stderr[-3000:]
    else:
        assert proc.returncode != 0 and "illegal memory access" in proc.stderr, (proc.returncode, proc.stderr[-3000:])


if __name__ == "__main__":
    sys.exit(_guard_run(sys.argv[1]))


# ---------------------------------------------------------------------------
# K2: the int8 convolution with its fused epilogue
# ---------------------------------------------------------------------------

# (N, H, W, Cin, Cout, k, stride): YOLOv8s@416's kinds of layer at N = 2,
# odd sizes, Cout = 1 and 5, and the deepest reduction (K = 4,608); split-K
# over a cluster at 13x13 (K = 2,304 and 4,608); spatial sizes 1 and 7 at
# stride 2; Cout = 8 and 24 (the narrowest tile, and a tile wider than
# Cout); Cin = 16, aligned but not a TMA box's 32 channels (byte gather)
CONV_SHAPES = [
    (2, 416, 416, 3, 32, 3, 2),
    (2, 208, 208, 32, 64, 3, 2),
    (2, 104, 104, 64, 64, 1, 1),
    (2, 104, 104, 32, 32, 3, 1),
    (2, 52, 52, 128, 1, 1, 1),
    (2, 13, 13, 512, 512, 3, 1),
    (3, 9, 7, 12, 5, 3, 2),
    (12, 13, 13, 256, 256, 3, 1),
    (12, 13, 13, 512, 128, 3, 1),
    (2, 1, 1, 32, 32, 3, 2),
    (2, 7, 7, 64, 64, 3, 2),
    (2, 20, 20, 32, 8, 3, 1),
    (2, 20, 20, 64, 24, 1, 1),
    (2, 9, 11, 16, 32, 3, 1),
]


def _conv_data(shape, seed):
    n, h, w, cin, cout, k, _ = shape
    rng = np.random.default_rng(seed)
    dev = "cuda"
    x = torch.from_numpy(rng.integers(-127, 128, (n, h, w, cin)).astype(np.int8)).to(dev)
    wt = torch.from_numpy(rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)).to(dev)
    sw = torch.from_numpy((rng.uniform(0.5, 1.5, cout) * 9 / (np.sqrt(k * k * cin) * 127**2)).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.normal(0, 2, cout).astype(np.float32)).to(dev)
    return x, wt, sw, b


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CONV_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("epilogue", ["acc", "logits", "silu_q"])
def test_conv_s8_matches_plain_version(shape, epilogue):
    """``acc`` and ``logits`` bit for bit; ``silu_q`` bit for bit too (the
    kernel rounds each operation as the plain version's torch operations do;
    only a tanhf that differs between nvcc's and torch's CUDA math library
    could move a value by 1, and the bar allows no such case here)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from wtracker_tpu_torch.ops.conv_s8 import conv_s8, conv_s8_reference, pack_weights

    x, wt, sw, b = _conv_data(shape, 0)
    stride = shape[-1]
    before = conv_s8.launches
    got = conv_s8(x, wt, stride, epilogue, sw, b, 0.037, wp=pack_weights(wt))
    torch.cuda.synchronize()
    assert conv_s8.launches == before + 1
    want = conv_s8_reference(x, wt, stride, epilogue, sw, b, 0.037)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_conv_s8_reads_a_channel_slice_in_place():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from wtracker_tpu_torch.ops.conv_s8 import conv_s8, conv_s8_reference, pack_weights

    x, wt, _, _ = _conv_data((2, 52, 52, 64, 64, 3, 1), 1)
    wide = torch.cat([x, x.flip(-1)], dim=-1)
    # 16-byte aligned (TMA boxes), and not (byte gathers)
    for part in (wide[..., 64:], wide[..., 1:65], wide[..., 8:72]):
        got = conv_s8(part, wt, 1, "acc", wp=pack_weights(wt))
        torch.cuda.synchronize()
        assert torch.equal(got, conv_s8_reference(part.contiguous(), wt, 1, "acc"))


@pytest.mark.cuda
def test_conv_s8_refuses_what_it_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from wtracker_tpu_torch.ops.conv_s8 import conv_s8, pack_weights

    x, wt, sw, b = _conv_data((1, 8, 8, 8, 4, 3, 1), 2)
    with pytest.raises(ValueError, match="on cpu"):
        conv_s8(x, wt.cpu())
    with pytest.raises(ValueError, match="packed form"):
        conv_s8(x, wt, 1, "acc", wp=pack_weights(wt)[:-1])
    with pytest.raises(ValueError, match="packed weights"):
        conv_s8(x, wt, 1, "acc")
    before = conv_s8.launches
    with pytest.raises(ValueError, match="packed form"):
        conv_s8(x, wt, 1, "acc", wp=pack_weights(wt).view(torch.int32))
    with pytest.raises(ValueError, match="NHWC int8"):
        conv_s8(x.to(torch.uint8), wt, 1, "acc", wp=pack_weights(wt))
    assert conv_s8.launches == before


# -- K3: the float64 polyfit ----------------------------------------------------

POLYFIT_TIMES = {5: [-15.0, -10.0, -5.0, 0.0, 3.0], 8: [-30.0, -25.0, -20.0, -15.0, -10.0, -5.0, 0.0, 3.0],
                 11: list(np.arange(-40.0, 1.0, 4.0)), 16: list(np.arange(-60.0, 1.0, 4.0))}


def _polyfit_data(name: str, deg: int, n: int, m: int = 2, p: int = 0):
    """Seeded (x, y, w) on the card: the engine's and the swarm's sample
    times, a track with noise, and zeroed, masked or batched weights."""
    rng = np.random.default_rng([deg, n, m, p, sum(map(ord, name))])
    x = np.array(POLYFIT_TIMES[n])
    y = 180 + 2.5 * x[:, None] + 0.1 * x[:, None] ** 2 + rng.normal(0, 3, (n, m))
    w = rng.uniform(0.0, 1.0, (p, n)) if p else rng.uniform(0.2, 2.0, n)
    if name == "y_1d":
        y = y[:, 0]
    elif name == "zero_weights":
        w[..., [1, 3]] = 0.0
    elif name == "all_masked":  # the engine's cycle with no valid sample
        w[...] = 0.0
        y[...] = 0.0
        y[::2] = -0.0
    elif name == "rank_deficient":
        w[..., 2:] = 0.0
    return tuple(torch.from_numpy(a).cuda() for a in (x, y, w))


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int64), b.view(torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 8])
@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4, 5, 7])
@pytest.mark.parametrize("name", ["y_2d", "y_1d", "zero_weights", "all_masked", "rank_deficient"])
def test_polyfit_kernel_equals_plain_version_bit_for_bit(name, deg, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from wtracker_tpu_torch.ops.polyfit import polyfit, polyfit_reference

    x, y, w = _polyfit_data(name, deg, n)
    before = polyfit.launches
    got = polyfit(x, y, deg, w)
    torch.cuda.synchronize()
    assert polyfit.launches == before + 1
    assert _same_bits(got, polyfit_reference(x, y, deg, w))


@pytest.mark.cuda
@pytest.mark.parametrize("p, m", [(1, 1), (3, 2), (100, 7993)], ids=["one", "few", "swarm"])
@pytest.mark.parametrize("name", ["y_2d", "zero_weights", "rank_deficient"])
def test_polyfit_kernel_batched_weightings_bit_for_bit(name, p, m):
    """The swarm's batch: P weightings of the same samples, M columns."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from wtracker_tpu_torch.ops.polyfit import polyfit, polyfit_reference

    x, y, w = _polyfit_data(name, 2, 8, m=m, p=p)
    got = polyfit(x, y, 2, w)
    torch.cuda.synchronize()
    assert got.shape == (p, 3, m) and _same_bits(got, polyfit_reference(x, y, 2, w))
    assert _same_bits(polyfit(x, y, 2, None), polyfit_reference(x, y, 2, None))


@pytest.mark.cuda
def test_polyfit_on_the_card_never_runs_the_plain_version(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    tp = importlib.import_module("wtracker_tpu_torch.ops.polyfit")  # the package's ``polyfit`` name is the function

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(tp, "polyfit_reference", refuse)
    x, y, w = _polyfit_data("y_2d", 2, 5)
    before = tp.polyfit.launches
    tp.polyfit(x, y, 2, w)
    assert tp.polyfit(x, y, 8, w).shape == (9, 2) and tp.polyfit(x, y, 12, w).shape == (13, 2)  # K3's wave form
    assert tp.polyfit.launches == before + 3
    with pytest.raises(ValueError, match="w must be"):
        tp.polyfit(x, y, 2, w[:4])
    torch.cuda.synchronize()


def _polyfit_plan(p: int, n: int, deg: int, m: int):
    from wtracker_tpu_torch.ops.polyfit import plan

    return plan(p, n, deg + 1, m, torch.cuda.get_device_properties(0).multi_processor_count)


def _check_polyfit(x, y, deg, w):
    from wtracker_tpu_torch.ops.polyfit import polyfit, polyfit_reference

    before = polyfit.launches
    got = polyfit(x, y, deg, w)
    torch.cuda.synchronize()
    assert polyfit.launches == before + 1  # one launch whatever the grid
    assert torch.isfinite(got).all() and _same_bits(got, polyfit_reference(x, y, deg, w))


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [-1, 0, 1, 4 * 224 + 1], ids=["below", "at", "above", "five_tiles"])
def test_polyfit_kernel_around_a_column_tile_bit_for_bit(extra):
    """M below, at and just above one column a column thread (224: one
    tile), and into a fifth tile, at the swarm's P=100 weightings."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from wtracker_tpu_torch.ops.polyfit import KERNEL_COL_THREADS

    m = KERNEL_COL_THREADS + extra
    x, y, w = _polyfit_data("y_2d", 2, 8, m=m, p=100)
    assert _polyfit_plan(100, 8, 2, m).tiles == (1 if extra <= 0 else 2 if extra == 1 else 5)
    _check_polyfit(x, y, 2, w)


@pytest.mark.cuda
@pytest.mark.parametrize("p, m", [(1, 7993), (1000, 2)], ids=["one_weighting_wide", "many_weightings_narrow"])
def test_polyfit_kernel_extreme_batches_bit_for_bit(p, m):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, y, w = _polyfit_data("y_2d", 2, 8, m=m, p=p)
    assert _polyfit_plan(p, 8, 2, m).blocks == p * (36 if m == 7993 else 1)
    _check_polyfit(x, y, 2, w)


@pytest.mark.cuda
@pytest.mark.parametrize("deg", range(8))
def test_polyfit_kernel_at_the_shared_memory_limit_bit_for_bit(deg):
    """N = 6,144 / (deg + 1): the scaled rows fill the 48 KB the wrapper
    allows; integral sample times around 0, two weightings, three columns."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    n = 6144 // (deg + 1)
    rng = np.random.default_rng([deg, n])
    t = np.arange(n, dtype=np.float64) - n // 2
    y = 180 + 0.05 * t[:, None] + rng.normal(0, 3, (n, 3))
    w = rng.uniform(0.0, 1.0, (2, n))
    w[1, ::3] = 0.0
    _check_polyfit(*(torch.from_numpy(a).cuda() for a in (t, y)), deg, torch.from_numpy(w).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["zero_weights", "all_masked", "rank_deficient"])
def test_polyfit_kernel_edge_cases_over_several_tiles_bit_for_bit(name):
    """Zeroed, all-masked (signed zeros in y) and rank-deficient weightings,
    P=4 of them, 2,000 columns split over several tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, y, w = _polyfit_data(name, 2, 8, m=2000, p=4)
    assert _polyfit_plan(4, 8, 2, 2000).tiles > 1
    _check_polyfit(x, y, 2, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [11, 16])
@pytest.mark.parametrize("deg", range(8, 16))
@pytest.mark.parametrize("name", ["y_2d", "y_1d", "zero_weights", "all_masked", "rank_deficient"])
def test_polyfit_general_form_equals_plain_version_bit_for_bit(name, deg, n):
    """deg 8-15 (the wave form since it took them from the general form),
    11 and 16 samples: full rank, fewer samples than terms, zeroed, all
    masked."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from wtracker_tpu_torch.ops.polyfit import plan

    x, y, w = _polyfit_data(name, deg, n)
    assert plan(1, n, deg + 1, 2).form == "wave"
    _check_polyfit(x, y, deg, w)


@pytest.mark.cuda
@pytest.mark.parametrize("deg, n, m, p", [(2, 20_000, 3, 2), (8, 1_000, 5, 3), (0, 7_000, 2, 1)])
def test_polyfit_general_form_beyond_the_register_rows_bit_for_bit(deg, n, m, p):
    """N·(deg + 1) beyond the register form's 6,144 (the wave form takes
    them): integral sample times around 0, the rows recomputed where they
    are read, each thread's sums in shared memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from wtracker_tpu_torch.ops.polyfit import KERNEL_GENERAL_ROWS

    assert 8 * n * (deg + 2) > KERNEL_GENERAL_ROWS and _polyfit_plan(p, n, deg, m).form == "wave"
    rng = np.random.default_rng([deg, n])
    t = np.arange(n, dtype=np.float64) - n // 2
    y = 180 + 0.05 * t[:, None] + rng.normal(0, 3, (n, m))
    w = rng.uniform(0.0, 1.0, (p, n))
    w[-1, ::3] = 0.0
    _check_polyfit(*(torch.from_numpy(a).cuda() for a in (t, y)), deg, torch.from_numpy(w).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("workspace", [False, True], ids=["shared", "workspace"])
@pytest.mark.parametrize("deg", [0, 2, 7, 8])
def test_polyfit_forced_general_form_bit_for_bit(deg, workspace):
    """The general form through the wrapper's internal entry at small K,
    its matrices in shared memory or in the global workspace, at the
    swarm's batch (P=100 over 2,000 columns) with every edge case."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    tp = importlib.import_module("wtracker_tpu_torch.ops.polyfit")

    x, y, w = _polyfit_data("y_2d", deg, 8, m=2000, p=100)
    w[1, [1, 3]] = 0.0
    w[2] = 0.0
    w[3, 2:] = 0.0
    grid = tp.plan(100, 8, deg + 1, 2000, torch.cuda.get_device_properties(0).multi_processor_count, workspace)
    assert grid.form == "general" and grid.tiles > 1 and (grid.workspace > 0) == workspace
    before = tp.polyfit.launches
    got = tp._polyfit_kernel(x, y, deg, w, workspace=workspace)
    torch.cuda.synchronize()
    assert tp.polyfit.launches == before + 1
    assert _same_bits(got, tp.polyfit_reference(x, y, deg, w))
    if tp.register_form(8, deg + 1):  # the register form, where polyfit routes it, on the same inputs: the same bits
        assert _same_bits(tp.polyfit(x, y, deg, w), got)


@pytest.mark.cuda
@pytest.mark.parametrize("deg", range(8))
def test_polyfit_wave_form_below_deg_8_bit_for_bit(deg):
    """The wave form below deg 8 over 2,000 columns (their right-hand sides
    held beside the Jacobi) with every edge case: deg 4-7 at the swarm's
    batch (P=100 of N=8), deg 0-3 with N just beyond the register form's
    48 KB of rows (P=4), where ``plan`` routes them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    tp = importlib.import_module("wtracker_tpu_torch.ops.polyfit")

    if deg >= 4:
        x, y, w = _polyfit_data("y_2d", deg, 8, m=2000, p=100)
    else:
        n = tp.KERNEL_REGISTER_ROWS // (8 * (deg + 1)) + 1
        rng = np.random.default_rng([deg, n])
        x = torch.arange(n, dtype=torch.float64, device="cuda") - n // 2
        y = 180 + 0.05 * x[:, None] + torch.from_numpy(rng.normal(0, 3, (n, 2000))).cuda()
        w = torch.from_numpy(rng.uniform(0.0, 1.0, (4, n))).cuda()
    w[1, [1, 3]] = 0.0
    w[2] = 0.0
    w[3, 2:] = 0.0
    y[::2, :7] = -0.0
    p = w.shape[0]
    grid = tp.plan(p, x.shape[0], deg + 1, 2000, torch.cuda.get_device_properties(0).multi_processor_count)
    assert grid.form == "wave" and grid.tiles > 1 and 0 < grid.hold <= grid.tile
    before = tp.polyfit.launches
    got = tp.polyfit(x, y, deg, w)
    torch.cuda.synchronize()
    assert tp.polyfit.launches == before + 1
    assert _same_bits(got, tp.polyfit_reference(x, y, deg, w))


@pytest.mark.cuda
@pytest.mark.parametrize("deg", [8, 12])
def test_polyfit_wave_form_beyond_its_held_columns_bit_for_bit(deg):
    """P=100 over 7,993 columns: a block holds the right-hand sides of only
    its first columns beside the Jacobi and forms the rest after it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, y, w = _polyfit_data("zero_weights", deg, 16, m=7993, p=100)
    grid = _polyfit_plan(100, 16, deg, 7993)
    assert grid.form == "wave" and 0 < grid.hold < grid.tile
    _check_polyfit(x, y, deg, w)


@pytest.mark.cuda
@pytest.mark.parametrize("deg, n", [(40, 64), (71, 80)], ids=["k41_shared", "k72_workspace"])
def test_polyfit_general_form_at_large_degrees_bit_for_bit(deg, n):
    """K beyond a warp's 32 lanes: the Jacobi's lanes take several entries
    each; at K = 72 the matrices leave shared memory for the workspace
    without being asked to."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng([deg, n])
    t = np.arange(n, dtype=np.float64) - n // 2
    y = 180 + 0.05 * t[:, None] + rng.normal(0, 3, (n, 3))
    w = rng.uniform(0.2, 2.0, (2, n))
    w[1, ::4] = 0.0
    grid = _polyfit_plan(2, n, deg, 3)
    assert grid.form == "general" and (grid.workspace > 0) == (deg + 1 == 72)
    _check_polyfit(*(torch.from_numpy(a).cuda() for a in (t, y)), deg, torch.from_numpy(w).cuda())


# -- K4: the detector's bias + SiLU pass ----------------------------------------

CHECKPOINT = Path(__file__).resolve().parent.parent / "models" / "yolov8s_worm416.npz"
# the detector's shapes, views cut to a few: b2.cv1 and b0 (the largest), the
# 26 x 26 and 13 x 13 levels (H*W = 676 and 169: NCHW vectors straddle two
# channels), and 105 elements (C and H*W odd: a scalar tail after the vectors)
BIAS_SILU_SHAPES = [(4, 64, 104, 104), (2, 32, 208, 208), (3, 256, 26, 26), (3, 512, 13, 13), (1, 5, 7, 3)]
LAYOUTS = [torch.channels_last, torch.contiguous_format]


def _bias_silu_data(shape, dtype, memory_format, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(shape, generator=g, device="cuda") * 4).to(dtype).contiguous(memory_format=memory_format)
    b = (torch.randn(shape[1], generator=g, device="cuda") * 2).to(dtype)
    return x, b


def _silu_f32(x, b):
    """The pass in float32 on the card, before its one rounding."""
    y = x.float() + b.float().view(1, -1, 1, 1)
    return 0.5 * y * (torch.tanh(0.5 * y) + 1.0)


def _check_bias_silu(x, b):
    from wtracker_tpu_torch.ops.bias_silu import bias_silu_

    want = _silu_f32(x, b)
    before, ptr, strides = bias_silu_.launches, x.data_ptr(), x.stride()
    got = bias_silu_(x, b)
    torch.cuda.synchronize()
    assert bias_silu_.launches == before + 1
    assert got is x and x.data_ptr() == ptr and x.stride() == strides  # in place
    if x.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    else:  # within one bf16 ulp of the float32 value (bf16 keeps 8 significant bits)
        _, exp = torch.frexp(want)
        assert ((got.float() - want).abs() <= torch.ldexp(torch.ones_like(want), exp - 8)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BIAS_SILU_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("memory_format", LAYOUTS, ids=["channels_last", "nchw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bias_silu_matches_float32_version(shape, memory_format, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _check_bias_silu(*_bias_silu_data(shape, dtype, memory_format, sum(shape)))


@pytest.mark.cuda
def test_bias_silu_refuses_what_it_cannot_take_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from wtracker_tpu_torch.ops.bias_silu import bias_silu_

    x, b = _bias_silu_data((1, 8, 4, 4), torch.bfloat16, torch.channels_last, 3)
    before = bias_silu_.launches
    with pytest.raises(ValueError, match="bias must be"):
        bias_silu_(x, b.cpu())
    with pytest.raises(ValueError, match="dense channels-last or NCHW-contiguous"):
        bias_silu_(x[:, :, :, :2], b)
    # a view one element into its storage: the kernel's vectors need 16-byte alignment
    flat = torch.zeros(x.numel() + 1, dtype=x.dtype, device="cuda")[1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        bias_silu_(flat.view(1, 4, 4, 8).permute(0, 3, 1, 2), b)
    assert bias_silu_.launches == before


def _worm_views(n, seed):
    """n rendered 360 px camera views of the synthetic worm on the card."""
    from wtracker_tpu_torch.sim.synthetic import SyntheticScene

    g = torch.Generator(device="cuda").manual_seed(seed)
    worms = 600 + 400 * torch.rand(n, 2, generator=g, device="cuda")
    tls = worms - 180 + 120 * (torch.rand(n, 2, generator=g, device="cuda") - 0.5)
    return SyntheticScene().render_views(worms, tls, (360, 360), torch.arange(n, device="cuda"))


def _head_rel_err(program, reference):
    """The benchmark's ``head_rel_err``: ||program - reference|| over the
    reference's spread about each output channel's mean."""
    num = den = 0.0
    for p, r in zip(program[0] + program[1], reference[0] + reference[1]):
        r = r.detach().double()
        num += float(((p.detach().double() - r) ** 2).sum())
        den += float(((r - r.mean(dim=(0, 1, 2))) ** 2).sum())
    return (num / den) ** 0.5


@pytest.mark.cuda
def test_detector_runs_each_fused_epilogue_through_bias_silu():
    """57 launches a standard forward, 56 a folded one (b0 is the folded
    stem's), none with autograd on; the heads within a third of the tighter
    bf16 cell's ``head_rel_err`` limit (0.06) of the eager form's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from wtracker_tpu_torch.models.yolov8 import YoloV8Detector, make_folded_detect, preprocess_batch
    from wtracker_tpu_torch.ops.bias_silu import bias_silu_

    model = YoloV8Detector.load(str(CHECKPOINT), imgsz=416, device="cuda").fuse().to(torch.bfloat16).model
    views = _worm_views(12, 0)
    x, _ = preprocess_batch(views.round().to(torch.uint8), (416, 416), dtype=torch.bfloat16)
    before = bias_silu_.launches
    with torch.inference_mode():
        fused = model(x)
    assert bias_silu_.launches - before == 57
    with torch.enable_grad():
        eager = model(x)
    assert bias_silu_.launches - before == 57
    assert _head_rel_err(fused, eager) <= 0.06 / 3
    detect = make_folded_detect(model, (360, 360), (416, 416))
    with torch.inference_mode():
        detect(model, views, None, 0.1)
    assert bias_silu_.launches - before == 57 + 56


@pytest.mark.cuda
def test_int8_forwards_launch_no_bias_silu():
    """Calibration, ``QuantizedYolo.apply`` and ``apply_folded``: K2 and its
    own epilogue, never the bf16 pass."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from wtracker_tpu_torch.models.yolov8 import YoloV8Detector, fold_stem_matrices, preprocess_batch
    from wtracker_tpu_torch.models.yolov8_int8 import quantize_detector
    from wtracker_tpu_torch.ops.bias_silu import bias_silu_
    from wtracker_tpu_torch.ops.conv_s8 import conv_s8

    model32 = YoloV8Detector.load(str(CHECKPOINT), imgsz=416, device="cuda").fuse().model
    views = _worm_views(4, 1)
    frames = views.round().to(torch.uint8)
    before, k2 = bias_silu_.launches, conv_s8.launches
    q = quantize_detector(model32, frames, (416, 416))
    qw = q.device_weights("cuda")
    x, _ = preprocess_batch(frames, (416, 416), dtype=torch.bfloat16)
    q.apply(qw, x)
    q.apply_folded(qw, views, fold_stem_matrices((360, 360), (416, 416), dtype=torch.bfloat16, device="cuda"))
    torch.cuda.synchronize()
    assert bias_silu_.launches == before and conv_s8.launches - k2 == 63 + 62
