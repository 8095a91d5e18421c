"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and ``nvcc`` (the kernels are built at first
use) and skip elsewhere.  The file imports nothing of JAX, so it also runs
on a machine without it: ``python -m pytest --noconftest
tests/test_torch_kernels_cuda.py``.
"""

import ctypes
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
