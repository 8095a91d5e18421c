"""The detector's bias + SiLU pass (``ops/bias_silu.py``) on the CPU.

The kernel itself runs only on the card (``tests/test_torch_kernels_cuda.py``).
Here: a BN-fused ``ConvBN`` on the CPU keeps its eager form bit for bit
(every parity test against the JAX package runs through it), the wrapper's
refusals (a CPU tensor among them) and the plain version's arithmetic (the
kernel's entry in the build table: ``tests/test_torch_build.py``)."""

import pytest
import torch

from wtracker_tpu_torch.models.yolov8 import ConvBN, YoloV8, _silu
from wtracker_tpu_torch.ops import bias_silu
from wtracker_tpu_torch.ops.bias_silu import bias_silu_, bias_silu_reference, layout

DTYPES = [torch.float32, torch.bfloat16]


def _fused(cin=8, cout=16, k=3, stride=1, dtype=torch.float32, seed=0):
    torch.manual_seed(seed)
    m = ConvBN(cin, cout, k, stride, fused=True)
    with torch.no_grad():
        m.conv.bias.normal_(0.0, 1.0)
    return m.to(dtype).eval()


@pytest.mark.parametrize("grad", ["enabled", "no_grad", "inference_mode"])
@pytest.mark.parametrize("memory_format", [torch.contiguous_format, torch.channels_last])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_fused_convbn_on_the_cpu_is_the_eager_form_bit_for_bit(dtype, memory_format, grad):
    m = _fused(dtype=dtype, stride=2)
    x = (torch.randn(2, 8, 13, 11) * 3).to(dtype).contiguous(memory_format=memory_format)
    ctx = {"enabled": torch.enable_grad, "no_grad": torch.no_grad, "inference_mode": torch.inference_mode}[grad]
    before = bias_silu_.launches
    with ctx():
        got = m(x)
        want = _silu(m.conv(x))
    assert bias_silu_.launches == before
    assert got.dtype == dtype and torch.equal(got, want)


def test_whole_detector_on_the_cpu_launches_nothing():
    model = YoloV8(nc=1, scale="n", fused=True).eval()
    before = bias_silu_.launches
    with torch.inference_mode():
        model(torch.rand(1, 64, 64, 3))
    assert bias_silu_.launches == before


@pytest.mark.parametrize("memory_format", [torch.contiguous_format, torch.channels_last])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_plain_version_is_float32_inside(dtype, memory_format):
    """The plain version adds the bias and takes SiLU in float32, one
    rounding to the tensor's dtype; in float32 that is the eager form's
    arithmetic exactly.  It leaves its input as it was."""
    torch.manual_seed(1)
    x = (torch.randn(3, 24, 7, 5) * 4).to(dtype).contiguous(memory_format=memory_format)
    x0 = x.clone()
    b = torch.randn(24).to(dtype)
    y = x.float() + b.float().view(1, -1, 1, 1)
    want = _silu(y).to(dtype)
    assert torch.equal(bias_silu_reference(x, b), want)
    if dtype == torch.float32:
        assert torch.equal(want, _silu(x + b.view(-1, 1, 1)))
    assert torch.equal(x, x0)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_wrapper_has_no_cpu_path(dtype):
    """A CPU tensor it could otherwise take is refused, left as it was: the
    CPU keeps ``ConvBN``'s eager form."""
    x = torch.ones(2, 3, 4, 5, dtype=dtype)
    before = bias_silu_.launches
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        bias_silu_(x, torch.zeros(3, dtype=dtype))
    assert bias_silu_.launches == before and torch.equal(x, torch.ones(2, 3, 4, 5, dtype=dtype))


@pytest.mark.parametrize("memory_format", [torch.contiguous_format, torch.channels_last])
def test_wrapper_refuses_a_tensor_not_16_byte_aligned(memory_format):
    """The kernel takes 16-byte vectors from the first element on; a view
    that starts one element into its storage is refused before any device
    check."""
    n, c, h, w = 2, 3, 4, 5
    flat = torch.zeros(n * c * h * w + 1)[1:]
    x = flat.view(n, h, w, c).permute(0, 3, 1, 2) if memory_format == torch.channels_last else flat.view(n, c, h, w)
    assert x.data_ptr() % 16 and layout(x) is not None
    with pytest.raises(ValueError, match="16-byte aligned"):
        bias_silu_(x, torch.zeros(c))


def test_layout_names_the_two_dense_forms():
    x = torch.zeros(2, 3, 4, 5)
    assert layout(x) == "contiguous"
    assert layout(x.contiguous(memory_format=torch.channels_last)) == "channels_last"
    assert layout(x[:, :, :, ::2]) is None
    assert layout(torch.zeros(2, 4, 3, 5).permute(0, 2, 1, 3)) is None  # dense, neither form
    assert layout(torch.zeros(3, 4, 5)) is None


def test_wrapper_refuses_what_the_kernel_cannot_take():
    b = torch.zeros(3)
    x = torch.zeros(2, 3, 4, 5)
    before = bias_silu_.launches
    for bad in (
        x[:, :, :, ::2],  # not dense
        torch.zeros(2, 4, 3, 5).permute(0, 2, 1, 3),  # dense, permuted, not channels-last
        x.permute(0, 1, 3, 2),  # dense, permuted, not channels-last
        torch.zeros(3, 4, 5),  # not 4-D
    ):
        with pytest.raises(ValueError, match="dense channels-last or NCHW-contiguous"):
            bias_silu_(bad, b)
    for dtype in (torch.float16, torch.float64, torch.int32):
        with pytest.raises(ValueError, match="must be one of"):
            bias_silu_(x.to(dtype), b.to(dtype))
    for bias in (torch.zeros(4), torch.zeros(2), torch.zeros(1, 3), torch.zeros(3, dtype=torch.bfloat16),
                 torch.zeros(6)[::2]):
        with pytest.raises(ValueError, match="bias must be"):
            bias_silu_(x, bias)
    with pytest.raises(ValueError, match="at most"):
        bias_silu_(torch.zeros(1, bias_silu.MAX_CHANNELS + 1, 1, 1), torch.zeros(bias_silu.MAX_CHANNELS + 1))
    assert bias_silu_.launches == before
    assert torch.equal(x, torch.zeros(2, 3, 4, 5))
