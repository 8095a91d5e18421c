"""The int8 convolution (K2) against the JAX package's.

Reference: ``wtracker_tpu/models/yolov8_int8.py`` (``_conv_s8``,
``_quant`` and the epilogues of ``_ApplyOps.convbn`` / ``plain_conv``).  On
the CPU the wrapper runs the plain version: its int32 accumulators must
equal ``jax.lax.conv_general_dilated``'s exactly at every shape the walker
gives it (1x1 and 3x3, stride 1 and 2, Cin = 3, Cout = 1, channel slices);
its ``logits`` and ``silu_q`` outputs must equal JAX's epilogue run op by op
exactly.  XLA's compiled epilogue contracts the scale and bias into one fused
multiply-add, so against JAX's jitted epilogue the int8 outputs may differ
by ±1 where the float32 value sits on a rounding boundary: every mismatch
must be ±1 and at most 1 % of the outputs.  The packed weights the CUDA
kernel reads are checked by redoing its word arithmetic in numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wtracker_tpu.models.yolov8 import _silu as jax_silu
from wtracker_tpu.models.yolov8_int8 import _conv_s8 as jax_conv_s8
from wtracker_tpu.models.yolov8_int8 import _quant as jax_quant
from wtracker_tpu_torch.ops.conv_s8 import conv_s8, conv_s8_reference, pack_weights, quant

torch.set_num_threads(2)

JIT_MISMATCH_SHARE = 0.01

# (N, H, W, Cin, Cout, k, stride): the walker's kinds of layer at small widths
SHAPES = [
    (3, 64, 64, 3, 16, 3, 2),  # b0: Cin = 3, K = 27
    (2, 32, 32, 16, 32, 3, 2),  # downsampling 3x3
    (2, 16, 16, 32, 32, 1, 1),  # C2f cv1
    (2, 16, 16, 16, 16, 3, 1),  # bottleneck 3x3
    (2, 8, 8, 48, 64, 1, 1),  # C2f cv2 over a concat
    (2, 8, 8, 64, 1, 1, 1),  # class head: Cout = 1
    (1, 5, 7, 12, 5, 3, 2),  # odd sizes, Cout not a multiple of 4
    (2, 4, 4, 512, 8, 3, 1),  # deep reduction: K = 4,608
]


def _data(shape, seed):
    n, h, w, cin, cout, k, _ = shape
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (n, h, w, cin)).astype(np.int8)
    wt = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    # y = acc·sw of a few units: acc has a spread of about √K·127²/3
    sw = (rng.uniform(0.5, 1.5, cout) * 3 / (np.sqrt(k * k * cin) * 127**2 / 3)).astype(np.float32)
    b = rng.normal(0, 2, cout).astype(np.float32)
    return x, wt, sw, b


def _jax_epilogue(acc, sw, b, s_out):
    """``_ApplyOps.convbn``'s epilogue on given accumulators."""
    y = acc.astype(jnp.float32) * jnp.asarray(sw, jnp.float32)
    return jax_quant(jax_silu(y + jnp.asarray(b, jnp.float32)), s_out)


def _jax_logits(acc, sw, b):
    y = acc.astype(jnp.float32) * jnp.asarray(sw, jnp.float32)
    return (y + jnp.asarray(b, jnp.float32)).astype(jnp.bfloat16)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_accumulators_equal_jax(shape):
    x, wt, _, _ = _data(shape, 0)
    stride = shape[-1]
    want = np.asarray(jax_conv_s8(jnp.asarray(x), jnp.asarray(wt), stride))
    got = conv_s8(torch.from_numpy(x), torch.from_numpy(wt), stride, "acc")
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_epilogues_equal_jax_op_by_op(shape):
    x, wt, sw, b = _data(shape, 1)
    stride, s_out = shape[-1], 0.037
    acc = jax_conv_s8(jnp.asarray(x), jnp.asarray(wt), stride)
    args = (torch.from_numpy(x), torch.from_numpy(wt), stride)
    with jax.disable_jit():
        want_q = np.asarray(_jax_epilogue(acc, sw, b, s_out))
        want_l = np.asarray(_jax_logits(acc, sw, b).astype(jnp.float32))
    got_q = conv_s8(*args, "silu_q", torch.from_numpy(sw), torch.from_numpy(b), s_out)
    got_l = conv_s8(*args, "logits", torch.from_numpy(sw), torch.from_numpy(b))
    assert got_q.dtype == torch.int8 and got_l.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_l.float().numpy(), want_l)
    assert np.abs(want_q.astype(int)).max() > 10  # the scales reach well into int8


@pytest.mark.parametrize("shape", SHAPES[:5], ids=lambda s: "x".join(map(str, s)))
def test_silu_q_against_jitted_jax_differs_by_one_at_most(shape):
    x, wt, sw, b = _data(shape, 2)
    stride, s_out = shape[-1], 0.037
    want = np.asarray(jax.jit(lambda a: _jax_epilogue(a, sw, b, s_out))(jax_conv_s8(jnp.asarray(x), jnp.asarray(wt), stride)))
    got = conv_s8(torch.from_numpy(x), torch.from_numpy(wt), stride, "silu_q", torch.from_numpy(sw), torch.from_numpy(b), s_out)
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= JIT_MISMATCH_SHARE, f"{(diff > 0).sum()} of {diff.size} outputs differ by 1"


def test_input_channel_slice_is_read_in_place():
    """C2f's split hands a bottleneck a channel slice of a wider tensor."""
    x, wt, _, _ = _data((2, 9, 9, 16, 8, 3, 1), 3)
    wide = np.concatenate([x, x[..., ::-1]], axis=-1)
    part = torch.from_numpy(wide)[..., 16:]
    assert not part.is_contiguous() and part.stride(-1) == 1
    want = np.asarray(jax_conv_s8(jnp.asarray(wide[..., 16:]), jnp.asarray(wt), 1))
    np.testing.assert_array_equal(conv_s8(part, torch.from_numpy(wt), 1, "acc").numpy(), want)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_packed_words_give_the_accumulators(shape):
    """The kernel's arithmetic, redone in numpy: per tap and group of 4 input
    channels, the 4 byte products of an activation word and a packed weight
    word (``__dp4a``), summed; zero-padded channels and taps contribute 0."""
    x, wt, _, _ = _data(shape, 4)
    n, h, w, cin, cout, k, stride = shape
    pad = k // 2
    cg = -(-cin // 4)
    words = pack_weights(torch.from_numpy(wt))
    assert words.dtype == torch.int32 and tuple(words.shape) == (k * k * cg, cout) and words.is_contiguous()
    wb = words.numpy().view(np.int8).reshape(k, k, cg, cout, 4).astype(np.int64)
    xp = np.zeros((n, h + 2 * pad, w + 2 * pad, cg * 4), np.int64)
    xp[:, pad : pad + h, pad : pad + w, :cin] = x
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    acc = np.zeros((n, ho, wo, cout), np.int64)
    for kh in range(k):
        for kw in range(k):
            patch = xp[:, kh : kh + stride * ho : stride, kw : kw + stride * wo : stride].reshape(n, ho, wo, cg, 4)
            acc += np.einsum("nyxgb,gcb->nyxc", patch, wb[kh, kw])
    np.testing.assert_array_equal(acc, conv_s8_reference(torch.from_numpy(x), torch.from_numpy(wt), stride).numpy())


def test_quant_matches_jax():
    y = np.random.default_rng(5).normal(0, 3, 4096).astype(np.float32)
    y[:4] = [0.5 * 0.1, 1.5 * 0.1, -2.5 * 0.1, 1e6]  # halves and a clip
    for scale in (0.1, 0.037, 1.0 / 3.0):
        np.testing.assert_array_equal(quant(torch.from_numpy(y), scale).numpy(), np.asarray(jax_quant(jnp.asarray(y), scale)))


def test_wrapper_refuses_what_the_kernel_cannot_take():
    x, wt, sw, b = (torch.from_numpy(a) for a in _data((1, 8, 8, 8, 4, 3, 1), 6))
    with pytest.raises(ValueError, match="NHWC int8"):
        conv_s8(x.float(), wt)
    with pytest.raises(ValueError, match="1x1 or 3x3"):
        conv_s8(x, torch.zeros((5, 5, 8, 4), dtype=torch.int8))
    with pytest.raises(ValueError, match="takes 8 channels"):
        conv_s8(x[..., :4], wt)
    with pytest.raises(ValueError, match="stride"):
        conv_s8(x, wt, 3)
    with pytest.raises(ValueError, match="epilogue"):
        conv_s8(x, wt, 1, "relu")
    with pytest.raises(ValueError, match="sw must be"):
        conv_s8(x, wt, 1, "logits", sw.double(), b)
    with pytest.raises(ValueError, match="s_out"):
        conv_s8(x, wt, 1, "silu_q", sw, b)
    before = conv_s8.launches
    conv_s8(x, wt, 1, "logits", sw, b)
    assert conv_s8.launches == before  # the plain version launches nothing
