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
kernel reads are checked by redoing its product in numpy, and its launch
plan at every convolution of YOLOv8s@416's int8 forward (12 and 360 views).
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wtracker_tpu.models.yolov8 import _silu as jax_silu
from wtracker_tpu.models.yolov8_int8 import _conv_s8 as jax_conv_s8
from wtracker_tpu.models.yolov8_int8 import _quant as jax_quant
from wtracker_tpu_torch.models import yolov8 as ty
from wtracker_tpu_torch.models import yolov8_int8 as ti
from wtracker_tpu_torch.ops import conv_s8 as conv_s8_module
from wtracker_tpu_torch.ops.conv_s8 import (
    BK,
    BLOCK_COLS,
    BLOCK_ROWS,
    MAX_SPLIT,
    RED_PAD,
    SMEM_LIMIT,
    SMS,
    STAGES,
    TILE_H,
    TILE_W,
    conv_s8,
    conv_s8_reference,
    pack_weights,
    plan,
    quant,
)

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


def _silu_q_mismatch_report(acc, sw, b, s_out, args, got_q, want_q) -> str:
    """What a ``silu_q`` mismatch needs to name its cause: each side's
    stages at the first differing outputs, whether each side gives its own
    bits again when run a second time, and the process state either side
    could read (threads, CPU affinity, x64, denormal flushing)."""
    with jax.disable_jit():
        jy = acc.astype(jnp.float32) * jnp.asarray(sw, jnp.float32) + jnp.asarray(b, jnp.float32)
        jh = 0.5 * jy
        jt = jnp.tanh(jh)
        jq_again = np.asarray(_jax_epilogue(acc, sw, b, s_out))
    ty_ = conv_s8(*args, "acc").float() * torch.from_numpy(sw) + torch.from_numpy(b)
    th = 0.5 * ty_
    tt = torch.tanh(th)
    tq_again = conv_s8(*args, "silu_q", torch.from_numpy(sw), torch.from_numpy(b), s_out).numpy()
    jh, jt, th, tt = (np.asarray(v, np.float32) for v in (jh, jt, th.numpy(), tt.numpy()))
    lines = [
        f"silu_q: {int((got_q != want_q).sum())} of {got_q.size} outputs differ; rerun reproduces "
        f"JAX {np.array_equal(jq_again, want_q)}, torch {np.array_equal(tq_again, got_q)}; torch threads "
        f"{torch.get_num_threads()}, CPUs {len(os.sched_getaffinity(0))}, x64 {jax.config.jax_enable_x64}, "
        f"denormals flushed {float(np.float32(1e-39) * np.float32(1)) == 0.0}"
    ]
    for i in np.argwhere(got_q != want_q)[:8]:
        i = tuple(int(v) for v in i)
        lines.append(
            f"  at {i}: acc {int(np.asarray(acc)[i])}, h {float(jh[i]).hex()} / {float(th[i]).hex()}, "
            f"tanh {float(jt[i]).hex()} / {float(tt[i]).hex()}, q {int(want_q[i])} / {int(got_q[i])} (JAX / torch)"
        )
    return "\n".join(lines)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_epilogues_equal_jax_op_by_op(shape):
    x, wt, sw, b = _data(shape, 1)
    stride, s_out = shape[-1], 0.037
    acc = jax_conv_s8(jnp.asarray(x), jnp.asarray(wt), stride)
    args = (torch.from_numpy(x), torch.from_numpy(wt), stride)
    # the stages before the SiLU, so that a mismatch below names the stage
    # that moved: the accumulators and the float32 pre-activation must be
    # equal too (the SiLU's tanh differs between XLA and torch by up to 4.5
    # ulps, which the int8 rounding absorbs on these inputs); a silu_q
    # mismatch reports each side's stages and whether each side repeats itself
    got_acc = conv_s8(*args, "acc")
    np.testing.assert_array_equal(got_acc.numpy(), np.asarray(acc), err_msg="accumulators")
    with jax.disable_jit():
        want_y = np.asarray(acc.astype(jnp.float32) * jnp.asarray(sw, jnp.float32) + jnp.asarray(b, jnp.float32))
        want_q = np.asarray(_jax_epilogue(acc, sw, b, s_out))
        want_l = np.asarray(_jax_logits(acc, sw, b).astype(jnp.float32))
    got_y = got_acc.float() * torch.from_numpy(sw) + torch.from_numpy(b)
    np.testing.assert_array_equal(got_y.numpy(), want_y, err_msg="pre-activation acc·sw + b")
    got_q = conv_s8(*args, "silu_q", torch.from_numpy(sw), torch.from_numpy(b), s_out)
    got_l = conv_s8(*args, "logits", torch.from_numpy(sw), torch.from_numpy(b))
    assert got_q.dtype == torch.int8 and got_l.dtype == torch.bfloat16
    got_q = got_q.numpy()
    if not np.array_equal(got_q, want_q):
        pytest.fail(_silu_q_mismatch_report(acc, sw, b, s_out, args, got_q, want_q))
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


PACK_CASES = [(shape, False) for shape in SHAPES] + [((2, 9, 9, 16, 8, 3, 1), True)]


@pytest.mark.parametrize(
    "shape, sliced", PACK_CASES, ids=lambda c: "x".join(map(str, c)) if isinstance(c, tuple) else ("slice" if c else "")
)
def test_packed_words_give_the_accumulators(shape, sliced):
    """The kernel's product, redone in numpy from the packed weights: each
    output pixel's im2col row (taps in ``kidx = (kh·k + kw)·Cin + ci``
    order, zero outside the image) times ``wp[:Cout, :K]``ᵀ, in int64; the
    sliced case reads its input as a channel slice of a wider tensor, as the
    kernel does through strides."""
    x, wt, _, _ = _data(shape, 4)
    n, h, w, cin, cout, k, stride = shape
    if sliced:
        xt = torch.from_numpy(np.concatenate([x[..., ::-1], x], axis=-1))[..., cin:]
        assert not xt.is_contiguous()
    else:
        xt = torch.from_numpy(x)
    pad = k // 2
    kdim = k * k * cin
    wp = pack_weights(torch.from_numpy(wt))
    assert wp.dtype == torch.int8 and wp.is_contiguous()
    assert tuple(wp.shape) == (-(-cout // 8) * 8, -(-kdim // 32) * 32)
    xp = np.zeros((n, h + 2 * pad, w + 2 * pad, cin), np.int64)
    xp[:, pad : pad + h, pad : pad + w] = xt.numpy()
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    taps = [xp[:, kh : kh + stride * ho : stride, kw : kw + stride * wo : stride] for kh in range(k) for kw in range(k)]
    rows = np.concatenate(taps, axis=-1).reshape(n * ho * wo, kdim)
    acc = rows @ wp[:cout, :kdim].numpy().astype(np.int64).T
    want = conv_s8_reference(xt, torch.from_numpy(wt), stride).numpy()
    np.testing.assert_array_equal(acc.reshape(n, ho, wo, cout), want)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_packed_weights_unpack_to_hwio_with_zero_padding(shape):
    _, wt, _, _ = _data(shape, 7)
    k, cin, cout = shape[5], shape[3], shape[4]
    wp = pack_weights(torch.from_numpy(wt)).numpy()
    kdim = k * k * cin
    np.testing.assert_array_equal(wp[:cout, :kdim].T.reshape(k, k, cin, cout), wt)
    assert not wp[cout:].any() and not wp[:, kdim:].any()


# ---------------------------------------------------------------------------
# the kernel's launch plan, at every convolution of YOLOv8s@416's int8 forward
# ---------------------------------------------------------------------------


def _forward_convs(n: int) -> list[tuple]:
    """The int8 forward's convolutions at ``n`` views, walked from the
    model's layer list (a model on the meta device: shapes, no data, so
    nothing runs on the CPU)."""
    with torch.device("meta"):
        model = ty.YoloV8(nc=1, scale="s")
    return [shape for shape, _ in ti.conv_shapes(model, n, (416, 416))]


FORWARD_VIEWS = (12, 360)


@pytest.fixture(scope="module")
def forward_convs():
    return {n: _forward_convs(n) for n in FORWARD_VIEWS}


def test_the_walker_finds_the_forward_convolutions(forward_convs):
    """63 convolutions a forward (62 after the folded stem), Cin = 3 to 512,
    Cout = 1 to 512, the deepest reduction K = 4,608."""
    for n, convs in forward_convs.items():
        assert len(convs) == 63
        assert convs[0] == (n, 416, 416, 3, 32, 3, 2)
        assert {c[3] for c in convs} >= {3, 512} and {c[4] for c in convs} >= {1, 512}
        assert max(c[5] ** 2 * c[3] for c in convs) == 4608


_RECORD_A_FORWARD = """
import json, torch
from wtracker_tpu_torch.models import yolov8 as ty, yolov8_int8 as ti
seen, conv = [], ti._conv_bf16
def record(x, w, stride=1):
    seen.append((*x.shape, w.shape[3], w.shape[0], stride))
    return conv(x, w, stride)
ti._conv_bf16 = record
ti.forward_bf16_reference(ty.YoloV8(nc=1, scale="n", fused=True).eval(), torch.zeros((2, 64, 64, 3)))
print(json.dumps(seen))
"""


def test_the_walker_sees_what_a_forward_runs():
    """The shapes walked from the layer list are those a real forward hands
    its convolutions (a fused nano detector at 64 px, 2 views).  The forward
    runs in a child process, so that the exact comparisons with JAX in this
    file do not run after it in the same process: a few ``silu_q`` outputs
    have been seen one apart after other work in one process."""
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [str(root), os.environ.get("PYTHONPATH")]))}
    proc = subprocess.run([sys.executable, "-c", _RECORD_A_FORWARD], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    seen = [tuple(c) for c in json.loads(proc.stdout.strip().splitlines()[-1])]
    with torch.device("meta"):
        model = ty.YoloV8(nc=1, scale="n", fused=True)
    walked = ti.conv_shapes(model, 2, (64, 64))
    assert seen == [shape for shape, _ in walked]
    assert [e for _, e in walked].count("logits") == 6


@pytest.mark.parametrize("views", FORWARD_VIEWS)
def test_plan_fits_every_forward_convolution(forward_convs, views):
    """Each convolution gets one launch (its K splits are the blocks of one
    cluster), a width wgmma takes, shared memory within the block's limit,
    split-K only below a wave of tiles, and a split with no empty part."""
    for shape in forward_convs[views]:
        p = plan(*shape)
        assert p.bn in BLOCK_COLS and p.bn % 8 == 0 and 8 <= p.bn <= 256, shape
        assert p.smem_bytes <= SMEM_LIMIT, shape
        assert p.cluster == (1, 1, p.grid[2]) and p.split <= MAX_SPLIT
        m_tiles, n_tiles, _ = p.grid
        n, h, w, _, cout, k, stride = shape
        ho, wo = (h + 2 * (k // 2) - k) // stride + 1, (w + 2 * (k // 2) - k) // stride + 1
        assert m_tiles == n * -(-ho // TILE_H) * -(-wo // TILE_W) and TILE_H * TILE_W == BLOCK_ROWS
        assert n_tiles * p.bn >= cout > (n_tiles - 1) * p.bn
        if p.split > 1:  # below a wave, and no further than half a wave of blocks needs
            assert m_tiles * n_tiles < SMS, shape
            assert m_tiles * n_tiles * (p.split - 1) < SMS // 2, shape
        assert p.split == min(MAX_SPLIT, p.ksteps) or m_tiles * n_tiles * p.split >= SMS // 2, shape
        steps = p.split_steps()
        assert len(steps) == p.split and min(steps) >= 1 and sum(steps) == p.ksteps, shape
        assert p.ksteps * BK >= p.kdim > (p.ksteps - 1) * BK
    if views == 12:  # the 13x13 and 26x26 levels fill the card through split-K
        assert any(plan(*s).split > 1 for s in forward_convs[views] if s[1] == 13)
        assert any(plan(*s).split > 1 for s in forward_convs[views] if s[1] == 26)


def test_plan_constants_are_the_kernels():
    """The plan sizes shared memory with the kernel's own constants."""
    src = (Path(conv_s8_module.__file__).resolve().parents[1] / "csrc" / "conv_s8.cu").read_text()
    for name, value in (("kBM", BLOCK_ROWS), ("kTileW", TILE_W), ("kBK", BK), ("kStages", STAGES), ("kRedPad", RED_PAD), ("kMaxSplit", MAX_SPLIT)):
        found = re.search(rf"constexpr int {name} = (\d+);", src)
        assert found and int(found.group(1)) == value, name


def test_quant_matches_jax():
    y = np.random.default_rng(5).normal(0, 3, 4096).astype(np.float32)
    y[:4] = [0.5 * 0.1, 1.5 * 0.1, -2.5 * 0.1, 1e6]  # halves and a clip
    for scale in (0.1, 0.037, 1.0 / 3.0):
        np.testing.assert_array_equal(quant(torch.from_numpy(y), scale).numpy(), np.asarray(jax_quant(jnp.asarray(y), scale)))


def test_wrapper_refuses_what_the_kernel_cannot_take():
    x, wt, sw, b = (torch.from_numpy(a) for a in _data((1, 8, 8, 8, 4, 3, 1), 6))
    before = conv_s8.launches
    with pytest.raises(ValueError, match="NHWC int8"):
        conv_s8(x.float(), wt)
    with pytest.raises(ValueError, match="NHWC int8"):
        conv_s8(x.to(torch.uint8), wt, wp=pack_weights(wt))
    wp = pack_weights(wt)
    for bad in (wp[:, :-16], wp.view(torch.int32), wp.t(), torch.zeros((4, 72), dtype=torch.int8)):
        with pytest.raises(ValueError, match="packed form"):
            conv_s8(x, wt, 1, "acc", wp=bad)
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
    conv_s8(x, wt, 1, "logits", sw, b, wp=wp)
    assert conv_s8.launches == before  # the plain version launches nothing
