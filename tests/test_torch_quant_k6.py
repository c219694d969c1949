"""K5's patch order and input layouts, and K6, the int8 convolution's
dequant epilogue (stf_unet_tpu_torch/ops/kernels/quant.py), held against
the JAX package's int8 convolution (stf_unet_tpu/ops/quant.py:_int8_conv)
on the CPU, where the wrappers run their plain twins; on the card
chip_smoke.py holds both kernels bit-equal to these twins.

Tolerances: none, every comparison is exact.
  * The patch matrix: column k = (dy*KW + dx)*C + c holds the quantized
    tap, checked against a gather written out in numpy; x given NCHW and
    channels-last gives the identical matrix; times the packed weights it
    equals XLA's int32 accumulators for the four geometries of
    tests/test_quant.py (integer sums, exact in any order).
  * The epilogue: bit-equal to `_int8_conv`'s f32 epilogue on seeded
    accumulators, some past 2^24 (where int32 -> f32 rounds), in f32 and
    bf16, with and without bias; the rows and columns past m and o hold
    noise that must not reach the output.
  * Refusals: a layout, dtype or shape a wrapper does not take raises on
    either device (the checks come before the CPU branch).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stf_unet_tpu.ops import quant as jq
from stf_unet_tpu_torch.core.config import ModelConfig
from stf_unet_tpu_torch.models.registry import create_model, preprocess_input
from stf_unet_tpu_torch.ops import quant
from stf_unet_tpu_torch.ops.kernels.quant import (dequant_epilogue,
                                                  dequant_epilogue_plain,
                                                  quantize_patches,
                                                  quantize_patches_plain)

GEOMETRIES = [((3, 3), 1, 1), ((3, 3), 2, 1), ((7, 7), 2, 3),
              ((1, 1), 1, "SAME")]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
CIN, COUT = 5, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small CPU steps: the test
    workers share the host's cores, and torch's default of a thread per
    core makes each tiny op of one worker wait on the others'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gather_numpy(xq, kernel, stride, pad):
    """[N, C, H, W] integers -> [N*Ho*Wo, KH*KW*C], column (dy*KW + dx)*C
    + c: the patch order K5 writes, spelled out tap by tap."""
    n, c, h, w = xq.shape
    (kh, kw), (sh, sw) = kernel, (stride, stride)
    xp = np.pad(xq, ((0, 0), (0, 0), (pad, pad), (pad, pad)))
    ho = (h + 2 * pad - kh) // sh + 1
    wo = (w + 2 * pad - kw) // sw + 1
    taps = [xp[:, :, dy:dy + sh * (ho - 1) + 1:sh, dx:dx + sw * (wo - 1) + 1:sw]
            for dy in range(kh) for dx in range(kw)]  # each [N, C, Ho, Wo]
    return np.stack(taps, 1).transpose(0, 3, 4, 1, 2).reshape(
        n * ho * wo, kh * kw * c)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kernel,stride,padding", GEOMETRIES)
def test_patch_order_both_layouts_and_xla_accumulators(kernel, stride,
                                                       padding, dtype):
    rng = np.random.default_rng(11)
    jdt, tdt = DTYPES[dtype]
    x_j = jnp.asarray(rng.normal(size=(2, 13, 11, CIN)).astype(np.float32),
                      jdt)
    w = rng.normal(0, 0.3, size=(*kernel, CIN, COUT)).astype(np.float32)
    wq_j, _ = jq.quantize_kernel(jnp.asarray(w))
    sx = jnp.float32(2.7)
    scale_j = jnp.maximum(sx, 1e-8) / 127.0
    xq_j = jnp.clip(jnp.round(x_j.astype(jnp.float32) / scale_j),
                    -127, 127).astype(jnp.int8)
    strides, pads = jq._conv_geometry(
        fnn.Conv(COUT, kernel, strides=stride, padding=padding))
    acc_j = jax.lax.conv_general_dilated(
        xq_j, wq_j, strides, pads, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)

    pad = 0 if padding == "SAME" else padding
    geom = (kernel, (stride, stride), (pad, pad))
    nhwc = torch.from_numpy(np.array(x_j.astype(jnp.float32))).to(tdt)
    x_cl = nhwc.permute(0, 3, 1, 2)
    x_nchw = x_cl.contiguous()
    assert x_cl.is_contiguous(memory_format=torch.channels_last)
    assert not x_cl.is_contiguous()
    scale = quant.activation_scale(torch.tensor(2.7))
    p = quantize_patches_plain(x_nchw, scale, *geom)
    for x in (x_nchw, x_cl):
        torch.testing.assert_close(quantize_patches_plain(x, scale, *geom),
                                   p, rtol=0, atol=0)
        torch.testing.assert_close(quantize_patches(x, scale, *geom), p,
                                   rtol=0, atol=0)
    k = CIN * kernel[0] * kernel[1]
    want = _gather_numpy(np.array(xq_j).transpose(0, 3, 1, 2), kernel,
                         stride, pad)
    np.testing.assert_array_equal(p[:, :k].numpy(), want)
    assert not p[:, k:].any()
    wq = torch.from_numpy(np.array(wq_j).transpose(3, 2, 0, 1).copy())
    acc = torch._int_mm(p, quant.pack_weights(wq).t())[:, :COUT]
    np.testing.assert_array_equal(acc.numpy(),
                                  np.asarray(acc_j).reshape(-1, COUT))


def _accumulators(rng, pixels, k, o):
    """int8 activations [pixels, K] and weights [K, O] whose products
    reach past 2^24: one row of +127 against columns of +127, the rest
    seeded."""
    xq = rng.integers(-127, 128, (pixels, k)).astype(np.int64)
    wq = rng.integers(-127, 128, (k, o)).astype(np.int64)
    xq[0] = 127
    wq[:, :2] = 127
    xq[1, : k // 2] = -127
    return xq, wq


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dequant_epilogue_bit_equal_to_jax(dtype, with_bias):
    """K6's plain twin and the CPU wrapper against `_int8_conv`'s
    epilogue: a 1x1 conv of K = 4,608 channels on x = xq * scale, which
    quantizes back to xq exactly, so XLA's accumulators are xq @ wq."""
    rng = np.random.default_rng(13 + with_bias)
    jdt, tdt = DTYPES[dtype]
    k, o, side = 4608, 6, 3
    xq, wq = _accumulators(rng, side * side, k, o)
    acc = xq @ wq
    assert np.abs(acc).max() > 2 ** 24
    sx = np.float32(3.1)
    scale = np.float32(np.maximum(sx, np.float32(1e-8)) / np.float32(127))
    x = (xq.astype(np.float32) * scale).reshape(1, side, side, k)
    x_j = jnp.asarray(x, jdt)
    assert np.array_equal(np.clip(np.rint(
        np.asarray(x_j.astype(jnp.float32)) / scale), -127, 127).reshape(
            -1, k), xq)
    sw = rng.uniform(1e-4, 1e-2, o).astype(np.float32)
    b = rng.normal(0, 1, o).astype(np.float32) if with_bias else None
    out_j = jq._int8_conv(
        fnn.Conv(o, (1, 1)), x_j,
        jnp.asarray(wq.reshape(1, 1, k, o), jnp.int8), jnp.asarray(sw),
        jnp.asarray(sx), None if b is None else jnp.asarray(b))
    want = np.asarray(out_j.astype(jnp.float32)).reshape(-1, o)

    m = side * side
    rows, np_ = m + 5, 16  # rows and columns past m and o: noise
    full = rng.integers(-2 ** 31, 2 ** 31 - 1, (rows, np_), dtype=np.int64)
    full[:m, :o] = acc
    acc_t = torch.from_numpy(full.astype(np.int32))
    args = (m, torch.from_numpy(sw), quant.activation_scale(torch.tensor(sx)),
            None if b is None else torch.from_numpy(b), tdt)
    for fn in (dequant_epilogue_plain, dequant_epilogue):
        y = fn(acc_t, *args)
        assert y.dtype == tdt and y.shape == (m, o) and y.is_contiguous()
        np.testing.assert_array_equal(y.to(torch.float32).numpy(), want)


def test_wrappers_refuse_what_they_do_not_take():
    x = torch.randn(2, 4, 9, 10)
    scale = torch.tensor(0.05)
    geom = ((3, 3), (1, 1), (1, 1))
    for bad in (x[..., ::2], x.permute(0, 1, 3, 2),
                x.permute(0, 2, 3, 1).permute(0, 1, 3, 2)):
        with pytest.raises(ValueError, match="NCHW-contiguous or "
                                             "channels-last"):
            quantize_patches(bad, scale, *geom)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        quantize_patches(x.half(), scale, *geom)
    acc = torch.zeros(40, 16, dtype=torch.int32)
    sw = torch.ones(8)
    ok = (20, sw, scale, None, torch.bfloat16)
    assert dequant_epilogue(acc, *ok).shape == (20, 8)
    for bad_acc in (acc.long(), acc.t(), acc[:, :4], acc[0]):
        with pytest.raises(ValueError, match="int32 accumulators"):
            dequant_epilogue(bad_acc, *ok)
    with pytest.raises(ValueError, match="int32 accumulators"):
        dequant_epilogue(acc, 41, sw, scale, None, torch.bfloat16)
    for name, bad in (("sw", (20, sw.bfloat16(), scale, None)),
                      ("bias", (20, sw, scale, torch.ones(7))),
                      ("bias", (20, sw, scale, torch.ones(16)[::2]))):
        with pytest.raises(ValueError, match=name):
            dequant_epilogue(acc, *bad, torch.bfloat16)
    with pytest.raises(ValueError, match="scale"):
        dequant_epilogue(acc, 20, sw, scale.double(), None, torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dequant_epilogue(acc, *ok[:-1], torch.float16)


def test_int8_conv_takes_either_layout_and_refuses_others():
    """The same output for x NCHW and channels-last; a strided view is
    refused, not copied."""
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.normal(size=(2, 16, 12, 10)).astype(
        np.float32)).bfloat16()
    wq, sw = quant.quantize_kernel(torch.from_numpy(
        rng.normal(size=(24, 16, 3, 3)).astype(np.float32)))
    bias = torch.from_numpy(rng.normal(size=24).astype(np.float32))
    args = (quant.pack_weights(wq).t(), sw, torch.tensor(2.5), bias, 3, 2, 1)
    want = quant.int8_conv2d(x, *args)
    assert want.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(
        quant.int8_conv2d(x.contiguous(memory_format=torch.channels_last),
                          *args), want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="NCHW-contiguous or channels-last"):
        quant.int8_conv2d(x[..., ::2], *args)


@pytest.mark.parametrize("name,kw,planes", [
    ("unet", {"base_c": 4}, 8),
    ("stflstm", {"time_steps": 2}, 2),
    ("stflstm", {"time_steps": 2, "use_pk_maps": True}, 5)])
def test_every_quantized_conv_input_is_in_a_taken_layout(name, kw, planes):
    """Between the quantized convs nothing is copied: each conv's input
    arrives NCHW-contiguous (the stems) or channels-last (the previous
    int8 conv's output, through BN, ReLU, pooling, the LSTMs and the
    decoder), so int8_conv2d hands it to K5 as it is."""
    torch.manual_seed(0)
    model = create_model(ModelConfig(model=name, **kw),
                         dtype=torch.bfloat16).eval()
    x = preprocess_input(torch.randn(1, planes, 32, 32, 1), model)
    qmodel = quant.QuantizedModel(model, quant.calibrate(model, [x]))
    seen = []

    def record(mod, args):
        seen.append(args[0].is_contiguous() or args[0].is_contiguous(
            memory_format=torch.channels_last))

    handles = [c.register_forward_pre_hook(record)
               for c in quant.conv_modules(model).values()]
    try:
        with torch.no_grad():
            qmodel(x)
    finally:
        for h in handles:
            h.remove()
    assert len(seen) == len(qmodel.paths) and all(seen)
