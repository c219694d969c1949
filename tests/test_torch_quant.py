"""The port's int8 post-training quantization (stf_unet_tpu_torch/ops/
quant.py, ops/kernels/quant.py, cli/quantize.py, cli/serve --dtype int8)
held against the JAX package's (stf_unet_tpu/ops/quant.py) on the CPU.

The CPU runs K5's plain twin (`quantize_patches_plain`) and
`torch._int_mm`; on the card chip_smoke.py holds K5 bit-equal to the plain
twin. Tolerances:
  * quantize_kernel: wq and sw bit-equal (the same f32 absmax, division,
    round half to even and clip);
  * the convolution, for JAX's four geometries (tests/test_quant.py) in
    f32 and bf16: the int32 accumulators bit-equal to
    lax.conv_general_dilated(..., preferred_element_type=int32) on the
    same x and sx (exact integer sums), and int8_conv2d's output equal to
    JAX's `_int8_conv` (one f32 multiply, one add, one cast: the same
    rounding points). Inputs placed on .5 rounding boundaries and on
    points where x / s and x * (1 / s) round apart catch `roundf` and a
    reciprocal multiply;
  * whole models (UNet base_c 4 at 32^2; STF-LSTM-UNet at full width,
    T=2, 16^2), JAX weights through the bridge and JAX's scales through
    conv_scales_from_jax: the port's int8 logits within mean |diff| <=
    5e-3 * mean |logit| of JAX's QuantizedModel.apply and argmax
    agreement >= 99 %. The float layers around the convs differ by
    round-off (XLA against ATen), and an activation that moves by an ulp
    can flip its int8 rounding, so bit-equality is not expected there.
    The port's int8 against its own float forward keeps JAX's bounds
    (err < 0.06, agreement > 0.98 UNet / 0.97 STF);
  * calibrate: every conv's absmax within 1e-5 relative of JAX's (f32),
    the same 19 / 48 convs;
  * excluded convs, the engine and the server: bit-equal / equal masks.
"""

import json
import os
import shutil

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stf_unet_tpu.core.config import ModelConfig as JaxModelConfig
from stf_unet_tpu.models.registry import create_model as jax_create_model
from stf_unet_tpu.models.registry import \
    preprocess_input as jax_preprocess_input
from stf_unet_tpu.ops import quant as jq
from stf_unet_tpu_torch.cli import quantize as quantize_cli
from stf_unet_tpu_torch.cli import train as train_cli
from stf_unet_tpu_torch.cli.serve import build_server
from stf_unet_tpu_torch.cli.serve import parse_args as serve_args
from stf_unet_tpu_torch.core.config import DataConfig, ModelConfig
from stf_unet_tpu_torch.data.synthetic import make_synthetic_breadm
from stf_unet_tpu_torch.data.transforms import normalize
from stf_unet_tpu_torch.models.registry import create_model, preprocess_input
from stf_unet_tpu_torch.ops import quant
from stf_unet_tpu_torch.ops.conv import Conv2d
from stf_unet_tpu_torch.ops.kernels.quant import (quantize_patches,
                                                  quantize_patches_plain)
from stf_unet_tpu_torch.serve.client import SegmentationClient, ServerError
from stf_unet_tpu_torch.serve.engine import InferenceEngine
from stf_unet_tpu_torch.utils.weights import (conv_scales_from_jax,
                                              stflstm_state_dict_from_jax,
                                              unet_state_dict_from_jax)

GEOMETRIES = [((3, 3), 1, 1), ((3, 3), 2, 1), ((7, 7), 2, 3),
              ((1, 1), 1, "SAME")]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
CIN, COUT = 4, 8
LOGIT_REL = 5e-3
AGREE = 0.99


# ---------------------------------------------------------------- weights

def seeded_variables(model, x, seed):
    """A JAX model's variables drawn from a numpy seed: the tree of
    model.init (traced by eval_shape, nothing compiles), kernels and LSTM
    matrices fan-in scaled, BN scales / variances in [0.5, 1.5], biases
    and means near 0."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), x,
                                               train=False))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name in ("kernel", "w_ih", "w_hh"):
            fan_in = np.prod(leaf.shape[:-1])
            a = rng.normal(0.0, 1.0 / np.sqrt(fan_in), leaf.shape)
        elif name in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, leaf.shape)
        else:
            a = rng.normal(0.0, 0.1, leaf.shape)
        return jnp.asarray(a, leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("shape,loud", [((3, 3, 4, 8), 3),
                                        ((7, 7, 1, 16), None),
                                        ((1, 1, 12, 2), 1)])
def test_quantize_kernel_bit_equal_to_jax(shape, loud):
    w = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    if loud is not None:
        w[..., loud] *= 100.0  # one loud channel must not crush the others
    wq_j, sw_j = jq.quantize_kernel(jnp.asarray(w))
    wq, sw = quant.quantize_kernel(torch.from_numpy(
        w.transpose(3, 2, 0, 1).copy()))
    assert wq.dtype == torch.int8 and sw.dtype == torch.float32
    np.testing.assert_array_equal(wq.numpy(),
                                  np.asarray(wq_j).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(sw_j))


# ------------------------------------------------------------ convolution

def _boundary_inputs(scale: np.float32, n: int) -> np.ndarray:
    """x values on the quantizer's edges for step `scale`: f32 (k + 0.5) *
    scale and its neighbours, kept where x / scale lands on a .5 tie or
    where x / scale and x * (1 / scale) round to different integers."""
    k = np.arange(-126, 126, dtype=np.float32)
    base = ((k + np.float32(0.5)) * scale).astype(np.float32)
    cand = np.concatenate([base, np.nextafter(base, np.float32(np.inf)),
                           np.nextafter(base, np.float32(-np.inf))])
    div = cand / scale
    mul = cand * (np.float32(1.0) / scale)
    keep = (np.rint(div) != np.rint(mul)) | (div - np.floor(div) == 0.5)
    picked = cand[keep]
    assert picked.size >= 8, "no rounding boundaries at this scale"
    return np.resize(picked, n)


def _conv_case(kernel, stride, padding, dtype, sx):
    """x NHWC with boundary values at the activation step of sx, HWIO
    kernel and bias, all from one seed."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 16, 16, CIN)).astype(np.float32)
    scale = np.float32(np.maximum(np.float32(sx), 1e-8) / np.float32(127))
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, flat.size // 2, replace=False)
    flat[idx] = _boundary_inputs(scale, idx.size)
    jdt, tdt = DTYPES[dtype]
    x_j = jnp.asarray(x, jdt)  # bf16: the edges round onto bf16 values
    w = rng.normal(0, 0.3, size=(*kernel, CIN, COUT)).astype(np.float32)
    b = rng.normal(0, 0.1, size=(COUT,)).astype(np.float32)
    return x_j, w, b


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kernel,stride,padding", GEOMETRIES)
@pytest.mark.parametrize("sx", [127.0, 3.3])
def test_int8_conv_bit_equal_to_xla(kernel, stride, padding, dtype, sx):
    x_j, w, b = _conv_case(kernel, stride, padding, dtype, sx)
    mod = fnn.Conv(COUT, kernel, strides=stride, padding=padding)
    wq_j, sw_j = jq.quantize_kernel(jnp.asarray(w))
    sx_j = jnp.float32(sx)
    # XLA's int8 convolution on the quantization jq._int8_conv applies
    strides, pads = jq._conv_geometry(mod)
    sx_scale = jnp.maximum(sx_j, 1e-8) / 127.0
    xq_j = jnp.clip(jnp.round(x_j.astype(jnp.float32) / sx_scale),
                    -127, 127).astype(jnp.int8)
    acc_j = jax.lax.conv_general_dilated(
        xq_j, wq_j, strides, pads, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    out_j = jq._int8_conv(mod, x_j, wq_j, sw_j, sx_j, jnp.asarray(b))

    x_t = torch.from_numpy(np.array(x_j.astype(jnp.float32))).permute(
        0, 3, 1, 2).to(DTYPES[dtype][1])
    wq, sw = quant.quantize_kernel(torch.from_numpy(
        w.transpose(3, 2, 0, 1).copy()))
    wq_mat = quant.pack_weights(wq).t()
    pad = 0 if padding == "SAME" else padding
    sx_t = torch.tensor(sx, dtype=torch.float32)
    scale = quant.activation_scale(sx_t)
    patches = quantize_patches_plain(x_t, scale, kernel, (stride, stride),
                                     (pad, pad), kp=wq_mat.shape[0])
    assert patches.dtype == torch.int8 and patches.shape[1] % 8 == 0
    torch.testing.assert_close(
        quantize_patches(x_t, scale, kernel, (stride, stride), (pad, pad),
                         kp=wq_mat.shape[0]), patches, rtol=0, atol=0)
    acc = torch._int_mm(patches, wq_mat)[:, :COUT]
    np.testing.assert_array_equal(
        acc.numpy(), np.asarray(acc_j).reshape(-1, COUT))
    out = quant.int8_conv2d(x_t, wq_mat, sw, sx_t, torch.from_numpy(b),
                            kernel, stride, pad)
    assert out.dtype == x_t.dtype and out.shape == (
        x_t.shape[0], COUT, *np.asarray(out_j).shape[1:3])
    np.testing.assert_array_equal(
        out.to(torch.float32).permute(0, 2, 3, 1).numpy(),
        np.asarray(out_j.astype(jnp.float32)))


def test_patch_rows_padded_for_the_gemm_and_refusals():
    """A GEMM of M <= 16 rows (torch._int_mm's CUDA rule) gets zero rows;
    grouped and dilated convs are refused by name."""
    x = torch.randn(1, 3, 4, 4)
    conv = Conv2d(3, 5, 3, padding=1)
    net = torch.nn.Sequential(conv).eval()
    net.num_classes = 5
    scales = quant.calibrate(net, [x])
    q = quant.QuantizedModel(net, scales)
    assert q.quant["0"].wq.shape == (8, 32)  # O 5 -> 8, K 27 -> 32
    p = quantize_patches_plain(x, quant.activation_scale(
        torch.tensor(scales["0"])), (3, 3), (1, 1), (1, 1), kp=32, rows=32)
    assert p.shape == (32, 32) and not p[16:].any() and not p[:, 27:].any()
    with torch.no_grad():
        ref = net(x)
        got = q(x)
    assert got.shape == ref.shape
    assert (got - ref).abs().max() < 0.05 * ref.abs().max()
    for bad, word in ((Conv2d(4, 4, 3, groups=2), "groups"),
                      (Conv2d(4, 4, 3, dilation=2), "dilation")):
        with pytest.raises(ValueError, match=word):
            quant.QuantConv(bad, 1.0)


# ---------------------------------------------------------- whole models

def _unet_pair():
    jm = jax_create_model(JaxModelConfig(model="unet", num_classes=1,
                                         base_c=4, time_steps=8))
    x = np.random.default_rng(0).normal(size=(2, 8, 32, 32, 1)).astype(
        np.float32)
    xin = jax_preprocess_input(jnp.asarray(x), jm)
    v = seeded_variables(jm, xin, seed=1)
    port = create_model(ModelConfig(model="unet", base_c=4))
    port.load_state_dict(unet_state_dict_from_jax(
        jax.device_get(v["params"]), jax.device_get(v["batch_stats"])))
    return jm, v, xin, port.eval(), x


def _stflstm_pair():
    jm = jax_create_model(JaxModelConfig(model="stflstm", num_classes=1,
                                         time_steps=2))
    x = np.random.default_rng(5).normal(size=(1, 2, 16, 16, 1)).astype(
        np.float32)
    xin = jax_preprocess_input(jnp.asarray(x), jm)
    v = seeded_variables(jm, xin, seed=2)
    port = create_model(ModelConfig(model="stflstm", time_steps=2))
    port.load_state_dict(stflstm_state_dict_from_jax(
        jax.device_get(v["params"]), jax.device_get(v["batch_stats"])))
    return jm, v, xin, port.eval(), x


@pytest.fixture(scope="module", params=["unet", "stflstm"])
def model_pair(request):
    """(name, JAX scales, JAX int8 logits, JAX float logits, port model,
    port input): one JAX calibration and one compile per model."""
    jm, v, xin, port, x = (_unet_pair if request.param == "unet"
                           else _stflstm_pair)()
    scales = jq.calibrate(jm, v, [xin])
    # quantize_variables inside the compiled forward: one compile
    q_logits = jax.jit(lambda v, x: jq.QuantizedModel(jm).apply(
        jq.quantize_variables(v, scales), x, train=False)["out"])(v, xin)
    return (request.param, scales, np.asarray(q_logits), port,
            preprocess_input(torch.from_numpy(x), port))


def test_calibrate_matches_jax(model_pair):
    name, scales_j, _, port, x = model_pair
    got = quant.calibrate(port, [x])
    want = conv_scales_from_jax(scales_j, name)
    assert len(got) == len(want) == {"unet": 19, "stflstm": 48}[name]
    assert set(got) == set(want) == set(quant.conv_modules(port))
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-5 * v, (k, got[k], v)


def test_int8_logits_match_jax(model_pair):
    name, scales_j, want, port, x = model_pair
    q = quant.QuantizedModel(port, conv_scales_from_jax(scales_j, name))
    with torch.no_grad():
        got = q(x)["out"].numpy()
        ref = port(x)["out"].numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).mean()
    assert err <= LOGIT_REL * np.abs(want).mean(), err
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= AGREE
    # the port's int8 against its own float forward, JAX's bounds
    own = np.abs(got - ref).mean() / (np.abs(ref).mean() + 1e-8)
    agree = (got.argmax(-1) == ref.argmax(-1)).mean()
    assert own < 0.06, own
    assert agree > {"unet": 0.98, "stflstm": 0.97}[name], agree
    # the delegated contract of the engine and evaluate
    assert (q.num_classes, q.input_format) == (port.num_classes,
                                               port.input_format)


def test_conv_scales_from_jax_refuses_unknown_paths():
    with pytest.raises(ValueError, match="encoder/nope"):
        conv_scales_from_jax({"encoder/nope": 1.0}, "stflstm")
    assert conv_scales_from_jax({"out_conv": 2, "enc1/conv2/conv": 1},
                                "unet") == {"out_conv": 2.0, "enc1.3": 1.0}


# --------------------------------------------------- exclude, scales file

@pytest.fixture(scope="module")
def tiny_unet():
    torch.manual_seed(0)
    model = create_model(ModelConfig(model="unet", base_c=4)).eval()
    x = torch.randn(2, 32, 32, 8)
    return model, x, quant.calibrate(model, [x])


def test_exclude_falls_back_to_exact_float(tiny_unet):
    model, x, scales = tiny_unet
    q = quant.QuantizedModel(model, scales, exclude=tuple(scales))
    assert len(q.quant) == 0
    with torch.no_grad():
        torch.testing.assert_close(q(x)["out"], model(x)["out"], rtol=0,
                                   atol=0)
    one = quant.QuantizedModel(model, scales, exclude=("out_conv",))
    assert "out_conv" not in one.paths and len(one.paths) == 18
    with pytest.raises(ValueError, match="nope"):
        quant.QuantizedModel(model, {"nope": 1.0})


def test_scales_json_roundtrip_and_jax_format(tmp_path):
    scales = {"enc1.0": 3.25, "out_conv": 0.125}
    path = quant.scales_path_for(str(tmp_path / "unet_best_model.pth"))
    assert path == str(tmp_path / "unet_best_model.quant_scales.json")
    quant.save_scales(path, scales, checkpoint_meta={"epoch": 2,
                                                     "best_dice": 0.5})
    assert quant.load_scales(path) == scales
    # the JAX package's file and the port's are the same JSON
    jpath = str(tmp_path / "jax.json")
    jq.save_scales(jpath, scales, checkpoint_meta={"epoch": 2,
                                                   "best_dice": 0.5})
    with open(path) as a, open(jpath) as b:
        assert json.load(a) == json.load(b)
    with open(path, "w") as f:
        f.write("{}")
    with pytest.raises(ValueError):
        quant.load_scales(path)


def test_scales_staleness_warning(tmp_path, capsys):
    path = str(tmp_path / "s.json")
    quant.save_scales(path, {"c": 1.0},
                      checkpoint_meta={"epoch": 3, "best_dice": 0.9})
    quant.load_scales(path, checkpoint_meta={"epoch": 3, "best_dice": 0.9})
    assert "WARNING" not in capsys.readouterr().out
    quant.load_scales(path, checkpoint_meta={"epoch": 7, "best_dice": 0.95})
    assert "re-run cli/quantize" in capsys.readouterr().out
    quant.save_scales(path, {"c": 1.0})  # no identity: loads silently
    quant.load_scales(path, checkpoint_meta={"epoch": 7})
    assert "WARNING" not in capsys.readouterr().out


def test_engine_serves_the_quantized_forward(tiny_unet):
    model, _, scales = tiny_unet
    q = quant.QuantizedModel(model, scales)
    cfg = DataConfig()
    engine = InferenceEngine(q, cfg.mean, cfg.std, max_batch=4,
                             device="cpu")
    images = np.random.default_rng(4).integers(0, 256, (3, 8, 32, 32, 1),
                                               dtype=np.uint8)
    masks = engine.predict(images)
    with torch.no_grad():
        x = normalize(torch.from_numpy(images), cfg.mean, cfg.std)
        logits = q(preprocess_input(x, q))["out"]
    np.testing.assert_array_equal(masks, logits.argmax(-1).numpy())


# ------------------------------------------------------------ the CLIs

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny cli/train run of the port (UNet base_c 4, crop 32, one
    epoch) and its tree."""
    root = str(tmp_path_factory.mktemp("quant"))
    data = os.path.join(root, "breadm")
    make_synthetic_breadm(data, size=40, seed=3)
    train_cli.run(["--data-path", data, "--save-dir", f"{root}/w",
                   "--output-dir", f"{root}/o", "--device", "cpu",
                   "--model", "unet", "--model-base-c", "4",
                   "--data-base-size", "40", "--data-crop-size", "32",
                   "--batch-size", "2", "--epochs", "1", "--print-freq",
                   "100", "--silent", "true"])
    return root, data


def test_quantize_cli_end_to_end(trained):
    root, data = trained
    res = quantize_cli.main([
        "--model", "unet", "--model-dir", f"{root}/w", "--root", data,
        "--calib-samples", "4", "--batch-size", "2", "--threshold-sweep",
        "--dtype", "f32", "--device", "cpu"])
    assert res["scales_path"] == f"{root}/w/unet_best_model.quant_scales.json"
    assert os.path.exists(res["scales_path"]) and res["num_convs"] == 19
    assert abs(res["dice_delta"]) < 0.05
    for key in ("best_float", "best_int8"):
        assert 0.0 <= res[key]["threshold"] <= 1.0
        assert 0.0 <= res[key]["dice"] <= 1.0
    with pytest.raises(SystemExit, match="not found among"):
        quantize_cli.main(["--model", "unet", "--model-dir", f"{root}/w",
                           "--root", data, "--calib-samples", "2",
                           "--no-eval", "--exclude", "nope",
                           "--device", "cpu"])


def test_serve_int8_answers_and_reloads(trained, tmp_path):
    """cli/serve --dtype int8: the answer is the direct quantized
    forward's mask; a reload with scales swaps in the new checkpoint
    (200), one without scales is refused (409) and the old weights keep
    serving."""
    root, data = trained
    d = str(tmp_path)
    best = os.path.join(d, "unet_best_model.pth")
    shutil.copy(f"{root}/w/unet_best_model.pth", best)
    argv = ["--model", "unet", "--model-dir", d, "--dtype", "int8",
            "--device", "cpu", "--port", "0", "--max-batch", "2",
            "--batch-window-ms", "1"]
    with pytest.raises(SystemExit, match="calibrate first"):
        build_server(serve_args(argv))
    quantize_cli.main(["--model", "unet", "--model-dir", d, "--root", data,
                       "--calib-samples", "2", "--no-eval", "--dtype",
                       "f32", "--device", "cpu"])
    server = build_server(serve_args(argv + ["--tta"]))
    server.start()
    client = SegmentationClient("http://%s:%d" % server.address, timeout=60)
    frames = np.random.default_rng(9).integers(0, 256, (8, 32, 32),
                                               dtype=np.uint8)
    try:
        old = client.segment(frames)
        image, _ = server.preprocess(frames)
        np.testing.assert_array_equal(
            old, server.engine.predict(image[None])[0])
        assert isinstance(server.weights, quant.QuantizedModel)
        # a retrained checkpoint with its scales: 200, new weights (a
        # head bias that puts every pixel in the class `old` uses least)
        sd = torch.load(best, weights_only=True)
        fg = float(old.mean() < 0.5)
        sd["model"]["out_conv.bias"] = torch.tensor([20.0, -20.0]) * (
            1 - 2 * fg)
        torch.save(sd, best)
        assert client.reload()["reloaded"] is True
        new = client.segment(frames)
        assert (new == fg).all() and not np.array_equal(old, new)
        torch.testing.assert_close(server.weights.model.out_conv.bias,
                                   sd["model"]["out_conv.bias"], rtol=0,
                                   atol=0)
        # the same checkpoint without scales: 409, the weights stay
        os.remove(quant.scales_path_for(best))
        with pytest.raises(ServerError) as e:
            client.reload()
        assert e.value.code == 409 and "quant_scales" in str(e.value)
        np.testing.assert_array_equal(client.segment(frames), new)
    finally:
        server.stop()
