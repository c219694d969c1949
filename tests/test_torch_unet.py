"""The port's vanilla UNet held against the JAX package's on the CPU, at
base_c = 4: the weight bridge, the input adaptation, eval logits with and
without PK maps, one whole train-mode step, and the serving engine.

Tolerances:
  * weight bridge and flat_channels input: bit-equal; the average_frame
    input within 1e-6 (a mean over T, summed in another order);
  * eval logits (f32): max |difference| <= 1e-5 * max |logit|. Both sides
    compute the same 23 convolutions in f32 and differ only in summation
    order (XLA's against ATen/oneDNN's), a few ulps a layer;
  * one train-mode step, both packages in float64 (the logits cast to f32,
    as both models do): loss within 1e-6 relative, every gradient within
    1e-6 * max |gradient| of its tensor (the tests/test_torch_train.py
    pattern), the conv biases before BN, whose gradient is 0 in exact
    arithmetic, below 1e-12 of the largest gradient on both sides (an f32
    train-mode comparison is too noisy, ROADMAP.md §3);
  * the engine (f32): the logits of its normalized input within 1e-5 *
    max |logit|, its float16 probabilities within 2e-3, masks equal where
    the two classes' logits differ by more than twice the logits' bound.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stf_unet_tpu.losses.criterion import criterion as jax_criterion
from stf_unet_tpu.models.registry import \
    preprocess_input as jax_preprocess_input
from stf_unet_tpu.models.unet import UNet as JaxUNet
from stf_unet_tpu.serve.engine import InferenceEngine as JaxEngine
from stf_unet_tpu.utils.torch_export import export_unet_state_dict
from stf_unet_tpu_torch.core.config import DataConfig, ModelConfig
from stf_unet_tpu_torch.models.registry import create_model, preprocess_input
from stf_unet_tpu_torch.serve.engine import InferenceEngine
from stf_unet_tpu_torch.train.loop import loss_and_grads
from stf_unet_tpu_torch.utils.weights import unet_state_dict_from_jax

BASE_C = 4
T_STEPS = 8
PK = 3
REL_TOL = 1e-5


def seeded_unet_variables(model, in_channels, seed):
    """Variables of a JAX UNet drawn from a numpy seed: the tree of
    model.init (traced by eval_shape, so nothing compiles), every leaf
    random. Non-trivial BN statistics and affine terms, so the bridge's
    BN entries matter; means near 0, so the ReLUs after them keep about
    half their inputs."""
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.key(0), jnp.zeros((1, 16, 16, in_channels)),
        train=False))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":  # fan-in scaled, as lecun_normal
            fan_in = np.prod(leaf.shape[:-1])
            a = rng.normal(0.0, 1.0 / np.sqrt(fan_in), leaf.shape)
        elif name in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, leaf.shape)
        else:  # conv / BN biases, running means
            a = rng.normal(0.0, 0.1, leaf.shape)
        return jnp.asarray(a, leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_unet(in_channels, seed=0):
    model = JaxUNet(num_classes=2, base_c=BASE_C)
    return model, seeded_unet_variables(model, in_channels, seed)


def _port_unet(variables, pk=False, dtype=torch.float32):
    sd = unet_state_dict_from_jax(jax.device_get(variables["params"]),
                                  jax.device_get(variables["batch_stats"]))
    model = create_model(ModelConfig(model="unet", base_c=BASE_C,
                                     time_steps=T_STEPS, use_pk_maps=pk),
                         dtype=dtype).to(dtype)
    model.load_state_dict(sd, strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def jax_unet():
    return _jax_unet(T_STEPS)


def test_weight_bridge_matches_jax_export(jax_unet):
    _, variables = jax_unet
    want = export_unet_state_dict(variables["params"],
                                  variables["batch_stats"])
    got = unet_state_dict_from_jax(jax.device_get(variables["params"]),
                                   jax.device_get(variables["batch_stats"]))
    assert list(got) == list(want)
    for k, v in want.items():
        assert isinstance(got[k], torch.Tensor), k
        assert got[k].dtype == torch.from_numpy(np.array(v)).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)
    port = create_model(ModelConfig(model="unet", base_c=BASE_C))
    assert set(port.state_dict()) == set(want)
    for k, v in port.state_dict().items():
        assert tuple(v.shape) == np.asarray(want[k]).shape, k


def test_flat_channels_input_matches_jax():
    x = np.random.default_rng(0).normal(
        size=(2, T_STEPS + PK, 12, 10, 1)).astype(np.float32)
    model = create_model(ModelConfig(model="unet", base_c=BASE_C))
    assert model.input_format == "flat_channels"
    got = preprocess_input(torch.from_numpy(x), model).numpy()
    want = np.asarray(jax_preprocess_input(jnp.asarray(x), JaxUNet()))
    assert got.shape == want.shape == (2, 12, 10, T_STEPS + PK)
    np.testing.assert_array_equal(got, want)

    class Averaged(torch.nn.Module):
        input_format = "average_frame"

    class JaxAveraged:
        input_format = "average_frame"

    # the frame mean: the same f32 sum over T in another order
    np.testing.assert_allclose(
        preprocess_input(torch.from_numpy(x), Averaged()).numpy(),
        np.asarray(jax_preprocess_input(jnp.asarray(x), JaxAveraged())),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", [32, 48])
@pytest.mark.parametrize("pk", [False, True])
def test_eval_logits_match_jax(size, pk):
    planes = T_STEPS + (PK if pk else 0)
    model, variables = _jax_unet(planes, seed=size + pk)
    port = _port_unet(variables, pk=pk)
    assert all(p.dtype == torch.float32 for p in port.parameters())
    x = np.random.default_rng(size + 2 * pk).normal(
        size=(2, planes, size, size, 1)).astype(np.float32)
    want = np.asarray(model.apply(
        variables, jax_preprocess_input(jnp.asarray(x), model),
        train=False)["out"])
    with torch.no_grad():
        got = port(preprocess_input(torch.from_numpy(x), port))["out"]
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (2, size, size, 2)
    assert want.std() > 1e-3 * np.abs(want).max() > 0  # not a constant map
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=REL_TOL * np.abs(want).max())


def test_bf16_unet_keeps_f32_params_and_logits(jax_unet):
    _, variables = jax_unet
    port = _port_unet(variables)
    lo = create_model(ModelConfig(model="unet", base_c=BASE_C),
                      dtype=torch.bfloat16)
    lo.load_state_dict(port.state_dict(), strict=True)
    lo.eval()
    assert all(p.dtype == torch.float32 for p in lo.parameters())
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(1, T_STEPS, 32, 32, 1)).astype(np.float32))
    with torch.no_grad():
        out = lo(preprocess_input(x, lo))["out"]
        ref = port(preprocess_input(x, port))["out"]
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    scale = ref.abs().max().item()
    assert (out - ref).abs().max().item() < 0.05 * scale


def test_train_step_matches_jax_in_float64(jax_unet):
    model, variables = jax_unet
    params, stats = variables["params"], variables["batch_stats"]
    rng = np.random.default_rng(7)
    images = rng.normal(size=(2, T_STEPS, 32, 32, 1)).astype(np.float32)
    targets = rng.integers(0, 2, (2, 32, 32)).astype(np.int64)

    def loss_fn(params, batch_stats, images, targets):
        outputs, _ = model.apply(
            {"params": params, "batch_stats": batch_stats},
            jax_preprocess_input(images, model), train=True,
            mutable=["batch_stats"])
        return jax_criterion(outputs, targets, num_classes=2,
                             ignore_index=-100)

    with jax.enable_x64(True):
        f64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), (params, stats, images))
        jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
            *f64, jnp.asarray(targets, jnp.int32))
        jloss, jgrads = float(jloss), jax.device_get(jgrads)
    want = unet_state_dict_from_jax(jgrads, jax.device_get(stats))

    port = _port_unet(variables, dtype=torch.float64)
    loss = loss_and_grads(port, torch.from_numpy(images).double(),
                          torch.from_numpy(targets), num_classes=2)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-6)
    names = [n for n, _ in port.named_parameters()]
    assert len(names) == sum(not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))
        for k in want)
    gmax = max(np.abs(want[n].numpy()).max() for n in names)
    for name, p in port.named_parameters():
        ref = want[name].double().numpy()
        if name.endswith((".0.bias", ".3.bias")):
            # a conv bias that feeds train-mode BN: its gradient is 0 in
            # exact arithmetic (BN subtracts the batch mean), so both
            # packages sit at float64 round-off
            assert np.abs(ref).max() < 1e-12 * gmax, name
            assert p.grad.abs().max().item() < 1e-12 * gmax, name
            continue
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max(),
                                   err_msg=name)


def test_engine_serves_the_unet_like_jax(jax_unet):
    model, variables = jax_unet
    port = _port_unet(variables)
    cfg = DataConfig(crop_size=32)
    images = np.random.default_rng(5).integers(
        0, 256, (3, T_STEPS, 32, 32, 1), dtype=np.uint8)
    jax_eng = JaxEngine(model, variables, cfg.mean, cfg.std, max_batch=4)
    eng = InferenceEngine(port, cfg.mean, cfg.std, max_batch=4,
                          device="cpu")
    want_masks, want_probs = jax_eng.predict(images, return_probs=True)
    got_masks, got_probs = eng.predict(images, return_probs=True)
    assert got_masks.dtype == np.int32 and got_masks.shape == (3, 32, 32)
    # float16 probabilities: 2^-11 relative spacing, plus the logits' tol
    np.testing.assert_allclose(got_probs.astype(np.float32),
                               want_probs.astype(np.float32), atol=2e-3)
    x = (images.astype(np.float32) / 255.0 - cfg.mean) / cfg.std
    want = np.asarray(model.apply(
        variables, jax_preprocess_input(jnp.asarray(x), model),
        train=False)["out"])
    tol = REL_TOL * np.abs(want).max()
    with torch.no_grad():
        got = port(preprocess_input(torch.from_numpy(x), port))["out"]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    decided = np.abs(want[..., 1] - want[..., 0]) > 2 * tol
    np.testing.assert_array_equal(got_masks[decided], want_masks[decided])
    np.testing.assert_array_equal(got_masks[decided],
                                  want.argmax(-1)[decided])
