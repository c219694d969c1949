"""The port's PK-maps path of STF-LSTM-UNet held against the JAX package on
the CPU: the weight bridge and the eval logits of STFLSTMUNet(use_pk_maps=
True), one train-mode step in float64, the PK augmentation at the warp
boundary, the host loader's PK batches, and cli/train + cli/serve on a PK
tree.

Tolerances:
  * eval logits (f32, crop 64, B=2): max |difference| <= 1e-4 * max
    |logit|, as for the model without maps (tests/test_torch_stflstm.py:
    convolution summation order over ~40 layers);
  * the train step in float64 (crop 32, B=2): loss within 1e-6 relative,
    every gradient within 1e-6 * its tensor's max |gradient|, as in
    tests/test_torch_train.py;
  * augmentation: targets equal; images within 1e-5 (the port folds
    (x/255 - mean)/std into one multiply-add, JAX divides then
    normalizes: an f32 ulp or two of values below 6);
  * loader: bytes equal.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from PIL import Image

from stf_unet_tpu.core.config import DataConfig as JaxDataConfig
from stf_unet_tpu.data import transforms as jax_T
from stf_unet_tpu.data.index import DatasetIndex as JaxIndex
from stf_unet_tpu.data.loader import HostLoader as JaxHostLoader
from stf_unet_tpu.losses.criterion import criterion as jax_criterion
from stf_unet_tpu.models.stf_lstm_unet import STFLSTMUNet as JaxSTFLSTMUNet
from stf_unet_tpu.utils.torch_export import export_stflstm_state_dict
from stf_unet_tpu_torch.cli import train as train_cli
from stf_unet_tpu_torch.cli.common import restore_for_inference
from stf_unet_tpu_torch.cli.serve import build_server, parse_args
from stf_unet_tpu_torch.core.config import (DataConfig, ModelConfig,
                                            parse_config)
from stf_unet_tpu_torch.core.prng import augment_generator
from stf_unet_tpu_torch.data.index import DatasetIndex
from stf_unet_tpu_torch.data.loader import HostLoader
from stf_unet_tpu_torch.data.synthetic import make_synthetic_breadm
from stf_unet_tpu_torch.data.transforms import TrainAugment
from stf_unet_tpu_torch.models.registry import create_model
from stf_unet_tpu_torch.serve.client import SegmentationClient
from stf_unet_tpu_torch.train.loop import loss_and_grads
from stf_unet_tpu_torch.utils.weights import stflstm_state_dict_from_jax

T_STEPS = 2
PK = 3
REL_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small CPU steps: the test
    workers share the host's cores, and torch's default of a thread per
    core makes each tiny op of one worker wait on the others'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _numpy_leaf(rng, name, shape):
    """A parameter or statistic of the given kind, drawn with numpy at a
    scale that keeps activations in range through ~40 layers."""
    if name == "kernel":     # conv HWIO: fan-in scaled
        return rng.normal(0.0, np.prod(shape[:-1]) ** -0.5, shape)
    if name in ("w_ih", "w_hh", "b_ih", "b_hh"):  # LSTM, torch's init
        k = (shape[0] if name.startswith("w") else shape[0] // 4) ** -0.5
        return rng.uniform(-k, k, shape)
    if name in ("scale", "var"):
        return rng.uniform(0.5, 1.5, shape)
    return rng.uniform(-0.2, 0.2, shape)  # bias, mean


@pytest.fixture(scope="module")
def jax_pk_model():
    """The JAX model with variables made from a numpy seed (only their
    shapes come from flax: eval_shape traces init without running it)."""
    model = JaxSTFLSTMUNet(num_classes=2, time_steps=T_STEPS,
                           use_pk_maps=True)
    shapes = jax.eval_shape(
        lambda k, x: model.init(k, x, train=False), jax.random.key(0),
        jnp.zeros((1, T_STEPS + PK, 32, 32, 1)))
    rng = np.random.default_rng(1)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(
            _numpy_leaf(rng, path[-1].key, a.shape), a.dtype), shapes)
    return model, {"params": variables["params"],
                   "batch_stats": variables["batch_stats"]}


def _port_sd(variables):
    return stflstm_state_dict_from_jax(
        jax.device_get(variables["params"]),
        jax.device_get(variables["batch_stats"]))


def _port_model(sd, dtype=torch.float32):
    model = create_model(ModelConfig(num_classes=1, time_steps=T_STEPS,
                                     use_pk_maps=True), dtype=dtype)
    model.load_state_dict(sd, strict=True)
    return model


def test_pk_weight_bridge_matches_jax_export(jax_pk_model):
    _, variables = jax_pk_model
    want = export_stflstm_state_dict(variables["params"],
                                     variables["batch_stats"])
    got = _port_sd(variables)
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)
    assert tuple(got["conv1.weight"].shape) == (64, 1 + PK, 7, 7)
    for i, width in enumerate((64, 128, 256, 512), start=1):
        assert tuple(got[f"pk_fusion{i}.weight"].shape) == (width,
                                                           width + PK, 1, 1)
        assert tuple(got[f"pk_fusion{i}.bias"].shape) == (width,)
    model = _port_model(got)
    assert set(model.state_dict()) == set(want)


def test_pk_model_matches_jax(jax_pk_model):
    model, variables = jax_pk_model
    x = np.random.default_rng(2).normal(
        size=(2, T_STEPS + PK, 64, 64, 1)).astype(np.float32)
    want = np.asarray(model.apply(variables, jnp.asarray(x),
                                  train=False)["out"])
    port = _port_model(_port_sd(variables)).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x))["out"].numpy()
    assert got.shape == want.shape == (2, 64, 64, 2)
    tol = REL_TOL * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    # the maps matter: other maps, other logits
    x2 = x.copy()
    x2[:, T_STEPS:] = 0.0
    with torch.no_grad():
        other = port(torch.from_numpy(x2))["out"].numpy()
    assert np.abs(other - got).max() > 100 * tol


def test_pk_train_step_matches_jax_in_float64(jax_pk_model):
    model, variables = jax_pk_model
    rng = np.random.default_rng(3)
    images = rng.normal(size=(2, T_STEPS + PK, 32, 32, 1))
    targets = rng.integers(0, 2, (2, 32, 32)).astype(np.int64)

    def loss_fn(params, batch_stats, x, y):
        out, _ = model.apply({"params": params, "batch_stats": batch_stats},
                             x, train=True, mutable=["batch_stats"])
        return jax_criterion(out, y, num_classes=2, ignore_index=-100)

    with jax.enable_x64(True):
        params, stats = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64),
            (variables["params"], variables["batch_stats"]))
        jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
            params, stats, jnp.asarray(images, jnp.float64),
            jnp.asarray(targets, jnp.int32))
        jloss, jgrads = float(jloss), jax.device_get(jgrads)
    want = stflstm_state_dict_from_jax(jgrads, variables["batch_stats"])

    port = _port_model(_port_sd(variables), torch.float64).to(torch.float64)
    loss = loss_and_grads(port, torch.from_numpy(images),
                          torch.from_numpy(targets), num_classes=2).item()
    np.testing.assert_allclose(loss, jloss, rtol=1e-6)
    grads = {n: p.grad.numpy() for n, p in port.named_parameters()}
    assert {f"pk_fusion{i}.weight" for i in range(1, 5)} <= set(grads)
    for name, g in grads.items():
        ref = want[name].double().numpy()
        np.testing.assert_allclose(g, ref, atol=1e-6 * np.abs(ref).max(),
                                   rtol=0, err_msg=name)


def test_train_augment_with_pk_at_the_warp_boundary():
    """One warp over [frames, maps, mask] under one draw: the maps are
    warped and normalized as JAX warps and normalizes them
    (_warp_bilinear_and_nearest on the concatenated planes), at the same
    source grids; the frames and targets are those of the call without
    maps."""
    cfg = DataConfig(base_size=48, crop_size=32)
    aug = TrainAugment(cfg)
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (3, T_STEPS, 48, 48)).astype(np.uint8)
    pk = rng.integers(0, 256, (3, PK, 48, 48)).astype(np.uint8)
    masks = rng.integers(0, 2, (3, 48, 48)).astype(np.uint8)
    sizes = np.array([[48, 48], [40, 48], [48, 36]], np.int32)
    for i, (h, w) in enumerate(sizes):
        masks[i, h:] = 255
        masks[i, :, w:] = 255
        pk[i, :, h:] = 0
        pk[i, :, :, w:] = 0
    images, targets = aug(augment_generator(0, 1, 2), torch.from_numpy(frames),
                          torch.from_numpy(masks), sizes, torch.from_numpy(pk))
    assert images.shape == (3, T_STEPS + PK, 32, 32, 1)
    plain_images, plain_targets = aug(augment_generator(0, 1, 2),
                                      torch.from_numpy(frames),
                                      torch.from_numpy(masks), sizes)
    torch.testing.assert_close(images[:, :T_STEPS], plain_images, rtol=0,
                               atol=0)
    torch.testing.assert_close(targets, plain_targets, rtol=0, atol=0)

    gy, gx = aug.grids(augment_generator(0, 1, 2), sizes, "cpu")
    jcfg = JaxDataConfig()
    for i in range(3):
        raw = np.concatenate([frames[i], pk[i]]).astype(np.float32)
        warped, near = jax_T._warp_bilinear_and_nearest(
            jnp.asarray(raw), jnp.asarray(masks[i], jnp.float32),
            jnp.asarray(gy[i].numpy()), jnp.asarray(gx[i].numpy()),
            jnp.float32(sizes[i, 0]), jnp.float32(sizes[i, 1]))
        want = (np.asarray(warped) / 255.0 - jcfg.mean) / jcfg.std
        np.testing.assert_allclose(images[i, ..., 0].numpy(), want,
                                   atol=1e-5, rtol=0)
        np.testing.assert_array_equal(targets[i].numpy(),
                                      np.asarray(near).astype(np.int64))


@pytest.fixture(scope="module")
def pk_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("pk_loader")
    make_synthetic_breadm(str(root), size=40, patients_per_split=3,
                          slices_per_patient=2, with_pk_maps=True, seed=9)
    pk_dir = os.path.join(str(root), "seg", "training", "pk_maps")
    # an off-resolution map (NEAREST-resized on load) and a missing one
    # (zero-filled), as the reference loader treats them
    small = np.arange(20 * 20, dtype=np.uint8).reshape(20, 20)
    Image.fromarray(small).save(os.path.join(pk_dir, "P000", "ve.png"))
    os.remove(os.path.join(pk_dir, "P001", "vp.png"))
    return str(root)


def test_host_loader_pk_batches_match_jax(pk_tree):
    seqs = tuple(f"VIBRANT+C{i}" for i in range(1, 9))
    jidx = JaxIndex(pk_tree, "train", seqs, use_pk_maps=True)
    pidx = DatasetIndex(pk_tree, "train", seqs, use_pk_maps=True)
    jl = JaxHostLoader(jidx, 4, shuffle=True, seed=2, use_pk_maps=True,
                       use_native=False, prefetch=0)
    pl = HostLoader(pidx, 4, shuffle=True, seed=2, use_pk_maps=True)
    assert len(pl) == len(jl) == 2
    for g, w in zip(pl.epoch(1), jl.epoch(1)):
        for name in ("frames", "masks", "sizes", "pk"):
            a, b = getattr(g, name), getattr(w, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert g.pk.shape == (len(g.frames), 3, 64, 64)
    without = next(iter(HostLoader(pidx, 4, shuffle=True, seed=2).epoch(1)))
    assert without.pk is None


@pytest.fixture(scope="module")
def pk_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("pk_cli")
    data = str(root / "breadm")
    make_synthetic_breadm(data, size=40, sequence_prefix="SUB", seed=3)
    result = train_cli.run([
        "--data-path", data, "--use-subtraction", "--use-pk-maps",
        "--generate-pk-maps", "--device", "cpu", "--data-base-size", "40",
        "--data-crop-size", "32", "--batch-size", "2", "--epochs", "1",
        "--print-freq", "1", "--save-dir", str(root / "weights"),
        "--output-dir", str(root / "out")])
    return data, str(root / "weights"), result


def test_pk_train_cli_writes_pk_checkpoint(pk_run):
    data, weights, result = pk_run
    assert result["steps"] == 2 and np.isfinite(
        result["epochs"][0]["train_loss"])
    for split in ("training", "val", "test"):
        for patient in ("P000", "P001"):
            out = os.path.join(data, "seg", split, "pk_maps", patient)
            assert os.path.isfile(os.path.join(out, "ktrans.png")), out
    sd = torch.load(os.path.join(weights, "stflstm_best_model_pk.pth"),
                    weights_only=True)["model"]
    assert tuple(sd["conv1.weight"].shape) == (64, 1 + PK, 7, 7)
    assert {f"pk_fusion{i}.weight" for i in range(1, 5)} <= set(sd)


def test_serve_answers_an_11_plane_request_from_a_pk_checkpoint(pk_run):
    _, weights, _ = pk_run
    path = os.path.join(weights, "stflstm_best_model_pk.pth")
    _, _, model_cfg, _ = restore_for_inference("stflstm", path, crop_size=32,
                                               dtype="f32", device="cpu")
    assert model_cfg.use_pk_maps and model_cfg.pk_channels == PK
    server = build_server(parse_args(
        ["--weights", path, "--device", "cpu", "--dtype", "f32",
         "--crop-size", "32", "--port", "0", "--max-batch", "2"]))
    planes = 8 + PK
    assert server.engine.seen_shapes == {(1, planes, 32, 32, 1),
                                         (2, planes, 32, 32, 1)}
    server.start()
    try:
        client = SegmentationClient("http://%s:%d" % server.address)
        frames = np.random.default_rng(4).integers(
            0, 256, (planes, 40, 40), dtype=np.uint8)
        mask = client.segment(frames)
        assert mask.shape == (32, 32) and int(mask.max()) <= 1
        assert client.segment(frames, full_size=True).shape == (40, 40)
    finally:
        server.stop()


def test_parse_config_pk_flags():
    cfg = parse_config(["--use-subtraction", "--use-pk-maps",
                        "--generate-pk-maps", "--model-pk-channels", "3"])
    assert cfg.generate_pk_maps and cfg.data.use_pk_maps
    assert cfg.model.use_pk_maps and cfg.model.pk_channels == 3
    assert cfg.tag_suffix == "_pk"
    assert not parse_config([]).generate_pk_maps
