"""The plain reference against the port on the CPU at a small size, in
float32 (the port's kernels take their plain twins here): the two
models' forwards in eval and train mode with the benchmark's seeded
weights, and the augmentation."""

import json

import numpy as np
import pytest
import torch

import portbench_tiny

from portbench.harness.weights import load_into, seeded_weights
from portbench.reference import train as ref_train
from portbench.reference.models import stflstm, unet

REFS = {"stflstm": stflstm, "unet": unet}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config(name):
    return json.loads((portbench_tiny.REPO / "portbench" / "configs"
                       / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["stflstm", "unet"])
@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_the_port(name, train):
    from stf_unet_tpu_torch.core.config import ModelConfig
    from stf_unet_tpu_torch.models.registry import (create_model,
                                                    preprocess_input)

    cfg = _config(name)
    model = create_model(ModelConfig(model=name))
    weights = seeded_weights(model, 2**31 + 5, torch.device("cpu"),
                             cfg["zero_leaves"])
    load_into(model, weights)
    x = torch.randn(2, 8, 32, 32, 1, generator=torch.Generator()
                    .manual_seed(1))
    model.train(train)
    with torch.no_grad():
        got = model(preprocess_input(x, model))["out"]
        want = REFS[name].forward(weights, x, cfg["architecture"], train)
    assert got.shape == want.shape == (2, 32, 32, 2)
    err = float((got - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()) + 1e-6, err


def test_augmentation_matches_the_port():
    from stf_unet_tpu_torch.core.config import DataConfig
    from stf_unet_tpu_torch.core.prng import augment_generator
    from stf_unet_tpu_torch.data.transforms import TrainAugment

    aug = {"base_size": 64, "crop_size": 48, "hflip_prob": 0.5,
           "vflip_prob": 0.5, "rotate_degrees": 30.0, "rotate_prob": 0.5,
           "mean": 0.709, "std": 0.127}
    rng = np.random.default_rng(3)
    frames = torch.from_numpy(rng.integers(0, 256, (4, 8, 64, 64),
                                           dtype=np.uint8))
    masks = torch.from_numpy(rng.integers(0, 2, (4, 64, 64), dtype=np.uint8))
    sizes = torch.full((4, 2), 64, dtype=torch.int32)
    for step in range(3):
        images, targets = TrainAugment(DataConfig(**aug))(
            augment_generator(77, 0, step), frames, masks, sizes.numpy())
        r_images, r_targets = ref_train.augment(77, 0, step, frames, masks,
                                                sizes, aug)
        assert torch.equal(targets, r_targets)
        assert float((images - r_images).abs().max()) <= 1e-5


def test_fp8_control_rounds_operands():
    from portbench.reference import nn as rnn

    x = torch.linspace(-3, 3, 1000, requires_grad=True)
    y = rnn.fp8(x)
    assert 0 < float((y - x).detach().abs().max()) <= 3 * 2 ** -3
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))


def test_the_window_stretch_is_repeated_exactly(tmp_path):
    """In float32 on the CPU the reference repeats the window's own first
    steps, from the state the program held when the window opened, to
    rounding (leaves with a gradient, as the check compares them)."""
    from portbench.harness import common
    from portbench.harness.run import Run
    from portbench.harness.spec import Spec
    from portbench.drivers import train_loop
    from portbench.reference.compare import eligible_leaves, leaf_norms

    root = portbench_tiny.tiny_root(tmp_path)
    run = Run.of(Spec(root), "unet.train.b16", 2**31 + 21, 1.0, False,
                 torch.device("cpu"))
    stepper, weights, names = train_loop._build(run, common.Spans())
    train_loop._first_steps(stepper, weights, 3)
    probes = train_loop.window_probes(stepper, 2)
    train_loop.window(stepper, probes, lambda: True)
    stretches = [p.stretch() for p in probes]
    assert [(s.t0, s.positions) for s in stretches] == [
        (3, [(0, 3), (1, 0)]), (4, [(1, 0), (1, 1)])]
    refs = train_loop.reference(run, weights, names, stretches)
    for stretch, (losses, grads, _) in zip(stretches, refs):
        assert max(abs(a - b) / b
                   for a, b in zip(stretch.losses, losses)) < 1e-5
        norms = leaf_norms(grads)
        for k in eligible_leaves(norms):
            err = float((stretch.grads[k] - grads[k]).norm()) / norms[k]
            assert err < 1e-3, (k, err)
