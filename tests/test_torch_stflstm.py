"""The port's STF-LSTM-UNet slice held against the JAX package on the CPU:
the weight bridge, the whole model's eval logits, and the serving engine.

Whole-model tolerance: max |logit difference| <= 1e-4 * max |logit|. Both
sides compute in f32; they differ only in the summation order of the
convolutions (XLA's against ATen/oneDNN's) and of the LSTM products, which
moves each of ~40 layers' outputs by a few f32 ulps. Argmax masks must
agree wherever the two classes' logits differ by more than that bound.
"""

import ast
import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stf_unet_tpu.models.stf_lstm_unet import STFLSTMUNet as JaxSTFLSTMUNet
from stf_unet_tpu.serve.engine import InferenceEngine as JaxEngine
from stf_unet_tpu.utils.torch_export import export_stflstm_state_dict
from stf_unet_tpu_torch.core.config import DataConfig, ModelConfig
from stf_unet_tpu_torch.models.registry import create_model, preprocess_input
from stf_unet_tpu_torch.serve.engine import InferenceEngine
from stf_unet_tpu_torch.utils.weights import stflstm_state_dict_from_jax

T_STEPS = 2
SIZE = 32
REL_TOL = 1e-4
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_model():
    model = JaxSTFLSTMUNet(num_classes=2, time_steps=T_STEPS)
    variables = model.init(jax.random.key(0),
                           jnp.zeros((1, T_STEPS, SIZE, SIZE, 1)),
                           train=False)
    # non-trivial BN statistics, so the bridge's running stats matter
    rng = np.random.default_rng(1)
    stats = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype),
        variables["batch_stats"])
    return model, {"params": variables["params"], "batch_stats": stats}


@pytest.fixture(scope="module")
def port_model(jax_model):
    _, variables = jax_model
    sd = stflstm_state_dict_from_jax(jax.device_get(variables["params"]),
                                     jax.device_get(variables["batch_stats"]))
    model = create_model(ModelConfig(num_classes=1, time_steps=T_STEPS))
    model.load_state_dict(sd, strict=True)
    return model.eval()


def test_weight_bridge_matches_jax_export(jax_model):
    _, variables = jax_model
    want = export_stflstm_state_dict(variables["params"],
                                     variables["batch_stats"])
    got = stflstm_state_dict_from_jax(
        jax.device_get(variables["params"]),
        jax.device_get(variables["batch_stats"]))
    assert list(got) == list(want)
    for k, v in want.items():
        assert isinstance(got[k], torch.Tensor), k
        assert got[k].dtype == torch.from_numpy(np.array(v)).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)


def test_state_dict_keys_are_the_reference_layout(jax_model, port_model):
    _, variables = jax_model
    want = export_stflstm_state_dict(variables["params"],
                                     variables["batch_stats"])
    assert set(port_model.state_dict()) == set(want)
    for k, v in port_model.state_dict().items():
        assert tuple(v.shape) == np.asarray(want[k]).shape, k


def test_whole_model_matches_jax(jax_model, port_model):
    model, variables = jax_model
    x = np.random.default_rng(2).normal(
        size=(2, T_STEPS, SIZE, SIZE, 1)).astype(np.float32)
    want = np.asarray(model.apply(variables, jnp.asarray(x),
                                  train=False)["out"])
    with torch.no_grad():
        got = port_model(preprocess_input(torch.from_numpy(x),
                                          port_model))["out"]
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (2, SIZE, SIZE, 2)
    got = got.numpy()
    tol = REL_TOL * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    decided = np.abs(want[..., 1] - want[..., 0]) > 2 * tol
    np.testing.assert_array_equal(got.argmax(-1)[decided],
                                  want.argmax(-1)[decided])


def test_kernel_backends_match_scan_in_the_model(port_model):
    """On the CPU "fused" and "last" run the kernels' plain versions; the
    whole model gives the same logits through each."""
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(1, T_STEPS, SIZE, SIZE, 1)).astype(np.float32))
    outs = {}
    try:
        for backend in ("scan", "fused", "last"):
            port_model.set_lstm_backend(backend)
            with torch.no_grad():
                outs[backend] = port_model(x)["out"]
    finally:
        port_model.set_lstm_backend("auto")
    scale = outs["scan"].abs().max().item()
    for backend in ("fused", "last"):
        torch.testing.assert_close(outs[backend], outs["scan"], rtol=0,
                                   atol=REL_TOL * scale)


def test_bf16_model_keeps_f32_params_and_logits(port_model):
    model = create_model(ModelConfig(num_classes=1, time_steps=T_STEPS),
                         dtype=torch.bfloat16)
    model.load_state_dict(port_model.state_dict(), strict=True)
    model.eval()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(1, T_STEPS, SIZE, SIZE, 1)).astype(np.float32))
    with torch.no_grad():
        lo = model(x)["out"]
        hi = port_model(x)["out"]
    assert lo.dtype == torch.float32 and torch.isfinite(lo).all()
    agree = (lo.argmax(-1) == hi.argmax(-1)).float().mean().item()
    assert agree > 0.9


def test_engine_matches_jax_engine(jax_model, port_model):
    """Same uint8 batch through both engines (f32): masks and float16
    probabilities; 3 requests pad to the 4 bucket and come back as 3."""
    model, variables = jax_model
    cfg = DataConfig(crop_size=SIZE)
    images = np.random.default_rng(5).integers(
        0, 256, (3, T_STEPS, SIZE, SIZE, 1), dtype=np.uint8)
    jax_eng = JaxEngine(model, variables, cfg.mean, cfg.std, max_batch=4)
    eng = InferenceEngine(port_model, cfg.mean, cfg.std, max_batch=4,
                          device="cpu")
    want_masks, want_probs = jax_eng.predict(images, return_probs=True)
    got_masks, got_probs = eng.predict(images, return_probs=True)
    assert got_masks.dtype == np.int32 and got_masks.shape == (3, SIZE, SIZE)
    assert got_probs.dtype == np.float16
    assert got_probs.shape == (3, SIZE, SIZE, 2)
    assert eng.seen_shapes == {(4, T_STEPS, SIZE, SIZE, 1)}
    # float16 probabilities: 2^-11 relative spacing, plus the logits' tol
    np.testing.assert_allclose(got_probs.astype(np.float32),
                               want_probs.astype(np.float32), atol=2e-3)
    decided = np.abs(want_probs[..., 1].astype(np.float32) - 0.5) > 2e-3
    np.testing.assert_array_equal(got_masks[decided], want_masks[decided])
    # padding rows never change real rows
    per = np.stack([eng.predict(images[i:i + 1])[0] for i in range(3)])
    np.testing.assert_array_equal(eng.predict(images), per)


def test_engine_buckets(port_model):
    eng = InferenceEngine(port_model, 0.5, 0.2, max_batch=8, device="cpu")
    assert [eng._bucket(n) for n in range(1, 9)] == [1, 2, 4, 4, 8, 8, 8, 8]
    eng = InferenceEngine(port_model, 0.5, 0.2, max_batch=6, device="cpu")
    # a non-power-of-two cap is a memory cap: never pad past it
    assert [eng._bucket(n) for n in (3, 5, 6)] == [4, 6, 6]


def test_entry_points_refuse_missing_cuda(port_model):
    """The default device is CUDA; without a GPU the engine raises rather
    than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceEngine(port_model, 0.5, 0.2)
    from stf_unet_tpu_torch.cli.common import restore_for_inference
    with pytest.raises(RuntimeError, match="cuda"):
        restore_for_inference("stflstm", "unused.pth")


def test_unported_variants_raise():
    """The per-frame re-roll mode is ported; a stop agreed across hosts
    needs the process group it agrees over."""
    from stf_unet_tpu_torch.data.transforms import TrainAugment
    from stf_unet_tpu_torch.train.preempt import PreemptionGuard
    assert not TrainAugment(DataConfig(
        shared_frame_augmentation=False)).cfg.shared_frame_augmentation
    with pytest.raises(RuntimeError, match="process group"):
        PreemptionGuard(num_hosts=2)


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


# Modules of the training slice; the check below must reach each of them.
TRAINING_MODULES = (
    "cli/train.py", "core/prng.py", "data/index.py", "data/loader.py",
    "data/synthetic.py", "losses/criterion.py", "losses/dice.py",
    "metrics/confusion.py", "metrics/dice.py", "metrics/meters.py",
    "ops/kernels/lstm_last_x_bwd.py", "ops/kernels/warp.py",
    "train/checkpoint.py", "train/early_stop.py", "train/loop.py",
    "train/schedule.py", "train/state.py",
)
# Modules of the UNet and cli/test slice.
TEST_MODULES = (
    "cli/test.py", "models/unet.py", "metrics/binary.py",
    "metrics/patient.py", "metrics/surface.py", "ops/tta.py",
    "serve/tiled.py", "viz/comparison.py", "viz/overlay.py",
)
# Modules of the PK slice.
PK_MODULES = (
    "pk/__init__.py", "pk/aif.py", "pk/fit.py", "pk/maps.py", "pk/tofts.py",
    "ops/kernels/tofts.py",
)
# Modules of the labels-free deployment path.
DEPLOY_MODULES = (
    "pk/enhanced.py", "pk/debug.py", "cli/predict.py", "cli/pipeline.py",
    "cli/serve.py", "serve/http.py", "serve/engine.py",
)
# Modules of the trainer's diagnostics and the model and data tools.
TOOLS_MODULES = (
    "utils/profiling.py", "models/stf_lstm_unet.py", "cli/val.py",
    "cli/average.py", "cli/migrate.py", "cli/export.py", "cli/stats.py",
    "cli/split.py", "cli/doctor.py", "cli/merge.py",
)
# Modules of data parallelism.
PARALLEL_MODULES = (
    "core/distributed.py", "core/mesh.py", "parallel/__init__.py",
    "parallel/dryrun.py", "models/blocks.py", "train/preempt.py",
    "train/autobatch.py",
)


def test_port_imports_nothing_of_jax():
    files = sorted((REPO / "stf_unet_tpu_torch").rglob("*.py"))
    for rel in (TRAINING_MODULES + TEST_MODULES + PK_MODULES
                + DEPLOY_MODULES + PARALLEL_MODULES + TOOLS_MODULES):
        assert REPO / "stf_unet_tpu_torch" / rel in files, rel
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 40
    forbidden = {"jax", "jaxlib", "flax", "optax", "orbax", "stf_unet_tpu"}
    for path in files:
        bad = forbidden & set(_imported_roots(path))
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"
