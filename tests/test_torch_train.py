"""The port's training slice held against the JAX package on the CPU: the
criterion, the schedule, the eval metrics, one AdamW step against
optax.adamw, the host loader's batches, and one whole train-mode step of
STF-LSTM-UNet (loss, every parameter gradient, the BN running statistics)
against jax.value_and_grad of the JAX train step's loss function.

Tolerances:
  * criterion, schedule, metrics, AdamW: 1e-6 (f32 arithmetic of the same
    formulas in another operation order; the metrics count exactly);
  * host loader: bytes and order equal;
  * whole step, B=2, T=2, crop 32. The same function: the port and JAX
    both in float64, every gradient within 1e-6 * max |gradient| of its
    tensor, the loss within 1e-6 relative (both take the cross-entropy of
    f32 logits, as the JAX package does). The slice's dtype, f32: loss
    within 1e-5 relative of JAX's f32 loss; each port f32 gradient within
    1e-2 * max |gradient| of JAX's float64 one. At this size train-mode BN
    normalizes the 1/32 scale over B*T = 4 values per channel, and the f32
    gradients of either package sit several 1e-3 of a tensor's max from
    float64, so two f32 implementations cannot be held to each other at
    1e-3; the float64 comparison is the tight one (ROADMAP.md §3). BN
    running means within 1e-5 * max |mean| (+1e-6) of JAX's f32 update,
    running variances likewise after torch's unbiased correction (see
    test_whole_train_step_matches_jax).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from stf_unet_tpu.data.index import DatasetIndex as JaxIndex
from stf_unet_tpu.data.loader import HostLoader as JaxHostLoader
from stf_unet_tpu.losses.criterion import criterion as jax_criterion
from stf_unet_tpu.losses import dice as jax_dice
from stf_unet_tpu.metrics import confusion as jax_conf
from stf_unet_tpu.metrics import dice as jax_mdice
from stf_unet_tpu.models.stf_lstm_unet import STFLSTMUNet as JaxSTFLSTMUNet
from stf_unet_tpu.train.schedule import \
    warmup_poly_schedule as jax_schedule
from stf_unet_tpu_torch.core.config import ModelConfig, OptimConfig
from stf_unet_tpu_torch.data.index import DatasetIndex
from stf_unet_tpu_torch.data.loader import HostLoader
from stf_unet_tpu_torch.data.synthetic import make_synthetic_breadm
from stf_unet_tpu_torch.losses import criterion as crit
from stf_unet_tpu_torch.losses import dice as port_dice
from stf_unet_tpu_torch.metrics import confusion as conf
from stf_unet_tpu_torch.metrics import dice as mdice
from stf_unet_tpu_torch.models.registry import create_model
from stf_unet_tpu_torch.train.loop import loss_and_grads
from stf_unet_tpu_torch.train.schedule import warmup_poly_schedule
from stf_unet_tpu_torch.train.state import make_optimizer
from stf_unet_tpu_torch.utils.weights import stflstm_state_dict_from_jax

T_STEPS = 2
SIZE = 32


def _logits_targets(seed, b=2, h=12, w=10, c=3, ignore=None):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, h, w, c)).astype(np.float32) * 3
    targets = rng.integers(0, c, (b, h, w)).astype(np.int64)
    if ignore is not None:
        targets[:, :3] = ignore
    return logits, targets


@pytest.mark.parametrize("ignore", [-100, 255])
@pytest.mark.parametrize("weighted", [False, True])
def test_criterion_matches_jax(ignore, weighted):
    logits, targets = _logits_targets(1, ignore=ignore)
    weight = np.array([0.5, 1.0, 4.0], np.float32) if weighted else None
    want = jax_criterion(
        {"out": jnp.asarray(logits)}, jnp.asarray(targets, jnp.int32),
        loss_weight=None if weight is None else jnp.asarray(weight),
        num_classes=3, ignore_index=ignore)
    got = crit.criterion(
        {"out": torch.from_numpy(logits)}, torch.from_numpy(targets),
        loss_weight=None if weight is None else torch.from_numpy(weight),
        num_classes=3, ignore_index=ignore)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)


def test_dice_pieces_match_jax():
    logits, targets = _logits_targets(2, ignore=255)
    targets[1] = 0  # one image without foreground: the empty-set guard
    jt = jax_dice.build_target(jnp.asarray(targets, jnp.int32), 3, 255)
    pt = port_dice.build_target(torch.from_numpy(targets), 3, 255)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    for c in range(3):
        want = jax_dice.dice_coeff(jnp.asarray(probs[..., c]), jt[..., c],
                                   ignore_index=255)
        got = port_dice.dice_coeff(torch.from_numpy(probs[..., c]),
                                   pt[..., c], ignore_index=255)
        np.testing.assert_allclose(got.item(), float(want), atol=1e-6)
    zero = torch.zeros((1, 4, 4))
    assert port_dice.dice_coeff(zero, zero).item() == pytest.approx(1.0)
    want = jax_dice.dice_loss(jnp.asarray(logits), jt, ignore_index=255)
    got = port_dice.dice_loss(torch.from_numpy(logits), pt, ignore_index=255)
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6)


@pytest.mark.parametrize("warmup", [True, False])
def test_schedule_matches_jax(warmup):
    kw = dict(warmup=warmup, warmup_epochs=2, warmup_factor=1e-3,
              power=0.9)
    want = jax_schedule(1e-3, 7, 5, **kw)
    got = warmup_poly_schedule(1e-3, 7, 5, **kw)
    for step in range(0, 40):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=0,
                                   atol=1e-6 * 1e-3)
    assert got(35) == 0.0


def test_eval_metrics_match_jax():
    logits, targets = _logits_targets(3, b=3, ignore=255)
    targets[2] = 255  # an image that is all padding: union 0 -> dice 1
    pred = logits.argmax(-1)
    want = jax_conf.confusion_update(jax_conf.confusion_init(3),
                                     jnp.asarray(targets, jnp.int32),
                                     jnp.asarray(pred, jnp.int32))
    got = conf.confusion_update(conf.confusion_init(3),
                                torch.from_numpy(targets),
                                torch.from_numpy(pred))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    mat = got.numpy()
    assert conf.format_confusion(mat) == jax_conf.format_confusion(mat)
    assert conf.confusion_report(mat) == jax_conf.confusion_report(mat)

    cum, cnt = jax_mdice.eval_dice_update(
        jnp.zeros((3,), jnp.float32), jnp.zeros((), jnp.int32),
        jnp.asarray(logits), jnp.asarray(targets, jnp.int32))
    pcum, pcnt = mdice.eval_dice_update(torch.zeros(3), 0,
                                        torch.from_numpy(logits),
                                        torch.from_numpy(targets))
    assert pcnt == int(cnt) == 3
    np.testing.assert_allclose(pcum.numpy(), np.asarray(cum), atol=1e-6)
    np.testing.assert_allclose(mdice.eval_dice_value(pcum, pcnt),
                               float(jax_mdice.eval_dice_value(cum, cnt)),
                               atol=1e-6)


def test_adamw_step_matches_optax():
    """torch.optim.AdamW (decoupled decay, eps outside the sqrt) and
    optax.adamw compute the same update, over three steps."""
    rng = np.random.default_rng(4)
    p0 = rng.normal(size=(5, 7)).astype(np.float32)
    grads = [rng.normal(size=(5, 7)).astype(np.float32) for _ in range(3)]
    cfg = OptimConfig()
    lrs = [1e-3, 5e-4, 2e-4]

    model = torch.nn.Linear(7, 5, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(p0))
    opt = make_optimizer(cfg, model, torch.device("cpu"))
    tx = optax.adamw(learning_rate=lambda count: jnp.asarray(lrs)[count],
                     b1=cfg.beta1, b2=cfg.beta2, eps=cfg.eps,
                     weight_decay=cfg.weight_decay)
    params = jnp.asarray(p0)
    opt_state = tx.init(params)
    for g, lr in zip(grads, lrs):
        for group in opt.param_groups:
            group["lr"] = lr
        model.weight.grad = torch.from_numpy(g)
        opt.step()
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, params)
        params = params + updates
        np.testing.assert_allclose(model.weight.detach().numpy(),
                                   np.asarray(params), atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def small_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("breadm")
    make_synthetic_breadm(str(root), size=40, patients_per_split=3,
                          slices_per_patient=3, seed=7)
    return str(root)


@pytest.mark.parametrize("batch_size,drop_last", [(2, False), (4, True)])
def test_host_loader_matches_jax(small_tree, batch_size, drop_last):
    seqs = tuple(f"VIBRANT+C{i}" for i in range(1, 9))
    jidx = JaxIndex(small_tree, "train", seqs)
    pidx = DatasetIndex(small_tree, "train", seqs)
    jl = JaxHostLoader(jidx, batch_size, shuffle=True, seed=3,
                       drop_last=drop_last, use_native=False, prefetch=0)
    pl = HostLoader(pidx, batch_size, shuffle=True, seed=3,
                    drop_last=drop_last, prefetch=2)
    assert len(pl) == len(jl) and pl.canvas == jl.canvas
    for epoch in (0, 1):
        want = list(jl.epoch(epoch))
        got = list(pl.epoch(epoch))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for name in ("frames", "masks", "sizes"):
                a, b = getattr(g, name), getattr(w, name)
                assert a.dtype == b.dtype, name
                np.testing.assert_array_equal(a, b, err_msg=name)
    skipped = list(pl.epoch(1, skip_batches=1))
    np.testing.assert_array_equal(skipped[0].frames, got[1].frames)


# ---------------------------------------------------------------------------
# The slice as a whole: one train-mode step against JAX
# ---------------------------------------------------------------------------

def _jax_loss_fn(model):
    """The JAX train step's loss function (stf_unet_tpu/train/loop.py:
    82-90, with make_train_step's default ignore_index and no class
    weights)."""
    def loss_fn(params, batch_stats, images, targets):
        outputs, mutated = model.apply(
            {"params": params, "batch_stats": batch_stats}, images,
            train=True, mutable=["batch_stats"])
        loss = jax_criterion(outputs, targets, num_classes=2,
                                  ignore_index=-100)
        return loss, mutated["batch_stats"]
    return loss_fn


def _port_step(state_dict, images, targets, dtype):
    """The port's model at `dtype` (parameters and compute), one
    train-mode forward + backward; (loss, {name: grad}, model)."""
    model = create_model(ModelConfig(num_classes=1, time_steps=T_STEPS),
                         dtype=dtype).to(dtype)
    model.load_state_dict(state_dict, strict=True)
    rows = {}
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.register_forward_pre_hook(
                lambda m, inp, name=name: rows.__setitem__(
                    name, inp[0].numel() // inp[0].shape[1]))
    loss = loss_and_grads(model, torch.from_numpy(images).to(dtype),
                          torch.from_numpy(targets), num_classes=2)
    grads = {n: p.grad.double().numpy() for n, p in model.named_parameters()}
    return loss.item(), grads, model, rows


def test_whole_train_step_matches_jax():
    jmodel = JaxSTFLSTMUNet(num_classes=2, time_steps=T_STEPS)
    variables = jmodel.init(jax.random.key(0),
                            jnp.zeros((1, T_STEPS, SIZE, SIZE, 1)),
                            train=False)
    rng = np.random.default_rng(1)
    stats = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype),
        variables["batch_stats"])
    params = variables["params"]
    images = rng.normal(size=(2, T_STEPS, SIZE, SIZE, 1)).astype(np.float32)
    targets = rng.integers(0, 2, (2, SIZE, SIZE)).astype(np.int64)

    step = jax.value_and_grad(_jax_loss_fn(jmodel), has_aux=True)
    jtargets = jnp.asarray(targets, jnp.int32)
    (jloss, jstats), _ = jax.jit(step)(params, stats, jnp.asarray(images),
                                        jtargets)
    with jax.enable_x64(True):
        f64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), (params, stats, images))
        (jloss64, _), jgrads = jax.jit(step)(*f64, jtargets)
        jloss64, jgrads = float(jloss64), jax.device_get(jgrads)
    old = stflstm_state_dict_from_jax(jax.device_get(params),
                                      jax.device_get(stats))
    want = stflstm_state_dict_from_jax(jgrads, jax.device_get(jstats))

    loss64, grads64, _, _ = _port_step(old, images, targets, torch.float64)
    np.testing.assert_allclose(loss64, jloss64, rtol=1e-6)
    loss, grads, model, bn_rows = _port_step(old, images, targets,
                                             torch.float32)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    assert set(grads) <= set(want)
    for name in grads:
        ref = want[name].double().numpy()
        scale = np.abs(ref).max()
        np.testing.assert_allclose(grads64[name], ref, atol=1e-6 * scale,
                                   rtol=0, err_msg=f"{name} (float64)")
        np.testing.assert_allclose(grads[name], ref, atol=1e-2 * scale,
                                   rtol=0, err_msg=f"{name} (f32)")

    # BN running statistics after the step. flax updates the running
    # variance with the biased batch variance; torch (the reference's
    # BatchNorm2d) with the unbiased one, n/(n-1) larger, n = rows per
    # channel. Recover the batch variance from JAX's update, then hold the
    # port to torch's rule.
    sd = model.state_dict()
    assert len(bn_rows) == sum(k.endswith("running_var") for k in sd)
    for bn, n in bn_rows.items():
        for stat in ("running_mean", "running_var"):
            key = f"{bn}.{stat}"
            prev, upd = old[key].double(), want[key].double()
            expect = upd
            if stat == "running_var":
                batch_var = (upd - 0.9 * prev) / 0.1
                expect = 0.9 * prev + 0.1 * batch_var * n / (n - 1)
            tol = 1e-5 * expect.abs().max().item() + 1e-6
            np.testing.assert_allclose(sd[key].double().numpy(),
                                       expect.numpy(), atol=tol, rtol=0,
                                       err_msg=key)
