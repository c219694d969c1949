"""Spatial parallelism in the port (parallel/spatial.py), the mirror of
tests/test_spatial.py: image rows sharded over the space axis of a 2-D
(data x space) group, with the halo exchanges written by hand, held
against one process and against the JAX package's unsharded step.

Four gloo ranks are spawned once as CPU processes (`ranks`); inside that
one group they build a 2 x 2 and a 1 x 4 mesh and run every library
check, writing their outputs to files; one `cli.train --spatial-parallel
2` run starts beside them. Each is waited on with a timeout that kills
its processes.

Tolerances:
  * the UNet (base_c 4) eval forward at 64^2 on the 2 x 2 mesh against
    one process: rtol / atol 1e-5 (tests/test_spatial.py's); the STF
    forward at 64^2 over 4 space ranks (its 2-row layer4 does not split
    over 4: the uneven-rows rule gathers it): rtol 1e-4, atol 1e-5;
  * the f32 train step of the UNet on 2 x 2 against one process, from a
    fixed batch and through the fused augmentation (K2's plain twin,
    then the row cut): loss rtol 1e-5, parameters rtol 5e-3 / atol 5e-5,
    BN statistics rtol 5e-3 / atol 1e-5 (tests/test_spatial.py's bounds:
    Adam turns f32 reduction-order noise on ~0 gradients into a +-lr
    update at the warmup's first lr, 1e-5);
  * one float64 step of the UNet (16^2) and of the STF-LSTM-UNet (32^2,
    T = 2) on 2 x 2 against the JAX package's make_train_step on the
    whole batch (AdamW eps 0.1): loss 1e-6 relative, parameters and BN
    statistics within 1e-6 of each tensor's largest change, as
    tests/test_torch_data_parallel.py holds its two-rank step;
  * every row-reading op in float64 over 4 space ranks against one
    process (output, input gradient, weight gradient): 1e-10.
"""

import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from stf_unet_tpu_torch.cli import train as train_cli
from stf_unet_tpu_torch.core import distributed
from stf_unet_tpu_torch.core import mesh as mesh_lib
from stf_unet_tpu_torch.core.config import (DataConfig, ModelConfig,
                                            OptimConfig)
from stf_unet_tpu_torch.data.synthetic import make_synthetic_breadm
from stf_unet_tpu_torch.data.transforms import TrainAugment
from stf_unet_tpu_torch.models.registry import (create_model,
                                                preprocess_input)
from stf_unet_tpu_torch.parallel import spatial
from stf_unet_tpu_torch.train.loop import DeviceBatch, train_step
from stf_unet_tpu_torch.train.schedule import warmup_poly_schedule
from stf_unet_tpu_torch.train.state import (TrainState, data_parallel,
                                            make_optimizer)
from stf_unet_tpu_torch.utils.weights import (stflstm_state_dict_from_jax,
                                              unet_state_dict_from_jax)

# The ranks import this module for run_rank, so the JAX package and the
# helpers of tests/test_torch_data_parallel.py (which import it) are
# imported where the test process needs them, not here.
T_UNET, T_STF = 8, 2  # test_torch_data_parallel's, for its weights
WORLD = 4
FWD = 64  # the eval forwards' rows and columns
OP_W = 12  # the op checks' columns

# One rank: argv = workdir rank world port.
CHILD = r"""
import sys
import torch

wd, rank, world, port = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
    sys.argv[4]
torch.set_num_threads(1)
from stf_unet_tpu_torch.core import distributed, mesh as mesh_lib
distributed.initialize(f"localhost:{port}", world, rank, device="cpu")
mesh22 = mesh_lib.create_2d_mesh(2, 2, "cpu")
mesh14 = mesh_lib.create_2d_mesh(1, 4, "cpu")

from test_torch_spatial import run_rank
torch.save(run_rank(torch.load(f"{wd}/inputs.pt", weights_only=False),
                    mesh22, mesh14), f"{wd}/out_{rank}.pt")
distributed.shutdown()
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small CPU steps: the test
    workers share the host's cores, and torch's default of a thread per
    core makes each tiny op of one worker wait on the others'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class FixedBatch:
    """An augmentation that hands back a fixed (data shard's) batch."""

    def __init__(self, images, targets):
        self.batch = (images, targets)

    def __call__(self, gen, frames, masks, sizes, pk=None):
        return self.batch


DUMMY = DeviceBatch(torch.zeros(1), torch.zeros(1), None, None)


def _model(name, t, sd, dtype):
    model = create_model(ModelConfig(model=name, base_c=4, time_steps=t),
                         dtype=dtype).to(dtype)
    model.load_state_dict(sd)
    return model


def _step(name, t, sd, images, targets, dtype, opt_cfg, sched, group=None,
          augment=None, batch=DUMMY):
    """One train step (DDP and the synced BN under `group`): (loss, the
    state_dict after it)."""
    model = _model(name, t, sd, dtype)
    ddp = data_parallel(model, group) if group is not None else None
    state = TrainState(model, make_optimizer(opt_cfg, model,
                                             torch.device("cpu")),
                       group=group, ddp=ddp)
    if augment is None:
        if group is not None:
            images, targets = mesh_lib.shard_batch(group, (images, targets))
        augment = FixedBatch(images, targets)
    loss, _ = train_step(state, augment, batch,
                         torch.Generator().manual_seed(3), sched, 2,
                         torch.device("cpu"))
    return float(loss), {k: v.clone() for k, v in model.state_dict().items()}


def _fwd(name, t, sd, x, group=None):
    """The eval forward's logits: whole, or this rank's block of them."""
    model = _model(name, t, sd, torch.float32).eval()
    with torch.no_grad():
        if group is None:
            return model(preprocess_input(x, model))["out"]
        local = spatial.spatial_sharding(group, x, 2)
        with spatial.row_sharded(group, x.shape[2], x.shape[3]):
            return model(preprocess_input(local, model))["out"]


def _ops():
    """(name, input rows, module) of every row-reading op, seeded; two
    fall back to gathering (a 6-row output does not split over 4; a 7x7
    halo of 3 rows from 2-row shards), and the last two run on the block
    padded with its halos (1-row and 4-row shards, too short for the
    boundary strips)."""
    from stf_unet_tpu_torch.ops.conv import (Conv2d, ConvTranspose2d,
                                             MaxPool2d, max_pool2d)
    from stf_unet_tpu_torch.ops.resize import resize_bilinear_align_corners

    class Fn(torch.nn.Module):
        def __init__(self, fn, *mods):
            super().__init__()
            self.mods = torch.nn.ModuleList(mods)
            self.fn = fn

        def forward(self, x):
            return self.fn(x, *self.mods)

    def resize(x, conv):
        return resize_bilinear_align_corners(conv(x), x.shape[-2],
                                             x.shape[-1])

    torch.manual_seed(4)
    return [
        ("conv3x3", 32, Conv2d(3, 4, 3, padding=1)),
        ("stem7x7s2", 32, Conv2d(3, 4, 7, stride=2, padding=3,
                                 bias=False)),
        ("conv3x3s2", 32, Conv2d(3, 4, 3, stride=2, padding=1)),
        ("conv1x1s2", 32, Conv2d(3, 4, 1, stride=2, bias=False)),
        ("conv1x1", 32, Conv2d(3, 4, 1)),
        ("convT3s2", 16, ConvTranspose2d(3, 4, 3, stride=2, padding=1,
                                         output_padding=1)),
        ("convT2s2", 16, ConvTranspose2d(3, 4, 2, stride=2)),
        ("maxpool3s2", 32, MaxPool2d(3, 2, 1)),
        ("maxpool2", 32, Fn(lambda x: max_pool2d(x, 2))),
        ("resize", 32, Fn(resize, Conv2d(3, 3, 3, stride=2, padding=1))),
        ("gathered_conv3x3s2", 12, Conv2d(3, 4, 3, stride=2, padding=1)),
        ("gathered_stem", 8, Conv2d(3, 4, 7, stride=2, padding=3)),
        ("padded_conv3x3", 4, Conv2d(3, 4, 3, padding=1)),
        ("padded_stem", 16, Conv2d(3, 4, 7, stride=2, padding=3)),
    ]


N_OPS = 14


def _op_inputs(rows):
    rng = np.random.default_rng(rows)
    return torch.from_numpy(rng.normal(size=(2, 3, rows, OP_W)))


def _op_grad(shape):
    rng = np.random.default_rng(list(shape))
    return torch.from_numpy(rng.normal(size=shape))


def _op_run(mod, x, group=None):
    """(y, dx, parameter gradients) of sum(op(x) * g), g seeded by the
    output's shape; under `group` (1 x n_space) this rank's rows, the
    rows of a whole output counted by space rank 0 alone."""
    mod = mod.double()
    mod.zero_grad()
    if group is None:
        x = x.clone().requires_grad_()
        y = mod(x)
        (y * _op_grad(y.shape)).sum().backward()
        return y.detach(), x.grad, [p.grad for p in mod.parameters()]
    height = x.shape[-2]
    xl = spatial.cut_rows(group, x, 2).clone().requires_grad_()
    with spatial.row_sharded(group, height, x.shape[-1]) as plan:
        y = mod(xl)
    whole = plan.heights.get((y.shape[-2], y.shape[-1]))
    if spatial.splits(whole, group.n_space):
        g = _op_grad((*y.shape[:2], whole, y.shape[-1]))
        loss = (y * spatial.cut_rows(group, g, 2)).sum()
    else:
        loss = (y * _op_grad(y.shape)).sum() * (group.space_index == 0)
    loss.backward()
    grads = [mesh_lib.all_sum(group, p.grad.clone())
             for p in mod.parameters()]
    return y.detach(), xl.grad, grads


def run_rank(inp, mesh22, mesh14) -> dict:
    """Every library check on this rank of the 4-rank group."""
    cpu = torch.device("cpu")
    out = {}
    out["unet_fwd"] = _fwd("unet", T_UNET, inp["unet32"], inp["unet_x"],
                           mesh22)
    out["stf_fwd"] = _fwd("stflstm", T_STF, inp["stf32"], inp["stf_x"],
                          mesh14)
    # float64 steps against JAX
    sched = warmup_poly_schedule(1e-3, 2, 3, warmup=False)
    for name, t in (("unet", T_UNET), ("stflstm", T_STF)):
        out[f"{name}_step64"] = _step(
            name, t, inp[name]["sd"], inp[name]["images"],
            inp[name]["targets"], torch.float64,
            OptimConfig(warmup=False, eps=0.1), sched, mesh22)
    # f32 steps at tests/test_spatial.py's optimizer: a fixed batch, then
    # the fused augmentation of uint8 frames
    jsched = warmup_poly_schedule(1e-2, 4, 2)
    f32 = inp["f32"]
    out["step32"] = _step("unet", 2, f32["sd"], f32["images"],
                          f32["targets"], torch.float32, OptimConfig(),
                          jsched, mesh22)
    aug = inp["aug"]
    rows = slice(mesh22.data_index * 2, mesh22.data_index * 2 + 2)
    out["aug32"] = _step(
        "unet", 2, f32["sd"], None, None, torch.float32, OptimConfig(),
        jsched, mesh22,
        augment=TrainAugment(aug["cfg"], mesh22.data_index, mesh22.n_data),
        batch=DeviceBatch(aug["frames"][rows], aug["masks"][rows], None,
                          aug["sizes"][rows]))
    # every row-reading op over 4 space ranks, float64
    out["ops"] = {name: _op_run(mod, _op_inputs(rows), mesh14)
                  for name, rows, mod in _ops()}
    plan_text = []
    with spatial.row_sharded(mesh14, 64, 48) as plan:
        model = _model("stflstm", T_STF, inp["stf32"], torch.float32)
        with torch.no_grad():
            model.eval()(torch.zeros(1, T_STF, 16, 48, 1))
        plan_text.append(plan.report())
    out["plan"] = (plan.heights, plan.choices, plan_text)
    return out


def _unet_images(seed, shape):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape)).float()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The inputs, the JAX steps, each rank's outputs; the CLI run's
    result and log."""
    from test_torch_data_parallel import CLI_RUNNER, _env, _wait

    wd = tmp_path_factory.mktemp("spatial")
    here = os.path.dirname(os.path.abspath(__file__))
    tree = str(wd / "tree")
    make_synthetic_breadm(tree, size=40, seed=5)
    cli_out = str(wd / "cli.json")
    cli = [[sys.executable, "-c", CLI_RUNNER, "train", cli_out,
            "--data-path", tree, "--model", "unet", "--model-base-c", "4",
            "--device", "cpu", "--spatial-parallel", "2", "--epochs", "1",
            "--batch-size", "2", "--data-base-size", "40",
            "--data-crop-size", "32", "--print-freq", "1",
            "--save-dir", str(wd / "w"), "--output-dir", str(wd / "o")]]
    # the CLI run first, the ranks once their inputs exist, the JAX
    # steps in this process meanwhile
    with ThreadPoolExecutor(4) as pool:
        cli_run = pool.submit(_wait, cli, _env(here))
        try:
            inp, starts = _inputs(wd)
            port = distributed.free_port()
            rank_runs = pool.submit(_wait, [
                [sys.executable, "-c", CHILD, str(wd), str(r), str(WORLD),
                 str(port)] for r in range(WORLD)], _env(here))
            try:  # the two compile side by side
                steps = {name: pool.submit(_jax_step, starts[name],
                                           inp[name])
                         for name in ("unet", "stflstm")}
                jax_steps = {name: f.result() for name, f in steps.items()}
            finally:
                rank_runs.result()
        finally:
            log = cli_run.result()[0]
    with open(cli_out) as f:
        result = json.load(f)
    return (inp, jax_steps, [torch.load(str(wd / f"out_{r}.pt"),
                                        weights_only=False)
                             for r in range(WORLD)], result, log, str(wd))


def _inputs(wd):
    """The ranks' inputs, saved to wd/inputs.pt, and the JAX models and
    variables of the steps they are held to."""
    import jax

    from test_torch_data_parallel import (_jax_stf_start, _jax_unet_start,
                                          _step_batch)

    starts = {"unet": _jax_unet_start(), "stflstm": _jax_stf_start()}
    bridge = {"unet": unet_state_dict_from_jax,
              "stflstm": stflstm_state_dict_from_jax}
    inp = {}
    for name, (t, size) in (("unet", (T_UNET, 16)),
                            ("stflstm", (T_STF, 32))):
        _, variables = starts[name]
        images, targets = _step_batch(len(name), t, size)
        sd = bridge[name](jax.device_get(variables["params"]),
                          jax.device_get(variables["batch_stats"]))
        inp[name] = {"sd": {k: v.double() if v.is_floating_point() else v
                            for k, v in sd.items()},
                     "images": torch.from_numpy(images),
                     "targets": torch.from_numpy(targets)}
    inp["unet32"] = {k: v.float() if v.is_floating_point() else v
                     for k, v in inp["unet"]["sd"].items()}
    inp["stf32"] = {k: v.float() if v.is_floating_point() else v
                    for k, v in inp["stflstm"]["sd"].items()}
    inp["unet_x"] = _unet_images(1, (4, T_UNET, FWD, FWD, 1))
    inp["stf_x"] = _unet_images(2, (1, T_STF, FWD, FWD, 1))
    torch.manual_seed(0)
    f32 = create_model(ModelConfig(model="unet", base_c=4, time_steps=2))
    rng = np.random.default_rng(3)
    inp["f32"] = {"sd": f32.state_dict(),
                  "images": torch.from_numpy(rng.normal(
                      size=(4, 2, 32, 32, 1))).float(),
                  "targets": torch.from_numpy(
                      (rng.random((4, 32, 32)) > 0.7).astype(np.int64))}
    rng = np.random.default_rng(7)
    inp["aug"] = {"cfg": DataConfig(base_size=40, crop_size=32),
                  "frames": torch.from_numpy(rng.integers(
                      0, 256, (4, 2, 40, 40), dtype=np.uint8)),
                  "masks": torch.from_numpy((rng.random((4, 40, 40)) > 0.7)
                                            .astype(np.uint8)),
                  "sizes": np.asarray([[40, 40], [36, 40], [40, 30],
                                       [40, 40]], np.int32)}
    torch.save(inp, str(wd / "inputs.pt"))
    return inp, starts


def _jax_step(start, batch):
    """The JAX package's make_train_step, once, in float64 on the whole
    batch (AdamW eps 0.1, no warmup): (loss, its variables after)."""
    import jax
    import jax.numpy as jnp

    from stf_unet_tpu.core.config import OptimConfig as JaxOptimConfig
    from stf_unet_tpu.train.loop import \
        make_train_step as jax_make_train_step
    from stf_unet_tpu.train.schedule import \
        warmup_poly_schedule as jax_warmup_poly_schedule
    from stf_unet_tpu.train.state import TrainState as JaxTrainState
    from stf_unet_tpu.train.state import \
        make_optimizer as jax_make_optimizer

    model, variables = start
    jcfg = JaxOptimConfig(warmup=False, eps=0.1)
    with jax.enable_x64(True):
        params, stats = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64),
            (variables["params"], variables["batch_stats"]))
        schedule = jax_warmup_poly_schedule(jcfg.lr, 2, 3, warmup=False)
        optim = jax_make_optimizer(jcfg, schedule)
        state = JaxTrainState(params=params, batch_stats=stats,
                              opt_state=optim.init(params),
                              step=jnp.zeros((), jnp.int32))
        step = jax_make_train_step(model, optim, schedule, 2)
        state, loss, _ = step(state, jnp.asarray(batch["images"]),
                              jnp.asarray(batch["targets"], jnp.int32))
        return float(loss), jax.device_get(state)


def _blocks(outs, key, data, space, rows_dim=1):
    """The whole tensor from the ranks' blocks: rank r holds data shard
    r // space, row shard r % space."""
    shards = [torch.cat([outs[d * space + s][key] for s in range(space)],
                        dim=rows_dim) for d in range(data)]
    return torch.cat(shards, dim=0)


def test_unet_sharded_forward_matches_unsharded(ranks):
    inp, _, outs, *_ = ranks
    want = _fwd("unet", T_UNET, inp["unet32"], inp["unet_x"])
    got = _blocks(outs, "unet_fwd", 2, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_stflstm_sharded_forward_matches_unsharded(ranks):
    """64^2 over 4 space ranks: layer4's 2 rows do not split over 4, so
    the uneven-rows rule computes that level whole on every rank."""
    inp, _, outs, *_ = ranks
    want = _fwd("stflstm", T_STF, inp["stf32"], inp["stf_x"])
    got = _blocks(outs, "stf_fwd", 1, 4)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_the_rule_splits_every_level_it_can_and_says_so(ranks):
    heights, choices, (text,) = ranks[2][0]["plan"]
    # rows 64 x 48 over 4: levels 64 .. 4 split, 2 whole
    assert sorted(set(heights.values()), reverse=True) == [64, 32, 16, 8,
                                                           4, 2]
    assert text.startswith("spatial rows, 64x48 over 4 space ranks: "
                           "64 rows split 16/rank")
    assert "2 rows whole" in text and "conv3x3s2 4->2" in text
    gathered = {k for k, mode in choices.items() if mode == "gathered"}
    assert ("conv3x3s2", 4, 2) in gathered  # layer4's first conv
    assert ("conv1x1s2", 4, 2) in gathered  # and its shortcut
    assert choices[("conv7x7s2", 64, 32)] == "halo"
    assert choices[("maxpool3s2", 32, 16)] == "halo"
    assert choices[("convT3x3s2", 4, 8)] == "halo"
    assert choices[("convT3x3s2", 2, 4)] == "whole"
    assert choices[("conv3x3s1", 2, 2)] == "whole"  # layer4's own convs
    assert "; whole: " in text
    assert choices[("resize", 32, 64)] == "gathered"


@pytest.mark.parametrize("name", ["unet", "stflstm"])
def test_sharded_step_matches_jax_one_process(ranks, name):
    """One float64 step on the 2 x 2 mesh (each rank 2 images' half
    rows), from the JAX weights, against the JAX package's unsharded
    make_train_step on the 4-image batch."""
    inp, jax_steps, outs, *_ = ranks
    jloss, jstate = jax_steps[name]
    bridge = (unet_state_dict_from_jax if name == "unet"
              else stflstm_state_dict_from_jax)
    want = bridge(jstate.params, jstate.batch_stats)
    start = inp[name]["sd"]
    for o in outs:
        loss, got = o[f"{name}_step64"]
        assert loss == pytest.approx(jloss, rel=1e-6)
        assert set(got) == set(want)
        for key, w in want.items():
            if key.endswith("num_batches_tracked"):
                continue
            w = w.double().numpy()
            delta = np.abs(w - start[key].numpy()).max()
            np.testing.assert_allclose(got[key].numpy(), w, rtol=0,
                                       atol=max(1e-6 * delta, 1e-12),
                                       err_msg=key)
    for key in want:  # the ranks hold one state
        for o in outs[1:]:
            assert torch.equal(outs[0][f"{name}_step64"][1][key],
                               o[f"{name}_step64"][1][key]), key


def _check_f32_step(got, want):
    (loss, sd), (wloss, wsd) = got, want
    assert loss == pytest.approx(wloss, rel=1e-5)
    for key, w in wsd.items():
        if key.endswith("num_batches_tracked"):
            assert torch.equal(sd[key], w)
            continue
        stat = key.endswith(("running_mean", "running_var"))
        np.testing.assert_allclose(sd[key].numpy(), w.numpy(), rtol=5e-3,
                                   atol=1e-5 if stat else 5e-5,
                                   err_msg=key)


def test_full_train_step_on_2x2_matches_one_process(ranks):
    inp, _, outs, *_ = ranks
    f32 = inp["f32"]
    want = _step("unet", 2, f32["sd"], f32["images"], f32["targets"],
                 torch.float32, OptimConfig(), warmup_poly_schedule(1e-2, 4,
                                                                    2))
    for o in outs:
        _check_f32_step(o["step32"], want)


def test_fused_augment_step_on_2x2_matches_one_process(ranks):
    """uint8 frames through TrainAugment (K2's plain twin) on the data
    shard's whole images, then the row cut, against one process."""
    inp, _, outs, *_ = ranks
    aug, f32 = inp["aug"], inp["f32"]
    want = _step("unet", 2, f32["sd"], None, None, torch.float32,
                 OptimConfig(), warmup_poly_schedule(1e-2, 4, 2),
                 augment=TrainAugment(aug["cfg"]),
                 batch=DeviceBatch(aug["frames"], aug["masks"], None,
                                   aug["sizes"]))
    for o in outs:
        _check_f32_step(o["aug32"], want)
    assert outs[0]["aug32"][0] != outs[0]["step32"][0]


@pytest.mark.parametrize("index", range(N_OPS))
def test_each_row_op_passes_gradients_through_its_halo(ranks, index):
    ops = _ops()
    assert len(ops) == N_OPS
    name, rows, mod = ops[index]
    _, _, outs, *_ = ranks
    y, dx, grads = _op_run(mod, _op_inputs(rows))
    whole = outs[0]["ops"][name][0].shape[-2] == y.shape[-2]
    got_y = (outs[0]["ops"][name][0] if whole else
             torch.cat([o["ops"][name][0] for o in outs], dim=2))
    got_dx = torch.cat([o["ops"][name][1] for o in outs], dim=2)
    tol = dict(rtol=0, atol=1e-10)
    np.testing.assert_allclose(got_y.numpy(), y.numpy(), **tol)
    np.testing.assert_allclose(got_dx.numpy(), dx.numpy(), **tol)
    for o in outs:
        for g, w in zip(o["ops"][name][2], grads):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **tol)


def test_cli_train_spatial_parallel_end_to_end(ranks):
    """cli.train --spatial-parallel 2 --device cpu: a 1 x 2 mesh of gloo
    ranks trains an epoch, evaluates with the rows sharded and runs the
    test pass to finite metrics."""
    *_, cli, log, _ = ranks
    assert "2-D mesh: 1 data x 2 spatial shards" in log
    assert "spatial rows, 32x32 over 2 space ranks: 32 rows split" in log
    assert cli["steps"] == 2  # 4 training slices, batch 2
    epoch = cli["epochs"][0]
    assert np.isfinite(epoch["train_loss"]) and 0.0 <= epoch["dice"] <= 1.0
    assert np.isfinite(cli["test"]["dice"])


@pytest.mark.parametrize("flags,message", [
    (["--multihost"], "single-process only"),
    (["--batch-size", "auto"], "does not model --spatial-parallel"),
])
def test_spatial_parallel_refuses_what_jax_refuses(flags, message, capsys):
    with pytest.raises(SystemExit) as e:
        train_cli.run(["--data-path", "/nonexistent", "--device", "cpu",
                       "--spatial-parallel", "2", *flags])
    assert message in str(e.value)


def test_mesh_shape_follows_the_jax_rule(monkeypatch):
    assert mesh_lib.mesh_2d_shape(2, 0, "cpu") == (1, 2)
    assert mesh_lib.mesh_2d_shape(2, 3, "cpu") == (3, 2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert mesh_lib.mesh_2d_shape(2, 0, "cuda") == (2, 2)
    assert mesh_lib.mesh_2d_shape(4, 1, "cuda") == (1, 4)
    with pytest.raises(ValueError, match="mesh 3x2 needs 6 devices, have 4"):
        mesh_lib.mesh_2d_shape(2, 3, "cuda")
    with pytest.raises(ValueError, match="mesh 2x2 needs 4 processes"):
        mesh_lib.create_2d_mesh(2, 2, "cpu")
    assert mesh_lib.create_2d_mesh(1, 1, "cpu").n_space == 1
