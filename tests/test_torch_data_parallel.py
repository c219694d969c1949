"""Data parallelism in the port held against the JAX package and against
the port's own one-process runs, on the CPU.

Every multi-rank case is two gloo ranks in spawned processes on a free
localhost port; each scenario spawns once, writes its numbers to files
and is waited on with a timeout (its processes killed on expiry, so no
case can hang). The library scenario (`ranks`) covers the synced BN, one
whole DDP step of the UNet (base_c 4) and of the STF-LSTM-UNet (T = 2,
32^2), the CE normalizer, evaluate's two modes, int8 evaluation, the
agreed stop, checkpoints and replicate; `cli_runs` drives
`cli.train --data-parallel 2 --device cpu` and `cli.test --data-parallel
2`.

Tolerances:
  * synced BN in float64 against flax's BatchNorm on the whole batch:
    1e-10 for the output, the input and weight gradients and the running
    statistics (the same arithmetic in another summation order); in f32
    against the port's one-process TorchBatchNorm: 1e-5;
  * one whole step in float64 against the JAX package's one-process
    make_train_step on the global batch: loss 1e-6 relative, parameters
    and BN statistics within 1e-6 of each tensor's largest change (atol
    floor 1e-12), as tests/test_torch_grad_accum_ema.py holds its steps,
    with AdamW eps 0.1 for the reason given there;
  * cli.train over two ranks against one process over the same global
    batches (f32): per-epoch losses within 1e-5, the final parameters and
    EMA within 1e-5; the stopped-and-resumed run bit-equal to the
    uninterrupted one;
  * evaluation: the confusion matrix equal, dice within 1e-6.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stf_unet_tpu.core.config import DataConfig as JaxDataConfig
from stf_unet_tpu.core.config import OptimConfig as JaxOptimConfig
from stf_unet_tpu.data.index import DatasetIndex as JaxDatasetIndex
from stf_unet_tpu.data.loader import HostLoader as JaxHostLoader
from stf_unet_tpu.models.blocks import TorchBatchNorm as JaxBN
from stf_unet_tpu.models.stf_lstm_unet import STFLSTMUNet as JaxSTFLSTMUNet
from stf_unet_tpu.models.unet import UNet as JaxUNet
from stf_unet_tpu.train import autobatch as jax_autobatch
from stf_unet_tpu.train.loop import \
    eval_batches_from_index as jax_eval_batches
from stf_unet_tpu.train.loop import make_train_step as jax_make_train_step
from stf_unet_tpu.train.schedule import \
    warmup_poly_schedule as jax_warmup_poly_schedule
from stf_unet_tpu.train.state import TrainState as JaxTrainState
from stf_unet_tpu.train.state import make_optimizer as jax_make_optimizer
from stf_unet_tpu_torch.cli import test as cli_test
from stf_unet_tpu_torch.cli import train as train_cli
from stf_unet_tpu_torch.core import distributed
from stf_unet_tpu_torch.core import mesh as mesh_lib
from stf_unet_tpu_torch.core.config import (DataConfig, ModelConfig,
                                            TrainConfig)
from stf_unet_tpu_torch.data.index import DatasetIndex
from stf_unet_tpu_torch.data.loader import Batch, HostLoader
from stf_unet_tpu_torch.data.pack import open_split_pack
from stf_unet_tpu_torch.data.synthetic import make_synthetic_breadm
from stf_unet_tpu_torch.data.transforms import TrainAugment
from stf_unet_tpu_torch.losses.criterion import cross_entropy
from stf_unet_tpu_torch.models.blocks import TorchBatchNorm
from stf_unet_tpu_torch.models.registry import (create_model,
                                                preprocess_input)
from stf_unet_tpu_torch.ops import quant
from stf_unet_tpu_torch.train.autobatch import pick_batch_size
from stf_unet_tpu_torch.train.loop import eval_batches_from_index, evaluate
from stf_unet_tpu_torch.utils.weights import (stflstm_state_dict_from_jax,
                                              unet_state_dict_from_jax)
from test_torch_unet import seeded_unet_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
TIMEOUT = 240  # seconds a scenario may take before its processes die
SEQ = tuple(f"VIBRANT+C{i}" for i in range(1, 9))
T_UNET, T_STF, STF_SIZE = 8, 2, 32
EVAL_CROP = 32

# One rank of the library scenario: argv = workdir rank world port.
LIB_CHILD = r"""
import sys
import numpy as np
import torch

wd, rank, world, port = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
    sys.argv[4]
torch.set_num_threads(1)
from stf_unet_tpu_torch.core import distributed, mesh as mesh_lib
assert distributed.initialize(f"localhost:{port}", world, rank,
                              device="cpu")
group = mesh_lib.create_mesh(0, "cpu")
assert (group.world, group.rank, group.host_group) == (world, rank, None)
assert distributed.host_info() == (rank, world)
assert distributed.is_main_process() == (rank == 0)

from stf_unet_tpu_torch.core.config import (DataConfig, ModelConfig,
                                            OptimConfig)
from stf_unet_tpu_torch.data.index import DatasetIndex
from stf_unet_tpu_torch.losses.criterion import cross_entropy
from stf_unet_tpu_torch.models.blocks import (TorchBatchNorm,
                                              convert_sync_batchnorm)
from stf_unet_tpu_torch.models.registry import (create_model,
                                                preprocess_input)
from stf_unet_tpu_torch.ops import quant
from stf_unet_tpu_torch.train.checkpoint import CheckpointManager
from stf_unet_tpu_torch.train.loop import (DeviceBatch, evaluate,
                                           eval_batches_from_index,
                                           gather_eval_outputs, train_step)
from stf_unet_tpu_torch.train.preempt import PreemptionGuard
from stf_unet_tpu_torch.train.schedule import warmup_poly_schedule
from stf_unet_tpu_torch.train.state import (TrainState, data_parallel,
                                            make_optimizer)

inp = torch.load(f"{wd}/inputs.pt", weights_only=False)
cpu = torch.device("cpu")
out = {}
rows = lambda t: mesh_lib.shard_batch(group, t)

# synced BN: one forward + backward, then two more forwards
for name, dt in (("bn64", torch.float64), ("bn32", torch.float32)):
    bn = TorchBatchNorm(inp["bn"]["weight"].shape[0]).to(dt)
    bn.load_state_dict({k: v.to(dt) if v.is_floating_point() else v
                        for k, v in inp["bn"].items()})
    convert_sync_batchnorm(bn, group).train()
    x = rows(inp["bn_x"][0].to(dt)).clone().requires_grad_()
    y = bn(x)
    (y * rows(inp["bn_g"].to(dt))).sum().backward()
    dw, db = bn.weight.grad.clone(), bn.bias.grad.clone()
    mesh_lib.all_sum(group, dw)
    mesh_lib.all_sum(group, db)
    ys = [y.detach()]
    with torch.no_grad():
        for xs in inp["bn_x"][1:]:
            ys.append(bn(rows(xs.to(dt))))
    out[name] = {"y": ys, "dx": x.grad, "dw": dw, "db": db,
                 "mean": bn.running_mean.clone(),
                 "var": bn.running_var.clone(),
                 "tracked": int(bn.num_batches_tracked)}

# the CE normalizer: this rank's scaled CE (DDP's mean is the global CE)
logits, target, weight = inp["ce"]
out["ce"] = [float(cross_entropy(rows(logits), rows(target),
                                 ignore_index=255, weight=w, group=group))
             for w in (None, weight)]


class FixedBatch:
    def __init__(self, images, targets):
        self.batch = (images, targets)

    def __call__(self, gen, frames, masks, sizes, pk):
        return self.batch


dummy = DeviceBatch(torch.zeros(1), torch.zeros(1), None, None)
sched = warmup_poly_schedule(1e-3, 2, 3, warmup=False)
opt_cfg = OptimConfig(warmup=False, eps=0.1)
states = {}
for name, t in (("unet", inp["t_unet"]), ("stflstm", inp["t_stf"])):
    cfg = ModelConfig(model=name, base_c=4, time_steps=t)
    model = create_model(cfg, dtype=torch.float64).to(torch.float64)
    model.load_state_dict(inp[name]["sd"])
    ddp = data_parallel(model, group)
    state = TrainState(model, make_optimizer(opt_cfg, model, cpu),
                       group=group, ddp=ddp)
    aug = FixedBatch(rows(inp[name]["images"]), rows(inp[name]["targets"]))
    loss, _ = train_step(state, aug, dummy, None, sched, 2, cpu)
    out[name] = {"loss": float(loss), "sd": model.state_dict()}
    states[name] = state

# evaluate: each rank its shard of the records (at batch 4, and at batch 1
# with the outputs gathered to rank 0) or its rows of a batch, summed
dcfg = DataConfig(base_size=40, crop_size=32)
index = DatasetIndex(f"{wd}/tree", "val", dcfg.resolved_sequence_types)
emodel = create_model(ModelConfig(model="unet", base_c=4))
emodel.load_state_dict({k: v.float() if v.is_floating_point() else v
                        for k, v in inp["unet"]["sd"].items()})
sharded = evaluate(emodel, eval_batches_from_index(
    index, dcfg, batch_size=4, host_index=rank, num_hosts=world), 2,
    data_cfg=dcfg, device=cpu, reduce_across_processes=True)
split = gather_eval_outputs(group, evaluate(
    emodel, eval_batches_from_index(index, dcfg, host_index=rank,
                                    num_hosts=world),
    2, data_cfg=dcfg, device=cpu, collect_outputs=True,
    reduce_across_processes=True))
qmodel = quant.QuantizedModel(emodel, inp["scales"])
qsplit = evaluate(qmodel, [rows(inp["int8_batch"])], 2, data_cfg=dcfg,
                  device=cpu, reduce_across_processes=True)
out["eval"] = {k: (m["confusion_matrix"], m["dice"]) for k, m in
               (("sharded", sharded), ("split", split), ("int8", qsplit))}
out["eval_outputs"] = split.get("outputs")
out["eval_batches"] = split.get("batches")

# the stop: nobody asks; then rank 1 alone gets the signal
guard = PreemptionGuard(world, group=group)
out["stop_none"] = guard.should_stop()
if rank == 1:
    guard._event.set()
out["stop_one"] = guard.should_stop()
guard.uninstall()

# checkpoints: rank 0 writes, every rank restores the same file; inside
# an accumulation window each rank's summed gradients are its own
ckpt = CheckpointManager(f"{wd}/ckpt", "unet")
state = states["unet"]
ckpt.save("latest", state, epoch=0, best_dice=0.5)
model = create_model(ModelConfig(model="unet", base_c=4),
                     dtype=torch.float64).to(torch.float64)
fresh = TrainState(model, make_optimizer(opt_cfg, model, cpu), group=group)
meta = ckpt.restore("latest", fresh)
out["restore_equal"] = all(torch.equal(a, b) for a, b in zip(
    fresh.model.state_dict().values(), state.model.state_dict().values()))
out["restored_step"] = fresh.step
model = create_model(ModelConfig(model="unet", base_c=4),
                     dtype=torch.float64).to(torch.float64)
model.load_state_dict(inp["unet"]["sd"])
accum = TrainState(model, make_optimizer(opt_cfg, model, cpu), grad_accum=2,
                   group=group, ddp=data_parallel(model, group))
aug = FixedBatch(rows(inp["unet"]["images"]), rows(inp["unet"]["targets"]))
train_step(accum, aug, dummy, None, sched, 2, cpu)
ckpt.save("mid", accum, epoch=0, best_dice=0.5, step_in_epoch=1)
model = create_model(ModelConfig(model="unet", base_c=4),
                     dtype=torch.float64).to(torch.float64)
back = TrainState(model, make_optimizer(opt_cfg, model, cpu), grad_accum=2,
                  group=group)
ckpt.restore("mid", back)
out["accum_equal"] = all(
    torch.equal(p.grad, q.grad) for p, q in
    zip(back.model.parameters(), accum.model.parameters()))
out["accum_grads"] = accum.model.enc1[0].weight.grad.clone()
out["accum_ranks"] = len(ckpt.load("mid")["accum_grads"])

# replicate: rank 0's values everywhere
t = torch.full((3,), float(rank + 1))
out["replicated"] = mesh_lib.replicate(group, {"t": t, "obj": [rank]})
torch.save(out, f"{wd}/out_{rank}.pt")
distributed.shutdown()
"""

# Runs one CLI in this process's interpreter and dumps its result as
# JSON: argv = module out.json cli-args...
CLI_RUNNER = r"""
import importlib, json, sys
import numpy as np

name, out, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
mod = importlib.import_module("stf_unet_tpu_torch.cli." + name)
result = mod.run(argv) if name == "train" else mod.main(argv)


def clean(x):
    if isinstance(x, dict):
        return {str(k): clean(v) for k, v in x.items()
                if k not in ("outputs", "batches")}
    if isinstance(x, (list, tuple)):
        return [clean(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    return x


json.dump(clean(result), open(out, "w"))
"""

# Logs every torch.save of a checkpoint's temporary file with the writing
# process's id: the ranks are spawned processes, which import this too.
SAVE_LOGGER = r"""
import os
import torch

_save = torch.save


def _logged(obj, f, *args, **kwargs):
    if isinstance(f, str) and f.endswith(".tmp"):
        with open(os.environ["STF_TEST_SAVE_LOG"], "a") as log:
            log.write(f"{os.getpid()} {f}\n")
    return _save(obj, f, *args, **kwargs)


torch.save = _logged
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


def _env(extra_path=None):
    env = dict(os.environ)
    paths = [p for p in (extra_path, REPO, env.get("PYTHONPATH")) if p]
    env["PYTHONPATH"] = os.pathsep.join(paths)
    env["OMP_NUM_THREADS"] = "1"
    return env


def _wait(cmds, env, timeout=TIMEOUT):
    """Run the commands together (each in a session of its own) and wait
    for all; on the timeout every process they started is killed. `env`
    is every command's environment, or a list of one for each."""
    envs = env if isinstance(env, list) else [env] * len(cmds)
    procs = [subprocess.Popen(cmd, env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              start_new_session=True)
             for cmd, e in zip(cmds, envs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        raise
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-6000:]
    return outs


def _cli(name, argv, out, env, timeout=TIMEOUT):
    _wait([[sys.executable, "-c", CLI_RUNNER, name, out, *argv]], env,
          timeout)
    with open(out) as f:
        return json.load(f)


def _jax_unet_start():
    model = JaxUNet(num_classes=2, base_c=4)
    variables = seeded_unet_variables(model, T_UNET, 21)
    return model, variables


def _jax_stf_start():
    """Variables drawn from numpy on the tree of model.init (traced by
    eval_shape, so nothing compiles): fan-in scaled matrices and kernels,
    BN scales and variances in [0.5, 1.5], the rest N(0, 0.1)."""
    model = JaxSTFLSTMUNet(num_classes=2, time_steps=T_STF)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.key(0), jnp.zeros((1, T_STF, STF_SIZE, STF_SIZE, 1)),
        train=False))
    rng = np.random.default_rng(22)

    def draw(path, leaf):
        if path[-1].key in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, leaf.shape)
        elif leaf.ndim >= 2:
            a = rng.normal(0.0, 1.0 / np.sqrt(np.prod(leaf.shape[:-1])),
                           leaf.shape)
        else:
            a = rng.normal(0.0, 0.1, leaf.shape)
        return jnp.asarray(a, leaf.dtype)

    return model, jax.tree_util.tree_map_with_path(draw, shapes)


def _step_batch(seed, t, size):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(4, t, size, size, 1))
    targets = rng.integers(0, 2, (4, size, size))
    targets[0, :3] = 255  # ignored pixels: the ranks' CE counts differ
    return images, targets


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The library scenario: the inputs, then each rank's outputs."""
    wd = tmp_path_factory.mktemp("ranks")
    rng = np.random.default_rng(5)
    bn = {"weight": torch.from_numpy(rng.uniform(0.5, 1.5, 5)),
          "bias": torch.from_numpy(rng.normal(0, 0.3, 5)),
          "running_mean": torch.from_numpy(rng.uniform(-1, 1, 5)),
          "running_var": torch.from_numpy(rng.uniform(0.5, 1.5, 5)),
          "num_batches_tracked": torch.tensor(0)}
    inp = {"bn": bn, "t_unet": T_UNET, "t_stf": T_STF,
           "bn_x": [torch.from_numpy(rng.normal(1.0, 2.0, (4, 5, 4, 6)))
                    for _ in range(3)],
           "bn_g": torch.from_numpy(rng.normal(size=(4, 5, 4, 6)))}
    logits = torch.from_numpy(rng.normal(size=(4, 6, 5, 3)))
    target = torch.from_numpy(rng.integers(0, 3, (4, 6, 5)))
    target[1, :4] = 255
    inp["ce"] = (logits, target, torch.tensor([0.5, 2.0, 1.0],
                                              dtype=torch.float64))
    starts = {"unet": _jax_unet_start(), "stflstm": _jax_stf_start()}
    bridge = {"unet": unet_state_dict_from_jax,
              "stflstm": stflstm_state_dict_from_jax}
    for name, (t, size) in (("unet", (T_UNET, 16)),
                            ("stflstm", (T_STF, STF_SIZE))):
        _, variables = starts[name]
        images, targets = _step_batch(len(name), t, size)
        inp[name] = {"sd": {k: v.double() if v.is_floating_point() else v
                            for k, v in bridge[name](
                                jax.device_get(variables["params"]),
                                jax.device_get(variables["batch_stats"])
                            ).items()},
                     "images": torch.from_numpy(images),
                     "targets": torch.from_numpy(targets)}
    make_synthetic_breadm(str(wd / "tree"), splits=("val",), size=40,
                          patients_per_split=7, slices_per_patient=1,
                          seed=6)
    emodel = _eval_model(inp)
    x = torch.from_numpy(rng.normal(size=(2, T_UNET, 32, 32, 1))).float()
    inp["scales"] = quant.calibrate(emodel, [preprocess_input(x, emodel)])
    inp["int8_batch"] = (
        rng.integers(0, 256, (8, T_UNET, 32, 32, 1), dtype=np.uint8),
        (rng.random((8, 32, 32)) > 0.7).astype(np.uint8))
    torch.save(inp, str(wd / "inputs.pt"))

    port = distributed.free_port()
    dryrun = ("import json, sys; from stf_unet_tpu_torch.parallel.dryrun "
              "import dryrun_multichip; "
              "json.dump(dryrun_multichip(2, device='cpu'), "
              "open(sys.argv[1], 'w'))")
    _wait([[sys.executable, "-c", LIB_CHILD, str(wd), str(r), str(WORLD),
            str(port)] for r in range(WORLD)]
          + [[sys.executable, "-c", dryrun, str(wd / "dryrun.json")]],
          _env())
    outs = [torch.load(str(wd / f"out_{r}.pt"), weights_only=False)
            for r in range(WORLD)]
    return inp, starts, outs, str(wd)


def _eval_model(inp):
    model = create_model(ModelConfig(model="unet", base_c=4))
    model.load_state_dict({k: v.float() if v.is_floating_point() else v
                           for k, v in inp["unet"]["sd"].items()})
    return model.eval()


def _cat(outs, key, part):
    return torch.cat([o[key][part] for o in outs]).numpy()


def test_synced_batchnorm_matches_flax_on_the_whole_batch(ranks):
    inp, _, outs, _ = ranks
    bn = inp["bn"]
    jbn = JaxBN()
    nhwc = (0, 2, 3, 1)
    with jax.enable_x64(True):
        params = {"bn": {"scale": jnp.asarray(bn["weight"].numpy()),
                         "bias": jnp.asarray(bn["bias"].numpy())}}
        stats = {"bn": {"mean": jnp.asarray(bn["running_mean"].numpy()),
                        "var": jnp.asarray(bn["running_var"].numpy())}}
        g = jnp.asarray(inp["bn_g"].numpy().transpose(nhwc))

        def loss(params, x):
            y, upd = jbn.apply({"params": params, "batch_stats": stats}, x,
                               use_running_average=False,
                               mutable=["batch_stats"])
            return jnp.sum(y * g), (y, upd["batch_stats"])

        x0 = jnp.asarray(inp["bn_x"][0].numpy().transpose(nhwc))
        (_, (y0, stats)), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params, x0)
        ys = [y0]
        for x in inp["bn_x"][1:]:
            y, upd = jbn.apply({"params": params, "batch_stats": stats},
                               jnp.asarray(x.numpy().transpose(nhwc)),
                               use_running_average=False,
                               mutable=["batch_stats"])
            ys.append(y)
            stats = upd["batch_stats"]
    tol = dict(rtol=0, atol=1e-10)
    for i, want in enumerate(ys):
        got = np.concatenate([o["bn64"]["y"][i].numpy() for o in outs])
        np.testing.assert_allclose(got.transpose(nhwc), np.asarray(want),
                                   **tol, err_msg=f"forward {i}")
    dx = np.concatenate([o["bn64"]["dx"].numpy() for o in outs])
    np.testing.assert_allclose(dx.transpose(nhwc), np.asarray(gx), **tol)
    for o in outs:  # the ranks' weight gradients, summed, and the stats
        np.testing.assert_allclose(o["bn64"]["dw"].numpy(),
                                   np.asarray(gp["bn"]["scale"]), **tol)
        np.testing.assert_allclose(o["bn64"]["db"].numpy(),
                                   np.asarray(gp["bn"]["bias"]), **tol)
        np.testing.assert_allclose(o["bn64"]["mean"].numpy(),
                                   np.asarray(stats["bn"]["mean"]), **tol)
        np.testing.assert_allclose(o["bn64"]["var"].numpy(),
                                   np.asarray(stats["bn"]["var"]), **tol)
        assert o["bn64"]["tracked"] == 3


def test_synced_batchnorm_f32_matches_one_process(ranks):
    inp, _, outs, _ = ranks
    bn = TorchBatchNorm(5)
    bn.load_state_dict({k: v.float() if v.is_floating_point() else v
                        for k, v in inp["bn"].items()})
    bn.train()
    x = inp["bn_x"][0].float().clone().requires_grad_()
    y = bn(x)
    (y * inp["bn_g"].float()).sum().backward()
    ys = [y.detach()]
    with torch.no_grad():
        ys += [bn(xs.float()) for xs in inp["bn_x"][1:]]
    tol = dict(rtol=0, atol=1e-5)
    for i, want in enumerate(ys):
        got = np.concatenate([o["bn32"]["y"][i].numpy() for o in outs])
        np.testing.assert_allclose(got, want.numpy(), **tol)
    dx = np.concatenate([o["bn32"]["dx"].numpy() for o in outs])
    np.testing.assert_allclose(dx, x.grad.numpy(), **tol)
    for o in outs:
        for got, want in ((o["bn32"]["dw"], bn.weight.grad),
                          (o["bn32"]["db"], bn.bias.grad),
                          (o["bn32"]["mean"], bn.running_mean),
                          (o["bn32"]["var"], bn.running_var)):
            np.testing.assert_allclose(got.numpy(), want.detach().numpy(),
                                       **tol)


def test_cross_entropy_takes_the_global_normalizer(ranks):
    inp, _, outs, _ = ranks
    logits, target, weight = inp["ce"]
    for i, w in enumerate((None, weight)):
        want = float(cross_entropy(logits, target, ignore_index=255,
                                   weight=w))
        mean = sum(o["ce"][i] for o in outs) / WORLD  # DDP's mean
        assert mean == pytest.approx(want, rel=1e-12, abs=0)
    assert outs[0]["ce"][0] != outs[1]["ce"][0]


@pytest.mark.parametrize("name", ["unet", "stflstm"])
def test_two_rank_step_matches_jax_one_process(ranks, name):
    """Two ranks of 2 rows each, one DDP step (AdamW at the schedule's
    first lr) in float64, against the JAX package's make_train_step on
    the 4-row batch."""
    inp, starts, outs, _ = ranks
    model, variables = starts[name]
    images = inp[name]["images"].numpy()
    targets = inp[name]["targets"].numpy()
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
        state, loss, _ = step(state, jnp.asarray(images),
                              jnp.asarray(targets, jnp.int32))
        jloss = float(loss)
        jstate = jax.device_get(state)
    bridge = (unet_state_dict_from_jax if name == "unet"
              else stflstm_state_dict_from_jax)
    want = bridge(jstate.params, jstate.batch_stats)
    start = inp[name]["sd"]
    for o in outs:
        assert o[name]["loss"] == pytest.approx(jloss, rel=1e-6)
        got = o[name]["sd"]
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
        assert torch.equal(outs[0][name]["sd"][key],
                           outs[1][name]["sd"][key]), key


def _one_process_eval(inp, wd, **kw):
    dcfg = DataConfig(base_size=40, crop_size=32)
    index = DatasetIndex(f"{wd}/tree", "val", dcfg.resolved_sequence_types)
    return evaluate(_eval_model(inp), eval_batches_from_index(
        index, dcfg, **kw), 2, data_cfg=dcfg, device=torch.device("cpu"),
        collect_outputs=True)


@pytest.mark.parametrize("mode", ["sharded", "split"])
def test_evaluate_over_ranks_matches_one_process(ranks, mode):
    """Each rank evaluates records[rank::2] of the 7 val records and the
    sums reduce. sharded: at batch 4 (a batch of 4 and one of 3); split:
    at batch 1, cli/test's traffic, with every rank's outputs and batches
    gathered to rank 0 in record order (gather_eval_outputs)."""
    inp, _, outs, wd = ranks
    want = _one_process_eval(inp, wd)
    for o in outs:
        conf, dice = o["eval"][mode]
        np.testing.assert_array_equal(conf, want["confusion_matrix"])
        assert dice == pytest.approx(want["dice"], abs=1e-6)
    if mode == "split":
        main, other = outs
        assert other["eval_outputs"] is None  # rank 0 alone holds them
        assert len(main["eval_outputs"]) == len(want["outputs"]) == 7
        for got, ref in zip(main["eval_outputs"], want["outputs"]):
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
        for got, ref in zip(main["eval_batches"], want["batches"]):
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(g, r)


def test_int8_evaluation_over_ranks_matches_one_process(ranks):
    """The port's twin of the JAX package's quantized evaluation under a
    mesh: an int8 QuantizedModel evaluated over two ranks, each on its
    rows of the batch, equals the one-process evaluation."""
    inp, _, outs, _ = ranks
    qmodel = quant.QuantizedModel(_eval_model(inp), inp["scales"])
    want = evaluate(qmodel, [inp["int8_batch"]], 2,
                    data_cfg=DataConfig(), device=torch.device("cpu"))
    for o in outs:
        conf, dice = o["eval"]["int8"]
        np.testing.assert_array_equal(conf, want["confusion_matrix"])
        assert dice == pytest.approx(want["dice"], abs=1e-6)


def test_stop_is_agreed_by_every_rank(ranks):
    _, _, outs, _ = ranks
    for o in outs:
        assert o["stop_none"] is False
        assert o["stop_one"] is True  # rank 1's signal stops rank 0 too


def test_checkpoints_write_once_and_restore_everywhere(ranks):
    _, _, outs, wd = ranks
    for o in outs:
        assert o["restore_equal"] and o["restored_step"] == 1
        assert o["accum_equal"] and o["accum_ranks"] == WORLD
    # inside the window each rank holds its own rows' gradients
    assert not torch.equal(outs[0]["accum_grads"], outs[1]["accum_grads"])
    assert sorted(f for f in os.listdir(f"{wd}/ckpt")) == [
        "unet_latest_model.pth", "unet_mid_model.pth"]


def test_replicate_gives_rank_zeros_values(ranks):
    _, _, outs, _ = ranks
    for o in outs:
        assert torch.equal(o["replicated"]["t"], torch.ones(3))
        assert o["replicated"]["obj"] == [0]


# --- no process group needed --------------------------------------------

def test_shard_batch_and_padding():
    group = mesh_lib.DataGroup(2, 1, torch.device("cpu"))
    x = np.arange(12).reshape(4, 3)
    got = mesh_lib.shard_batch(group, {"a": x, "b": (torch.arange(4),)})
    np.testing.assert_array_equal(got["a"], x[2:])
    assert got["b"][0].tolist() == [2, 3]
    with pytest.raises(ValueError, match="does not divide"):
        mesh_lib.shard_batch(group, np.zeros((3, 1)))
    assert mesh_lib.pad_batch_to_multiple(5, 2) == 6
    assert mesh_lib.pad_batch_to_multiple(16, 4) == 16
    assert mesh_lib.DATA_AXIS == "data"


def test_create_mesh_errors(monkeypatch):
    """JAX create_mesh's errors: more shards than devices; a group that
    leaves processes out; and, outside a group, more than one rank."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh_lib.data_world(0, "cuda") == 2
    assert mesh_lib.data_world(2, "cuda") == 2
    with pytest.raises(ValueError, match="requested 3 data shards but "
                                         "only 2 devices"):
        mesh_lib.data_world(3, "cuda")
    assert mesh_lib.data_world(4, "cpu") == 4  # gloo ranks share the host
    assert mesh_lib.data_world(0, "cpu") == 1
    one = mesh_lib.create_mesh(1, "cpu")
    assert (one.world, one.rank, one.is_main) == (1, 0, True)
    with pytest.raises(ValueError, match="needs 2 processes"):
        mesh_lib.create_mesh(2, "cpu")
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 4)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 3)
    monkeypatch.setattr(torch.distributed, "get_backend", lambda: "gloo")
    with pytest.raises(ValueError, match="must span all 4 processes"):
        mesh_lib.create_mesh(2, "cpu")
    group = mesh_lib.create_mesh(0, "cpu")
    assert (group.world, group.rank, group.is_main) == (4, 3, False)


def test_data_parallel_beyond_visible_gpus_raises(monkeypatch, tmp_path):
    """No silent shrinking: --data-parallel 3 with two GPUs raises before
    anything starts; so does cli.test's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="only 2 devices"):
        train_cli.run(["--data-path", str(tmp_path), "--data-parallel",
                       "3"])
    with pytest.raises(ValueError, match="only 2 devices"):
        cli_test.main(["--model-dir", str(tmp_path), "--data-parallel",
                       "3"])


def _uninitialized(monkeypatch):
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)


def _fake_group(monkeypatch, world, calls):
    def init(backend, **kw):
        calls.append({"backend": backend, **kw})
        monkeypatch.setattr(torch.distributed, "is_initialized",
                            lambda: True)
    monkeypatch.setattr(torch.distributed, "init_process_group", init)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: world)


def test_maybe_initialize_without_coordinator_is_one_process(monkeypatch):
    _uninitialized(monkeypatch)
    assert distributed.maybe_initialize() is False


def test_maybe_initialize_reads_torchrun_environment(monkeypatch):
    _uninitialized(monkeypatch)
    calls = []
    _fake_group(monkeypatch, 4, calls)
    for var, val in (("MASTER_ADDR", "10.0.0.1"), ("MASTER_PORT", "1234"),
                     ("WORLD_SIZE", "4"), ("RANK", "2")):
        monkeypatch.setenv(var, val)
    assert distributed.maybe_initialize(device="cpu") is True
    assert len(calls) == 1
    call = calls[0]
    assert (call["backend"], call["init_method"], call["world_size"],
            call["rank"]) == ("gloo", "tcp://10.0.0.1:1234", 4, 2)
    assert call["timeout"] == distributed.DEFAULT_TIMEOUT


def test_explicit_arguments_override_the_environment(monkeypatch):
    _uninitialized(monkeypatch)
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    calls = []
    _fake_group(monkeypatch, 4, calls)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    assert distributed.maybe_initialize("10.1.2.3:9999", num_processes=4,
                                        process_id=1, device="cuda") is True
    assert (calls[0]["init_method"], calls[0]["world_size"],
            calls[0]["rank"], calls[0]["backend"]) == \
        ("tcp://10.1.2.3:9999", 4, 1, "nccl")
    calls.clear()
    _uninitialized(monkeypatch)
    distributed.initialize("h:1", 2, 0, device="cuda", backend="gloo")
    assert calls[0]["backend"] == "gloo"  # the library callers' override


def test_maybe_initialize_degrades_on_failure(monkeypatch, capsys):
    _uninitialized(monkeypatch)
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")

    def boom(*args, **kwargs):
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(torch.distributed, "init_process_group", boom)
    assert distributed.maybe_initialize(device="cpu") is False
    assert "coordinator unreachable" in capsys.readouterr().out


def test_initialize_failure_raises(monkeypatch):
    """The --multihost path: the user asked for a group, so a failure
    raises, and without any coordinator it says so."""
    _uninitialized(monkeypatch)

    def boom(*args, **kwargs):
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(torch.distributed, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="coordinator unreachable"):
        distributed.initialize("10.0.0.1:1234", 2, 0, device="cpu")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        distributed.initialize(device="cpu")


def test_initialize_single_process_returns_false(monkeypatch):
    _uninitialized(monkeypatch)
    _fake_group(monkeypatch, 1, [])
    assert distributed.initialize("localhost:1", 1, 0, device="cpu") is False


def test_initialize_already_initialized_short_circuits(monkeypatch):
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)

    def boom(*args, **kwargs):
        raise AssertionError("init_process_group must not run twice")

    monkeypatch.setattr(torch.distributed, "init_process_group", boom)
    assert distributed.initialize() is True
    assert distributed.maybe_initialize() is True


def test_host_info_single_process():
    assert distributed.host_info() == (0, 1)
    assert distributed.is_main_process() is True


def test_host_info_mocked_group(monkeypatch):
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 2)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 4)
    assert distributed.host_info() == (2, 4)
    assert distributed.is_main_process() is False
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 0)
    assert distributed.is_main_process() is True


@pytest.fixture(scope="module")
def shard_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    data = str(root / "breadm")
    make_synthetic_breadm(data, size=40, seed=7, patients_per_split=3,
                          slices_per_patient=3, splits=("training", "val"))
    from stf_unet_tpu_torch.cli import pack as pack_cli
    pack_cli.main(["--data-path", data, "--output", str(root / "pack"),
                   "--eval-size", "32"])
    return data, str(root / "pack")


@pytest.mark.parametrize("source", ["decode", "pack", "cache"])
def test_host_loader_shards_match_jax(shard_tree, source):
    """Each rank's batches over three epochs (9 samples: the shards cut
    to 4 each) equal the JAX package's HostLoader(host_index,
    num_hosts)'s, byte for byte, decoded, from a pack and from the RAM
    cache."""
    data, pack_root = shard_tree
    index = DatasetIndex(data, "train", SEQ)
    jindex = JaxDatasetIndex(data, "train", SEQ)
    kw = {"pack": open_split_pack(pack_root, "train")} \
        if source == "pack" else {}
    jkw = {"pack": __import__("stf_unet_tpu.data.pack", fromlist=["x"])
           .open_split_pack(pack_root, "train")} if source == "pack" else {}
    seen = {epoch: [] for epoch in range(3)}
    for host in range(WORLD):
        ours = HostLoader(index, 2, shuffle=True, seed=3, prefetch=0,
                          use_native=False, host_index=host,
                          num_hosts=WORLD, drop_last=True,
                          cache_ram=source == "cache", verbose=False, **kw)
        theirs = JaxHostLoader(jindex, 2, shuffle=True, seed=3, prefetch=0,
                               use_native=False, host_index=host,
                               num_hosts=WORLD, drop_last=True,
                               cache_ram=source == "cache", **jkw)
        assert len(ours) == len(theirs) == 2
        for epoch in range(3):
            got, want = list(ours.epoch(epoch)), list(theirs.epoch(epoch))
            assert len(got) == len(want) == 2
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.frames, w.frames)
                np.testing.assert_array_equal(g.masks, w.masks)
                np.testing.assert_array_equal(g.sizes, w.sizes)
                seen[epoch] += [f.tobytes() for f in g.frames]
    for epoch, frames in seen.items():  # an epoch's shards are disjoint
        assert len(set(frames)) == len(frames) == 8, epoch


@pytest.mark.parametrize("source", ["decode", "pack"])
def test_eval_shards_match_jax(shard_tree, source):
    data, pack_root = shard_tree
    cfg = DataConfig(base_size=40, crop_size=32)
    jcfg = JaxDataConfig(base_size=40, crop_size=32)
    index = DatasetIndex(data, "val", SEQ)
    jindex = JaxDatasetIndex(data, "val", SEQ)
    total = 0
    for host in range(WORLD):
        pack = (open_split_pack(pack_root, "val") if source == "pack"
                else None)
        got = list(eval_batches_from_index(index, cfg, host_index=host,
                                           num_hosts=WORLD, pack=pack))
        jpack = (__import__("stf_unet_tpu.data.pack", fromlist=["x"])
                 .open_split_pack(pack_root, "val") if source == "pack"
                 else None)
        want = list(jax_eval_batches(jindex, jcfg, host_index=host,
                                     num_hosts=WORLD, pack=jpack))
        assert len(got) == len(want) == len(index.records[host::WORLD])
        for (gi, gt), (wi, wt) in zip(got, want):
            np.testing.assert_array_equal(gi, np.asarray(wi))
            np.testing.assert_array_equal(gt, np.asarray(wt))
        total += len(got)
    assert total == len(index)


@pytest.mark.parametrize("extras", ["plain", "extras", "per_frame"])
def test_augment_rank_slices_equal_the_global_draw(extras):
    """The ranks' slices of the global batch's draws (geometry, elastic
    field, photometric factors and noise; the per-frame mode) are the
    one-process run's rows, bit for bit."""
    kw = dict(base_size=40, crop_size=32)
    if extras == "extras":
        kw.update(elastic_alpha=4.0, elastic_prob=1.0, brightness=0.2,
                  contrast=0.2, gamma_jitter=0.2, noise_std=0.05)
    if extras == "per_frame":
        kw.update(shared_frame_augmentation=False)
    cfg = DataConfig(**kw)
    rng = np.random.default_rng(9)
    b = 3 * WORLD
    frames = torch.from_numpy(rng.integers(0, 256, (b, 2, 40, 40),
                                           dtype=np.uint8))
    masks = torch.from_numpy(rng.integers(0, 2, (b, 40, 40),
                                          dtype=np.uint8))
    sizes = np.asarray([[40, 40], [36, 40], [40, 30]] * WORLD, np.int32)

    def gen():
        return torch.Generator().manual_seed(11)

    images, targets = TrainAugment(cfg)(gen(), frames, masks, sizes)
    for rank in range(WORLD):
        rows = slice(rank * 3, rank * 3 + 3)
        got_i, got_t = TrainAugment(cfg, rank, WORLD)(
            gen(), frames[rows], masks[rows], sizes[rows])
        assert torch.equal(got_i, images[rows]), rank
        assert torch.equal(got_t, targets[rows]), rank


@pytest.mark.parametrize("n_shards", [2, 4])
def test_autobatch_global_batch_matches_jax(n_shards, monkeypatch):
    gib, mib = 2 ** 30, 2 ** 20

    def measure(batch):
        return int(1.1 * gib + 205 * mib * batch), int(0.4 * gib)

    monkeypatch.setattr(jax_autobatch, "measure_step_memory",
                        lambda cfg, t, b, canvas=None: measure(b))
    want = jax_autobatch.pick_batch_size(
        __import__("stf_unet_tpu.core.config", fromlist=["x"])
        .TrainConfig(), 8, n_shards=n_shards, budget_bytes=16 * gib)
    got = pick_batch_size(TrainConfig(), 8, n_shards, budget_bytes=16 * gib,
                          measure=measure)
    assert got == want == 64 * n_shards


def test_dryrun_twin_runs_the_full_step_over_two_ranks(ranks):
    """parallel/dryrun.py, the twin of __graft_entry__.dryrun_multichip
    (run beside the library scenario): one full STF-LSTM-UNet step (warp,
    DDP forward and backward with synced BN, AdamW, EMA) and a sharded
    evaluation over two gloo ranks (device="cpu": the entry point runs
    on the GPUs unless asked)."""
    with open(os.path.join(ranks[3], "dryrun.json")) as f:
        result = json.load(f)
    assert result["world"] == 2 and np.isfinite(result["loss"])
    assert 0.0 <= result["dice"] <= 1.0
    assert int(np.sum(result["confusion"])) == 2 * 32 * 32
