"""The port's Swin-UNet (models/swin_unet.py, ops/window_attention.py)
held on the CPU to the benchmark's plain reference
(portbench/reference/models/swinunet.py, the one copy the cell's check
runs), and driven through the port's paths.

At a tiny size (img 16, patch 2, C = 8, three stages at 8^2, 4^2 and 2^2
tokens, window 2: the first two stages and their decoder stages shift,
the last takes its whole 2 x 2 map as its window), in float32, on
seeded random weights (LayerNorm gains near 1, bias tables of spread
0.5, so that the bias and the region masks move the logits):
  * logits in eval and train mode within 1e-5 of the largest logit: the
    port's SDPA and the reference's explicit softmax sum in other orders,
    a few ulps a block (5e-7 measured);
  * the loss (the port's criterion against the reference's) within 1e-5
    relative, the same rounding carried through the mean (1e-7 measured
    over five seeds);
  * every parameter's gradient within 1e-4 of its tensor's largest
    entry: the backward sums the same products in other orders again,
    over 10 blocks, and the bias tables' gradients are sums over every
    window and sample (the worst, 6e-6, a bias table's, over five
    seeds).
The region masks: bit-equal outputs where the masked tokens' weight
(exp(-100 + s) against exp(s)) is far below float32's rounding.

Paths: cli/train --model swinunet for an epoch on a tiny tree, with the
profiler's trace holding `window_attention` ranges; its checkpoint
through cli/test, cli/val, cli/predict, cli/serve's server (warmed up)
and the serving engine (a 256^2 slice resized to 224^2 and back); the
refusals of spatial parallelism and int8.
"""

import inspect
import json
import os

import numpy as np
import pytest
import torch

from portbench.reference import train as ref_train
from portbench.reference.models import swinunet as ref
from stf_unet_tpu_torch.cli import train as train_cli
from stf_unet_tpu_torch.cli.common import restore_for_inference
from stf_unet_tpu_torch.core.config import ModelConfig, parse_config
from stf_unet_tpu_torch.data.synthetic import make_synthetic_breadm
from stf_unet_tpu_torch.losses.criterion import criterion
from stf_unet_tpu_torch.models import swin_unet
from stf_unet_tpu_torch.models.registry import create_model, preprocess_input
from stf_unet_tpu_torch.ops import window_attention as wa
from stf_unet_tpu_torch.ops import quant

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(img_size=16, patch_size=2, embed_dim=8, depths=(2, 2, 2),
            num_heads=(2, 2, 4), window_size=2)
TINY_ARCH = dict(TINY, time_steps=8, num_classes=2, mlp_ratio=4.0,
                 depths=[2, 2, 2], num_heads=[2, 2, 4])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small CPU steps: the test
    workers share the host's cores, and torch's default of a thread per
    core makes each tiny op of one worker wait on the others'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny_model(seed=0, **kw):
    model = swin_unet.SwinUNet(in_chans=8, num_classes=2, **{**TINY, **kw})
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=gen)
            if p.dim() == 1 and name.endswith("norm.weight") or \
                    name.endswith(("norm1.weight", "norm2.weight",
                                   "norm_up.weight")):
                p.copy_(1.0 + 0.1 * noise)
            elif p.dim() == 2 and "bias_table" not in name:
                p.copy_(noise * p.shape[1] ** -0.5)
            else:
                p.copy_(0.5 * noise if p.dim() < 4 else 0.2 * noise)
    return model


def _batch(seed=1, size=16):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(2, 8, size, size, 1, generator=gen),
            torch.randint(0, 2, (2, size, size), generator=gen))


@pytest.mark.parametrize("train", [False, True])
def test_logits_match_the_reference(train):
    model = _tiny_model().train(train)
    images, _ = _batch()
    params = dict(model.named_parameters())
    with torch.no_grad():
        got = model(preprocess_input(images, model))["out"]
        want = ref.forward(params, images, TINY_ARCH, train)
    assert got.shape == want.shape == (2, 16, 16, 2)
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


def test_loss_and_gradients_match_the_reference():
    model = _tiny_model().train(True)
    images, targets = _batch()
    loss = criterion(model(preprocess_input(images, model)), targets,
                     num_classes=2)
    loss.backward()
    params = {k: p.detach().clone().requires_grad_(True)
              for k, p in model.named_parameters()}
    ref_loss = ref_train.loss_fn(ref.forward(params, images, TINY_ARCH,
                                             True), targets)
    ref_loss.backward()
    assert abs(loss.item() - ref_loss.item()) <= 1e-5 * abs(ref_loss.item())
    for name, p in model.named_parameters():
        want = params[name].grad
        scale = float(want.abs().max())
        assert scale > 0, name
        assert float((p.grad - want).abs().max()) <= 1e-4 * scale, name


def _groups(height, window, shift):
    """Each position's (window, region) after the roll by -shift."""
    rolled = (np.arange(height) - shift) % height
    region = np.where(rolled < height - window, 0,
                      np.where(rolled < height - shift, 1, 2))
    win = rolled // window
    return win[:, None], win[None, :], region[:, None], region[None, :]


@pytest.mark.parametrize("window,shift,token", [(2, 1, (0, 0)),
                                                 (4, 2, (1, 1)),
                                                 (4, 2, (7, 0))])
def test_a_shifted_block_never_mixes_regions(window, shift, token):
    """Moving one token changes the attention's output only at the
    tokens of its own window and its own region of the roll (itself and,
    where the region holds more, its neighbours there): every other
    output is bit-equal."""
    height, dim, heads = 8, 8, 2
    gen = torch.Generator().manual_seed(4)
    attn = wa.window_attention
    table = torch.randn((2 * window - 1) ** 2, heads, generator=gen)
    weights = (torch.randn(3 * dim, dim, generator=gen) * dim ** -0.5,
               torch.randn(3 * dim, generator=gen) * 0.1,
               torch.randn(dim, dim, generator=gen) * dim ** -0.5,
               torch.randn(dim, generator=gen) * 0.1)
    index = wa.relative_position_index(window)
    mask = wa.region_mask(height, height, window, shift)
    x = torch.randn(1, height, height, dim, generator=gen)
    moved = x.clone()
    moved[0, token[0], token[1]] += 3.0
    out0 = attn(x, *weights, table, index, heads, window, shift, mask)
    out1 = attn(moved, *weights, table, index, heads, window, shift, mask)
    changed = (out0 != out1).any(-1)[0].numpy()
    wr, wc, rr, rc = _groups(height, window, shift)
    i, j = token
    group = ((wr == wr[i, 0]) & (wc == wc[0, j]) & (rr == rr[i, 0])
             & (rc == rc[0, j]))
    assert changed[i, j]
    assert not changed[~group].any()
    if group.sum() > 1:  # attention reaches the rest of the region
        assert changed[group].sum() > 1


@pytest.mark.parametrize("window", [2, 7])
def test_relative_position_index_is_the_published_formula(window):
    index = wa.relative_position_index(window)
    n = window * window
    assert index.shape == (n, n)
    for a in range(n):
        for b in range(n):
            dh = a // window - b // window
            dw = a % window - b % window
            assert int(index[a, b]) == ((dh + window - 1) * (2 * window - 1)
                                        + dw + window - 1)
    assert torch.equal(index, ref.relative_position_index(window, "cpu"))


def _published_count(in_chans, classes):
    """Swin-Unet's parameters from its shapes: C 96, depths 2, heads 3-24,
    window 7, MLP ratio 4, patch 4."""
    c, heads, ws = 96, (3, 6, 12, 24), 7
    table = (2 * ws - 1) ** 2

    def ln(d):
        return 2 * d

    def lin(i, o, bias=True):
        return i * o + (o if bias else 0)

    def block(d, h):
        return (ln(d) + table * h + lin(d, 3 * d) + lin(d, d) + ln(d)
                + lin(d, 4 * d) + lin(4 * d, d))

    n = in_chans * 16 * c + c + ln(c)                      # patch embed
    for i in range(4):
        d = c << i
        n += 2 * block(d, heads[i])
        if i < 3:
            n += ln(4 * d) + lin(4 * d, 2 * d, False)      # merging
    n += ln(8 * c)                                         # encoder norm
    n += lin(8 * c, 16 * c, False) + ln(4 * c)             # first expand
    for i in (2, 1, 0):
        d = c << i
        n += lin(2 * d, d) + 2 * block(d, heads[i])
        if i > 0:
            n += lin(d, 2 * d, False) + ln(d // 2)         # expand
    n += ln(c) + lin(c, 16 * c, False) + ln(c)             # norm_up, x4
    return n + c * classes                                 # 1x1 head


def test_the_published_model_has_its_parameter_count():
    model = create_model(ModelConfig(model="swinunet"))
    count = sum(p.numel() for p in model.parameters())
    assert count == _published_count(8, 2) == 27_175_908
    assert all(p.dtype == torch.float32 for p in model.parameters())
    blocks = [m for m in model.modules()
              if isinstance(m, swin_unet.SwinBlock)]
    assert len(blocks) == 14
    assert [b.shift for b in blocks] == [0, 3] * 3 + [0, 0] + [0, 3] * 3
    pk = create_model(ModelConfig(model="swinunet", use_pk_maps=True))
    assert pk.patch_embed.proj.in_channels == 11


def test_the_benchmark_configuration_is_the_constructors_default():
    """portbench/drivers/train_loop.py builds ModelConfig(model, num_classes,
    time_steps, base_c) and nothing more: the configuration's widths
    must be what the constructor builds by default."""
    with open(os.path.join(REPO, "portbench", "configs",
                           "swinunet.json")) as f:
        arch = json.load(f)["architecture"]
    defaults = {k: v.default for k, v in inspect.signature(
        swin_unet.SwinUNet).parameters.items()}
    rename = {"time_steps": "in_chans"}
    fixed = {"qkv_bias", "patch_norm", "ape"}
    for key, value in arch.items():
        if key in fixed:
            continue
        want = defaults[rename.get(key, key)]
        assert (list(want) if isinstance(want, tuple) else want) == value, \
            key
    model = create_model(ModelConfig(model="swinunet"))
    block = model.layers[0].blocks[0]
    assert arch["qkv_bias"] and block.attn.qkv.bias is not None
    assert arch["patch_norm"] and isinstance(model.patch_embed.norm,
                                             torch.nn.LayerNorm)
    assert not arch["ape"] and not any(
        "absolute_pos_embed" in k for k in model.state_dict())


@pytest.mark.parametrize("case", ["rate0", "train", "eval"])
def test_drop_path(case):
    x = torch.randn(64, 3, 5)
    if case == "rate0":
        assert swin_unet.drop_path(x, 0.0, True) is x
        model = _tiny_model()
        images, _ = _batch()
        with torch.no_grad():
            a = model.train()(preprocess_input(images, model))["out"]
            b = model.eval()(preprocess_input(images, model))["out"]
        assert torch.equal(a, b)
        return
    if case == "eval":
        assert swin_unet.drop_path(x, 0.3, False) is x
        model = _tiny_model(drop_path_rate=0.3).eval()
        images, _ = _batch()
        with torch.no_grad():
            a = model(preprocess_input(images, model))["out"]
            b = model(preprocess_input(images, model))["out"]
        assert torch.equal(a, b)
        return
    torch.manual_seed(7)
    y = swin_unet.drop_path(x, 0.3, True)
    kept = (y != 0).flatten(1).any(1)
    assert 0 < int(kept.sum()) < 64
    assert torch.allclose(y[kept], x[kept] / 0.7, rtol=1e-6)
    assert torch.equal(y[~kept], torch.zeros_like(y[~kept]))
    rates = [b.drop_path_rate for b in _tiny_model(
        drop_path_rate=0.3).modules() if isinstance(b, swin_unet.SwinBlock)]
    assert rates[:6] == pytest.approx([0.0, 0.06, 0.12, 0.18, 0.24, 0.3])
    assert rates[6:] == pytest.approx([0.12, 0.18, 0.0, 0.06])
    assert parse_config(["--drop-path-rate", "0.2"]).model \
        .drop_path_rate == 0.2


def test_the_op_counts_its_calls_and_off_size_inputs_are_resized():
    model = _tiny_model().eval()
    images, _ = _batch(size=24)
    before = wa.window_attention.launches
    with torch.no_grad():
        out = model(preprocess_input(images, model))["out"]
        small = torch.nn.functional.interpolate(
            images[..., 0], size=(16, 16), mode="bilinear",
            align_corners=True)
        inner = model(small.permute(0, 2, 3, 1))["out"]
    assert wa.window_attention.launches - before == 2 * 10
    assert out.shape == (2, 24, 24, 2)
    back = torch.nn.functional.interpolate(
        inner.permute(0, 3, 1, 2), size=(24, 24), mode="bilinear",
        align_corners=True).permute(0, 2, 3, 1)
    assert torch.allclose(out, back, atol=1e-6)


# ------------------------------------------------------------ the paths

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """cli/train --model swinunet, one epoch of one step on a tiny tree,
    the first epoch traced."""
    root = tmp_path_factory.mktemp("swin")
    data = make_synthetic_breadm(str(root / "data"), size=40,
                                 patients_per_split=1, slices_per_patient=2,
                                 seed=5)
    result = train_cli.run([
        "--data-path", data, "--model", "swinunet", "--device", "cpu",
        "--data-base-size", "40", "--data-crop-size", "32",
        "--batch-size", "2", "--epochs", "1", "--print-freq", "100",
        "--profile-dir", str(root / "prof"), "--save-dir",
        str(root / "w"), "--output-dir", str(root / "o")])
    return data, str(root / "w"), result


def test_train_cli_trains_swinunet_and_traces_the_op(trained):
    _, weights, result = trained
    assert result["steps"] == 1
    assert all(np.isfinite(e["train_loss"]) for e in result["epochs"])
    assert os.path.isfile(os.path.join(weights,
                                       "swinunet_best_model.pth"))
    with open(result["trace_file"]) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    # 14 blocks a forward: the training step's and the evaluations'
    assert names.count("window_attention") >= 14


def test_the_checkpoint_answers_through_cli_test_and_the_engine(trained):
    from stf_unet_tpu_torch.cli import test as test_cli
    from stf_unet_tpu_torch.serve.engine import InferenceEngine

    data, weights, _ = trained
    report = test_cli.main(["--model", "swinunet", "--model-dir", weights,
                            "--root", data, "--device", "cpu",
                            "--dtype", "f32"])
    assert 0.0 <= report["dice"] <= 1.0
    model, data_cfg, model_cfg, _ = restore_for_inference(
        "swinunet", os.path.join(weights, "swinunet_best_model.pth"),
        dtype="f32", device="cpu")
    assert model_cfg.model == "swinunet" and not model_cfg.use_pk_maps
    engine = InferenceEngine(model, data_cfg.mean, data_cfg.std,
                             max_batch=2, device="cpu")
    frames = np.random.default_rng(0).integers(
        0, 256, (1, 8, 256, 256, 1), dtype=np.uint8)
    masks = engine.predict(frames)
    assert masks.shape == (1, 256, 256)
    x = (torch.from_numpy(frames).float() / 255.0 - data_cfg.mean) \
        / data_cfg.std
    with torch.no_grad():
        logits = model(preprocess_input(x, model))["out"]
    margin = (logits[..., 1] - logits[..., 0]).abs() > 1e-3
    assert np.array_equal(np.asarray(masks)[margin.numpy()],
                          logits.argmax(-1)[margin].numpy())


def test_the_checkpoint_answers_through_val_predict_and_serve(
        trained, tmp_path, monkeypatch):
    import yaml

    from stf_unet_tpu_torch.cli import predict as predict_cli
    from stf_unet_tpu_torch.cli import serve as serve_cli
    from stf_unet_tpu_torch.cli import val as val_cli

    data, weights, _ = trained
    monkeypatch.chdir(tmp_path)
    with open("config.yml", "w") as f:
        yaml.safe_dump({"arch": "swinunet", "crop_size": 32}, f)
    report = val_cli.main(["--model-path", weights, "--root", data,
                           "--config", "config.yml", "--device", "cpu"])
    assert 0.0 <= report["dice"] <= 1.0
    np.savez(tmp_path / "volume.npz", frames=np.random.default_rng(1)
             .integers(0, 256, (8, 48, 40), dtype=np.uint8))
    written = predict_cli.main([
        "--input", str(tmp_path / "volume.npz"), "--model", "swinunet",
        "--model-dir", weights, "--output-dir", str(tmp_path / "pred"),
        "--device", "cpu"])
    assert written["slices"] == 1
    server = serve_cli.build_server(serve_cli.parse_args([
        "--model", "swinunet", "--model-dir", weights, "--port", "0",
        "--device", "cpu", "--dtype", "f32", "--max-batch", "2"]))
    assert server is not None


def test_spatial_parallelism_refuses_swinunet(tmp_path):
    with pytest.raises(SystemExit, match="swinunet's window attention"):
        train_cli.run(["--data-path", str(tmp_path), "--model", "swinunet",
                       "--device", "cpu", "--spatial-parallel", "2",
                       "--batch-size", "2"])


def test_int8_refuses_swinunet(capsys):
    from stf_unet_tpu_torch.cli import quantize as quantize_cli
    from stf_unet_tpu_torch.cli import serve as serve_cli

    for parse, argv in (
            (quantize_cli.parse_args, ["--model", "swinunet"]),
            (serve_cli.parse_args, ["--model", "swinunet", "--weights",
                                    "x.pth", "--dtype", "int8"])):
        with pytest.raises(SystemExit):
            parse(argv)
        assert "swinunet computes in Linear layers" in capsys.readouterr().err
    model = _tiny_model()
    with pytest.raises(ValueError, match="Linear layers"):
        quant.QuantizedModel(model, {})
    with pytest.raises(ValueError, match="Linear layers"):
        quant.calibrate(model, [])


# ------------------------------------------------------------ on the card
# python -m pytest tests/test_torch_swin_unet.py --noconftest -m chip
# (tests/conftest.py imports JAX, which the card's machine lacks)

chip = pytest.mark.chip
CARD_B, CARD_SRC, CARD_CROP = 16, 256, 224


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _card_state(device, drop_path_rate=0.0, seed=0):
    from stf_unet_tpu_torch.core.config import OptimConfig
    from stf_unet_tpu_torch.train.state import TrainState, make_optimizer

    torch.manual_seed(seed)
    cfg = ModelConfig(model="swinunet", num_classes=1,
                      drop_path_rate=drop_path_rate)
    net = create_model(cfg, dtype=torch.bfloat16).to(device)
    return cfg, TrainState(net, make_optimizer(OptimConfig(), net, device))


def _card_batches(device, n, seed=1):
    from stf_unet_tpu_torch.train import loop

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        frames = rng.integers(0, 256, (CARD_B, 8, CARD_SRC, CARD_SRC),
                              dtype=np.uint8)
        masks = (rng.random((CARD_B, CARD_SRC, CARD_SRC)) > 0.8).astype(
            np.uint8)
        out.append(loop.DeviceBatch(
            torch.from_numpy(frames).to(device),
            torch.from_numpy(masks).to(device), None,
            np.full((CARD_B, 2), CARD_SRC, np.int32)))
    return out


def _card_run(state, cfg, batches, device, graph, lr, same_draws=False):
    from stf_unet_tpu_torch.core.config import DataConfig
    from stf_unet_tpu_torch.core.prng import augment_generator
    from stf_unet_tpu_torch.data.transforms import TrainAugment
    from stf_unet_tpu_torch.train import loop

    aug = TrainAugment(DataConfig(base_size=CARD_SRC, crop_size=CARD_CROP))
    losses = [loop.train_step(state, aug, batch,
                              augment_generator(0, 0, 0 if same_draws else i),
                              lr, cfg.total_classes, device, graph=graph)[0]
              for i, batch in enumerate(batches)]
    torch.cuda.synchronize(device)
    return [float(x) for x in losses]


def _exact_lr(step):
    """Every lr exact in float32, the precision a replay reads it in."""
    return 2.0 ** -10 * (1.0 - step / 64)


def _card_floats(state):
    return {k: v.detach().float().clone()
            for k, v in state.model.state_dict().items()}


@chip
def test_the_graph_path_is_the_eager_path_on_the_card(card):
    """Six steps at the cell's shape (B 16, crop 224) from one seeded
    state, graph path against eager path, in the form of
    tests/test_torch_step_graph.py's STF test: an eager rerun is the
    control for the sums the card leaves in an order of chance (the
    memory-efficient attention's backward accumulates in parallel), and
    the graph path may differ from the first eager run by three times
    the rerun's difference plus bf16's rounding (2^-8) of the first loss
    and of each leaf's change."""
    from stf_unet_tpu_torch.train import loop

    batches = _card_batches(card, 6)
    cfg, eager = _card_state(card)
    start = _card_floats(eager)
    before = {k: getattr(loop.train_step, k)
              for k in ("eager_steps", "captures", "replays")}
    lost_e = _card_run(eager, cfg, batches, card, False, _exact_lr)
    _, again = _card_state(card)
    lost_a = _card_run(again, cfg, batches, card, False, _exact_lr)
    _, graphed = _card_state(card)
    lost_g = _card_run(graphed, cfg, batches, card, True, _exact_lr)
    counts = {k: getattr(loop.train_step, k) - before[k] for k in before}
    assert counts == {"eager_steps": 13, "captures": 1, "replays": 5}
    own = np.abs(np.subtract(lost_a, lost_e)).max()
    gap = np.abs(np.subtract(lost_g, lost_e)).max()
    assert gap <= 3 * own + 2 ** -8 * lost_e[0], (lost_g, lost_e, lost_a)
    e, a, g = _card_floats(eager), _card_floats(again), _card_floats(graphed)
    worst = []
    for k in e:
        moved = (e[k] - start[k]).norm().item()
        own = (a[k] - e[k]).norm().item()
        gap = (g[k] - e[k]).norm().item()
        worst.append((gap / max(moved, 1e-12), k, gap, own, moved))
        assert gap <= 3 * own + 2 ** -8 * moved + 1e-6, (k, gap, own, moved)
    print("widest graph/eager gap over the change:", max(worst))


@chip
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_replays_draw_fresh_drop_path_masks(card, rate):
    """One batch stepped again and again at lr 0 under the same
    augmentation draws (the parameters and the inputs stay put): at
    --drop-path-rate 0.2 each replay draws new masks, so every loss
    differs; at 0 the replays repeat the loss exactly. Each replay
    advances the window-attention op's counter by the architecture's 14
    calls."""
    cfg, state = _card_state(card, drop_path_rate=rate)
    batch = _card_batches(card, 1)[0]
    before = wa.window_attention.launches
    losses = _card_run(state, cfg, [batch] * 6, card, True, lambda s: 0.0,
                       same_draws=True)
    # a warm step, the capture (which replays) and four replays
    assert wa.window_attention.launches - before == 14 * 6
    replayed = losses[1:]
    if rate:
        assert len(set(replayed)) == len(replayed), replayed
    else:
        assert len(set(replayed)) == 1, replayed
