"""The port's data-parallel inference (core/mesh.inference_devices,
replicate_module; serve/engine.py, serve/tiled.py, serve/http.reload,
cli/serve --data-parallel; pk/fit.py's voxel shards) held against the
JAX package on a 2-device mesh (`create_mesh(2)` over the conftest's
simulated CPU devices), with `devices=[cpu, cpu]` in the port: two
replicas that share the host, as JAX's simulated devices do.

Tolerances:
  * the port over two replicas against the port on one device: masks,
    float16 probabilities and PK fits bit-equal (each shard runs the
    arithmetic one device runs on those rows; each device fits exactly
    the chunk one device fits in that place);
  * the port against JAX's meshed engine: probabilities within 2e-3 and
    masks equal wherever JAX's foreground probability is more than 2e-3
    from 0.5 (tests/test_torch_stflstm.py's engine terms); the tiled
    masks >= 99.9 % equal (tests/test_torch_predict.py's --tiled terms);
  * PK fits against JAX's `mesh=`: >= 99 % of voxels within 1e-4 on
    every parameter (tests/test_torch_pk.py).
"""

import numpy as np
import pytest
import torch

import jax

from stf_unet_tpu.core.config import PKConfig as JaxPKConfig
from stf_unet_tpu.core.mesh import create_mesh
from stf_unet_tpu.models.unet import UNet as JaxUNet
from stf_unet_tpu.pk import fit as jfit
from stf_unet_tpu.serve.engine import InferenceEngine as JaxEngine
from stf_unet_tpu.serve.tiled import TiledPredictor as JaxTiled
from stf_unet_tpu_torch.cli.serve import build_server, parse_args
from stf_unet_tpu_torch.core.config import DataConfig, ModelConfig, PKConfig
from stf_unet_tpu_torch.core.mesh import (inference_devices,
                                          replicate_module, split_rows)
from stf_unet_tpu_torch.models.registry import create_model
from stf_unet_tpu_torch.ops import quant
from stf_unet_tpu_torch.ops.conv import Conv2d
from stf_unet_tpu_torch.ops.kernels import quant as kquant
from stf_unet_tpu_torch.pk import fit as pfit
from stf_unet_tpu_torch.serve import tiled as ptiled
from stf_unet_tpu_torch.serve.client import SegmentationClient
from stf_unet_tpu_torch.serve.engine import InferenceEngine
from stf_unet_tpu_torch.utils.weights import unet_state_dict_from_jax
from test_torch_pk import FIT_SHARE, _curves, _port_quad_of, _share_within
from test_torch_unet import seeded_unet_variables

BASE_C = 4
CROP = 32
T_STEPS = 8
PROB_TOL = 2e-3
MASK_SHARE = 0.999
TWO = [torch.device("cpu")] * 2
CFG = DataConfig(crop_size=CROP)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small CPU steps: the test
    workers share the host's cores, and torch's default of a thread per
    core makes each tiny op of one worker wait on the others'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    """A seeded JAX UNet (base_c 4) and the port's UNet on its weights."""
    jm = JaxUNet(num_classes=2, base_c=BASE_C)
    v = seeded_unet_variables(jm, T_STEPS, seed=11)
    port = create_model(ModelConfig(model="unet", base_c=BASE_C))
    port.load_state_dict(unet_state_dict_from_jax(
        jax.device_get(v["params"]), jax.device_get(v["batch_stats"])))
    return jm, v, port.eval()


def _images(n, h=CROP, w=CROP, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, T_STEPS, h, w, 1), dtype=np.uint8)


# ------------------------------------------------------------ the devices

def test_inference_devices(monkeypatch):
    assert inference_devices(2, "cpu") == TWO
    assert inference_devices(0, "cpu") == [torch.device("cpu")]
    if not torch.cuda.is_available():  # never a quiet CPU fallback
        with pytest.raises(RuntimeError, match="cuda"):
            inference_devices(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert inference_devices(0) == [torch.device("cuda", 0),
                                    torch.device("cuda", 1)]
    assert inference_devices(1) == [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="asks for 3 GPUs but 2 are "
                                         "visible"):
        inference_devices(3)


def test_split_rows_and_replicas(pair):
    x = np.arange(12).reshape(6, 2)
    assert [s.tolist() for s in split_rows(x, 3)] == [[[0, 1], [2, 3]],
                                                     [[4, 5], [6, 7]],
                                                     [[8, 9], [10, 11]]]
    with pytest.raises(ValueError, match="does not divide"):
        split_rows(x, 4)
    _, _, port = pair
    reps = replicate_module(port, TWO)
    assert reps[0] is port and reps[1] is not port
    assert not reps[1].training
    for a, b in zip(port.parameters(), reps[1].parameters()):
        assert a is not b and torch.equal(a, b)


# ------------------------------------------------------------- the engine

@pytest.mark.parametrize("n_dev", [1, 2, 4])
@pytest.mark.parametrize("max_batch", [4, 6, 8, 12])
def test_buckets_are_jax_buckets(pair, n_dev, max_batch):
    """The bucket of every batch size, floored at the device count and a
    non-power-of-two cap cut to a multiple of it, as JAX `_bucket`."""
    jm, v, port = pair
    want = JaxEngine(jm, v, 0.5, 0.2, max_batch=max_batch,
                     mesh=create_mesh(n_dev))
    got = InferenceEngine(port, 0.5, 0.2, max_batch=max_batch,
                          devices=[torch.device("cpu")] * n_dev)
    sizes = range(1, max_batch + 1)
    assert ([got._bucket(n) for n in sizes]
            == [want._bucket(n, max_batch) for n in sizes])
    assert all(got._bucket(n) % n_dev == 0 for n in sizes)


def test_engine_matches_jax_mesh(pair):
    jm, v, port = pair
    jax_eng = JaxEngine(jm, v, CFG.mean, CFG.std, max_batch=16,
                        mesh=create_mesh(2))
    one = InferenceEngine(port, CFG.mean, CFG.std, max_batch=16,
                          device="cpu")
    two = InferenceEngine(port, CFG.mean, CFG.std, max_batch=16,
                          devices=TWO)
    assert len(two.replicas) == 2 and two.replicas[0] is port
    for n in (1, 3, 8, 11):
        images = _images(n, seed=n)
        want = jax_eng.predict(images)
        masks, probs = two.predict(images, return_probs=True)
        assert masks.shape == (n, CROP, CROP) and probs.shape[0] == n
        np.testing.assert_array_equal(masks, two.predict(images))
        one_masks, one_probs = one.predict(images, return_probs=True)
        np.testing.assert_array_equal(masks, one_masks)
        np.testing.assert_array_equal(probs, one_probs)
        _, want_probs = jax_eng.predict(images, return_probs=True)
        np.testing.assert_allclose(probs.astype(np.float32),
                                   want_probs.astype(np.float32),
                                   atol=PROB_TOL)
        decided = np.abs(want_probs[..., 1].astype(np.float32)
                         - 0.5) > PROB_TOL
        np.testing.assert_array_equal(masks[decided], want[decided])
    assert two.seen_shapes == set(jax_eng._fns)
    with pytest.raises(ValueError, match="smaller than the 2 devices"):
        InferenceEngine(port, CFG.mean, CFG.std, max_batch=1, devices=TWO)


def test_tiled_matches_jax_mesh(pair, monkeypatch):
    """Groups of 4 tiles over 2 replicas; the 9th tile's group (1 tile)
    is smaller than the device count."""
    jm, v, port = pair
    monkeypatch.setattr(ptiled, "MAX_TILE_BATCH", 4)
    image = _images(1, 64, 64, seed=5)[0]
    kw = dict(mean=CFG.mean, std=CFG.std, tile=CROP, overlap=0.5)
    want = JaxTiled(jm, v, max_tile_batch=4, mesh=create_mesh(2),
                    **kw).predict(image)
    two = ptiled.TiledPredictor(port, devices=TWO, **kw)
    calls = []
    hooks = [r.register_forward_pre_hook(
        lambda _m, args, i=i: calls.append((i, args[0].shape[0])))
        for i, r in enumerate(two.replicas)]
    try:
        got = two.predict(image)
    finally:
        for h in hooks:
            h.remove()
    assert calls == [(0, 2), (1, 2), (0, 2), (1, 2), (0, 1)]
    one = ptiled.TiledPredictor(port, device="cpu", **kw)
    scores = one.scores(image)
    assert scores.shape == (64, 64, 2) and scores.dtype == torch.float32
    np.testing.assert_array_equal(got, scores.argmax(-1).numpy())
    np.testing.assert_array_equal(got, one.predict(image))
    assert got.shape == (64, 64) and (got == want).mean() >= MASK_SHARE


# ------------------------------------------------------------------ int8

@pytest.fixture(scope="module")
def int8_model(pair):
    _, _, port = pair
    x = torch.from_numpy(_images(2, seed=3)[..., 0].transpose(0, 2, 3, 1)
                         .astype(np.float32) / 255.0)
    return quant.QuantizedModel(port, quant.calibrate(port, [x])).eval()


def test_int8_replicas_run_their_own_convs(int8_model, monkeypatch):
    """Each replica's conv table maps its own convs, and K5's and K6's
    plain twins run on every replica, once per quantized conv."""
    two = InferenceEngine(int8_model, CFG.mean, CFG.std, max_batch=4,
                          devices=TWO)
    one = InferenceEngine(int8_model, CFG.mean, CFG.std, max_batch=4,
                          device="cpu")
    tables = [r._table for r in two.replicas]
    for r, table in zip(two.replicas, tables):
        own = {m for m in r.model.modules() if isinstance(m, Conv2d)}
        assert set(table) == own and len(table) == len(r.paths) == 19
        assert all(q in list(r.quant.values()) for q in table.values())
    assert not set(tables[0]) & set(tables[1])
    counts, current = [{"k5": 0, "k6": 0}, {"k5": 0, "k6": 0}], [None]
    hooks = [r.register_forward_pre_hook(
        lambda *_, i=i: current.__setitem__(0, i))
        for i, r in enumerate(two.replicas)]
    for name, key in (("quantize_patches_plain", "k5"),
                      ("dequant_epilogue_plain", "k6")):
        plain = getattr(kquant, name)

        def counted(*args, _plain=plain, _key=key):
            counts[current[0]][_key] += 1
            return _plain(*args)
        monkeypatch.setattr(kquant, name, counted)
    images = _images(3, seed=7)
    try:
        masks = two.predict(images)
    finally:
        for h in hooks:
            h.remove()
    assert counts == [{"k5": 19, "k6": 19}] * 2
    np.testing.assert_array_equal(masks, one.predict(images))


# ----------------------------------------------------------------- reload

def _write(path, seed):
    torch.manual_seed(seed)
    model = create_model(ModelConfig(model="unet", base_c=BASE_C))
    torch.save({"model": model.state_dict(), "epoch": 1}, path)
    return model


@pytest.mark.parametrize("flags", [[], ["--dtype", "int8", "--tta",
                                        "--tiled"]])
def test_reload_reaches_every_replica(flags, tmp_path, capsys):
    """A two-replica CPU server: after POST /v1/reload the rows that land
    on replica 1 answer with the new weights (a head bias that puts every
    pixel in the class the old weights use least), over HTTP, through the
    engine and the tiles."""
    best = str(tmp_path / "unet_best_model.pth")
    model = _write(best, seed=1)
    if "int8" in flags:
        x = torch.rand(2, CROP, CROP, T_STEPS)
        quant.save_scales(quant.scales_path_for(best),
                          quant.calibrate(model.eval(), [x]))
    server = build_server(parse_args([
        "--model", "unet", "--model-dir", str(tmp_path), "--port", "0",
        "--device", "cpu", "--dtype", "f32", "--crop-size", str(CROP),
        "--max-batch", "2", "--batch-window-ms", "1", "--data-parallel",
        "2", *flags]))
    assert "data-parallel serving over 2 devices" in capsys.readouterr().out
    assert len(server.engine.replicas) == 2
    if "--tiled" in flags:
        assert server.tiled.replicas is server.engine.replicas
    server.start()
    client = SegmentationClient("http://%s:%d" % server.address, timeout=60)
    images = _images(2, seed=4)
    try:
        old = server.engine.predict(images)
        fg = int(old.mean() < 0.5)
        sd = torch.load(best, weights_only=True)
        sd["model"]["out_conv.bias"] = torch.tensor([20.0, -20.0]) * (
            1 - 2 * fg)
        torch.save(sd, best)
        assert client.reload()["reloaded"] is True
        new = server.engine.predict(images)  # row 1 runs on replica 1
        assert (new == fg).all() and (old[1] != fg).any()
        assert (client.segment(images[0, :, :, :, 0]) == fg).all()
        if "--tiled" in flags:  # off the tile geometry: the tiles
            frames = np.random.default_rng(2).integers(
                0, 256, (T_STEPS, 48, 40), dtype=np.uint8)
            assert (client.segment(frames) == fg).all()
        weights = server._replica_weights()
        assert len(weights) == 2 and weights[0] is server.weights
        for w in weights:
            inner = w.model if "int8" in flags else w
            torch.testing.assert_close(inner.out_conv.bias,
                                       sd["model"]["out_conv.bias"],
                                       rtol=0, atol=0)
    finally:
        server.stop()


# ------------------------------------------------------------- the PK fit

@pytest.mark.parametrize("solver", ["lm", "adam"])
def test_fit_sharded_bit_equal_and_matches_jax_mesh(solver, monkeypatch):
    """CHUNK = 64 over 300 voxels: 5 chunks, 3 on device 0 and 2 on
    device 1 (two dispatches); bit-equal to one device, and JAX's
    voxel-sharded fit on its 2-device mesh within the PK terms."""
    jq, curves = _curves(noise=1e-3)
    cfg = PKConfig(lm_iters=20, num_epochs=50)
    jfn = jfit.fit_lm if solver == "lm" else jfit.fit_adam
    pfn = pfit.fit_lm if solver == "lm" else pfit.fit_adam
    pq = _port_quad_of(jq)
    monkeypatch.setattr(pfit, "CHUNK", 64)
    seen = []
    chunk_fn = pfit._lm_fit_chunk if solver == "lm" else pfit._adam_fit_chunk

    def spy(chunk, quad, *args):
        seen.append(chunk.shape[0])
        return chunk_fn(chunk, quad, *args)
    monkeypatch.setattr(pfit, "_lm_fit_chunk" if solver == "lm"
                        else "_adam_fit_chunk", spy)
    one = pfn(curves, pq, cfg)
    assert seen == [64, 64, 64, 64, 44]
    got = pfn(curves, pq, cfg, devices=TWO)
    np.testing.assert_array_equal(got, one)
    want = jfn(curves, jq, JaxPKConfig(lm_iters=20, num_epochs=50),
               mesh=create_mesh(2))
    assert got.shape == (300, 3) and _share_within(got, want) >= FIT_SHARE
    assert pfn(np.zeros((0, 8), np.float32), pq, cfg,
               devices=TWO).shape == (0, 3)


def test_fit_enqueues_every_device_before_reading(monkeypatch):
    """Each dispatch starts every device's chunk before it reads any
    result back: the solver's output for device 1 exists before device
    0's is copied to the host."""
    jq, curves = _curves(n=200, noise=1e-3)
    monkeypatch.setattr(pfit, "CHUNK", 64)
    events = []

    class Result:
        def __init__(self, t):
            self.t = t
            events.append(("start", t.shape[0]))

        def cpu(self):
            events.append(("read", self.t.shape[0]))
            return self.t

    def chunk_fn(chunk, quad, cfg):
        return Result(torch.zeros((chunk.shape[0], 3)))
    out = pfit._fit_chunked(curves, _port_quad_of(jq), PKConfig(), chunk_fn,
                            devices=TWO)
    assert out.shape == (200, 3)
    assert events == [("start", 64), ("start", 64), ("read", 64),
                      ("read", 64), ("start", 64), ("start", 8),
                      ("read", 64), ("read", 8)]
