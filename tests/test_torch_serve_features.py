"""The port's serving features of the checkpoint directory
(stf_unet_tpu_torch/cli/serve.py, serve/http.py, serve/engine.py) on the
CPU: --model-dir (best, else latest), --tta, --tiled with
--warmup-geometries, POST /v1/reload and the refusals, on a seeded UNet at
base_c = 4 served at crop 32 in f32, as the JAX package's server does
them (stf_unet_tpu/cli/serve.py, serve/http.py:122-160,293-300).

Every answer is compared with the module the flag wires in, called
directly on the same frames (ops/tta.FlipTTAModel, serve/tiled.
TiledPredictor, the engine on the new weights): equal masks, the same
arithmetic on the same process. The modules themselves are held to the
JAX package in tests/test_torch_cli_test.py.
"""

import os
import time

import numpy as np
import pytest
import torch

from stf_unet_tpu_torch.cli.serve import build_server, parse_args
from stf_unet_tpu_torch.core.config import ModelConfig
from stf_unet_tpu_torch.models.registry import create_model
from stf_unet_tpu_torch.ops.tta import FlipTTAModel
from stf_unet_tpu_torch.serve.client import SegmentationClient, ServerError
from stf_unet_tpu_torch.serve.tiled import TiledPredictor

BASE_C = 4
CROP = 32
ARGS = ["--model", "unet", "--port", "0", "--device", "cpu", "--dtype",
        "f32", "--crop-size", str(CROP), "--max-batch", "2",
        "--batch-window-ms", "1"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small CPU steps: the test
    workers share the host's cores, and torch's default of a thread per
    core makes each tiny op of one worker wait on the others'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write(path, seed, epoch, base_c=BASE_C):
    torch.manual_seed(seed)
    model = create_model(ModelConfig(model="unet", base_c=base_c))
    torch.save({"model": model.state_dict(), "epoch": epoch}, path)


def _frames(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (8, h, w),
                                                dtype=np.uint8)


def _serve(argv):
    server = build_server(parse_args(ARGS + argv))
    server.start()
    client = SegmentationClient("http://%s:%d" % server.address,
                                timeout=120)
    return server, client


def _engine_mask(server, frames):
    image, (h, w) = server.preprocess(frames)
    return server.engine.predict(image[None])[0][:h, :w]


def test_model_dir_serves_best_else_latest(tmp_path, capsys):
    d = str(tmp_path)
    latest = os.path.join(d, "unet_latest_model.pth")
    _write(latest, seed=1, epoch=4)
    server = build_server(parse_args(ARGS + ["--model-dir", d,
                                             "--no-warmup"]))
    assert f"serving {latest} (epoch 4)" in capsys.readouterr().out
    assert server.engine.seen_shapes == set()  # --no-warmup
    server.batcher.close()
    server.httpd.server_close()
    best = os.path.join(d, "unet_best_model.pth")
    _write(best, seed=2, epoch=3)
    server = build_server(parse_args(ARGS + ["--model-dir", d]))
    assert f"serving {best} (epoch 3)" in capsys.readouterr().out
    assert (1, 8, CROP, CROP, 1) in server.engine.seen_shapes
    server.batcher.close()
    server.httpd.server_close()
    with pytest.raises(FileNotFoundError, match="unet_best_model_pk"):
        build_server(parse_args(ARGS + ["--model-dir", d,
                                        "--use-pk-maps"]))


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_dir")
    _write(str(d / "unet_best_model.pth"), seed=3, epoch=7)
    return str(d)


def test_tta_answers_are_the_flip_ensemble(model_dir):
    server, client = _serve(["--model-dir", model_dir, "--tta"])
    try:
        frames = _frames(40, 52, seed=1)
        mask = client.segment(frames)
        _, probs = client.segment_probs(frames)
    finally:
        server.stop()
    assert isinstance(server.engine.model, FlipTTAModel)
    image, (h, w) = server.preprocess(frames)
    x = torch.from_numpy(image[None].astype(np.float32) / 255.0)
    x = (x - server.data_cfg.mean) / server.data_cfg.std
    tta = FlipTTAModel(server.weights).eval()
    with torch.no_grad():
        logits = tta(x.permute(0, 2, 3, 1, 4).reshape(
            1, *image.shape[1:3], 8))["out"][0, :h, :w]
    np.testing.assert_array_equal(mask, logits.argmax(-1).numpy())
    np.testing.assert_allclose(probs.astype(np.float32),
                               torch.softmax(logits, -1).numpy(),
                               atol=2.0 ** -10 + 1e-5)


def test_tiled_answers_are_the_tiled_predictor(model_dir, capsys):
    server, client = _serve(["--model-dir", model_dir, "--tiled",
                             "--tile-overlap", "0.25",
                             "--warmup-geometries", "40x52, 24x24"])
    out = capsys.readouterr().out
    assert "warming up tiled geometry 40x52" in out
    assert "warming up tiled geometry 24x24" in out
    try:
        frames = [_frames(40, 52, seed=2), _frames(CROP, CROP, seed=3),
                  _frames(24, 70, seed=4)]
        masks = [client.segment(f) for f in frames]
        with pytest.raises(ServerError) as e:
            client.segment_probs(frames[0])
        assert e.value.code == 400 and "tiled" in str(e.value)
    finally:
        server.stop()
    tiled = TiledPredictor(server.weights, server.data_cfg.mean,
                           server.data_cfg.std, tile=CROP, overlap=0.25,
                           device="cpu")
    assert tiled.stride == server.tiled.stride == 24
    for f, mask in zip(frames, masks):
        assert mask.shape == f.shape[1:]  # native resolution
        np.testing.assert_array_equal(mask, tiled.predict(f[..., None]))
    # a volume at the tile geometry takes the batched path, unresized
    assert (1, 8, CROP, CROP, 1) in server.engine.seen_shapes
    assert (1, 8, 40, 52, 1) not in server.engine.seen_shapes


@pytest.mark.parametrize("argv,warning", [
    (["--warmup-geometries", "64x64"], "ignored without --tiled"),
    (["--tiled", "--no-warmup", "--warmup-geometries", "64x64"],
     "ignored with --no-warmup"),
])
def test_warmup_geometries_warnings(model_dir, argv, warning, capsys):
    server = build_server(parse_args(ARGS + ["--model-dir", model_dir,
                                             *argv]))
    server.batcher.close()
    server.httpd.server_close()
    out = capsys.readouterr().out
    assert warning in out and "warming up tiled geometry" not in out


def test_bad_warmup_geometry_stops(model_dir):
    with pytest.raises(SystemExit, match="bad --warmup-geometries"):
        build_server(parse_args(ARGS + ["--model-dir", model_dir, "--tiled",
                                        "--warmup-geometries", "64by64"]))


def test_reload_swaps_in_the_new_best(tmp_path):
    d = str(tmp_path)
    best = os.path.join(d, "unet_best_model.pth")
    _write(best, seed=5, epoch=1)
    server, client = _serve(["--model-dir", d])
    frames = _frames(48, 40, seed=6)
    try:
        before = client.segment(frames)
        old = {k: v.clone() for k, v in server.weights.state_dict().items()}
        _write(best, seed=6, epoch=2)  # a run promotes a new best
        info = client.reload()
        assert info == {"reloaded": True, "checkpoint": best, "epoch": 2,
                        "best_dice": None}
        after = client.segment(frames)
        new = torch.load(best, weights_only=True)["model"]
        for k, v in server.weights.state_dict().items():
            assert torch.equal(v, new[k]), k
        np.testing.assert_array_equal(after, _engine_mask(server, frames))
        assert not np.array_equal(before, after)
        # an architecture change is refused; the new weights keep serving
        _write(best, seed=7, epoch=3, base_c=8)
        with pytest.raises(ServerError) as e:
            client.reload()
        assert e.value.code == 409 and "restart" in str(e.value)
        np.testing.assert_array_equal(client.segment(frames), after)
        assert any(not torch.equal(v, old[k]) for k, v in
                   server.weights.state_dict().items())
    finally:
        server.stop()


def test_reload_without_a_reloader_is_409(model_dir):
    from stf_unet_tpu_torch.serve.http import SegmentationServer

    server, _ = _serve(["--model-dir", model_dir, "--no-warmup"])
    server.stop()
    bare = SegmentationServer(server.weights, server.data_cfg, port=0,
                              device="cpu")
    bare.start()
    try:
        client = SegmentationClient("http://%s:%d" % bare.address,
                                    timeout=60)
        with pytest.raises(ServerError) as e:
            client.reload()
        assert e.value.code == 409 and "not configured" in str(e.value)
    finally:
        bare.stop()


def test_reload_under_load_answers_every_request(tmp_path):
    """Requests in flight while the weights swap: every answer is the old
    or the new weights' mask, never an error."""
    from concurrent.futures import ThreadPoolExecutor

    d = str(tmp_path)
    best = os.path.join(d, "unet_best_model.pth")
    _write(best, seed=8, epoch=1)
    server, client = _serve(["--model-dir", d])
    frames = _frames(CROP, CROP, seed=9)
    try:
        old = client.segment(frames)
        _write(best, seed=9, epoch=2)
        with ThreadPoolExecutor(4) as ex:
            futures = [ex.submit(client.segment, frames) for _ in range(6)]
            time.sleep(0.01)
            client.reload()
            masks = [f.result() for f in futures]
        new = client.segment(frames)
    finally:
        server.stop()
    assert all(np.array_equal(m, old) or np.array_equal(m, new)
               for m in masks)
    assert not np.array_equal(old, new)


@pytest.mark.parametrize("argv,item", [
    (["--weights", "a.pth", "--dtype", "int8"], "calibrate first"),
    (["--model-dir", "d", "--data-parallel", "2"],
     "data-parallel serving over 2 devices"),
    ([], "--weights"),
])
def test_serve_refusals(argv, item, capsys, tmp_path, monkeypatch):
    """The refusals, and --data-parallel, which the server took up: two
    CPU replicas answer as one device does, and more GPUs than are
    visible are refused naming the count."""
    if "--data-parallel" in argv:
        d = str(tmp_path / "d")
        os.makedirs(d)
        _write(os.path.join(d, "unet_best_model.pth"), seed=3, epoch=1)
        argv = ["--model-dir", d, "--data-parallel", "2", "--tta",
                "--tiled"]
        server, client = _serve(argv)
        assert item in capsys.readouterr().out
        one, _ = _serve(argv[:2] + argv[4:])
        try:
            for h, w in ((CROP, CROP), (40, 48)):
                frames = _frames(h, w, seed=h)
                np.testing.assert_array_equal(client.segment(frames),
                                              _engine_mask(one, frames))
        finally:
            server.stop()
            one.stop()
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="asks for 2 GPUs but 1 are"):
            build_server(parse_args(["--model", "unet", "--model-dir", d,
                                     "--data-parallel", "2"]))
        return
    if "int8" in argv:
        # --dtype int8 parses; the server refuses a checkpoint that has no
        # calibrated scales beside it, naming the command that writes them
        monkeypatch.chdir(tmp_path)
        _write("a.pth", seed=0, epoch=1)
        assert parse_args(ARGS + argv).dtype == "int8"
        with pytest.raises(SystemExit, match=item) as e:
            build_server(parse_args(ARGS + argv))
        assert "a.quant_scales.json not found" in str(e.value)
        assert "python -m stf_unet_tpu_torch.cli.quantize" in str(e.value)
    else:
        with pytest.raises(SystemExit):
            parse_args(["--model", "unet", *argv])
        assert item in capsys.readouterr().err
    with pytest.raises(SystemExit):
        parse_args(["--weights", "a.pth", "--model-dir", "d"])
