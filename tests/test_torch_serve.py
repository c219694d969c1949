"""The port's serving stack on the CPU (stf_unet_tpu_torch/serve, cli/serve)
and its eval preprocessing held against the JAX package's.

The HTTP tests run a narrow-input STF-LSTM-UNet (random weights from a
seed, crop 64) on device="cpu"; the server's wire contract is the JAX
package's (serve/http.py).
"""

import io
import os
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from stf_unet_tpu.core.config import DataConfig as JaxDataConfig
from stf_unet_tpu.data.transforms import eval_preprocess as jax_eval_preprocess
from stf_unet_tpu.ops import resize as jax_resize
from stf_unet_tpu_torch.cli.serve import build_server, parse_args
from stf_unet_tpu_torch.core.config import DataConfig, ModelConfig
from stf_unet_tpu_torch.data.transforms import eval_preprocess, normalize
from stf_unet_tpu_torch.models.registry import create_model
from stf_unet_tpu_torch.ops import resize
from stf_unet_tpu_torch.serve.client import SegmentationClient, ServerError

CROP = 64
T_STEPS = 8


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    torch.manual_seed(0)
    path = os.path.join(tmp_path_factory.mktemp("w"), "stflstm.pth")
    torch.save({"model": create_model(ModelConfig()).state_dict(),
                "epoch": 5}, path)
    return path


@pytest.fixture(scope="module")
def server(weights):
    srv = build_server(parse_args(
        ["--weights", weights, "--port", "0", "--device", "cpu",
         "--dtype", "f32", "--crop-size", str(CROP), "--max-batch", "2",
         "--batch-window-ms", "1"]))
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def client(server):
    return SegmentationClient("http://%s:%d" % server.address, timeout=120)


def _frames(h=70, w=90, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (T_STEPS, h, w),
                                                dtype=np.uint8)


def test_healthz_and_metrics(client):
    assert client.healthz()["status"] == "ok"
    assert client.healthz()["model"] == "stflstm"
    m = client.metrics()
    assert set(m) >= {"requests", "errors", "latency_ms", "batches",
                      "mean_batch", "seen_shapes"}
    # warmup ran both buckets at the served geometry
    assert [1, T_STEPS, CROP, CROP, 1] in m["seen_shapes"]
    assert [2, T_STEPS, CROP, CROP, 1] in m["seen_shapes"]


def test_segment_json_npz_png_and_full_size(server, client):
    frames = _frames()
    mask = client.segment(frames)
    assert mask.shape == (CROP, 82)  # short edge 70 -> 64, 90 -> 82
    full = client.segment(frames, full_size=True)
    assert full.shape == frames.shape[1:]
    summary = client.segment_summary(frames)
    assert summary["mask_shape"] == [CROP, 82]
    assert sum(summary["class_pixels"].values()) == CROP * 82
    png = Image.open(io.BytesIO(client.segment_png(frames)))
    assert png.size == (82, CROP)
    np.testing.assert_array_equal(np.asarray(png) // 255, mask)
    # the mask is the engine's argmax on the stride-padded resized input
    image, (h, w) = server.preprocess(frames)
    assert image.shape == (T_STEPS, CROP, 96, 1) and (h, w) == (CROP, 82)
    np.testing.assert_array_equal(
        server.engine.predict(image[None])[0][:h, :w], mask)


def test_segment_probs(client):
    frames = _frames(seed=1)
    mask, probs = client.segment_probs(frames)
    assert probs.dtype == np.float16 and probs.shape == mask.shape + (2,)
    np.testing.assert_allclose(probs.astype(np.float32).sum(-1), 1.0,
                               atol=2e-3)
    np.testing.assert_array_equal(mask, client.segment(frames))
    fmask, fprobs = client.segment_probs(frames, full_size=True)
    assert fmask.shape == frames.shape[1:] == fprobs.shape[:2]


def test_concurrent_requests_batch(client, server):
    from concurrent.futures import ThreadPoolExecutor

    frames = [_frames(64, 64, seed=i) for i in range(4)]
    with ThreadPoolExecutor(4) as ex:
        masks = list(ex.map(client.segment, frames))
    assert all(m.shape == (CROP, CROP) for m in masks)
    assert server.batcher.total_batches >= 2


def test_errors(server, client, weights):
    with pytest.raises(ServerError) as e:
        client._request("/v1/segment", b"not an npz")
    assert e.value.code == 400
    # a reload that cannot read its checkpoint: 409, as the JAX server
    os.replace(weights, weights + ".away")
    try:
        with pytest.raises(ServerError) as e:
            client.reload()
    finally:
        os.replace(weights + ".away", weights)
    assert e.value.code == 409
    assert client.reload()["reloaded"] is True
    with pytest.raises(ServerError) as e:
        client._request("/v1/segment?probs=1&format=png",
                        client._payload(_frames()))
    assert e.value.code == 400
    with pytest.raises(ServerError) as e:
        client._request("/nope")
    assert e.value.code == 404
    with pytest.raises(ValueError, match="uint8"):
        client.segment(_frames().astype(np.int16))


def test_prometheus_metrics(server):
    url = "http://%s:%d/metrics?format=prometheus" % server.address
    with urllib.request.urlopen(url, timeout=30) as r:
        text = r.read().decode()
    assert "stf_requests_total" in text and "stf_mean_batch_size" in text


def test_cli_flags(capsys):
    args = parse_args(["--weights", "m.pth"])
    assert (args.model, args.dtype, args.device, args.max_batch) == \
        ("stflstm", "bf16", "cuda", 8)
    assert parse_args(["--weights", "m.pth", "--dtype", "int8"]).dtype == \
        "int8"
    with pytest.raises(SystemExit):
        parse_args(["--weights", "m.pth", "--data-parallel", "2"])
    assert "data-parallel inference" in capsys.readouterr().err


@pytest.mark.parametrize("shape", [(3, 256, 256), (2, 300, 240),
                                   (1, 64, 64), (2, 100, 37)])
def test_eval_preprocess_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    frames = rng.integers(0, 256, shape, dtype=np.uint8)
    mask = rng.integers(0, 2, shape[1:], dtype=np.uint8)
    for raw in (True, False):
        want = jax_eval_preprocess(frames, mask, JaxDataConfig(), raw=raw)
        got = eval_preprocess(frames, mask, DataConfig(), raw=raw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_normalize_matches_host_formula():
    x = np.arange(256, dtype=np.uint8)
    cfg = DataConfig()
    got = normalize(torch.from_numpy(x), cfg.mean, cfg.std).numpy()
    want = (x.astype(np.float32) / 255.0 - cfg.mean) / cfg.std
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_in,n_out", [(7, 14), (28, 56), (56, 224),
                                        (256, 224), (90, 82), (5, 1)])
def test_resize_helpers_match_jax(n_in, n_out):
    np.testing.assert_array_equal(resize._nearest_indices(n_in, n_out),
                                  jax_resize._nearest_indices(n_in, n_out))
    np.testing.assert_array_equal(resize.pil_resize_weights(n_in, n_out),
                                  jax_resize.pil_resize_weights(n_in, n_out))
    np.testing.assert_array_equal(
        resize._align_corners_weights(n_in, n_out),
        jax_resize._align_corners_weights(n_in, n_out))
    assert resize.short_edge_size(n_in, n_out + 3, 64) == \
        jax_resize.short_edge_size(n_in, n_out + 3, 64)


def test_align_corners_interpolate_matches_weight_form():
    """The model resizes with F.interpolate(align_corners=True); it is the
    JAX package's two-matmul form with _align_corners_weights."""
    x = torch.randn(2, 3, 7, 5, generator=torch.Generator().manual_seed(0))
    got = resize.resize_bilinear_align_corners(x, 14, 11)
    wh = torch.from_numpy(resize._align_corners_weights(7, 14))
    ww = torch.from_numpy(resize._align_corners_weights(5, 11))
    want = torch.einsum("oh,nchw,pw->ncop", wh, x, ww)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
