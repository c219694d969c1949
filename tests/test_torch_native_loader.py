"""The port's native decoder (data/native_loader.py over its own copy of
the decoder, stf_unet_tpu_torch/native/decoder.cpp) and its RAM cache
held against PIL and the JAX package's native loader on the CPU: decoded
PNG and JPEG frames, padded canvases and failures, the banded resize,
HostLoader batches (native, PIL, RAM-cached epochs) and the sample path
of the eval pass. Tolerance: byte-equal everywhere.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from stf_unet_tpu.data import native_loader as jax_native
from stf_unet_tpu.data.index import DatasetIndex as JaxDatasetIndex
from stf_unet_tpu.data.loader import HostLoader as JaxHostLoader
from stf_unet_tpu.data.transforms import \
    _banded_resize_taps as jax_resize_taps
from stf_unet_tpu_torch.data import native_loader
from stf_unet_tpu_torch.data.index import DatasetIndex
from stf_unet_tpu_torch.data.loader import (HostLoader, load_sample_raw,
                                            load_sample_raw_native)
from stf_unet_tpu_torch.data.synthetic import make_synthetic_breadm
from stf_unet_tpu_torch.data.transforms import banded_resize_u8

SEQ = tuple(f"SUB{i}" for i in range(1, 9))


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
def tree(tmp_path_factory):
    data = str(tmp_path_factory.mktemp("native") / "breadm")
    make_synthetic_breadm(data, size=40, seed=7, sequence_prefix="SUB",
                          with_pk_maps=True)
    return data


def test_the_library_is_the_ports_own():
    assert native_loader.native_available()  # needs g++, libjpeg, libpng
    path = native_loader.library_path()
    assert path.exists() and "build" in path.parts
    assert path.parent != os.path.dirname(jax_native.__file__)


def test_decode_matches_pil_and_the_jax_decoder(tree, tmp_path):
    rec = DatasetIndex(tree, "train", SEQ).records[0]
    rng = np.random.default_rng(0)
    jpg = str(tmp_path / "x.jpg")
    Image.fromarray(rng.integers(0, 255, (40, 56), dtype=np.uint8)).save(
        jpg, quality=95)
    paths = [*rec.image_paths, rec.mask_path, jpg, str(tmp_path / "none")]
    canvas, sizes = native_loader.decode_batch(paths, 48, 64, fill=7)
    jcanvas, jsizes = jax_native.decode_batch(paths, 48, 64, fill=7)
    np.testing.assert_array_equal(canvas, jcanvas)
    np.testing.assert_array_equal(sizes, jsizes)
    for i, p in enumerate(paths[:-1]):
        with Image.open(p) as im:
            want = np.asarray(im.convert("L"))
        h, w = want.shape
        assert tuple(sizes[i]) == (h, w)
        np.testing.assert_array_equal(canvas[i, :h, :w], want)
        assert (canvas[i, h:] == 7).all() and (canvas[i, :, w:] == 7).all()
    assert tuple(sizes[-1]) == (0, 0) and (canvas[-1] == 7).all()
    assert native_loader.image_size(jpg) == (40, 56)


def test_banded_resize_matches_numpy_and_the_jax_kernel():
    rng = np.random.default_rng(7)
    for h, w, oh, ow in [(256, 256, 224, 224), (48, 64, 32, 42),
                         (100, 80, 224, 179), (31, 77, 64, 159)]:
        idx_h, wgt_h = jax_resize_taps(h, oh)
        idx_w, wgt_w = jax_resize_taps(w, ow)
        x = rng.integers(0, 256, (3, h, w), dtype=np.uint8)
        got = native_loader.banded_resize(x, oh, ow, idx_h, wgt_h, idx_w,
                                          wgt_w)
        np.testing.assert_array_equal(got, banded_resize_u8(
            x, oh, ow, idx_h, wgt_h, idx_w, wgt_w, force_numpy=True))
        np.testing.assert_array_equal(got, jax_native.banded_resize(
            x, oh, ow, idx_h, wgt_h, idx_w, wgt_w))


def test_loader_batches_native_pil_and_jax(tree, capsys):
    index = DatasetIndex(tree, "train", SEQ, use_pk_maps=True)
    kw = dict(shuffle=True, seed=1, use_pk_maps=True, prefetch=0)
    native = HostLoader(index, 3, use_native=True, **kw)
    pil = HostLoader(index, 3, use_native=False, **kw)
    out = capsys.readouterr().out.splitlines()
    assert "host decoder: native C++ (libjpeg / libpng)" in out
    assert "host decoder: PIL" in out
    jax = JaxHostLoader(JaxDatasetIndex(tree, "train", SEQ,
                                        use_pk_maps=True), 3, **kw)
    for a, b, c in zip(native.epoch(1), pil.epoch(1), jax.epoch(1)):
        for field in ("frames", "masks", "pk", "sizes"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field))
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(c, field))


def test_native_batches_resize_off_size_maps_as_pil(tree, tmp_path):
    """An off-size map is NEAREST-resized and a missing one zero-filled
    on the native path too (the PIL rules; the JAX package's native
    batch path would place the off-size map unresized)."""
    import shutil
    data = str(tmp_path / "breadm")
    shutil.copytree(tree, data)
    pk_dir = os.path.join(data, "seg", "training", "pk_maps")
    small = np.arange(20 * 20, dtype=np.uint8).reshape(20, 20)
    Image.fromarray(small).save(os.path.join(pk_dir, "P000", "ve.png"))
    os.remove(os.path.join(pk_dir, "P001", "vp.png"))
    index = DatasetIndex(data, "train", SEQ, use_pk_maps=True)
    kw = dict(shuffle=False, use_pk_maps=True, prefetch=0)
    for a, b in zip(HostLoader(index, 4, use_native=True, **kw).epoch(0),
                    HostLoader(index, 4, use_native=False, **kw).epoch(0)):
        np.testing.assert_array_equal(a.pk, b.pk)
        np.testing.assert_array_equal(a.frames, b.frames)


def test_ram_cache_epochs_equal_decode_epochs(tree, monkeypatch):
    index = DatasetIndex(tree, "train", SEQ, use_pk_maps=True)
    kw = dict(shuffle=True, seed=2, use_pk_maps=True, prefetch=1)
    cached = HostLoader(index, 2, cache_ram=True, **kw)
    plain = HostLoader(index, 2, **kw)
    first = [b.frames.copy() for b in cached.epoch(0)]
    assert len(cached._cache) == len(index)
    decoded = []
    monkeypatch.setattr(cached, "_make_batch",
                        lambda recs: decoded.append(recs))
    for epoch in (0, 1, 2):
        for a, b in zip(cached.epoch(epoch, skip_batches=epoch % 2),
                        plain.epoch(epoch, skip_batches=epoch % 2)):
            for field in ("frames", "masks", "pk", "sizes"):
                np.testing.assert_array_equal(getattr(a, field),
                                              getattr(b, field))
    assert not decoded  # later epochs never decode
    np.testing.assert_array_equal(np.concatenate(first),
                                  np.concatenate([b.frames for b in
                                                  plain.epoch(0)]))


def test_eval_samples_native_equal_pil(tree):
    for rec in DatasetIndex(tree, "val", SEQ, use_pk_maps=True).records:
        for got, want in zip(load_sample_raw_native(rec, True),
                             load_sample_raw(rec, True)):
            np.testing.assert_array_equal(got, want)
