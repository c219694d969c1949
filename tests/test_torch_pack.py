"""Dataset packs (data/pack.py, cli/pack.py) held against the JAX
package's on the CPU, on a tiny synthetic tree with PK maps: both CLIs
write byte-equal packs (every file, meta.json included), each package
reads the other's, pack-fed training batches equal decode-fed ones and
the eval store equals the live eval_preprocess. Tolerance: byte-equal.
"""

import os

import numpy as np
import pytest
import torch

from stf_unet_tpu.cli import pack as jax_pack_cli
from stf_unet_tpu.data.index import DatasetIndex as JaxDatasetIndex
from stf_unet_tpu.data.pack import DatasetPack as JaxDatasetPack
from stf_unet_tpu_torch.cli import pack as pack_cli
from stf_unet_tpu_torch.core.config import DataConfig
from stf_unet_tpu_torch.data.index import DatasetIndex
from stf_unet_tpu_torch.data.loader import HostLoader
from stf_unet_tpu_torch.data.pack import DatasetPack, open_split_pack
from stf_unet_tpu_torch.data.synthetic import make_synthetic_breadm
from stf_unet_tpu_torch.train.loop import eval_batches_from_index

SEQ = tuple(f"SUB{i}" for i in range(1, 9))
FLAGS = ["--use-subtraction", "--use-pk-maps", "--eval-size", "32"]


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
def packs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pack")
    data = str(root / "breadm")
    make_synthetic_breadm(data, size=40, seed=5, sequence_prefix="SUB",
                          with_pk_maps=True)
    pack_cli.main(["--data-path", data, "--output", str(root / "port"),
                   *FLAGS])
    jax_pack_cli.main(["--data-path", data, "--output", str(root / "jax"),
                       *FLAGS])
    return data, str(root / "port"), str(root / "jax")


def test_both_packages_write_the_same_bytes(packs):
    _, port, jax_root = packs
    for split in ("train", "val", "test"):
        names = sorted(os.listdir(os.path.join(port, split)))
        assert names == sorted(os.listdir(os.path.join(jax_root, split)))
        assert ("eval_frames.u8" in names) == (split != "train")
        for name in names:
            with open(os.path.join(port, split, name), "rb") as a, \
                    open(os.path.join(jax_root, split, name), "rb") as b:
                assert a.read() == b.read(), (split, name)


def test_each_package_reads_the_others_pack(packs):
    data, port, jax_root = packs
    theirs = DatasetPack(os.path.join(jax_root, "val"))
    ours = JaxDatasetPack(os.path.join(port, "val"))
    theirs.validate(DatasetIndex(data, "val", SEQ, use_pk_maps=True),
                    mask_format="binary", use_pk_maps=True)
    ours.validate(JaxDatasetIndex(data, "val", SEQ, use_pk_maps=True),
                  mask_format="binary", use_pk_maps=True)
    a = theirs.batch([1, 0], use_pk_maps=True)
    b = ours.batch([1, 0], use_pk_maps=True)
    for field in ("frames", "masks", "pk", "sizes"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    for i in range(len(theirs)):
        for x, y in zip(theirs.eval_sample(i), ours.eval_sample(i)):
            np.testing.assert_array_equal(x, y)


def test_pack_batches_equal_decode_batches(packs):
    data, port, _ = packs
    index = DatasetIndex(data, "train", SEQ, use_pk_maps=True)
    kw = dict(shuffle=True, seed=4, use_pk_maps=True, prefetch=0)
    packed = HostLoader(index, 3, pack=open_split_pack(port, "train"), **kw)
    for native in (True, False):
        decoded = HostLoader(index, 3, use_native=native, **kw)
        assert packed.canvas == decoded.canvas
        for epoch in (0, 1):
            for a, b in zip(packed.epoch(epoch, skip_batches=epoch),
                            decoded.epoch(epoch, skip_batches=epoch)):
                for field in ("frames", "masks", "pk", "sizes"):
                    np.testing.assert_array_equal(getattr(a, field),
                                                  getattr(b, field))


@pytest.mark.parametrize("crop", [32, 24])
def test_eval_store_equals_eval_preprocess(packs, crop):
    """At the stored size (32) the eval store serves; at another (24) the
    pack's decoded samples go through the live resize. Both equal the
    decode path."""
    data, port, _ = packs
    index = DatasetIndex(data, "test", SEQ, use_pk_maps=True)
    pack = open_split_pack(port, "test")
    cfg = DataConfig(crop_size=crop, use_subtraction=True, use_pk_maps=True)
    assert pack.serves_eval(crop, True) == (crop == 32)
    got = list(eval_batches_from_index(index, cfg, use_pk_maps=True,
                                       batch_size=2, pack=pack))
    want = list(eval_batches_from_index(index, cfg, use_pk_maps=True,
                                        batch_size=2))
    assert len(got) == len(want) > 0
    for (gi, gt), (wi, wt) in zip(got, want):
        assert gi.dtype == wi.dtype == np.uint8
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gt, wt)


def test_a_stale_pack_is_refused(packs):
    data, port, _ = packs
    pack = open_split_pack(port, "val")
    with pytest.raises(ValueError, match="split"):
        pack.validate(DatasetIndex(data, "test", SEQ, use_pk_maps=True),
                      mask_format="binary", use_pk_maps=True)
    with pytest.raises(ValueError, match="mask_format"):
        eval_batches_from_index(
            DatasetIndex(data, "val", SEQ, use_pk_maps=True),
            DataConfig(mask_format="index"), use_pk_maps=True, pack=pack)
