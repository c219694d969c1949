"""The port's host-only data CLIs (stf_unet_tpu_torch/cli/{stats, split,
merge, doctor}.py) held against the JAX package's on the same trees.

Everything here is numpy and PIL on both sides, so the outputs must be
equal: stats' mean and std, split's assignment and the tree it builds,
merge's overlay PNGs pixel for pixel, and doctor's --json report and
exit code for each damage class of tests/test_doctor.py (one case each
of a parametrised test, on a fresh tree). The one wording that differs
is the tool a missing-PK-maps warning names: the JAX package's
`stf-pk-maps` script, the port's `pk.maps` module.
"""

import json
import os
import shutil

import numpy as np
import pytest
from PIL import Image

from stf_unet_tpu.cli import doctor as jax_doctor
from stf_unet_tpu.cli import merge as jax_merge
from stf_unet_tpu.cli import split as jax_split
from stf_unet_tpu.cli import stats as jax_stats
from stf_unet_tpu_torch.cli import doctor, merge, split, stats
from stf_unet_tpu_torch.data.synthetic import make_synthetic_breadm


def _both(capsys, jax_main, port_main, argv):
    """(exit value, stdout) of each package's main on the same argv."""
    out = []
    for main in (jax_main, port_main):
        rc = main(list(argv))
        out.append((rc, capsys.readouterr().out))
    (rc_j, out_j), port = out
    return [(rc_j, out_j.replace("stf-pk-maps", "pk.maps")), port]


def test_stats_match_jax(synthetic_root, tmp_path, capsys):
    (rc_j, out_j), (rc_p, out_p) = _both(capsys, jax_stats.main, stats.main,
                                         [synthetic_root])
    assert rc_p == rc_j and out_p == out_j
    flat = tmp_path / "flat"
    flat.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (16, 20), np.uint8)).save(
            flat / f"f{i}.png")
    (rc_j, _), (rc_p, _) = _both(capsys, jax_stats.main, stats.main,
                                 [str(flat), "--flat"])
    assert rc_p == rc_j


def _pool(tmp_path):
    """An unsplit pool (images / labels per patient) of 6 patients."""
    tree = make_synthetic_breadm(str(tmp_path / "tree"), size=24,
                                 time_steps=2, patients_per_split=6,
                                 slices_per_patient=1, splits=("training",))
    pool = tmp_path / "pool"
    for kind in ("images", "labels"):
        shutil.copytree(os.path.join(tree, "seg", "training", kind),
                        pool / kind)
    return str(pool)


def _listing(root):
    out = {}
    for base, dirs, files in os.walk(root, followlinks=True):
        for name in dirs + files:
            path = os.path.join(base, name)
            rel = os.path.relpath(path, root)
            out[rel] = os.readlink(path) if os.path.islink(path) else None
    return out


@pytest.mark.parametrize("flags", [
    ["--ratios", "0.5,0.25,0.25", "--seed", "3"],
    ["--kfold", "3", "--fold", "1", "--mode", "copy"],
])
def test_split_matches_jax(tmp_path, flags, capsys):
    pool = _pool(tmp_path)
    res = []
    for name, main in (("jax", jax_split.main), ("port", split.main)):
        dest = str(tmp_path / name)
        res.append((main([pool, "--dest", dest, *flags]), dest))
    (want, dest_j), (got, dest_p) = res
    assert got["assignment"] == want["assignment"]
    assert got["counts"] == want["counts"]
    assert _listing(dest_p) == _listing(dest_j)
    capsys.readouterr()


def test_merge_matches_jax(tmp_path, capsys):
    subs, masks = tmp_path / "subs", tmp_path / "masks"
    subs.mkdir()
    masks.mkdir()
    rng = np.random.default_rng(1)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (20, 24), np.uint8)).save(
            subs / f"007_{i}.jpg")
        m = np.zeros((10, 12), np.uint8)
        m[2:7, 3:9] = rng.integers(100, 256)
        Image.fromarray(m).save(masks / f"007_{i}.png")
    outs = {}
    for name, main in (("jax", jax_merge.main), ("port", merge.main)):
        out_dir = str(tmp_path / name)
        n = main(["--patient-id", "007", "--subtraction-dir", str(subs),
                  "--mask-dir", str(masks), "--output-dir", out_dir,
                  "--overlay-color", "0,255,0", "--overlay-alpha", "0.4"])
        assert n == 3
        outs[name] = out_dir
    for f in sorted(os.listdir(outs["jax"])):
        np.testing.assert_array_equal(
            np.asarray(Image.open(os.path.join(outs["port"], f))),
            np.asarray(Image.open(os.path.join(outs["jax"], f))))
    with pytest.raises(SystemExit, match="cv2"):
        merge.main(["--patient-id", "007", "--subtraction-dir", str(subs),
                    "--mask-dir", str(masks), "--border-only"])
    capsys.readouterr()


SEQ = tuple(f"VIBRANT+C{i}" for i in range(1, 9))
TRAIN = ("seg", "training")


def _path(root, *parts):
    return os.path.join(root, *TRAIN, *parts)


def _truncate(path):
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[: max(len(data) // 2, 30)])


def _rm_seq(root):
    shutil.rmtree(_path(root, "images", "P000", "VIBRANT+C3"))


def _rm_slice(root):
    os.remove(_path(root, "images", "P001", "VIBRANT+C5", "slice_000.png"))


def _rm_mask(root):
    os.remove(_path(root, "labels", "P001", "VIBRANT+C1", "slice_001.png"))


def _empty_file(root):
    open(_path(root, "images", "P002", "VIBRANT+C2", "slice_000.png"),
         "wb").close()


def _bad_magic(root):
    with open(_path(root, "images", "P002", "VIBRANT+C4", "slice_001.png"),
              "wb") as f:
        f.write(b"JUNKJUNKJUNK")


def _resize_frame(root):
    p = _path(root, "images", "P000", "VIBRANT+C2", "slice_000.png")
    Image.open(p).resize((24, 24)).save(p)


def _odd_mask_value(root):
    p = _path(root, "labels", "P001", "VIBRANT+C1", "slice_000.png")
    arr = np.asarray(Image.open(p).convert("L")).copy()
    arr[0, 0] = 7
    Image.fromarray(arr).save(p)


def _rm_split(root):
    shutil.rmtree(os.path.join(root, "seg", "val"))


def _rm_all_labels(root):
    for p in ("P000", "P001", "P002"):
        shutil.rmtree(_path(root, "labels", p))


def _truncate_frame(root):
    _truncate(_path(root, "images", "P000", "VIBRANT+C2", "slice_000.png"))


def _truncate_mask(root):
    _truncate(_path(root, "labels", "P001", "VIBRANT+C1", "slice_000.png"))


def _orphan_mask(root):
    _rm_slice(root)
    Image.fromarray(np.zeros((8, 8), np.uint8)).save(
        _path(root, "labels", "P002", "VIBRANT+C1", "slice_999.png"))


def _leak(root):
    for kind in ("images", "labels"):
        shutil.copytree(_path(root, kind, "P000"),
                        os.path.join(root, "seg", "test", kind, "P000"),
                        dirs_exist_ok=True)


def _fake_png_mask(root):
    with open(_path(root, "labels", "P000", "VIBRANT+C1", "slice_000.png"),
              "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\nnot really a png")


def _ignore_corner(root):
    p = _path(root, "labels", "P000", "VIBRANT+C1", "slice_000.png")
    m = np.asarray(Image.open(p).convert("L")).copy()
    m[:4, :4] = 255
    Image.fromarray(m).save(p)


# (damage, flags, mask classes of the synthetic tree)
DOCTOR_CASES = {
    "clean": (None, [], 1),
    "missing_sequence_dir": (_rm_seq, [], 1),
    "slice_missing_from_a_sequence": (_rm_slice, [], 1),
    "missing_mask": (_rm_mask, [], 1),
    "empty_file": (_empty_file, [], 1),
    "bad_header_magic": (_bad_magic, [], 1),
    "frame_size_mismatch": (_resize_frame, ["--decode"], 1),
    "binary_mask_values": (_odd_mask_value, ["--decode"], 1),
    "index_mask_values": (_odd_mask_value,
                          ["--decode", "--mask-format", "index",
                           "--num-classes", "2"], 1),
    "missing_split": (_rm_split, ["--splits", "val"], 1),
    "empty_split": (_rm_all_labels, [], 1),
    "truncated_frame": (_truncate_frame, ["--decode"], 1),
    "undecodable_mask": (_truncate_mask, ["--splits", "train", "--decode"],
                         1),
    "orphan_mask": (_orphan_mask, [], 1),
    "unknown_split": (None, ["--splits", "training"], 1),
    "cross_split_leakage": (_leak, [], 1),
    "missing_pk_maps": (None, ["--use-pk-maps"], 1),
    "class_stats_binary": (None, ["--splits", "train,val",
                                  "--class-stats"], 1),
    "class_stats_index_ignore": (_ignore_corner,
                                 ["--class-stats", "--mask-format", "index",
                                  "--num-classes", "3"], 3),
    "class_stats_undecodable_mask": (_fake_png_mask,
                                     ["--splits", "train", "--class-stats"],
                                     1),
    "class_stats_zero_class": (None, ["--splits", "train", "--class-stats",
                                      "--mask-format", "index",
                                      "--num-classes", "5"], 3),
}


@pytest.mark.parametrize("case", sorted(DOCTOR_CASES))
def test_doctor_report_matches_jax(case, tmp_path, capsys):
    damage, flags, classes = DOCTOR_CASES[case]
    root = make_synthetic_breadm(str(tmp_path / "breadm"), size=40,
                                 time_steps=8, patients_per_split=3,
                                 slices_per_patient=2, mask_classes=classes)
    if damage is not None:
        damage(root)
    argv = ["--data-path", root, "--json", *flags]
    (rc_j, out_j), (rc_p, out_p) = _both(capsys, jax_doctor.main,
                                         doctor.main, argv)
    assert rc_p == rc_j
    assert json.loads(out_p) == json.loads(out_j)
    # the text report too
    (rc_j, out_j), (rc_p, out_p) = _both(
        capsys, jax_doctor.main, doctor.main, [a for a in argv
                                               if a != "--json"])
    assert (rc_p, out_p) == (rc_j, out_j)
