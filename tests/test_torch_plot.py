"""The port's cli/plot.py and viz/tic.py against the JAX package's on the
CPU, on the same inputs.

  * the parsers' dicts equal JAX's on the reference-style results text,
    on a metrics JSONL and on the results text / JSONL the port's
    cli/train writes;
  * `run` writes the same paths as JAX's `run` (one run, several runs, a
    patient report, a threshold sweep, from the port's cli/test report
    writers) and refuses a non-report .json with JAX's message;
  * every PNG, decoded with PIL, is pixel-equal to JAX's: tolerance 0,
    the same drawing code on the same matplotlib;
  * the three tic plots likewise, in both input layouts and from a torch
    tensor; on an empty mask both print the same warning and write
    nothing;
  * without matplotlib the port's viz package and the parsers import and
    work, and every render raises an ImportError naming matplotlib.
"""

import importlib
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from stf_unet_tpu.cli import plot as jax_plot
from stf_unet_tpu.viz import tic as jax_tic
from stf_unet_tpu_torch.cli import plot as port_plot
from stf_unet_tpu_torch.viz import tic as port_tic

REF_STYLE_BLOCKS = """\
[epoch: 0]
train_loss: 0.9123
lr: 0.000500
dice: 0.5120
global_acc: 0.9011
mean_iou: 0.4410
mean_precision: 0.6012
mean_recall: 0.5521
global correct: 90.1
average row correct: ['91.2', '45.0']
IoU: ['89.9', '30.1']
mean IoU: 60.0

[epoch: 1]
train_loss: 0.6018
lr: 0.000450
dice: 0.7233
global_acc: 0.9455
mean_iou: 0.6120
mean_precision: 0.7512
mean_recall: 0.7021
global correct: 94.6
average row correct: ['95.2', '65.0']
IoU: ['93.9', '50.1']
mean IoU: 72.0

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


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    """{name: path} of run logs: the reference-style results text (with
    the reference's argument-dump preamble), a metrics JSONL with a
    non-epoch record, and the results text and metrics JSONL of one
    port cli/train run (UNet, base_c 4, 2 epochs on a 40^2 tree)."""
    from stf_unet_tpu_torch.cli import train as train_cli
    from stf_unet_tpu_torch.data.synthetic import make_synthetic_breadm

    root = tmp_path_factory.mktemp("plot_logs")
    ref = root / "ref" / "unet_results_0101-1200.txt"
    ref.parent.mkdir()
    ref.write_text("Namespace(lr=0.0005, epochs=2)\n\n" + REF_STYLE_BLOCKS)
    jsonl = root / "jsonl" / "unet_metrics_0101.jsonl"
    jsonl.parent.mkdir()
    with open(jsonl, "w") as f:
        for ep in range(3):
            f.write(json.dumps({"epoch": ep, "train_loss": 1.0 - ep * 0.2,
                                "lr": 1e-3, "dice": 0.5 + ep * 0.1,
                                "global_acc": 0.9, "miou": 0.6,
                                "mprecision": 0.7, "mrecall": 0.65}) + "\n")
        f.write(json.dumps({"event": "test_phase", "dice": 0.9}) + "\n")
    data = str(root / "breadm")
    make_synthetic_breadm(data, size=40, seed=5)
    result = train_cli.run([
        "--data-path", data, "--model", "unet", "--model-base-c", "4",
        "--epochs", "2", "--batch-size", "2", "--data-base-size", "40",
        "--data-crop-size", "32", "--device", "cpu", "--print-freq", "10",
        "--save-dir", str(root / "weights"),
        "--output-dir", str(root / "out")])
    assert [e["epoch"] for e in result["epochs"]] == [0, 1]
    return {"ref_txt": str(ref), "jsonl": str(jsonl),
            "port_txt": result["results_file"],
            "port_jsonl": result["metrics_file"]}


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """A patient report (with surface metrics) and a threshold sweep, as
    the port's cli/test computes and writes them."""
    from stf_unet_tpu_torch.cli.test import _dump_json
    from stf_unet_tpu_torch.metrics.binary import ThresholdSweep
    from stf_unet_tpu_torch.metrics.patient import PatientAggregator

    root = tmp_path_factory.mktemp("plot_reports")
    rng = np.random.default_rng(0)
    agg = PatientAggregator(2, surface=True)
    sweep = ThresholdSweep()
    for i in range(10):
        target = np.zeros((24, 24), np.int32)
        target[4 + i % 5:14 + i % 7, 6:12 + i % 4] = 1
        prob = np.clip(target * 0.6 + rng.uniform(0, 0.5, target.shape),
                       0, 1)
        agg.update(f"P{i % 4:02d}", target, (prob > 0.5).astype(np.int32))
        sweep.update(prob, target)
    paths = {}
    for name, report in (("patient_report", agg.report()),
                         ("threshold_sweep", sweep.report())):
        paths[name] = str(root / f"{name}.json")
        _dump_json(report, paths[name])
    return paths


def _pixels(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


def _both_write(argv_of, tmp_path, capsys):
    """Run JAX's then the port's `run` on argv_of(side_dir); return
    (jax paths, port paths relative to their dirs, pixel arrays)."""
    out = {}
    for side, mod in (("jax", jax_plot), ("port", port_plot)):
        d = tmp_path / side
        d.mkdir()
        written = mod.run(argv_of(d))
        out[side] = ([os.path.relpath(w, d) for w in written],
                     [_pixels(w) for w in written])
    capsys.readouterr()
    return out["jax"], out["port"]


@pytest.mark.parametrize("name", ["ref_txt", "jsonl", "port_txt",
                                  "port_jsonl"])
def test_parsers_equal_jax(logs, name):
    path = logs[name]
    got = port_plot.parse_run(path)
    assert got == jax_plot.parse_run(path)
    parse = (port_plot.parse_jsonl if path.endswith(".jsonl")
             else port_plot.parse_results_txt)
    jax_parse = (jax_plot.parse_jsonl if path.endswith(".jsonl")
                 else jax_plot.parse_results_txt)
    assert parse(path) == jax_parse(path) == got
    assert len(got["epoch"]) >= 2 and "dice" in got


def test_parse_run_refuses_a_log_without_epochs(tmp_path):
    path = str(tmp_path / "empty_results.txt")
    open(path, "w").write("no epochs here\n")
    with pytest.raises(ValueError, match="no per-epoch records") as got:
        port_plot.parse_run(path)
    with pytest.raises(ValueError) as want:
        jax_plot.parse_run(path)
    assert str(got.value) == str(want.value)


def _copy(src, d):
    dst = d / os.path.basename(src)
    dst.write_bytes(open(src, "rb").read())
    return str(dst)


@pytest.mark.parametrize("case", ["single", "compare", "patient_report",
                                  "threshold_sweep"])
def test_run_writes_jax_paths_and_pixels(logs, reports, case, tmp_path,
                                         capsys):
    """One run (with a title), four runs into the default comparison
    file, and cli/test's two reports: the same paths, the same pixels."""
    def argv_of(d):
        if case == "single":
            return [_copy(logs["port_txt"], d), "--title", "port run"]
        if case == "compare":
            return [_copy(logs[k], d) for k in ("ref_txt", "jsonl",
                                                "port_txt", "port_jsonl")]
        return [_copy(reports[case], d)]

    cwd = os.getcwd()
    os.chdir(tmp_path)  # compare_curves.png lands in the working dir
    try:
        (jax_paths, jax_px), (port_paths, port_px) = _both_write(
            argv_of, tmp_path, capsys)
    finally:
        os.chdir(cwd)
    assert port_paths == jax_paths and len(port_paths) == 1
    if case == "compare":
        assert port_paths == [os.path.join("..", "compare_curves.png")]
    for a, b in zip(jax_px, port_px):
        assert a.shape == b.shape and np.array_equal(a, b)


def test_run_labels_equal_jax(tmp_path):
    """Same-named logs in two directories get the parent as a prefix;
    the same file twice is refused, as in JAX."""
    paths = [str(tmp_path / d / "unet_results.txt") for d in ("a", "b")]
    assert port_plot._run_labels(paths) == jax_plot._run_labels(paths) \
        == ["a/unet_results", "b/unet_results"]
    for mod in (port_plot, jax_plot):
        with pytest.raises(ValueError, match="duplicate run inputs"):
            mod._run_labels(paths[:1] * 2)


def test_run_refuses_a_json_that_is_no_report(tmp_path):
    path = tmp_path / "other.json"
    path.write_text(json.dumps({"rows": []}))
    with pytest.raises(SystemExit) as got:
        port_plot.run([str(path)])
    with pytest.raises(SystemExit) as want:
        jax_plot.run([str(path)])
    assert str(got.value) == str(want.value)
    assert "not a cli/test report artifact" in str(got.value)


def test_main_returns_status_zero(reports, tmp_path, capsys):
    path = _copy(reports["threshold_sweep"], tmp_path)
    assert port_plot.main([path, "--output", str(tmp_path / "s.png")]) == 0
    assert capsys.readouterr().out == f"wrote {tmp_path / 's.png'}\n"


def _sequences():
    """One [B, T, H, W] uint8-valued sample set and its mask, seeded."""
    rng = np.random.default_rng(1)
    seq = rng.integers(0, 255, (2, 4, 20, 24)).astype(np.float32)
    mask = np.zeros((2, 20, 24), np.uint8)
    mask[1, 5:11, 8:15] = 1
    return seq, mask


TIC_CALLS = {
    "visualize_sequence": lambda mod, seq, mask, path: mod.visualize_sequence(
        seq, index=1, save_path=path, title="seq"),
    "plot_mask_center_tic": lambda mod, seq, mask, path:
        mod.plot_mask_center_tic(seq, mask, index=1, time_interval=0.5,
                                 save_path=path),
    "plot_masked_time_intensity_curve": lambda mod, seq, mask, path:
        mod.plot_masked_time_intensity_curve(seq, mask, index=1,
                                             save_path=path),
}


@pytest.fixture(scope="module")
def jax_tic_pixels(tmp_path_factory):
    """Each JAX tic function's PNG pixels on _sequences()."""
    d = tmp_path_factory.mktemp("jax_tic")
    seq, mask = _sequences()
    out = {}
    for fn, call in TIC_CALLS.items():
        call(jax_tic, seq[..., None], mask, str(d / f"{fn}.png"))
        out[fn] = _pixels(str(d / f"{fn}.png"))
    return out


@pytest.mark.parametrize("layout", ["bthwc", "btchw", "torch"])
@pytest.mark.parametrize("fn", sorted(TIC_CALLS))
def test_tic_pixels_equal_jax(fn, layout, tmp_path, jax_tic_pixels):
    seq, mask = _sequences()
    frames = seq[:, :, None] if layout == "btchw" else seq[..., None]
    if layout == "torch":
        frames, mask = torch.from_numpy(frames), torch.from_numpy(mask)
    got = str(tmp_path / "port.png")
    TIC_CALLS[fn](port_tic, frames, mask, got)
    want = jax_tic_pixels[fn]
    assert _pixels(got).shape == want.shape
    assert np.array_equal(_pixels(got), want)


@pytest.mark.parametrize("fn", ["plot_mask_center_tic",
                                "plot_masked_time_intensity_curve"])
def test_tic_empty_mask_warns_as_jax(fn, tmp_path, capsys):
    seq, mask = _sequences()
    empty = np.zeros_like(mask)
    TIC_CALLS[fn](jax_tic, seq[..., None], empty, str(tmp_path / "j.png"))
    want = capsys.readouterr().out
    TIC_CALLS[fn](port_tic, seq[..., None], empty, str(tmp_path / "p.png"))
    assert capsys.readouterr().out == want
    assert want.startswith("Warning:")
    assert os.listdir(tmp_path) == []


def test_without_matplotlib(logs, reports, tmp_path, monkeypatch, capsys):
    """matplotlib hidden: the port's viz package and cli/plot import
    afresh, the parsers work, and every render raises naming
    matplotlib; main exits non-zero with that message."""
    for name in list(sys.modules):
        if name == "matplotlib" or name.startswith("matplotlib."):
            monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    import stf_unet_tpu_torch
    import stf_unet_tpu_torch.cli

    # the packages' attributes come back with sys.modules' entries
    monkeypatch.setattr(stf_unet_tpu_torch, "viz", stf_unet_tpu_torch.viz)
    monkeypatch.setattr(stf_unet_tpu_torch.cli, "plot", port_plot)
    for name in list(sys.modules):
        if name.startswith("stf_unet_tpu_torch.viz") \
                or name == "stf_unet_tpu_torch.cli.plot":
            monkeypatch.delitem(sys.modules, name)
    viz = importlib.import_module("stf_unet_tpu_torch.viz")
    plot = importlib.import_module("stf_unet_tpu_torch.cli.plot")
    assert plot is not port_plot
    series = plot.parse_run(logs["port_txt"])
    assert series == jax_plot.parse_run(logs["port_txt"])
    seq, mask = _sequences()
    png = str(tmp_path / "x.png")
    calls = [
        ("render_run", lambda: plot.render_run(series, png)),
        ("render_compare", lambda: plot.render_compare({"a": series}, png)),
        ("render_patient_report", lambda: plot.render_patient_report(
            json.load(open(reports["patient_report"])), png)),
        ("render_threshold_sweep", lambda: plot.render_threshold_sweep(
            json.load(open(reports["threshold_sweep"])), png)),
    ] + [(fn, lambda fn=fn: TIC_CALLS[fn](viz, seq[..., None], mask, png))
         for fn in sorted(TIC_CALLS)]
    for fn, call in calls:
        with pytest.raises(ImportError, match="matplotlib") as e:
            call()
        assert fn in str(e.value)
    assert not os.path.exists(png)
    with pytest.raises(SystemExit) as e:
        plot.main([logs["port_txt"], "--output", png])
    assert "matplotlib" in str(e.value) and e.value.code != 0
