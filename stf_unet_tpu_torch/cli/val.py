"""Standalone validation CLI with a YAML config and device timing
(counterpart of stf_unet_tpu/cli/val.py; the capability behind the
reference's legacy val.py: a config file with write-back of defaults,
ref:val.py:47-70, a per-batch device time meter, ref:val.py:136-156,
thresholded IoU / Dice averages and prediction dumps).

Usage: python -m stf_unet_tpu_torch.cli.val --model-path <save dir>
       --root <BreaDM root> [--config ./config.yml] [--name validation]
       [--split val|train|test] [--data-pack <pack root>]
       [--data-parallel N] [--dtype f32|bf16] [--device cuda|cpu]

The config (DEFAULT_CONFIG's keys) picks the model, its class count and
width, the crop, the batch and the input selection; a missing file is
written with the defaults. It is read and written with PyYAML.

The best (else latest) checkpoint of --model-path is restored
(cli/common.restore_for_inference: its EMA weights where it has them,
its mean / std where its config has them); the split's batches come from
train/loop.eval_batches_from_index (or a dataset pack). Each batch's
forward is timed on the device (CUDA events on each GPU it ran on; the
host clock on the CPU), after a first untimed call per input shape.
IoU and Dice are metrics/binary.iou_score of the foreground logit margin
against the mask, averaged over samples; the confusion matrix is over
argmax. Each prediction is written as a 0/255 JPG to
outputs/<name>/0/<index>.jpg under the working directory.

`--data-parallel N` (0 = every visible GPU) runs one process with a
model replica per device (core/mesh.inference_devices): a batch whose
size divides by N is split over them, any other runs whole on the
first, with a warning when the config's batch size does not divide.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from stf_unet_tpu_torch.cli.common import (DTYPES, checkpoint_path,
                                           restore_for_inference)
from stf_unet_tpu_torch.core import mesh as mesh_lib
from stf_unet_tpu_torch.data.index import DatasetIndex
from stf_unet_tpu_torch.data.transforms import normalize
from stf_unet_tpu_torch.metrics.binary import iou_score
from stf_unet_tpu_torch.metrics.confusion import (confusion_init,
                                                  confusion_report,
                                                  confusion_update,
                                                  format_confusion)
from stf_unet_tpu_torch.metrics.meters import SmoothedValue
from stf_unet_tpu_torch.models.registry import preprocess_input
from stf_unet_tpu_torch.train.loop import eval_batches_from_index

DEFAULT_CONFIG = {
    "arch": "stflstm",
    "num_classes": 1,
    "input_channels": 1,
    "time_steps": 8,
    "base_c": 64,
    "crop_size": 224,
    "batch_size": 1,
    "use_subtraction": False,
    "use_pk_maps": False,
}

def load_or_create_config(path: str) -> dict:
    """Read the config YAML over the defaults; create it with the defaults
    when missing (ref:val.py:47-70 write-back behavior)."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError("cli/val reads its config with PyYAML; install "
                          "PyYAML") from e
    config = dict(DEFAULT_CONFIG)
    try:
        with open(path) as f:
            config.update(yaml.safe_load(f) or {})
    except FileNotFoundError:
        print("Config file not found, using default configuration.")
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            yaml.safe_dump(config, f)
    return config


def _timed_forward(replicas, devices, image: np.ndarray, data_cfg):
    """The logits of one uint8 batch ([B, H, W, classes] float32, numpy)
    and the forward's device seconds: the batch split over the replicas
    when its size divides by their number, else whole on the first."""
    n = len(devices)
    parts = (mesh_lib.split_rows(image, n) if image.shape[0] % n == 0
             else [image])
    cuda = devices[0].type == "cuda"
    timers, outs = [], []
    t0 = time.perf_counter()
    for model, dev, part in zip(replicas, devices, parts):
        with mesh_lib.device_scope(dev):
            x = torch.from_numpy(part).to(dev)
            start = end = None
            if cuda:
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record()
            x = normalize(x, data_cfg.mean, data_cfg.std)
            outs.append(model(preprocess_input(x, model))["out"])
            if cuda:
                end.record()
                timers.append((start, end))
    logits = np.concatenate([o.cpu().numpy() for o in outs])
    if cuda:
        seconds = max(s.elapsed_time(e) for s, e in timers) / 1e3
    else:
        seconds = time.perf_counter() - t0
    return logits, seconds


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="STF-UNet validation "
                                 "(PyTorch port)")
    ap.add_argument("--model-path", type=str, default="./save_weights")
    ap.add_argument("--root", type=str, default="./BreaDM")
    ap.add_argument("--config", type=str, default="./config.yml")
    ap.add_argument("--name", type=str, default="validation")
    ap.add_argument("--split", type=str, default="val",
                    choices=["train", "val", "test"])
    ap.add_argument("--data-parallel", type=int, default=1,
                    help="a model replica on each of N GPUs, batches split "
                         "over them (0 = every visible GPU; identical "
                         "metrics)")
    ap.add_argument("--data-pack", type=str, default="",
                    help="dataset pack root (cli/pack): serve pre-decoded "
                         "samples by memmap instead of decoding images")
    ap.add_argument("--dtype", type=str, default="f32",
                    choices=sorted(DTYPES),
                    help="compute dtype (parameters stay float32)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device; 'cpu' only when asked for")
    return ap.parse_args(argv)


@torch.inference_mode()
def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    config = load_or_create_config(args.config)
    devices = mesh_lib.inference_devices(args.data_parallel, args.device)
    batch_size = int(config["batch_size"])
    use_pk = bool(config["use_pk_maps"])

    path = checkpoint_path(args.model_path, str(config["arch"]), use_pk)
    print(f"Loading model from {path}")
    model, data_cfg, model_cfg, _ = restore_for_inference(
        str(config["arch"]), path,
        use_subtraction=bool(config["use_subtraction"]),
        use_pk_maps=use_pk, num_classes=int(config["num_classes"]) + 1,
        base_c=int(config["base_c"]), crop_size=int(config["crop_size"]),
        dtype=args.dtype, device=devices[0])
    replicas = mesh_lib.replicate_module(model, devices)
    if len(devices) > 1:
        if batch_size % len(devices):
            print(f"warning: config batch_size {batch_size} is not a "
                  f"multiple of {len(devices)} — batches run whole on the "
                  "first device (no speedup); pick a divisible batch size")
        else:
            print(f"batches split over {len(devices)} devices")

    seqs = data_cfg.resolved_sequence_types
    index = DatasetIndex(args.root, args.split, seqs, use_pk_maps=use_pk)
    pack = None
    if args.data_pack:
        from stf_unet_tpu_torch.data.pack import open_split_pack
        pack = open_split_pack(args.data_pack, args.split)
        pack.validate(index, mask_format=data_cfg.mask_format,
                      use_pk_maps=use_pk)
        print(f"dataset pack [{args.split}]: {len(pack)} samples "
              "(decode-free)")

    iou_avg, dice_avg, devt = SmoothedValue(), SmoothedValue(), SmoothedValue()
    conf = confusion_init(model_cfg.total_classes)
    seen_shapes = set()
    out_dir = os.path.join("outputs", args.name, "0")
    os.makedirs(out_dir, exist_ok=True)

    from PIL import Image

    print("Starting validation...")
    for i, (image, target) in enumerate(eval_batches_from_index(
            index, data_cfg, use_pk_maps=use_pk, batch_size=batch_size,
            pack=pack)):
        if image.shape not in seen_shapes:  # builds, autotunes
            _timed_forward(replicas, devices, image, data_cfg)
            seen_shapes.add(image.shape)
        logits, seconds = _timed_forward(replicas, devices, image, data_cfg)
        devt.update(seconds)
        pred = np.argmax(logits, axis=-1)
        iou, dice = iou_score(logits[..., 1] - logits[..., 0], target == 1)
        iou_avg.update(iou, image.shape[0])
        dice_avg.update(dice, image.shape[0])
        conf = confusion_update(conf, torch.from_numpy(target).long(),
                                torch.from_numpy(pred))
        for b in range(pred.shape[0]):
            Image.fromarray((pred[b] * 255).astype(np.uint8)).save(
                os.path.join(out_dir, f"{i * batch_size + b:04d}.jpg"))

    mat = conf.numpy()
    report = confusion_report(mat)
    print("=" * 50)
    print("Validation Results:")
    print(f"IoU: {iou_avg.global_avg:.4f}")
    print(f"Dice: {dice_avg.global_avg:.4f}")
    print(f"Accuracy: {report['global_accuracy']:.4f}")
    print(f"Average device time: {devt.global_avg:.4f}s")
    print(format_confusion(mat))
    print("=" * 50)
    return {"iou": iou_avg.global_avg, "dice": dice_avg.global_avg,
            "device_time": devt.global_avg, "report": report,
            "confusion_matrix": mat, "batches": devt.count}


if __name__ == "__main__":
    main()
