"""Fused inference + PK pipeline (counterpart of
stf_unet_tpu/cli/pipeline.py): for each sample of a labelled split, the
segmentation forward and the per-voxel extended-Tofts fit of the same
frames, then a combined render (Ktrans heat and the predicted tumor).

Usage: python -m stf_unet_tpu_torch.cli.pipeline --root <BreaDM root>
       [--model stflstm|unet] [--model-dir ./save_weights]
       [--output-dir ./output/pipeline] [--split test] [--solver lm|adam]
       [--enhanced] [--data-pack <pack root>] [--use-subtraction]
       [--dtype f32|bf16] [--device cuda|cpu]

The model is the best (else latest) checkpoint of --model-dir, with its
training run's crop, mean and std where it carries them; without one it
warns and runs seeded random weights (seed 0), as the JAX CLI does. On
CUDA the forward runs kernels K1 and K3 (STF-LSTM-UNet), and the LM fit
kernel K4; decode and rendering stay on the host. Writes
`<patient>_<i>_pipeline.png` per sample and reports the mean seconds of
forward + fit per sample.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch
from PIL import Image

from stf_unet_tpu_torch.cli.common import (DTYPES, checkpoint_path,
                                           restore_for_inference)
from stf_unet_tpu_torch.core.config import (DataConfig, ModelConfig,
                                            PKConfig, resolve_device)
from stf_unet_tpu_torch.data.index import DatasetIndex
from stf_unet_tpu_torch.data.loader import load_sample_raw
from stf_unet_tpu_torch.data.transforms import eval_preprocess
from stf_unet_tpu_torch.models.registry import create_model
from stf_unet_tpu_torch.pk.aif import make_aif
from stf_unet_tpu_torch.pk.fit import fit_adam, fit_lm, preprocess_images
from stf_unet_tpu_torch.pk.tofts import ToftsQuadrature
from stf_unet_tpu_torch.serve.engine import InferenceEngine
from stf_unet_tpu_torch.viz.overlay import render_pk_overlay


def _model(args):
    """(eval model on the device, data settings): the checkpoint's, else
    seeded random weights with the default settings."""
    try:
        path = checkpoint_path(args.model_dir, args.model)
    except FileNotFoundError:
        print("warning: no checkpoint found; running with random weights")
        data_cfg = DataConfig(data_path=args.root,
                              use_subtraction=args.use_subtraction)
        torch.manual_seed(0)
        model = create_model(ModelConfig(
            model=args.model, num_classes=1,
            time_steps=len(data_cfg.resolved_sequence_types),
            base_c=args.base_c), dtype=DTYPES[args.dtype])
        return model.eval().to(resolve_device(args.device)), data_cfg
    model, data_cfg, _, _ = restore_for_inference(
        args.model, path, use_subtraction=args.use_subtraction,
        dtype=args.dtype, device=args.device)
    print(f"loaded {path}")
    return model, data_cfg


def run_pipeline(args: argparse.Namespace) -> dict:
    """-> {"samples", "avg_seconds" (forward + fit per sample),
    "seconds": {"forward", "fit", "render"} summed}."""
    model, data_cfg = _model(args)
    seqs = data_cfg.resolved_sequence_types
    engine = InferenceEngine(model, data_cfg.mean, data_cfg.std,
                             max_batch=1, device=args.device)
    pk_cfg = PKConfig(solver=args.solver,
                      time_points=tuple(float(i) for i in range(len(seqs))))
    quad = ToftsQuadrature.build(pk_cfg.time_points,
                                 make_aif(pk_cfg.aif_method,
                                          pk_cfg.aif_dose),
                                 pk_cfg.dt, device=engine.device)
    solver = fit_lm if pk_cfg.solver == "lm" else fit_adam

    index = DatasetIndex(args.root, args.split, seqs)
    pack = None
    if args.data_pack:
        from stf_unet_tpu_torch.data.pack import open_split_pack
        pack = open_split_pack(args.data_pack, args.split)
        pack.validate(index, mask_format="binary", use_pk_maps=False)
        print(f"dataset pack [{args.split}]: {len(pack)} samples "
              "(decode-free)")
    os.makedirs(args.output_dir, exist_ok=True)

    seconds = {"forward": 0.0, "fit": 0.0, "render": 0.0}
    for i, rec in enumerate(index.records):
        if pack is not None:
            frames, mask, _, _ = pack.sample(i, use_pk_maps=False)
        else:
            frames, mask, _ = load_sample_raw(rec)
        image, _ = eval_preprocess(frames, mask, data_cfg, raw=True)

        t0 = time.perf_counter()
        pred = engine.predict(image[None])[0].astype(np.uint8)
        t1 = time.perf_counter()
        # the PK fit on the raw (un-augmented) frames
        if args.enhanced:
            from stf_unet_tpu_torch.pk.enhanced import (
                enhanced_preprocess, postprocess_param_maps)
            imgs, tissue = enhanced_preprocess(frames)
        else:
            imgs, tissue = (t.numpy() for t in preprocess_images(frames,
                                                                 pk_cfg))
        pixels = imgs.transpose(1, 2, 0).reshape(-1, frames.shape[0])
        flat = tissue.reshape(-1)
        fitted = solver(pixels[flat], quad, pk_cfg)
        param_maps = np.zeros((3, flat.shape[0]), np.float32)
        param_maps[:, flat] = fitted.T
        param_maps = param_maps.reshape((3,) + frames.shape[1:])
        if args.enhanced:
            param_maps = postprocess_param_maps(param_maps, tissue)
        t2 = time.perf_counter()
        seconds["forward"] += t1 - t0
        seconds["fit"] += t2 - t1

        # Ktrans heat (red) + the predicted tumor (green)
        base = frames[0]
        pred_full = np.asarray(Image.fromarray(pred * 255).resize(
            (base.shape[1], base.shape[0]), Image.NEAREST))
        Image.fromarray(render_pk_overlay(base, param_maps[0],
                                          pred_full)).save(
            os.path.join(args.output_dir,
                         f"{rec.patient_id}_{i:03d}_pipeline.png"))
        seconds["render"] += time.perf_counter() - t2
    n = len(index.records)
    avg = (seconds["forward"] + seconds["fit"]) / n if n else 0.0
    print(f"processed {n} samples, avg fused inference+fit: "
          f"{avg:.3f}s/sample")
    return {"samples": n, "avg_seconds": avg, "seconds": seconds}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(
        description="Fused inference + PK pipeline (PyTorch port)")
    ap.add_argument("--root", type=str, required=True)
    ap.add_argument("--model", type=str, default="stflstm",
                    choices=["stflstm", "unet"])
    ap.add_argument("--model-dir", type=str, default="./save_weights")
    ap.add_argument("--output-dir", type=str, default="./output/pipeline")
    ap.add_argument("--split", type=str, default="test")
    ap.add_argument("--solver", type=str, default="lm",
                    choices=["lm", "adam"])
    ap.add_argument("--base-c", type=int, default=64,
                    help="UNet width of the random-weights model")
    ap.add_argument("--use-subtraction", action="store_true")
    ap.add_argument("--enhanced", action="store_true",
                    help="Otsu/bilateral PK preprocessing + param-map "
                         "postprocessing (ref:test_pk_fitting.py fork)")
    ap.add_argument("--data-pack", type=str, default="",
                    help="dataset pack root (cli/pack): decode-free "
                         "sample reads")
    ap.add_argument("--dtype", type=str, default="f32",
                    choices=sorted(DTYPES),
                    help="compute dtype (parameters stay float32)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device; 'cpu' only when asked for")
    return run_pipeline(ap.parse_args(argv))


if __name__ == "__main__":
    main()
