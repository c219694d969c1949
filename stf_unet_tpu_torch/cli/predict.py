"""Offline inference on unlabeled data (counterpart of
stf_unet_tpu/cli/predict.py).

Every dataset CLI drives `DatasetIndex`, which needs `labels/` beside
`images/`; new patients have no masks. This one segments
  * a BreaDM-style images tree:  <input>/<patient>/<SEQ>/<slice>.png
  * a single patient directory:  <input>/<SEQ>/<slice>.png
  * .npz volumes ("frames" uint8 [T, H, W], the serving wire contract):
    one file, or a directory of them
with cli/test's restore and preprocessing (the checkpoint's own crop,
mean and std; eval-geometry resize, or `--tiled` native-resolution
sliding windows; `--tta`). Outputs, per slice, under
`<output-dir>/<patient>/`: `<slice>_mask.png` (binary masks 0/255,
multiclass raw class indices), `<slice>_overlay.png`, with --save-probs
`<slice>_probs.npz`, and with --pk-fit `<slice>_pk.png` and
`<slice>_pk.npz` (the extended-Tofts maps of the slice's frames, fitted
through kernel K4 on CUDA).

Usage: python -m stf_unet_tpu_torch.cli.predict --input <dir|file.npz>
       [--model unet|stflstm] [--model-dir ./save_weights]
       [--output-dir ./output/predictions] [--tiled] [--tta] [--full-size]
       [--save-probs] [--pk-fit [--pk-solver lm|adam] [--pk-enhanced]]
       [--dtype f32|bf16] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

from stf_unet_tpu_torch.cli.common import (DTYPES, checkpoint_path,
                                           restore_for_inference)
from stf_unet_tpu_torch.core.config import PKConfig
from stf_unet_tpu_torch.data.loader import decode_stack, load_pk_stack
from stf_unet_tpu_torch.data.transforms import eval_preprocess
from stf_unet_tpu_torch.serve.engine import InferenceEngine
from stf_unet_tpu_torch.serve.http import upsample_nearest
from stf_unet_tpu_torch.viz.overlay import render_pk_overlay, save_overlay

IMG_EXTS = (".png", ".jpg", ".jpeg")
# Both models downsample 32x: other geometries are padded up to it with
# raw black and the mask cropped back (the server's convention).
STRIDE = 32


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="STF-UNet inference on unlabeled data (PyTorch port)")
    p.add_argument("--input", type=str, required=True,
                   help="images tree (<patient>/<SEQ>/<slice>.png), a "
                        "single patient dir (<SEQ>/<slice>.png), an .npz "
                        "volume ('frames' uint8 [T, H, W]), or a directory "
                        "of .npz volumes")
    p.add_argument("--model", type=str, default="unet",
                   choices=["unet", "stflstm"])
    p.add_argument("--model-dir", type=str, default="./save_weights")
    p.add_argument("--output-dir", type=str, default="./output/predictions")
    p.add_argument("--use-subtraction", action="store_true")
    p.add_argument("--use-pk-maps", action="store_true",
                   help="model consumes PK parameter maps; needs --pk-maps")
    p.add_argument("--pk-maps", type=str, default="",
                   help="directory holding <patient>/{ktrans,ve,vp}.png "
                        "(pk.maps output); missing maps zero-fill with a "
                        "warning (ref:my_dataset.py:206-224)")
    p.add_argument("--num-classes", type=int, default=None,
                   help="TOTAL classes incl. background; default: from the "
                        "checkpoint's head")
    p.add_argument("--base-c", type=int, default=None,
                   help="UNet width; default: from the checkpoint")
    p.add_argument("--crop-size", type=int, default=None,
                   help="eval short-edge size; default: from the "
                        "checkpoint's config")
    p.add_argument("--tiled", action="store_true",
                   help="segment at native resolution with sliding-window "
                        "tiles at the trained crop geometry")
    p.add_argument("--tile-overlap", type=float, default=0.5)
    p.add_argument("--tta", action="store_true",
                   help="flip test-time augmentation (4-orientation logit "
                        "ensemble)")
    p.add_argument("--data-parallel", type=int, default=1,
                   help=argparse.SUPPRESS)
    p.add_argument("--max-batch", type=int, default=8,
                   help="batch same-geometry slices up to this size")
    p.add_argument("--full-size", action="store_true",
                   help="nearest-upsample masks / overlays back to the "
                        "input geometry (no-op with --tiled, which is "
                        "native-resolution already)")
    p.add_argument("--no-overlay", action="store_true",
                   help="write only the mask PNGs")
    p.add_argument("--save-probs", action="store_true",
                   help="also write per-class softmax probabilities as "
                        "<slice>_probs.npz ('probs' float16 [h, w, C] at "
                        "the eval geometry); unavailable with --tiled")
    p.add_argument("--pk-fit", action="store_true",
                   help="also fit the extended Tofts model per voxel on "
                        "each slice's frames: writes <slice>_pk.png "
                        "(Ktrans heat + predicted tumor) and <slice>_pk.npz "
                        "(ktrans/ve/vp float32 [H, W])")
    p.add_argument("--pk-solver", type=str, default="lm",
                   choices=["lm", "adam"])
    p.add_argument("--pk-enhanced", action="store_true",
                   help="Otsu/bilateral enhanced PK preprocessing + map "
                        "postprocessing (the reference's "
                        "test_pk_fitting.py fork)")
    p.add_argument("--dtype", type=str, default="f32",
                   choices=sorted(DTYPES),
                   help="compute dtype (parameters stay float32)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' only when asked for")
    args = p.parse_args(argv)
    if args.data_parallel != 1:
        p.error("--data-parallel is not ported to the PyTorch package yet "
                "(ROADMAP.md §1, 'data parallelism')")
    return args


def scan_unlabeled(input_path: str, sequence_types: Sequence[str]
                   ) -> List[Tuple[str, str, Optional[List[str]]]]:
    """-> [(patient_id, slice_name, frame_paths, or None for an .npz)].

    DatasetIndex's layout rules without the mask: every sequence directory
    must exist for a patient (warn and skip otherwise,
    ref:my_dataset.py:69-77) and a slice's file name must exist in every
    sequence (warn and skip, ref:78-89)."""
    if os.path.isfile(input_path):
        if not input_path.endswith(".npz"):
            raise SystemExit(f"--input file must be .npz, got {input_path}")
        name = os.path.splitext(os.path.basename(input_path))[0]
        return [(name, name, None)]
    if not os.path.isdir(input_path):
        raise SystemExit(f"--input not found: {input_path}")

    entries = sorted(os.listdir(input_path))
    npzs = [e for e in entries if e.endswith(".npz")]
    if npzs:
        return [(os.path.splitext(e)[0], os.path.splitext(e)[0], None)
                for e in npzs]

    def patient_items(pid: str, pdir: str):
        missing = [s for s in sequence_types
                   if not os.path.isdir(os.path.join(pdir, s))]
        if missing:
            print(f"Warning: sequences {missing} not found for patient "
                  f"{pid} — skipping")
            return
        for nm in sorted(os.listdir(os.path.join(pdir, sequence_types[0]))):
            if not nm.lower().endswith(IMG_EXTS):
                continue
            paths = [os.path.join(pdir, s, nm) for s in sequence_types]
            if not all(os.path.isfile(p) for p in paths):
                print(f"Warning: slice {nm} missing in some sequences for "
                      f"patient {pid} — skipping")
                continue
            yield pid, os.path.splitext(nm)[0], paths

    items: List[Tuple[str, str, Optional[List[str]]]] = []
    if all(os.path.isdir(os.path.join(input_path, s))
           for s in sequence_types):  # a single patient's directory
        pid = os.path.basename(os.path.abspath(input_path))
        items = list(patient_items(pid, input_path))
    else:
        for pid in entries:
            pdir = os.path.join(input_path, pid)
            if os.path.isdir(pdir):
                items.extend(patient_items(pid, pdir))
    if not items:
        raise SystemExit(
            f"no predictable samples under {input_path}: expected "
            f"<patient>/<SEQ>/<slice>.png with sequences "
            f"{list(sequence_types)}, a single patient dir, or .npz "
            "volumes")
    return items


def _load_npz(path: str) -> np.ndarray:
    with np.load(path) as npz:
        if "frames" not in npz:
            raise SystemExit(f"{path}: expected 'frames' key (uint8 "
                             "[T, H, W], the serving wire contract)")
        frames = np.asarray(npz["frames"])
    if frames.ndim != 3:
        raise SystemExit(f"{path}: 'frames' must be [T, H, W], got "
                         f"{frames.shape}")
    return frames.astype(np.uint8)


def _write_outputs(mask: np.ndarray, raw_frame: np.ndarray, out_dir: str,
                   patient: str, name: str, num_classes: int,
                   overlay: bool) -> None:
    pdir = os.path.join(out_dir, patient)
    os.makedirs(pdir, exist_ok=True)
    # binary masks render 0/255 like the reference's saved predictions
    # (ref:test.py:168-176); multiclass keeps raw class indices
    png = mask * 255 if num_classes == 2 else mask
    Image.fromarray(png.astype(np.uint8)).save(
        os.path.join(pdir, f"{name}_mask.png"))
    if overlay:
        src = save_overlay(mask > 0, raw_frame, pdir, "ov", prefix=patient)
        os.replace(src, os.path.join(pdir, f"{name}_overlay.png"))


def predict(args: argparse.Namespace) -> dict:
    """Segment every slice of --input; returns the counts and "seconds":
    {"restore", "forward" (the model, with the host preprocessing of its
    batches), "pk_fit", "total"}."""
    t_start = time.perf_counter()
    if args.use_pk_maps and not args.pk_maps:
        raise SystemExit(
            "--use-pk-maps needs --pk-maps <dir> holding "
            "<patient>/{ktrans,ve,vp}.png (generate with pk.maps)")
    if args.save_probs and args.tiled:
        raise SystemExit("--save-probs is unavailable with --tiled (the "
                         "tile blend emits argmax masks only)")
    path = checkpoint_path(args.model_dir, args.model, args.use_pk_maps)
    model, data_cfg, model_cfg, _ = restore_for_inference(
        args.model, path, use_subtraction=args.use_subtraction,
        use_pk_maps=args.use_pk_maps, num_classes=args.num_classes,
        base_c=args.base_c, crop_size=args.crop_size, dtype=args.dtype,
        device=args.device)
    num_classes = model_cfg.total_classes
    print(f"model_path: {path}")
    if args.tta:
        from stf_unet_tpu_torch.ops.tta import FlipTTAModel
        model = FlipTTAModel(model).eval()
        print("flip TTA: logits averaged over 4 orientations")
    seconds = {"restore": time.perf_counter() - t_start, "forward": 0.0,
               "pk_fit": 0.0}

    tiled = engine = None
    if args.tiled:
        from stf_unet_tpu_torch.serve.tiled import TiledPredictor
        tiled = TiledPredictor(model, data_cfg.mean, data_cfg.std,
                               tile=data_cfg.crop_size,
                               overlap=args.tile_overlap, device=args.device)
        print(f"tiled native-resolution inference (tile={tiled.tile}, "
              f"stride={tiled.stride})")
    else:
        engine = InferenceEngine(model, data_cfg.mean, data_cfg.std,
                                 max_batch=args.max_batch,
                                 device=args.device)

    def pk_fit(frames, pred, pdir, name):
        """The Tofts fit of the slice's native frames and the combined
        render (cli/pipeline's analysis, labels-free)."""
        t0 = time.perf_counter()
        cfg = PKConfig(solver=args.pk_solver, time_points=tuple(
            float(i) for i in range(frames.shape[0])))
        if args.pk_enhanced:
            from stf_unet_tpu_torch.pk.enhanced import fit_volume_enhanced
            maps3 = fit_volume_enhanced(frames, cfg, device=args.device)
        else:
            from stf_unet_tpu_torch.pk.maps import fit_volume
            maps3 = fit_volume(frames, cfg, device=args.device)
        seconds["pk_fit"] += time.perf_counter() - t0
        pred_native = (pred if pred.shape == frames.shape[1:]
                       else upsample_nearest(pred, *frames.shape[1:]))
        Image.fromarray(render_pk_overlay(frames[0], maps3[0],
                                          pred_native)).save(
            os.path.join(pdir, f"{name}_pk.png"))
        np.savez_compressed(os.path.join(pdir, f"{name}_pk.npz"),
                            ktrans=maps3[0], ve=maps3[1], vp=maps3[2])

    items = scan_unlabeled(args.input, data_cfg.resolved_sequence_types)
    print(f"Found {len(items)} slices to segment")

    # same-geometry slices batch together on the eval-resize path
    pending: Dict[Tuple[int, ...], List] = {}
    written = 0
    patients = set()

    def flush(shape):
        nonlocal written
        batch = pending.pop(shape)
        t0 = time.perf_counter()
        images = np.stack([b[0] for b in batch])
        if args.save_probs:
            masks, probs = engine.predict(images, return_probs=True)
        else:
            masks, probs = engine.predict(images), None
        seconds["forward"] += time.perf_counter() - t0
        for i, ((image, (h, w), meta), mask) in enumerate(zip(batch, masks)):
            patient, name, frames = meta
            mask = mask[:h, :w]  # drop the stride padding
            if args.full_size and mask.shape != frames.shape[1:]:
                mask = upsample_nearest(mask, *frames.shape[1:])
                raw0 = frames[0]
            else:
                raw0 = image[0, :h, :w, 0]
            _write_outputs(mask, raw0, args.output_dir, patient, name,
                           num_classes, not args.no_overlay)
            pdir = os.path.join(args.output_dir, patient)
            if probs is not None:
                np.savez_compressed(os.path.join(pdir, f"{name}_probs.npz"),
                                    probs=probs[i, :h, :w])
            if args.pk_fit:
                pk_fit(frames, mask, pdir, name)
            written += 1

    for patient, name, paths in items:
        frames = (decode_stack(paths) if paths is not None else _load_npz(
            args.input if os.path.isfile(args.input)
            else os.path.join(args.input, f"{name}.npz")))
        patients.add(patient)
        pk = None
        if args.use_pk_maps:
            if paths is None:
                raise SystemExit("--use-pk-maps is not supported for .npz "
                                 "volumes (no patient directory to map)")
            pk = load_pk_stack(os.path.join(args.pk_maps, patient),
                               *frames.shape[1:], warn=True)
        if tiled is not None:
            img = frames if pk is None else np.concatenate([frames, pk], 0)
            t0 = time.perf_counter()
            mask = tiled.predict(img[..., None])
            seconds["forward"] += time.perf_counter() - t0
            _write_outputs(mask, frames[0], args.output_dir, patient, name,
                           num_classes, not args.no_overlay)
            if args.pk_fit:
                pk_fit(frames, mask, os.path.join(args.output_dir, patient),
                       name)
            written += 1
            continue
        t0 = time.perf_counter()
        dummy = np.zeros(frames.shape[1:], np.uint8)
        image, _ = eval_preprocess(frames, dummy, data_cfg, pk, raw=True)
        _, h, w, _ = image.shape
        ph, pw = -h % STRIDE, -w % STRIDE
        if ph or pw:
            image = np.pad(image, ((0, 0), (0, ph), (0, pw), (0, 0)))
        seconds["forward"] += time.perf_counter() - t0
        key = tuple(image.shape)
        pending.setdefault(key, []).append(
            (image, (h, w), (patient, name, frames)))
        if len(pending[key]) == args.max_batch:
            flush(key)
    for shape in list(pending):
        flush(shape)
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize()
    seconds["total"] = time.perf_counter() - t_start
    print(f"Wrote {written} masks"
          + ("" if args.no_overlay else " + overlays")
          + f" for {len(patients)} patients under {args.output_dir}")
    return {"patients": len(patients), "slices": written,
            "output_dir": args.output_dir, "seconds": seconds}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    return predict(parse_args(argv))


if __name__ == "__main__":
    main()
