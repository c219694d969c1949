"""PK parameter-map generation over a BreaDM tree (counterpart of
stf_unet_tpu/pk/maps.py; ref:pk_fitting.py:233-420 saving, :605-730
drivers).

    python -m stf_unet_tpu_torch.pk.maps <BreaDM root> [--solver lm|adam]
        [--aif-method population|modified|auto] [--splits training,val,test]
        [--enhanced] [--debug] [--compare-aif]
        [--num-shards N --shard-index i] [--device cuda|cpu]

Writes `<root>/seg/<split>/pk_maps/<patient>/{ktrans,ve,vp}.png` with
`{name}_raw.npy` and `combined_map.png`: the artifacts the dataset index
and the loader read (ref:my_dataset.py:198-227). The fit runs on CUDA
unless --device cpu is given. --enhanced fits through pk/enhanced.py's
preprocessing and postprocessing; --debug writes pk/debug.py's renders
under `<patient>/debug/` (matplotlib); --compare-aif writes the AIF
methods' comparison under `<root>/seg/<split>/pk_aif_comparison/
<patient>/` instead of the maps. --data-parallel waits for data
parallelism (ROADMAP.md §1).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
from PIL import Image

from stf_unet_tpu_torch.core.config import PKConfig, resolve_device
from stf_unet_tpu_torch.pk.aif import auto_detect_aif, make_aif
from stf_unet_tpu_torch.pk.debug import fit_with_debug, render_aif_debug
from stf_unet_tpu_torch.pk.fit import fit_adam, fit_lm, preprocess_images
from stf_unet_tpu_torch.pk.tofts import ToftsQuadrature

PARAM_NAMES = ("ktrans", "ve", "vp")
_UNPORTED = "is not ported to the PyTorch package yet (ROADMAP.md §1, " \
            "'data-parallel inference')"


def fit_volume(images: np.ndarray, cfg: PKConfig,
               output_dir: Optional[str] = None,
               debug_output_dir: Optional[str] = None,
               device="cuda") -> np.ndarray:
    """[T, H, W] signal volume -> [3, H, W] (Ktrans, ve, vp) maps
    (ref:fit_volume_gpu, pk_fitting.py:233-420), fitted on `device`.
    debug_output_dir: write the reference's diagnostic renders there
    (pk/debug.py: sample voxel curves, Adam's loss curve, the auto AIF's
    location, curve and derivative map)."""
    dev = resolve_device(device)
    t_steps, height, width = images.shape
    if t_steps != len(cfg.time_points):
        # Missing SUBk sequences were warn-and-skipped while loading
        # (ref:pk_fitting.py:626-636); fit over the frames that exist.
        cfg = dataclasses.replace(
            cfg, time_points=tuple(float(i) for i in range(t_steps)))
        print(f"note: {t_steps} frames present; time grid adjusted")
    t0 = time.time()
    imgs, tissue_mask = preprocess_images(images, cfg)
    imgs, mask_np = imgs.numpy(), tissue_mask.numpy()
    pixels = imgs.transpose(1, 2, 0).reshape(-1, t_steps)
    valid = pixels[mask_np.reshape(-1)]
    print(f"total pixels: {height * width}, valid pixels: {valid.shape[0]} "
          f"(preprocess {time.time() - t0:.2f}s)")

    aif = make_aif(cfg.aif_method, cfg.aif_dose)
    pos = None
    if cfg.aif_method == "auto":
        aif, pos = auto_detect_aif(imgs, mask_np,
                                   np.asarray(cfg.time_points))
        print(f"auto AIF voxel at {pos}")
    quad = ToftsQuadrature.build(cfg.time_points, aif, cfg.dt, device=dev)

    t0 = time.time()
    if debug_output_dir is not None:
        if pos is not None:
            render_aif_debug(imgs, mask_np, cfg.time_points,
                             debug_output_dir, position=pos)
        fitted = fit_with_debug(valid, quad, cfg, debug_output_dir)
    elif cfg.solver == "lm":
        fitted = fit_lm(valid, quad, cfg)  # [Nvalid, 3]
    else:
        fitted = fit_adam(valid, quad, cfg)
    print(f"fit ({cfg.solver}) done in {time.time() - t0:.2f}s")

    param_maps = np.zeros((3, height * width), np.float32)
    param_maps[:, mask_np.reshape(-1)] = fitted.T
    param_maps = param_maps.reshape(3, height, width)
    if output_dir is not None:
        save_param_maps(param_maps, output_dir)
    return param_maps


def _percentile_normalize(param_map: np.ndarray) -> np.ndarray:
    """Percentile-1/99 clip + [0, 255] scale (ref:393-400)."""
    if np.max(param_map) > 0:
        positive = param_map[param_map > 0]
        p_min, p_max = np.percentile(positive, [1, 99])
        if p_max <= p_min:
            p_max = p_min + 1e-6
        norm = np.clip(param_map, p_min, p_max)
        return ((norm - p_min) / (p_max - p_min) * 255).astype(np.uint8)
    return np.zeros_like(param_map, dtype=np.uint8)


def save_param_maps(param_maps: np.ndarray, output_dir: str) -> None:
    """PNG + raw .npy per parameter, plus the combined RGB map
    (ref:380-418, 568-602)."""
    os.makedirs(output_dir, exist_ok=True)
    for i, name in enumerate(PARAM_NAMES):
        Image.fromarray(_percentile_normalize(param_maps[i])).save(
            os.path.join(output_dir, f"{name}.png"))
        np.save(os.path.join(output_dir, f"{name}_raw.npy"), param_maps[i])
    combined = np.zeros(param_maps.shape[1:] + (3,), np.float32)
    for i in range(3):
        combined[..., i] = _percentile_normalize(param_maps[i]) / 255.0
    Image.fromarray((combined * 255).astype(np.uint8)).save(
        os.path.join(output_dir, "combined_map.png"))


def _load_patient_frames(patient_path: str) -> Optional[np.ndarray]:
    """First slice of each SUB1..8 sequence -> [T<=8, H, W] uint8
    (ref:605-662 loading), warn-and-skip on missing sequences."""
    frames = []
    for i in range(1, 9):
        sub = os.path.join(patient_path, f"SUB{i}")
        if not os.path.exists(sub):
            print(f"warning: {sub} missing")
            continue
        files = sorted(f for f in os.listdir(sub)
                       if f.endswith((".jpg", ".png")))
        if not files:
            print(f"warning: no images in {sub}")
            continue
        with Image.open(os.path.join(sub, files[0])) as im:
            frames.append(np.asarray(im.convert("L"), np.uint8))
    if not frames:
        print(f"error: no valid subtraction images in {patient_path}")
        return None
    return np.stack(frames)


def process_patient(patient_path: str, output_base_dir: str,
                    cfg: Optional[PKConfig] = None, enhanced: bool = False,
                    debug: bool = False, device="cuda"
                    ) -> Optional[np.ndarray]:
    """Fit the first slice of each SUB1..8 sequence of one patient
    (ref:605-670); None when it has no subtraction frames. enhanced:
    through pk/enhanced.py's Otsu / bilateral preprocessing and the maps'
    postprocessing; debug: the diagnostic renders under
    <patient>/debug/."""
    cfg = cfg or PKConfig()
    patient_id = os.path.basename(patient_path)
    print(f"processing patient: {patient_id}")
    output_dir = os.path.join(output_base_dir, patient_id)
    debug_dir = os.path.join(output_dir, "debug") if debug else None
    frames = _load_patient_frames(patient_path)
    if frames is None:
        return None
    if enhanced:
        from stf_unet_tpu_torch.pk.enhanced import fit_volume_enhanced
        maps = fit_volume_enhanced(frames, cfg, output_dir,
                                   debug_output_dir=debug_dir, device=device)
    else:
        maps = fit_volume(frames, cfg, output_dir,
                          debug_output_dir=debug_dir, device=device)
    print(f"PK maps for patient {patient_id} saved to {output_dir}")
    return maps


def _split_patients(dataset_path: str, split: str, num_shards: int,
                    shard_index: int):
    """(the split's images directory, its patients, this shard's)."""
    if not (0 <= shard_index < num_shards):
        raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")
    images_dir = os.path.join(dataset_path, "seg", split, "images")
    patients = sorted(p for p in os.listdir(images_dir)
                      if os.path.isdir(os.path.join(images_dir, p)))
    return images_dir, patients, patients[shard_index::num_shards]


def process_dataset(dataset_path: str, split: str = "training",
                    cfg: Optional[PKConfig] = None, enhanced: bool = False,
                    debug: bool = False, device="cuda",
                    num_shards: int = 1, shard_index: int = 0) -> None:
    """All patients of one split (ref:673-696). num_shards / shard_index:
    patient-level sharding over independent processes or machines; shard
    i fits patients i, i+N, i+2N, ..."""
    images_dir, every, patients = _split_patients(dataset_path, split,
                                                  num_shards, shard_index)
    output_base = os.path.join(dataset_path, "seg", split, "pk_maps")
    os.makedirs(output_base, exist_ok=True)
    if num_shards > 1:
        print(f"found {len(every)} patients; shard {shard_index}/"
              f"{num_shards} takes {len(patients)}")
    else:
        print(f"found {len(patients)} patients")
    done = 0
    for patient in patients:
        maps = process_patient(os.path.join(images_dir, patient), output_base,
                               cfg, enhanced=enhanced, debug=debug,
                               device=device)
        done += maps is not None
    print(f"{split}: PK maps written for {done}/{len(patients)} patients")
    if patients and done == 0:
        # PK fitting reads the SUB1..8 sequences only (ref:pk_fitting.py:
        # 625-662); a silent all-skip would later empty a --use-pk-maps
        # dataset scan.
        print(f"warning: no PK maps generated for split '{split}' - "
              "PK fitting reads the SUB1..8 subtraction sequences")


def generate_pk_maps_for_dataset(dataset_path: str,
                                 splits: Optional[Sequence[str]] = None,
                                 cfg: Optional[PKConfig] = None,
                                 enhanced: bool = False, debug: bool = False,
                                 device="cuda", num_shards: int = 1,
                                 shard_index: int = 0) -> Dict[str, str]:
    """All splits (ref:699-722); the trainer's --generate-pk-maps calls it
    (ref:train.py:165-169). Returns split -> its pk_maps directory."""
    splits = splits or ["training", "val", "test"]
    out = {}
    for split in splits:
        print(f"generating PK maps for {split}...")
        process_dataset(dataset_path, split, cfg, enhanced=enhanced,
                        debug=debug, device=device, num_shards=num_shards,
                        shard_index=shard_index)
        out[split] = os.path.join(dataset_path, "seg", split, "pk_maps")
    return out


def compare_aif_for_dataset(dataset_path: str,
                            splits: Optional[Sequence[str]] = None,
                            cfg: Optional[PKConfig] = None, device="cuda",
                            num_shards: int = 1,
                            shard_index: int = 0) -> Dict[str, str]:
    """Each patient volume fitted (enhanced) with the population, modified
    and auto AIFs, each method's maps and the pairwise difference renders
    under `<root>/seg/<split>/pk_aif_comparison/<patient>/`
    (ref:test_pk_fitting.py:709-887 test_aif_methods). Returns split ->
    that directory."""
    from stf_unet_tpu_torch.pk.enhanced import compare_aif_methods

    cfg = cfg or PKConfig()
    splits = splits or ["training", "val", "test"]
    out = {}
    for split in splits:
        images_dir, _, patients = _split_patients(dataset_path, split,
                                                  num_shards, shard_index)
        output_base = os.path.join(dataset_path, "seg", split,
                                   "pk_aif_comparison")
        print(f"{split}: AIF comparison over {len(patients)} patients"
              + (f" (shard {shard_index}/{num_shards})"
                 if num_shards > 1 else ""))
        for patient in patients:
            frames = _load_patient_frames(os.path.join(images_dir, patient))
            if frames is None:
                continue
            compare_aif_methods(frames, cfg,
                                os.path.join(output_base, patient),
                                device=device)
            print(f"AIF comparison for {patient} -> "
                  f"{os.path.join(output_base, patient)}")
        out[split] = output_base
    return out


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="Extended-Tofts PK map generation (PyTorch port)")
    ap.add_argument("dataset_path")
    ap.add_argument("--splits", type=str, default="training,val,test")
    ap.add_argument("--aif-method", type=str, default="population",
                    choices=["population", "modified", "auto"])
    ap.add_argument("--solver", type=str, default="lm",
                    choices=["lm", "adam"])
    ap.add_argument("--num-shards", type=int, default=1,
                    help="patient-level sharding: run N independent "
                         "processes or machines, one per shard")
    ap.add_argument("--shard-index", type=int, default=0,
                    help="which patient shard this process fits")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device; 'cpu' only when asked for")
    ap.add_argument("--enhanced", action="store_true",
                    help="Otsu/bilateral preprocessing + param-map "
                         "postprocessing (ref:test_pk_fitting.py fork)")
    ap.add_argument("--compare-aif", action="store_true",
                    help="render per-patient AIF-method comparison maps "
                         "instead of pk_maps (ref:test_aif_methods)")
    ap.add_argument("--debug", action="store_true",
                    help="write diagnostic renders (sample curves, loss "
                         "curve, AIF maps) under <patient>/debug/")
    ap.add_argument("--data-parallel", type=int, default=1, help=_UNPORTED)
    args = ap.parse_args(argv)
    if args.data_parallel != 1:
        ap.error(f"--data-parallel {_UNPORTED}")
    cfg = PKConfig(aif_method=args.aif_method, solver=args.solver)
    splits = args.splits.split(",")
    if args.compare_aif:
        return compare_aif_for_dataset(
            args.dataset_path, splits, cfg, device=args.device,
            num_shards=args.num_shards, shard_index=args.shard_index)
    return generate_pk_maps_for_dataset(
        args.dataset_path, splits, cfg, enhanced=args.enhanced,
        debug=args.debug, device=args.device, num_shards=args.num_shards,
        shard_index=args.shard_index)


if __name__ == "__main__":
    main()
