"""Merge tumor masks onto slice sequences — standalone CLI (counterpart
of stf_unet_tpu/cli/merge.py; ref:train_utils/merge_tumor_images.py:
28-180), through viz/overlay.merge_images. Host only: numpy and PIL.

--border-only (the contour outline) needs cv2, which the port does not
use: merge_images raises for it, and this CLI refuses the flag.

Usage: python -m stf_unet_tpu_torch.cli.merge --patient-id 001 --output-dir ./out
       --subtraction-dir <images dir> --mask-dir <masks dir>
       [--overlay-color 255,0,0] [--overlay-alpha 0.5]
       [--border-only] [--border-thickness 2]
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Optional, Sequence

import numpy as np
from PIL import Image

from stf_unet_tpu_torch.viz.overlay import merge_images


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Overlay tumor masks onto subtraction slices")
    p.add_argument("--patient-id", type=str, required=True)
    p.add_argument("--output-dir", type=str, default="./output")
    p.add_argument("--subtraction-dir", type=str, required=True)
    p.add_argument("--mask-dir", type=str, required=True)
    p.add_argument("--overlay-color", type=str, default="255,0,0")
    p.add_argument("--overlay-alpha", type=float, default=0.5)
    p.add_argument("--border-only", action="store_true",
                   help="contour outline only: needs cv2, which the port "
                        "does not use, so this flag is refused")
    p.add_argument("--border-thickness", type=int, default=2)
    return p.parse_args(argv)


def find_patient_images(directory: str, patient_id: str,
                        extension: str = ".jpg") -> list:
    """Files prefixed by the patient id (ref:52-55)."""
    return sorted(glob.glob(os.path.join(directory, f"{patient_id}*{extension}")))


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    if args.border_only:
        raise SystemExit("error: --border-only needs cv2, which the port "
                         "does not use (viz/overlay.merge_images raises)")
    os.makedirs(args.output_dir, exist_ok=True)

    subs = find_patient_images(args.subtraction_dir, args.patient_id, ".jpg")
    if not subs:
        subs = find_patient_images(args.subtraction_dir, args.patient_id, ".png")
    masks = find_patient_images(args.mask_dir, args.patient_id, ".png")

    if not subs:
        print(f"no subtraction images found for patient {args.patient_id}")
        return 0
    if not masks:
        print(f"no masks found for patient {args.patient_id}")
        return 0
    print(f"found {len(subs)} slices and {len(masks)} masks")

    color = tuple(int(c) for c in args.overlay_color.split(","))
    written = 0
    for i, (sub_path, mask_path) in enumerate(zip(subs, masks)):
        try:
            with Image.open(sub_path) as im:
                img = np.asarray(im.convert("L"), np.uint8)
            with Image.open(mask_path) as mm:
                mask = np.asarray(mm.convert("L"), np.uint8)
            mask = np.where(mask > 127, 255, 0).astype(np.uint8)  # ref:66
            if mask.shape != img.shape:
                mask = np.asarray(Image.fromarray(mask).resize(
                    (img.shape[1], img.shape[0]), Image.NEAREST))
            merged = merge_images(img, mask, color, alpha=args.overlay_alpha,
                                  border_only=args.border_only,
                                  border_thickness=args.border_thickness)
            out = os.path.join(args.output_dir,
                               f"{args.patient_id}_{i + 1:03d}_merged.png")
            Image.fromarray(merged).save(out)
            print(f"saved: {out}")
            written += 1
        except Exception as e:  # warn-and-continue (ref:174-175)
            print(f"error processing {sub_path} and {mask_path}: {e}")
    print(f"done; results in: {args.output_dir}")
    return written


if __name__ == "__main__":
    main()
