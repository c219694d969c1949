"""Dataset pack builder (counterpart of stf_unet_tpu/cli/pack.py):
decode the BreaDM image tree ONCE into memmappable uint8 blobs
(data/pack.py format, byte-compatible with the JAX package's), then
train / evaluate with ``--data-pack <dir>`` and zero image decode at run
time.

The reference decodes every JPEG in DataLoader workers each epoch
(ref:my_dataset.py:143-179); a pack moves that to a one-time build step.

Usage: python -m stf_unet_tpu_torch.cli.pack --data-path ./BreaDM
           --output ./BreaDM/pack [--splits train,val,test]
           [--use-pk-maps] [--use-subtraction] [--mask-format binary]
       python -m stf_unet_tpu_torch.cli.train ... --data-pack ./BreaDM/pack
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

from stf_unet_tpu_torch.core.config import DataConfig
from stf_unet_tpu_torch.data.index import DatasetIndex
from stf_unet_tpu_torch.data.pack import write_pack


def pack_split(data_cfg: DataConfig, mode: str, out_root: str, *,
               batch_size: int = 16,
               use_native: Optional[bool] = None,
               eval_size: Optional[int] = None) -> Optional[dict]:
    """Pack one split to <out_root>/<mode>. Returns the meta dict, or
    None when the split directory doesn't exist (partial datasets).
    eval_size additionally materializes the eval-geometry store
    (pre-resized eval samples; see data/pack.py)."""
    seq_types = data_cfg.resolved_sequence_types
    try:
        index = DatasetIndex(data_cfg.data_path, mode, seq_types,
                             use_pk_maps=data_cfg.use_pk_maps)
    except FileNotFoundError as e:
        print(f"[{mode}] skipped: {e}")
        return None
    if len(index) == 0:
        print(f"[{mode}] skipped: no complete samples found")
        return None

    out_dir = os.path.join(out_root, mode)
    t0 = time.time()
    last = [0.0]

    def progress(done: int, total: int) -> None:
        if time.time() - last[0] >= 5 or done == total:
            last[0] = time.time()
            print(f"[{mode}] {done}/{total} samples "
                  f"({done / max(time.time() - t0, 1e-9):.1f}/s)")

    meta = write_pack(index, out_dir,
                      use_pk_maps=data_cfg.use_pk_maps,
                      mask_format=data_cfg.mask_format,
                      batch_size=batch_size, use_native=use_native,
                      eval_size=eval_size,
                      progress=progress)
    ch, cw = meta["canvas"]
    gib = meta["n"] * meta["t"] * ch * cw / 2**30
    eval_note = (f", eval store @ {meta['eval_size']}"
                 if meta.get("eval_size") else "")
    print(f"[{mode}] packed {meta['n']} samples @ canvas {ch}x{cw} "
          f"(~{gib:.2f} GiB frames{eval_note}) -> {out_dir} in "
          f"{time.time() - t0:.1f}s")
    return meta


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(
        description="Pack a BreaDM dataset for decode-free training")
    p.add_argument("--data-path", default="./BreaDM")
    p.add_argument("--output", default=None,
                   help="pack root (default: <data-path>/pack)")
    p.add_argument("--splits", default="train,val,test")
    p.add_argument("--use-pk-maps", action="store_true")
    p.add_argument("--use-subtraction", action="store_true")
    p.add_argument("--sequence-types", default=None,
                   help="comma-separated override of the sequence list")
    p.add_argument("--mask-format", default="binary",
                   choices=("binary", "index"))
    p.add_argument("--batch-size", type=int, default=16,
                   help="decode batch size (threaded native decoder)")
    p.add_argument("--eval-size", type=int, default=-1,
                   help="also store pre-resized eval samples at this "
                        "short-edge size (default: the 224 eval size for "
                        "val/test splits, ref:train.py:70-74; 0 disables)")
    args = p.parse_args(argv)

    seq = (tuple(s.strip() for s in args.sequence_types.split(",")
                 if s.strip())
           if args.sequence_types else None)
    data_cfg = DataConfig(data_path=args.data_path,
                          use_subtraction=args.use_subtraction,
                          sequence_types=seq,
                          use_pk_maps=args.use_pk_maps,
                          mask_format=args.mask_format)
    out_root = args.output or os.path.join(args.data_path, "pack")

    def split_eval_size(mode: str) -> Optional[int]:
        # The eval store only ever serves val/test (eval_batches_from_index
        # is the sole reader) — never materialize one for train, even under
        # an explicit --eval-size: it would cost pack time and disk for
        # bytes no code path reads.
        if args.eval_size == 0 or mode not in ("val", "test"):
            return None
        if args.eval_size > 0:
            return args.eval_size
        return DataConfig().crop_size

    packed = [m for m in (
        pack_split(data_cfg, mode.strip(), out_root,
                   batch_size=args.batch_size,
                   eval_size=split_eval_size(mode.strip()))
        for mode in args.splits.split(",") if mode.strip()) if m]
    if not packed:
        raise SystemExit("error: nothing packed (no splits found)")
    print(f"pack root: {out_root}\nTrain with: --data-pack {out_root}")


if __name__ == "__main__":
    main()
