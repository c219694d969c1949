"""Model-serving entry point: one process owns the GPU and serves
segmentation over HTTP with dynamic batching (counterpart of
stf_unet_tpu/cli/serve.py).

Usage: python -m stf_unet_tpu_torch.cli.serve --model-dir ./save_weights
       [--model stflstm|unet] [--use-subtraction] [--use-pk-maps]
       [--host 127.0.0.1] [--port 8421] [--max-batch 8]
       [--batch-window-ms 5] [--dtype bf16|f32] [--crop-size 224]
       [--tta] [--tiled [--tile-overlap 0.5] [--warmup-geometries HxW,..]]
       [--no-warmup] [--device cuda]
   or: ... --weights model.pth

--model-dir serves the best, else the latest checkpoint of a cli/train
save directory (`<model>_{best,latest}_model<_pk>.pth`), as cli/test
restores; POST /v1/reload re-reads it (a run that promotes a new best
reaches the live server). --weights serves one reference-layout file,
{"model": state_dict, "epoch": N} (`python -m stf_unet_tpu.cli.migrate
out.pth --model stflstm --save-dir <jax run> --reverse` writes one from a
JAX checkpoint), and reload re-reads that file. A PK checkpoint (trained
with --use-pk-maps) takes requests of T + 3 planes: the frames, then the
Ktrans, ve and vp maps. --tta serves the 4-orientation flip ensemble
(ops/tta.py); --tiled segments volumes off the trained crop at native
resolution with sliding-window tiles (serve/tiled.py).

Client: stf_unet_tpu_torch.serve.client.SegmentationClient.
"""

from __future__ import annotations

import argparse
import signal
import threading
from typing import Optional, Sequence

import numpy as np

from stf_unet_tpu_torch.cli.common import (DTYPES, checkpoint_path,
                                           load_reference_checkpoint,
                                           restore_for_inference)
from stf_unet_tpu_torch.serve.http import SegmentationServer

# Flags of the JAX server whose features the port has not implemented
# yet -> the ROADMAP.md item (§1) that brings them.
UNPORTED = {"--dtype int8": "Serve features, 7.4 int8",
            "--data-parallel": "data parallelism"}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="STF-UNet serving on the GPU")
    p.add_argument("--model", type=str, default="stflstm",
                   choices=["stflstm", "unet"])
    p.add_argument("--model-dir", type=str, default=None,
                   help="cli/train save directory: serve its best, else "
                        "latest checkpoint")
    p.add_argument("--weights", type=str, default=None,
                   help="one reference-layout .pth checkpoint")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8421)
    p.add_argument("--use-subtraction", action="store_true")
    p.add_argument("--use-pk-maps", action="store_true",
                   help="with --model-dir: serve the PK checkpoint "
                        "(<model>_*_model_pk.pth)")
    p.add_argument("--num-classes", type=int, default=None,
                   help="TOTAL classes incl. background; default: from the "
                        "checkpoint's head")
    p.add_argument("--base-c", type=int, default=None,
                   help="UNet width; default: from the checkpoint")
    p.add_argument("--crop-size", type=int, default=None,
                   help="short edge the frames are resized to (default: "
                        "the checkpoint's training crop, else 224)")
    p.add_argument("--max-batch", type=int, default=8,
                   help="dynamic batching cap (power-of-two buckets)")
    p.add_argument("--batch-window-ms", type=float, default=5.0,
                   help="how long a request waits for batch peers")
    p.add_argument("--dtype", type=str, default="bf16",
                   choices=sorted(DTYPES) + ["int8"],
                   help="compute dtype (parameters stay float32; logits "
                        "are float32)")
    p.add_argument("--data-parallel", type=int, default=1,
                   help=argparse.SUPPRESS)
    p.add_argument("--no-warmup", action="store_true",
                   help="skip running the batch buckets at startup")
    p.add_argument("--tiled", action="store_true",
                   help="segment volumes whose geometry differs from the "
                        "trained crop at native resolution with "
                        "sliding-window tiles")
    p.add_argument("--tile-overlap", type=float, default=0.5,
                   help="tile overlap fraction for --tiled (default 0.5)")
    p.add_argument("--tta", action="store_true",
                   help="flip test-time augmentation: serve the "
                        "4-orientation logit ensemble (4 forwards a "
                        "request)")
    p.add_argument("--warmup-geometries", type=str, default="",
                   help="comma-separated HxW native geometries to run once "
                        "through --tiled at startup (e.g. 520x520)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' only when asked for")
    args = p.parse_args(argv)
    if (args.weights is None) == (args.model_dir is None):
        p.error("give one of --weights (a .pth file) or --model-dir (a "
                "cli/train save directory)")
    for flag, on in (("--dtype int8", args.dtype == "int8"),
                     ("--data-parallel", args.data_parallel != 1)):
        if on:
            p.error(f"{flag} is not ported to the PyTorch package yet "
                    f"(ROADMAP.md §1, '{UNPORTED[flag]}')")
    return args


def _geometries(spec: str):
    out = []
    for geom in (g.strip() for g in spec.split(",")):
        if not geom:
            continue
        try:
            h, w = (int(v) for v in geom.lower().split("x"))
        except ValueError:
            raise SystemExit(f"error: bad --warmup-geometries entry {geom!r} "
                             "(expected HxW, e.g. 520x520)")
        out.append((h, w))
    return out


def build_server(args: argparse.Namespace) -> SegmentationServer:
    """Load the model, build the (not yet started) server and, unless
    --no-warmup, run every batch bucket at the served geometry and each
    --warmup-geometries volume through the tiles."""
    def path():
        if args.weights is not None:
            return args.weights
        return checkpoint_path(args.model_dir, args.model, args.use_pk_maps)

    served = path()
    model, data_cfg, model_cfg, meta = restore_for_inference(
        args.model, served, use_subtraction=args.use_subtraction,
        use_pk_maps=args.use_pk_maps or None, num_classes=args.num_classes,
        base_c=args.base_c, crop_size=args.crop_size, dtype=args.dtype,
        device=args.device)
    print(f"serving {served} (epoch {meta.get('epoch', '?')}) on "
          f"{args.device} in {args.dtype}")
    weights = model
    if args.tta:
        from stf_unet_tpu_torch.ops.tta import FlipTTAModel
        model = FlipTTAModel(model).eval()
        print("flip TTA: serving the 4-orientation logit ensemble")
    tiled = None
    if args.tiled:
        from stf_unet_tpu_torch.serve.tiled import TiledPredictor
        tiled = TiledPredictor(model, data_cfg.mean, data_cfg.std,
                               tile=data_cfg.crop_size,
                               overlap=args.tile_overlap, device=args.device)
        print(f"tiled mode: non-{data_cfg.crop_size}² volumes segment at "
              f"native resolution (stride {tiled.stride})")

    def reloader():
        """POST /v1/reload: re-read the best / latest checkpoint (or the
        --weights file), so a training run can promote a new best into
        the live server."""
        again = path()
        state, meta2 = load_reference_checkpoint(again)
        return state, {"checkpoint": again, "epoch": meta2.get("epoch"),
                       "best_dice": meta2.get("best_dice")}

    server = SegmentationServer(
        model, data_cfg, model_name=args.model, host=args.host,
        port=args.port, max_batch=args.max_batch,
        window_ms=args.batch_window_ms, device=args.device, tiled=tiled,
        weights=weights, reloader=reloader)
    geometries = _geometries(args.warmup_geometries)
    if geometries and tiled is None:
        print("warning: --warmup-geometries ignored without --tiled")
    if geometries and args.no_warmup:
        print("warning: --warmup-geometries ignored with --no-warmup - the "
              "first request at each geometry builds its kernels in-line")
    if not args.no_warmup:
        # a PK checkpoint takes the T frames and then its maps (T + 3)
        planes = model_cfg.time_steps + (model_cfg.pk_channels
                                         if model_cfg.use_pk_maps else 0)
        server.engine.warmup(planes, data_cfg.crop_size, data_cfg.crop_size)
        if tiled is not None:
            for h, w in geometries:
                print(f"warming up tiled geometry {h}x{w}...")
                server.engine.predict(np.zeros((1, planes, h, w, 1),
                                               np.uint8))
    return server


def main(argv: Optional[Sequence[str]] = None) -> None:
    server = build_server(parse_args(argv))
    server.start()
    host, port = server.address
    print(f"listening on http://{host}:{port}  "
          f"(POST /v1/segment, POST /v1/reload, GET /healthz, GET /metrics)")
    stop = threading.Event()
    # SIGTERM drains like Ctrl-C: stop accepting, finish in-flight batches.
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        stop.wait()
        print("SIGTERM: shutting down")
    except KeyboardInterrupt:
        print("shutting down")
    finally:
        server.stop()


if __name__ == "__main__":
    main()
