"""Model-serving entry point: one process owns the GPU and serves
segmentation over HTTP with dynamic batching (counterpart of
stf_unet_tpu/cli/serve.py).

Usage: python -m stf_unet_tpu_torch.cli.serve --weights model.pth
       [--model stflstm|unet] [--host 127.0.0.1] [--port 8421] [--max-batch 8]
       [--batch-window-ms 5] [--dtype bf16|f32] [--crop-size 224]
       [--device cuda]

--weights is a reference-layout checkpoint, {"model": state_dict,
"epoch": N}, of the model `--model` names (STF-LSTM-UNet or the vanilla
UNet): cli/train writes them, and `python -m stf_unet_tpu.cli.migrate
out.pth --model stflstm --save-dir <jax run> --reverse` writes one from a
JAX checkpoint. A PK
checkpoint (trained with --use-pk-maps) takes requests of T + 3 planes:
the frames, then the Ktrans, ve and vp maps.

Client: stf_unet_tpu_torch.serve.client.SegmentationClient.
"""

from __future__ import annotations

import argparse
import signal
import threading
from typing import Optional, Sequence

from stf_unet_tpu_torch.cli.common import DTYPES, restore_for_inference
from stf_unet_tpu_torch.serve.http import SegmentationServer


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="STF-UNet serving on the GPU")
    p.add_argument("--model", type=str, default="stflstm",
                   choices=["stflstm", "unet"])
    p.add_argument("--weights", type=str, required=True,
                   help="reference-layout .pth checkpoint")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8421)
    p.add_argument("--max-batch", type=int, default=8,
                   help="dynamic batching cap (power-of-two buckets)")
    p.add_argument("--batch-window-ms", type=float, default=5.0,
                   help="how long a request waits for batch peers")
    p.add_argument("--dtype", type=str, default="bf16",
                   choices=sorted(DTYPES),
                   help="compute dtype (parameters stay float32; logits "
                        "are float32)")
    p.add_argument("--crop-size", type=int, default=None,
                   help="short edge the frames are resized to (default: "
                        "the checkpoint's training crop, else 224)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' only when asked for")
    return p.parse_args(argv)


def build_server(args: argparse.Namespace) -> SegmentationServer:
    """Load the model, build the (not yet started) server and warm every
    batch bucket at the served geometry."""
    model, data_cfg, model_cfg, meta = restore_for_inference(
        args.model, args.weights, crop_size=args.crop_size,
        dtype=args.dtype, device=args.device)
    print(f"serving {args.weights} (epoch {meta.get('epoch', '?')}) on "
          f"{args.device} in {args.dtype}")
    server = SegmentationServer(
        model, data_cfg, model_name=args.model, host=args.host,
        port=args.port, max_batch=args.max_batch,
        window_ms=args.batch_window_ms, device=args.device)
    # a PK checkpoint takes the T frames and then its maps (T + 3 planes)
    planes = model_cfg.time_steps + (model_cfg.pk_channels
                                     if model_cfg.use_pk_maps else 0)
    server.engine.warmup(planes, data_cfg.crop_size, data_cfg.crop_size)
    return server


def main(argv: Optional[Sequence[str]] = None) -> None:
    server = build_server(parse_args(argv))
    server.start()
    host, port = server.address
    print(f"listening on http://{host}:{port}  "
          f"(POST /v1/segment, GET /healthz, GET /metrics)")
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
