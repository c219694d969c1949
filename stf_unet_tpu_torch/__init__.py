"""PyTorch / CUDA port of stf_unet_tpu for one NVIDIA H100.

The JAX package (`stf_unet_tpu`) is the reference this package is held
against; the module layout mirrors it so each counterpart is easy to find.
This package imports torch, numpy, PIL and the standard library only.

Serving entry point: `python -m stf_unet_tpu_torch.cli.serve --weights
model.pth`. Every entry point runs on the GPU (`device="cuda"`) unless the
caller passes `device="cpu"`; a missing GPU raises, it never falls back.
"""

__version__ = "0.1.0"
