"""Hand-written CUDA kernels (sources in stf_unet_tpu_torch/csrc), each
beside its plain PyTorch version and a launch counter."""
