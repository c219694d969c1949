"""The Swin-UNet cell's arithmetic and reader on the CPU: the FLOP count
from the published shapes against torch's FlopCounterMode over the
port's forward, the reader's window-attention calls a step against the
op's own counter over a training step, and the reader's None where it
has nothing to read."""

import json

import pytest
import torch

import portbench_tiny

from portbench.arith import peaks
from portbench.arith import window_attention as wa
from portbench.arith.models import swinunet
from portbench.harness.spec import Spec

H100 = "NVIDIA H100 80GB HBM3"
ARCH = json.loads((portbench_tiny.REPO / "portbench" / "configs"
                   / "swinunet.json").read_text())["architecture"]
TINY = dict(img_size=32, patch_size=2, embed_dim=8, depths=[2, 2, 2],
            num_heads=[2, 2, 4], window_size=2)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _model(arch):
    from stf_unet_tpu_torch.models.swin_unet import SwinUNet

    return SwinUNet(in_chans=arch["time_steps"],
                    num_classes=arch["num_classes"],
                    img_size=arch["img_size"], patch_size=arch["patch_size"],
                    embed_dim=arch["embed_dim"],
                    depths=tuple(arch["depths"]),
                    num_heads=tuple(arch["num_heads"]),
                    window_size=arch["window_size"])


@pytest.mark.parametrize("arch,batch", [(ARCH, 1), (dict(ARCH, **TINY), 2)])
def test_forward_flops_match_torchs_count(arch, batch):
    """FlopCounterMode counts the attention's products where SDPA runs
    as its math decomposition (its CPU kernel goes uncounted)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.utils.flop_counter import FlopCounterMode

    model = _model(arch)
    x = torch.randn(batch, arch["img_size"], arch["img_size"],
                    arch["time_steps"])
    with FlopCounterMode(display=False) as counter, \
            sdpa_kernel(SDPBackend.MATH), torch.no_grad():
        model(x)
    assert swinunet.forward_flops(arch, batch, 224) == \
        counter.get_total_flops()


def test_published_step_flops():
    assert 3 * swinunet.forward_flops(ARCH, 16, 224) == 585614131200
    assert len(swinunet.attention_blocks(ARCH)) == 14


def test_the_readers_calls_are_the_ops_count():
    from stf_unet_tpu_torch.ops.window_attention import window_attention
    from stf_unet_tpu_torch.train.loop import loss_and_grads

    arch = dict(ARCH, **TINY)
    model = _model(arch)
    images = torch.randn(2, arch["time_steps"], 32, 32, 1)
    targets = torch.randint(0, 2, (2, 32, 32))
    before = window_attention.launches
    loss_and_grads(model, images, targets, arch["num_classes"])
    assert window_attention.launches - before == len(
        swinunet.attention_blocks(arch))


def _ctx(root, kernels):
    from portbench.harness.run import Run

    run = Run.of(Spec(root), "swinunet.train.b16", 3, 1.0, True,
                 torch.device("cpu"))
    return {"run": run, "device_kind": H100,
            "tail": {"steps": 2, "kernels": kernels}}


def test_the_reader(tmp_path, monkeypatch):
    from stf_unet_tpu_torch.ops.window_attention import window_attention

    root = portbench_tiny.tiny_root(tmp_path)
    reader = Spec(root).reader("wattn_roofline.train")
    monkeypatch.setattr(window_attention, "launches", 28)
    gemm = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64"
    assert reader.read(_ctx(root, {gemm: 1e-3})) is None
    assert reader.read(dict(_ctx(root, {}), tail=None)) is None
    fwd = "fmha_cutlassF_bf16_aligned_64x64_rf_sm80(PyTorchMemEffAttention" \
        "::AttentionKernel<...>::Params)"
    bwd = "fmha_cutlassB_bf16_aligned_64x64_k32_sm80(PyTorchMemEffAttention" \
        "::AttentionBackwardKernel<...>::Params)"
    ctx = _ctx(root, {gemm: 1.0, fwd: 2e-3, bwd: 6e-3})
    bsz = ctx["run"].traffic["batch_size"]
    bound = sum(peaks.bound_s(*part(bsz, *blk), H100)[0]
                for blk in swinunet.attention_blocks(ARCH)
                for part in (wa.forward, wa.backward))
    assert reader.read(ctx) == pytest.approx(100.0 * bound * 2 / 8e-3)
    monkeypatch.setattr(window_attention, "launches", 0)
    assert reader.read(ctx) is None
