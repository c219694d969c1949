"""bn_roofline.train: BN's element count from the published shapes (and
against the program's own BatchNorm layers), and its reader on synthetic
traced tails: ATen's, cuDNN's and the port's K7 kernel names match, and
a tail with no BatchNorm kernel reads None."""

import json
import types

import pytest

import portbench_tiny

from portbench.arith import batch_norm
from portbench.harness.spec import Spec

REPO = portbench_tiny.REPO
H100 = "NVIDIA H100 80GB HBM3"


def _config(name):
    return json.loads((REPO / "portbench" / "configs"
                       / f"{name}.json").read_text())


def _traffic():
    return json.loads((REPO / "portbench" / "traffic"
                       / "train_b16.json").read_text())


@pytest.mark.parametrize("model,layers,elements", [
    ("stflstm", 44, 502_562_816), ("unet", 18, 391_774_208),
    ("swinunet", 0, 0)])
def test_bn_elements_of_a_step(model, layers, elements):
    arch = _config(model)["architecture"]
    assert len(batch_norm.shapes(model, arch, 16, 224)) == layers
    assert batch_norm.elements(model, arch, 16, 224) == elements
    assert batch_norm.floor_bytes(model, arch, 16, 224, 2) == \
        10 * elements


@pytest.mark.parametrize("model", ["stflstm", "unet"])
def test_the_shapes_are_the_programs_bn_inputs(model):
    """The program's models on the meta device, a forward pre-hook on
    every BatchNorm: the same (N, C, H*W) in the same order."""
    import torch

    from stf_unet_tpu_torch.core.config import ModelConfig
    from stf_unet_tpu_torch.models.registry import create_model

    with torch.device("meta"):
        net = create_model(ModelConfig(model=model), dtype=torch.bfloat16)
    seen = []
    for m in net.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.register_forward_pre_hook(lambda mod, args: seen.append(
                (args[0].shape[0], args[0].shape[1],
                 args[0].shape[2] * args[0].shape[3])))
    net.eval()
    net(torch.empty((3, 8, 96, 96, 1) if model == "stflstm"
                    else (3, 96, 96, 8), device="meta"))
    assert seen == batch_norm.shapes(model, _config(model)["architecture"],
                                     3, 96)


def _ctx(model, kernels, steps=8):
    run = types.SimpleNamespace(config=_config(model), traffic=_traffic())
    return {"tail": {"kernels": kernels, "steps": steps},
            "run": run, "device_kind": H100}


ATEN = {
    "void at::native::batch_norm_collect_statistics_kernel<at::native::"
    "InvStd, c10::BFloat16, float, float, int>(...)": 0.0393,
    "void at::native::batch_norm_backward_kernel<c10::BFloat16, float, "
    "float, int>(...)": 0.0892,
    "void at::native::batch_norm_transform_input_kernel<c10::BFloat16, "
    "float, float, int, true>(...)": 0.0119,
}
K7 = {
    "void stf::bn_stats_kernel<unsigned short, 8>(unsigned short const*, "
    "stf::Tile, float*)": 0.004,
    "stf::bn_finish_kernel(float const*, int, int, float*, float*, "
    "float*, float*, float, float)": 0.001,
    "void stf::bn_apply_kernel<unsigned short, 8>(...)": 0.006,
    "void stf::bn_bwd_reduce_kernel<unsigned short, 4>(...)": 0.008,
    "stf::bn_bwd_finish_kernel(...)": 0.001,
    "void stf::bn_bwd_dx_kernel<unsigned short, 1>(...)": 0.012,
}
CUDNN = {"bn_fw_tr_1C11_kernel_NCHW<__nv_bfloat16, float, 512, true, 1>":
         0.02, "bn_bw_1C11_kernel_new<__nv_bfloat16, float>": 0.03}
OTHER = {"void at::native::vectorized_elementwise_kernel<4, at::native::"
         "CUDAFunctor_add<float>>(...)": 1.0,
         "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32": 2.0,
         "void stf::warp_kernel(...)": 0.5}


@pytest.mark.parametrize("names", [ATEN, K7, CUDNN], ids=["aten", "k7",
                                                          "cudnn"])
def test_the_reader_matches_every_bn_kernel(names):
    reader = Spec(REPO).reader("bn_roofline.train")
    floor_s = 10 * 502_562_816 / 3.35e12
    got = reader.read(_ctx("stflstm", {**names, **OTHER}))
    assert got == pytest.approx(100 * floor_s * 8 / sum(names.values()))


def test_the_parents_reading():
    """ATen's three BN kernels at their device times over 8 traced STF
    steps on an H100 (17.5 ms a step) read about 8.6 % of the byte
    floor."""
    reader = Spec(REPO).reader("bn_roofline.train")
    assert reader.read(_ctx("stflstm", {**ATEN, **OTHER})) == \
        pytest.approx(8.6, abs=0.1)


@pytest.mark.parametrize("model", ["stflstm", "swinunet"])
def test_the_reader_reads_none_without_a_bn_kernel(model):
    reader = Spec(REPO).reader("bn_roofline.train")
    assert reader.read(_ctx(model, OTHER)) is None
    assert reader.read({"run": None}) is None
