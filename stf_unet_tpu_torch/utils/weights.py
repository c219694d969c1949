"""Carry STF-LSTM-UNet and vanilla UNet weights from the JAX package's
Flax trees into the reference PyTorch state_dict layout that this
package's models load (strict=True). The port's own copy of the conversions in
stf_unet_tpu/utils/torch_export.py:

  * Conv kernel HWIO [kh,kw,in,out] -> torch [out,in,kh,kw]
  * Transposed conv: the stored flipped forward-conv HWIO kernel ->
    transpose to [in,out,kh,kw] -> spatial flip
  * BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var
    (+ a zero num_batches_tracked so strict loads succeed)
  * LSTM [C,4C] -> transposed torch [4C,C]; separate b_ih/b_hh kept

Inputs are trees of numpy arrays (or anything np.asarray takes); outputs
are CPU torch tensors.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_STAGE_SIZES = (3, 4, 6, 3)  # torchvision resnet34


def _np(x) -> np.ndarray:
    return np.asarray(x)


def conv_weight_from_hwio(k) -> np.ndarray:
    """HWIO [kh,kw,in,out] -> torch Conv2d [out,in,kh,kw]."""
    return _np(k).transpose(3, 2, 0, 1).copy()


def convt_weight_from_hwio(k) -> np.ndarray:
    """Flipped forward-conv HWIO kernel -> torch ConvTranspose2d
    [in,out,kh,kw]."""
    return _np(k).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1].copy()


def _conv(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = conv_weight_from_hwio(p["kernel"])
    if "bias" in p:
        sd[f"{prefix}.bias"] = _np(p["bias"])


def _convt(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = convt_weight_from_hwio(p["kernel"])
    if "bias" in p:
        sd[f"{prefix}.bias"] = _np(p["bias"])


def _bn(sd: Dict, prefix: str, p: Mapping, s: Mapping) -> None:
    sd[f"{prefix}.weight"] = _np(p["scale"])
    sd[f"{prefix}.bias"] = _np(p["bias"])
    sd[f"{prefix}.running_mean"] = _np(s["mean"])
    sd[f"{prefix}.running_var"] = _np(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)


def _residual_block(sd: Dict, prefix: str, p: Mapping, s: Mapping) -> None:
    _conv(sd, f"{prefix}.conv_block.0", p["conv1"])
    _bn(sd, f"{prefix}.conv_block.1", p["norm1"]["bn"], s["norm1"]["bn"])
    _conv(sd, f"{prefix}.conv_block.3", p["conv2"])
    _bn(sd, f"{prefix}.conv_block.4", p["norm2"]["bn"], s["norm2"]["bn"])
    if "shortcut_conv" in p:
        _conv(sd, f"{prefix}.shortcut.0", p["shortcut_conv"])
        _bn(sd, f"{prefix}.shortcut.1", p["shortcut_norm"]["bn"],
            s["shortcut_norm"]["bn"])


def _basic_block(sd: Dict, prefix: str, p: Mapping, s: Mapping) -> None:
    _conv(sd, f"{prefix}.conv1", p["conv1"])
    _bn(sd, f"{prefix}.bn1", p["bn1"]["bn"], s["bn1"]["bn"])
    _conv(sd, f"{prefix}.conv2", p["conv2"])
    _bn(sd, f"{prefix}.bn2", p["bn2"]["bn"], s["bn2"]["bn"])
    if "down_conv" in p:
        _conv(sd, f"{prefix}.downsample.0", p["down_conv"])
        _bn(sd, f"{prefix}.downsample.1", p["down_bn"]["bn"],
            s["down_bn"]["bn"])


def _lstm(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight_ih_l0"] = _np(p["w_ih"]).T.copy()
    sd[f"{prefix}.weight_hh_l0"] = _np(p["w_hh"]).T.copy()
    sd[f"{prefix}.bias_ih_l0"] = _np(p["b_ih"])
    sd[f"{prefix}.bias_hh_l0"] = _np(p["b_hh"])


def _decoder_block(sd: Dict, prefix: str, p: Mapping, s: Mapping) -> None:
    _convt(sd, f"{prefix}.up", p["up"])
    _conv(sd, f"{prefix}.fusion", p["fusion"])
    _residual_block(sd, f"{prefix}.res_conv", p["res_conv"], s["res_conv"])


def _torch(sd: Dict) -> Dict[str, torch.Tensor]:
    # np.array copies: arrays handed over from JAX are read-only views,
    # which torch.as_tensor would alias with a warning.
    return {k: torch.as_tensor(np.array(v)) for k, v in sd.items()}


_UNET_DOUBLE_CONVS = ("enc1", "enc2", "enc3", "enc4", "bottleneck",
                      "dec4", "dec3", "dec2", "dec1")


def unet_state_dict_from_jax(params: Mapping, batch_stats: Mapping
                             ) -> Dict[str, torch.Tensor]:
    """UNet (params, batch_stats) trees -> reference-layout torch
    state_dict (ref:src/unet.py: DoubleConv convs at .0 / .3, BNs at
    .1 / .4, ConvTranspose up*, 1x1 out_conv)."""
    sd: Dict = {}
    for name in _UNET_DOUBLE_CONVS:
        for i, (conv_idx, bn_idx) in enumerate(((0, 1), (3, 4))):
            p = params[name][f"conv{i + 1}"]
            s = batch_stats[name][f"conv{i + 1}"]
            _conv(sd, f"{name}.{conv_idx}", p["conv"])
            _bn(sd, f"{name}.{bn_idx}", p["norm"]["bn"], s["norm"]["bn"])
    for name in ("up4", "up3", "up2", "up1"):
        _convt(sd, name, params[name])
    _conv(sd, "out_conv", params["out_conv"])
    return _torch(sd)


def stflstm_state_dict_from_jax(params: Mapping, batch_stats: Mapping
                                ) -> Dict[str, torch.Tensor]:
    """STFLSTMUNet (params, batch_stats) trees -> reference-layout torch
    state_dict (torchvision resnet34 BasicBlock names + the STF-LSTM-UNet
    heads)."""
    sd: Dict = {}
    enc_p, enc_s = params["encoder"], batch_stats["encoder"]
    _conv(sd, "conv1", enc_p["conv1"])
    _bn(sd, "bn1", enc_p["bn1"]["bn"], enc_s["bn1"]["bn"])
    for stage, blocks in enumerate(_STAGE_SIZES):
        for b in range(blocks):
            name = f"layer{stage + 1}_block{b}"
            _basic_block(sd, f"layer{stage + 1}.{b}", enc_p[name],
                         enc_s[name])
    for i in range(1, 5):
        if f"pk_fusion{i}" in params:
            _conv(sd, f"pk_fusion{i}", params[f"pk_fusion{i}"])
        _lstm(sd, f"lstm{i}", params[f"lstm{i}"])
    for i in (4, 3, 2):
        _decoder_block(sd, f"decoder{i}", params[f"decoder{i}"],
                       batch_stats[f"decoder{i}"])
    _convt(sd, "upconv1", params["upconv1"])
    _residual_block(sd, "final_res", params["final_res"],
                    batch_stats["final_res"])
    _conv(sd, "final", params["final"])
    return _torch(sd)


def _residual_conv_names(jax_prefix: str, port_prefix: str) -> Dict:
    return {f"{jax_prefix}/{j}": f"{port_prefix}.{p}"
            for j, p in (("conv1", "conv_block.0"), ("conv2", "conv_block.3"),
                         ("shortcut_conv", "shortcut.0"))}


def _conv_names(model_name: str) -> Dict[str, str]:
    """Every conv path the JAX model can calibrate (flax module paths
    joined by "/", as stf_unet_tpu/ops/quant.py keys them) -> the port's
    module name, by the same mapping as the state_dict bridges above."""
    if model_name == "unet":
        names = {f"{n}/conv{i + 1}/conv": f"{n}.{idx}"
                 for n in _UNET_DOUBLE_CONVS for i, idx in enumerate((0, 3))}
        names["out_conv"] = "out_conv"
        return names
    if model_name != "stflstm":
        raise ValueError(f"Unknown model type: {model_name}")
    names = {"encoder/conv1": "conv1", "final": "final"}
    for stage, blocks in enumerate(_STAGE_SIZES):
        for b in range(blocks):
            jax_block = f"encoder/layer{stage + 1}_block{b}"
            port_block = f"layer{stage + 1}.{b}"
            for j, p in (("conv1", "conv1"), ("conv2", "conv2"),
                         ("down_conv", "downsample.0")):
                names[f"{jax_block}/{j}"] = f"{port_block}.{p}"
    for i in range(1, 5):
        names[f"pk_fusion{i}"] = f"pk_fusion{i}"
    for i in (4, 3, 2):
        names[f"decoder{i}/fusion"] = f"decoder{i}.fusion"
        names.update(_residual_conv_names(f"decoder{i}/res_conv",
                                          f"decoder{i}.res_conv"))
    names.update(_residual_conv_names("final_res", "final_res"))
    return names


def conv_scales_from_jax(scales: Mapping[str, float], model_name: str
                         ) -> Dict[str, float]:
    """The JAX package's int8 calibration scales ({flax conv path:
    absmax}, stf_unet_tpu/ops/quant.py) keyed by the port's conv module
    names (ops/quant.py); raises on a path the model has no conv for."""
    names = _conv_names(model_name)
    unknown = sorted(set(scales) - set(names))
    if unknown:
        raise ValueError(f"no {model_name} conv for the JAX scale paths "
                         f"{unknown}")
    return {names[path]: float(v) for path, v in scales.items()}
