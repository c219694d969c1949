"""Weights from the run seed, made on the model's device in one call of a
seeded torch.Generator there, in the type they are served in (float32
parameters).

Every leaf is uniform(-b, b) with b = 1/sqrt(fan_in), fan_in the
product of a weight's dimensions after the first (a bias takes its
module's weight's); BatchNorm weights are 1 and biases 0, its running
statistics mean 0 and variance 1; the leaves the configuration names in
`zero_leaves` are 0. The benchmark hands the same tensors to the program
and to the reference."""

from __future__ import annotations

from typing import Dict, Iterable

import torch
import torch.nn as nn

SEED_MASK = (1 << 63) - 1


def _fan_in(module: nn.Module, leaf: torch.Tensor) -> int:
    if leaf.dim() >= 2:
        return leaf.numel() // leaf.shape[0]
    for p in module.parameters(recurse=False):
        if p.dim() >= 2:
            return p.numel() // p.shape[0]
    return leaf.numel()


def seeded_weights(model: nn.Module, seed: int, device: torch.device,
                   zero: Iterable[str] = ()) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on `device`} of every parameter of `model`
    and every BatchNorm running statistic."""
    zero = set(zero)
    leaves, bn = [], {}
    for mod_name, mod in model.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        is_bn = isinstance(mod, nn.modules.batchnorm._BatchNorm)
        for name, p in mod.named_parameters(recurse=False):
            full = prefix + name
            if is_bn:
                bn[full] = (torch.ones if name == "weight"
                            else torch.zeros)(p.shape, device=device)
            elif full in zero:
                bn[full] = torch.zeros(p.shape, device=device)
            else:
                leaves.append((full, p.shape, _fan_in(mod, p)))
        if is_bn:
            bn[prefix + "running_mean"] = torch.zeros(mod.num_features,
                                                      device=device)
            bn[prefix + "running_var"] = torch.ones(mod.num_features,
                                                    device=device)
    total = sum(int(torch.Size(s).numel()) for _, s, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(int(seed) & SEED_MASK)
    flat = torch.rand(total, generator=gen, device=device).mul_(2).sub_(1)
    out, at = {}, 0
    for name, shape, fan in leaves:
        n = int(torch.Size(shape).numel())
        out[name] = flat[at:at + n].view(shape) * (1.0 / fan ** 0.5)
        at += n
    out.update(bn)
    return out


def load_into(model: nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy the weights into the model's own parameters and buffers."""
    state = model.state_dict()
    missing = [k for k in weights if k not in state]
    if missing:
        raise KeyError(f"weights the model does not hold: {missing[:5]}")
    with torch.no_grad():
        for k, t in weights.items():
            state[k].copy_(t)


def trainable(model: nn.Module):
    return [n for n, p in model.named_parameters() if p.requires_grad]
