"""The numbers that decide `correct`, each worked out from what the timed
path produced and what the reference computed from the same inputs.

Training, over each stretch of steps the reference repeats (the run's
first three steps from the seed, and the window's own first two from the
state the program held when the window opened); each number is the
larger of the stretches':
  loss_gap    max over the steps of |loss - ref| over the reference's
              loss at the run's first step (a loss the model has already
              learned down, as by the window's second epoch, would turn
              the rounding of a relative gap into a large share);
  loss_gap_first  the same of the first step alone (printed);
  grad_gap    the first gradient (as the optimizer holds it after one
              step) by its worst leaf: | ||g|| - ||g_ref|| | over the
              larger of ||g_ref|| and the median leaf's;
  grad_gap_median  the same gap of the median leaf: steady from seed to
              seed where the worst leaf is one small leaf's rounding;
  grad_err_median  the median leaf's ||g - g_ref|| over the same
              denominator: the gradient's direction, which a gap of norms
              cannot see (rounding noise in a lower precision);
  grad_err    the same of the worst leaf (printed);
  update_gap  the parameters' change over the stretch, as grad_gap.
Leaves whose reference gradient is under a thousandth of the median
leaf's (a bias under BN, whose gradient is rounding) are left out of the
leaf numbers: Adam moves them by round-off alone.
"""

from __future__ import annotations

import statistics
from typing import Dict, Sequence

import torch


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(t.double().norm()) for k, t in tensors.items()}


def eligible_leaves(ref_grad_norms: Dict[str, float]) -> Sequence[str]:
    med = statistics.median(ref_grad_norms.values())
    return [k for k, n in ref_grad_norms.items() if n >= 1e-3 * med]


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: Sequence[str]) -> Dict[str, float]:
    """Each leaf's | ||prog|| - ||ref|| | over the larger of ||ref|| and
    the median leaf's."""
    med = statistics.median(ref[k] for k in leaves)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves}


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               leaves: Sequence[str]):
    """(gap, leaf) of the worst leaf among `leaves`."""
    gaps = leaf_gaps(prog, ref, leaves)
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def train_numbers(losses, ref_losses, grads, ref_grads, deltas,
                  ref_deltas, loss_scale: float) -> dict:
    """One stretch's numbers: `grads` and `deltas` {leaf: tensor} (the
    first gradient, the parameters' change over the stretch);
    `loss_scale` the reference's loss at the run's first step."""
    grad_norms, ref_grad_norms = leaf_norms(grads), leaf_norms(ref_grads)
    leaves = eligible_leaves(ref_grad_norms)
    grad_gap, grad_leaf = worst_leaf(grad_norms, ref_grad_norms, leaves)
    update_gap, update_leaf = worst_leaf(
        leaf_norms(deltas), leaf_norms(ref_deltas), leaves)
    step_gaps = [abs(a - b) / abs(loss_scale)
                 for a, b in zip(losses, ref_losses)]
    g = leaf_gaps(grad_norms, ref_grad_norms, leaves)
    med = statistics.median(ref_grad_norms[k] for k in leaves)
    err = {k: float((grads[k].double() - ref_grads[k].double()).norm())
           / max(ref_grad_norms[k], med) for k in leaves}
    worst5 = sorted(g, key=g.get, reverse=True)[:5]
    return {"loss_gap": max(step_gaps), "loss_gap_first": step_gaps[0],
            "grad_gap": grad_gap,
            "grad_gap_median": statistics.median(g.values()),
            "grad_err_median": statistics.median(err.values()),
            "grad_err": max(err.values()),
            "update_gap": update_gap,
            "detail": {"losses": list(losses), "ref_losses": list(ref_losses),
                       "grad_leaf": grad_leaf, "update_leaf": update_leaf,
                       "grad_err_leaf": max(err, key=err.get),
                       "grad_worst5": {k: g[k] for k in worst5},
                       "leaves_compared": len(leaves),
                       "leaves_left_out": len(ref_grad_norms) - len(leaves)}}


def combine(stretches) -> dict:
    """Each number the largest over the stretches' numbers; `detail`
    lists theirs."""
    out = {k: max(n[k] for n in stretches)
           for k in stretches[0] if k != "detail"}
    out["detail"] = list(stretches)
    return out
