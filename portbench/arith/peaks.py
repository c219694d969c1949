"""Published peaks of the cards the benchmark runs on, by the name that
torch.cuda.get_device_name() gives. Dense rates without sparsity, at the
card's full power limit (NVIDIA's H100 SXM data sheet); the run prints
the card's power limit beside every share of them."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peak(kind: str):
    """The card's row of PEAKS, or None for a card not in the table (a
    share of an unknown peak is not reported, never reported as 0)."""
    return PEAKS.get(kind)


def bound_s(flops: float, nbytes: float, kind: str):
    """(least seconds the card could take, "operations" or "bytes"): the
    larger of the two times, or None for an unknown card."""
    row = peak(kind)
    if row is None:
        return None
    t_ops = flops / row["bf16_flops"]
    t_bytes = nbytes / row["hbm_bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
