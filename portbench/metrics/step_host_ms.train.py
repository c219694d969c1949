"""Mean host ms per train/loop.train_step call of the untraced window,
enqueue to return (augment, forward, backward, AdamW dispatched; the
device may still be running): the benchmark's `train_step` span."""

from portbench.harness import readers


def read(ctx):
    return readers.mean_ms(ctx, "train_step")
