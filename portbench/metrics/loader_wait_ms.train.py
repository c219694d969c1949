"""Mean host ms that the trainer's device-prefetch thread waited on the
HostLoader (data/loader, data/pack) for each batch of the untraced
window: the benchmark's `loader_next` span around the loader it hands
train_one_epoch."""

from portbench.harness import readers


def read(ctx):
    return readers.mean_ms(ctx, "loader_next")
