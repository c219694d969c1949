"""Share of the traced tail's training steps in which no device
operation ran."""

from portbench.harness import readers


def read(ctx):
    return readers.idle_pct(ctx)
