"""idle_share.ratio_train: idle_share.train's measure in the cells that
report ratio_train_samples_per_s: share of the profiled training steps'
wall time in which no device operation ran (the union of their
intervals), in %."""
from portbench.harness import trace as tr


def read(ctx):
    if ctx.trace is None or ctx.work.get("kind") != "train":
        return None
    return tr.idle_share(ctx.trace)
