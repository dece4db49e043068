"""idle_share.sample: share of the profiled sampler call's wall time in
which no device operation ran (the union of their intervals), in %."""
from portbench.harness import trace as tr


def read(ctx):
    if ctx.trace is None or ctx.work.get("kind") != "sample":
        return None
    return tr.idle_share(ctx.trace)
