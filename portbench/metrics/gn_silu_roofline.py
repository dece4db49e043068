"""gn_silu_roofline: the least time the card could take for every
GroupNorm+SiLU site of the profiled sampler call (bytes from
harness/counts.py over the card's memory bandwidth) over the device time
of the kernels that ran them (`gn_silu_kernel`), in %."""
from portbench.harness import trace as tr

KERNEL = "gn_silu_kernel"


def read(ctx):
    w = ctx.work
    if ctx.trace is None or ctx.peaks is None or w.get("kind") != "sample":
        return None
    t, n = tr.device_time(ctx.trace, lambda name: KERNEL in name)
    if not n:
        return None
    return 100.0 * w["gn_fwd_bytes"] / ctx.peaks["bytes"] / t
