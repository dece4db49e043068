"""gn_silu_bwd_roofline: the least time the card could take for
the GroupNorm+SiLU backward of every site of the profiled training steps
(bytes from harness/counts.py over the card's memory bandwidth) over the
device time of the kernels that ran it (`gn_silu_bwd_kernel` for dx and
the partial dγ, dβ; `gn_wb_reduce_kernel` for their sums), in %."""
from portbench.harness import trace as tr

KERNELS = ("gn_silu_bwd_kernel", "gn_wb_reduce_kernel")


def read(ctx):
    w = ctx.work
    if (ctx.trace is None or ctx.peaks is None or w.get("kind") != "train"
            or not w.get("gn_bwd_bytes")):
        return None
    t, n = tr.device_time(ctx.trace,
                          lambda name: any(k in name for k in KERNELS))
    if not n:
        return None
    return 100.0 * w["gn_bwd_bytes"] / ctx.peaks["bytes"] / t
