"""launches_per_step.sample: device operations of the profiled sampler
call (kernels, copies and fills, graph replays' kernels included, as the
trace shows them) over its Euler steps."""
from portbench.harness import trace as tr


def read(ctx):
    w = ctx.work
    if ctx.trace is None or w.get("kind") != "sample":
        return None
    _, n = tr.device_time(ctx.trace)
    return n / w["euler_steps"] if n else None
