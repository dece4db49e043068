"""setup.warmup_s: self time of `train.graph.warmup` (train/graphs.py:
the first macro step, eager on a side stream, until its device work has
drained), less the kernel loads inside it (setup.kernels_s counts them),
from the program's spans (harness/spans.py)."""
from portbench.harness import spans


def read(ctx):
    return spans.setup_seconds(ctx, ("train.graph.warmup",), "self_ns")
