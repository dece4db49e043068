"""setup.capture_s: self time of `train.graph.capture` (train/graphs.py:
the `torch.cuda.graph` block that records the macro step into the CUDA
graph), from the program's spans (harness/spans.py)."""
from portbench.harness import spans


def read(ctx):
    return spans.setup_seconds(ctx, ("train.graph.capture",), "self_ns")
