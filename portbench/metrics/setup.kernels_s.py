"""setup.kernels_s: seconds of the run spent building the port's CUDA
kernels (`ops.build`: the nvcc runs of `ops/_build.py:build_all`, when
anything is left to compile) and loading their libraries (`ops.load`:
each library's first `ctypes.CDLL` and any build it triggers), from the
program's spans (harness/spans.py); 0 where neither ran."""
from portbench.harness import spans


def read(ctx):
    return spans.setup_seconds(ctx, ("ops.build", "ops.load"), "total_ns")
