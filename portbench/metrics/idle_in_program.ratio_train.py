"""idle_in_program.ratio_train: idle_in_program.train's measure in the
cells that report ratio_train_samples_per_s: the part of
idle_share.ratio_train during which the host was inside a program span
(a `train.ratio.call`, its replay), as % of the profiled stretch
(harness/spans.py)."""
from portbench.harness import spans


def read(ctx):
    return spans.idle_in_program(ctx)
