"""idle_in_program.train: the part of idle_share.train during which the
host was inside one of the program's spans (a `train.fm.call`, its
replay): the profiled stretch's idle gaps whose midpoint such a span
holds, as % of the stretch (harness/spans.py). idle_share.train less this
is the idle time the host spent in the harness or its driver."""
from portbench.harness import spans


def read(ctx):
    return spans.idle_in_program(ctx)
