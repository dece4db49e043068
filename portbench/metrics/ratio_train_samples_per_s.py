"""ratio_train_samples_per_s: ratio-net pairs of every optimizer step the
window launched, over the host-clock time from the window's start to the
synchronise that drains them (train_samples_per_s's measure, under a name
of its own: the ratio net's graph of short kernels lets the host run only
some 0.6 s ahead of an H100, so a host stall costs this cell more, and it
has a bound of its own)."""


def read(ctx):
    return ctx.window.rate if ctx.unit == "samples" else None
