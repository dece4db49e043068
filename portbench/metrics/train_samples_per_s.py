"""train_samples_per_s: training examples (images, or ratio-net pairs) of
every optimizer step the window launched, over the host-clock time from
the window's start to the synchronise that drains them."""


def read(ctx):
    return ctx.window.rate if ctx.unit == "samples" else None
