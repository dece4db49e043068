"""pairs_per_s: guided pairs of every sampler call the window started,
over the host-clock time from the window's start to the end of its last
call (each call ends in a synchronise)."""


def read(ctx):
    return ctx.window.rate if ctx.unit == "pairs" else None
