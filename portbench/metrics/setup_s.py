"""setup_s: seconds from the process's start to the window's start:
importing, building or loading the kernels, making weights and data on
the card, and the warm-up of the cell's shapes (host clock)."""


def read(ctx):
    return ctx.setup_s
