"""mfu.sample: the sampler call's model FLOPs (harness/counts.py: both
velocity nets at every Euler step of phases A and B, the guidance's two
products a step, the ratio net once over the MC set) times calls per
second of the window, over the card's dense bf16 peak, in %."""


def read(ctx):
    w = ctx.work
    if w.get("kind") != "sample" or ctx.peaks is None:
        return None
    return 100.0 * w["flops_per_unit"] * w["units_per_s"] / ctx.peaks["bf16"]
