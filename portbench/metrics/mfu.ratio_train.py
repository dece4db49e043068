"""mfu.ratio_train: mfu.train's measure in the cells that report
ratio_train_samples_per_s: 3 × the forward FLOPs of each pair
(harness/counts.py) times the window's pairs per second, over the card's
float32 non-tensor peak (TF32 is off in the program), in %."""


def read(ctx):
    w = ctx.work
    if w.get("kind") != "train" or ctx.peaks is None:
        return None
    return 100.0 * w["flops_per_unit"] * w["units_per_s"] / ctx.peaks["fp32"]
