"""attn_roofline: the attention's two products over the profiled training
steps (`work()["attn_flops"]`: 3 × the forward's q kᵀ and weights-times-v
FLOPs of each example, as mfu.train counts, so the backward's recompute
is not credited) over the device time of the memory-efficient attention
kernels (`fmha_cutlassF*` forward, `fmha_cutlassB*` backward), over the
peak of the units they run on, in %. In float32 on sm80 and later those
kernels multiply as 3×TF32 on the tensor cores (three TF32 products for
each float32 one: a third of TF32's dense peak, which is half of bf16's),
so the peak is the card's bf16 peak / 6 (164.8 TFLOP/s on an H100 SXM).
None where the set-up ran attention on the math path (or none on the
memory-efficient one), or where the trace holds no such kernel."""
from portbench.harness import trace as tr

KERNELS = ("fmha_cutlassF", "fmha_cutlassB")


def read(ctx):
    w = ctx.work
    if (ctx.trace is None or ctx.peaks is None or w.get("kind") != "train"
            or not w.get("attn_flops")):
        return None
    calls = w.get("attn_calls") or {}
    if (calls.get("sdpa.math_launches", 0)
            or not calls.get("sdpa.efficient_launches")):
        return None
    t, n = tr.device_time(ctx.trace,
                          lambda name: any(k in name for k in KERNELS))
    if not n:
        return None
    return 100.0 * w["attn_flops"] / (ctx.peaks["bf16"] / 6.0) / t
