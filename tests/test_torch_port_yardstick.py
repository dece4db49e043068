"""Kernel A's float32 yardsticks (ops/guidance.py), on the CPU.

The card checks hold the scores that kernel 1 writes to an a-priori float32
bound, and kernel 2's g, ESS and l to a tolerance derived from its float32
rounding (ROADMAP F4). Here the arithmetic of those bounds is held: the
chain counts of the plans, the plain version inside both bounds, and a
perturbation of one score or one output by a few float32 steps outside.
"""
import numpy as np
import pytest
import torch

from ratio_guided_multimodal_fm_tpu_torch.ops.guidance import (
    flash_guidance_reference,
    flash_guidance_scores,
    bound_ratios,
    guidance_plan,
    score_chains,
    score_error_bound,
    scores_reference,
    weighted_sum_reference,
)

torch.set_num_threads(2)


def _inputs(B, N, H, ch, seed=0, quarter=False):
    """N(0,1) images, or quarter-integers in [-2, 2] (exact scores, one-hot
    weights at t = 0.95 whose other weights underflow float32)."""
    rng = np.random.default_rng(seed)
    shapes = ((B, H, H, ch[0]), (B, H, H, ch[1]), (N, H, H, ch[0]),
              (N, H, H, ch[1]))
    draw = ((lambda s: rng.integers(-8, 9, s) / 4.0) if quarter
            else rng.standard_normal)
    return tuple(torch.from_numpy(draw(s).astype(np.float32))
                 for s in shapes) + (
        torch.from_numpy(rng.standard_normal(N).astype(np.float32)),)


@pytest.mark.parametrize("B,N,Dx,Dy,cluster", [
    (512, 256, 1024, 3072, 6), (512, 256, 784, 784, 6),
    (64, 128, 12288, 12288, 8), (64, 128, 12288, 4096, 8)])
def test_score_chains(B, N, Dx, Dy, cluster):
    """The score kernel has no float32 chain (its products run on the FP64
    tensor cores, its sums in float64); the plain version (no plan) counts
    every term of D, then five roundings of the finishing."""
    plan = guidance_plan(B, N, Dx, Dy)
    assert plan.cluster == cluster
    assert score_chains(plan, Dx + Dy) == (0, 0)
    assert score_chains(None, Dx + Dy) == (Dx + Dy, 5)


def test_scores_reference_is_the_plain_versions_softmax_argument():
    """flash_guidance_reference is the softmax of scores_reference, which
    equals -|a - t v|²/(2σ²) + log r up to constants of the softmax."""
    ins = _inputs(6, 9, 4, (1, 3))
    s = scores_reference(*ins, 0.3, torch.float64)
    w = torch.softmax(s, 1)
    V = torch.cat([ins[2].reshape(9, -1), ins[3].reshape(9, -1)], 1).double()
    A = torch.cat([ins[0].reshape(6, -1), ins[1].reshape(6, -1)], 1).double()
    g = (w @ V - A) / (1 - np.float32(0.3) + np.float32(1e-3))
    got = flash_guidance_reference(*ins, 0.3, torch.float64)
    torch.testing.assert_close(got[0].reshape(6, -1), g[:, :16], rtol=1e-6,
                               atol=1e-9)
    t32 = np.float32(0.3)
    sigma = np.float32(1) - t32 + np.float32(1e-3)
    # |a - t v|² with the kernel's float32 scalars 2t and t² (t² rounded)
    sq = ((A * A).sum(1)[:, None] - float(2 * t32) * (A @ V.T)
          + float(t32 * t32) * (V * V).sum(1)[None, :])
    full = (ins[4].double()[None, :]
            - sq * float(np.float32(0.5) / (sigma * sigma)))
    torch.testing.assert_close(torch.softmax(full, 1), w, rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize("B,N,H,ch,quarter", [(32, 64, 32, (1, 3), False),
                                              (48, 256, 28, (1, 1), False),
                                              (8, 128, 64, (3, 3), False),
                                              (4, 16, 8, (3, 3), True)])
@pytest.mark.parametrize("t", [0.05, 0.5, 0.95])
def test_plain_version_holds_both_bounds(B, N, H, ch, quarter, t):
    """On the CPU the hook returns the plain version's float32 scores and
    outputs; with any summation order of D terms (chain D) and five
    roundings after it they hold the score bound,
    and its softmax and weighted sum hold kernel 2's tolerance (an exact
    entry passes at a zero tolerance)."""
    held = bound_ratios(
        _inputs(B, N, H, ch, seed=B + N, quarter=quarter), t)
    assert held["plan"] is None
    for nm, r in held["ratios"].items():
        assert 0.0 <= r <= 1.0, (nm, r)


def test_bounds_catch_a_score_or_an_output_a_few_steps_off():
    """Mutations a correct kernel cannot make: one score moved by 1e-6
    breaks the score kernel's bound (no float32 chain), one moved by 5 the
    plain version's (any order of D = 4096 float32 terms allows ~2 here),
    and one g entry moved by 4 float32 steps kernel 2's tolerance."""
    ins = _inputs(16, 64, 32, (1, 3), seed=3)
    t = 0.5
    out, S, _ = flash_guidance_scores(*ins, t)
    exact = scores_reference(*ins, t, torch.float64)
    assert S.dtype == torch.float64
    for chains, step, held in (((0, 0), 1e-6, exact),
                               (score_chains(None, 4096), 5.0, S)):
        bound = score_error_bound(*ins, t, chains)
        assert bool(((held - exact).abs() <= bound).all())
        bad = held.clone()
        bad[3, 5] += step
        assert not bool(((bad - exact).abs() <= bound).all())

    ref, tol = weighted_sum_reference(S, *ins[:4], t)
    within = (out[0].double() - ref[0]).abs() <= tol[0]
    assert bool(within.all())
    # the entry whose tolerance is the fewest float32 steps of its value
    i = int((tol[0] / out[0].abs().clamp_min(1e-30)).flatten().argmin())
    gx = out[0].clone().flatten()
    gx.view(torch.int32)[i] += 4
    assert not bool(((gx.double() - ref[0].flatten()).abs()
                     <= tol[0].flatten()).all())


def test_weighted_sum_reference_refuses_n_past_one_partial_a_lane():
    ins = _inputs(2, 1025, 1, (1, 1))
    with pytest.raises(ValueError, match="N <= 1024"):
        weighted_sum_reference(torch.zeros(2, 1025), *ins[:4], 0.5)
