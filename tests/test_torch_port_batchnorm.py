"""The fused train-mode BatchNorm+SiLU (ops/batchnorm.py) on the CPU: its
plain forward and backward against autograd of models/ratio.py:BatchNorm2d
+ F.silu, the routing of the ratio net's encoders, and the launch plan.
The kernels themselves run in tests/test_torch_port_cuda.py."""
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from ratio_guided_multimodal_fm_tpu_torch.models import ratio as ratio_mod
from ratio_guided_multimodal_fm_tpu_torch.models.classifiers import (
    MNISTClassifier,
)
from ratio_guided_multimodal_fm_tpu_torch.models.ratio import (
    BatchNorm2d,
    RatioEstimatorMNISTSVHN,
    fuses_bn_silu,
)
from ratio_guided_multimodal_fm_tpu_torch.ops.batchnorm import (
    MAX_C,
    ROWS_PER_PASS,
    batch_norm_silu,
    bn_plan,
    bn_stats_reference,
)
from ratio_guided_multimodal_fm_tpu_torch.ops.groupnorm import NUM_SMS

# The experiment-2 ratio net's 12 BatchNorm sites: (C, H = W)
SITES = {"mnist1": (32, 32), "mnist2": (64, 16), "mnist3": (128, 8),
         "mnist4": (128, 4), "svhn1a": (64, 32), "svhn1b": (64, 32),
         "svhn2a": (128, 16), "svhn2b": (128, 16), "svhn3a": (256, 8),
         "svhn3b": (256, 8), "svhn4a": (256, 4), "svhn4b": (256, 4)}
TOL = {torch.float64: dict(rtol=1e-9, atol=1e-10),
       torch.float32: dict(rtol=1e-4, atol=1e-5)}


def _module(C, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm2d(C, dtype=dtype).to(dtype)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(C, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(C, generator=g) * 0.1)
        bn.running_mean.copy_(torch.randn(C, generator=g) * 0.1)
        bn.running_var.copy_(torch.rand(C, generator=g) + 0.5)
    return bn.train()


def _bn_then_silu(x, bn):
    """silu(BatchNorm2d(x)) in train mode: the module itself in float32,
    its formula written out in float64 (the module computes in float32):
    the E[x²] − E[x]² variance clamped at 0 and the running update."""
    if x.dtype == torch.float32:
        return F.silu(bn(x))
    mean = x.mean(dim=(0, 2, 3))
    var = ((x * x).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
    with torch.no_grad():
        for run, new in ((bn.running_mean, mean), (bn.running_var, var)):
            run.copy_(0.9 * run + 0.1 * new)
        bn.num_batches_tracked.add_(1)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return F.silu((x - mean[:, None, None]) * mul[:, None, None]
                  + bn.bias[:, None, None])


def _compare(x, dy, bn, dtype):
    """The fused op (on the CPU: its plain versions) against autograd of
    silu(BatchNorm2d(x)) (`_bn_then_silu`) on a copy of the module, both in
    `dtype`."""
    fused = _module(bn.num_features, dtype, 0)
    fused.load_state_dict(bn.state_dict())
    xa = x.clone().requires_grad_(True)
    want = _bn_then_silu(xa, bn)
    want_g = torch.autograd.grad(want, (xa, bn.weight, bn.bias), dy)
    xb = x.clone().requires_grad_(True)
    got = batch_norm_silu(xb, fused.weight, fused.bias, fused.running_mean,
                          fused.running_var, fused.num_batches_tracked,
                          fused.eps)
    got_g = torch.autograd.grad(got, (xb, fused.weight, fused.bias), dy)
    tol = TOL[dtype]
    torch.testing.assert_close(got, want, **tol)
    for name, a, b in zip(("dx", "dgamma", "dbeta"), got_g, want_g):
        torch.testing.assert_close(a, b, **tol, msg=name)
    for k in ("running_mean", "running_var"):
        torch.testing.assert_close(getattr(fused, k), getattr(bn, k), **tol)
    assert int(fused.num_batches_tracked) == int(bn.num_batches_tracked) == 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("site", list(SITES))
def test_plain_fused_op_equals_batchnorm_then_silu(site, dtype):
    """At each site's (C, H) at N = 2: y, dx, dγ, dβ, the running
    statistics and num_batches_tracked."""
    C, H = SITES[site]
    g = torch.Generator().manual_seed(C + H)
    x = (torch.randn(2, C, H, H, generator=g) * 2.0 + 0.5).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    dy = torch.randn(2, C, H, H, generator=g).to(dtype)
    _compare(x, dy, _module(C, dtype, C), dtype)


def _clamping_pair():
    """Two float64 values whose E[x²] − E[x]² is negative: with two rows
    every sum is one addition, so BatchNorm2d and the plain version round
    the same way and both clamp."""
    c = 1.0
    while True:
        c = c * 1.0009765625 + 0.123
        x0, x1 = c, c * (1 + 1e-10)
        mean = (x0 + x1) / 2
        if (x0 * x0 + x1 * x1) / 2 - mean * mean < 0:
            return x0, x1


def test_plain_fused_op_at_a_clamped_variance():
    """Channel 1's variance clamps to 0 (rstd saved negated): the backward
    drops the variance term there as autograd of clamp_min does."""
    N, C = 2, 4
    g = torch.Generator().manual_seed(5)
    x = torch.randn(N, C, 1, 1, generator=g, dtype=torch.float64)
    x[:, 1, 0, 0] = torch.tensor(_clamping_pair(), dtype=torch.float64)
    dy = torch.randn(N, C, 1, 1, generator=g, dtype=torch.float64)
    _, rstd, var = bn_stats_reference(x)
    assert rstd[1] < 0 and var[1] == 0 and (rstd[[0, 2, 3]] > 0).all()
    _compare(x, dy, _module(C, torch.float64, 3), torch.float64)


def _spy(monkeypatch):
    calls = []

    def spy(*a, **k):
        calls.append(a[0].shape)
        raise AssertionError("the fused op ran")

    monkeypatch.setattr(ratio_mod, "batch_norm_silu", spy)
    return calls


@pytest.mark.parametrize("case", ["eval", "dp", "cpu"])
def test_encoders_keep_the_plain_path(monkeypatch, case):
    """Eval mode, a data-parallel run and CPU tensors run BatchNorm2d and
    F.silu as before; only float32 CUDA tensors in training fuse."""
    _spy(monkeypatch)
    torch.manual_seed(0)
    net = RatioEstimatorMNISTSVHN()
    net.train(case != "eval")
    if case == "dp":
        for m in net.modules():
            if isinstance(m, BatchNorm2d):
                m.dp = SimpleNamespace(size=1, sum_grad=lambda t: t)
    out = net(torch.randn(2, 1, 32, 32), torch.randn(2, 3, 32, 32))
    assert out.shape == (2,)


def test_routing_rule():
    bn = BatchNorm2d(8).train()
    card = SimpleNamespace(is_cuda=True, dtype=torch.float32)
    assert fuses_bn_silu(bn, card)
    assert not fuses_bn_silu(bn, torch.zeros(1, 8, 2, 2))
    assert not fuses_bn_silu(bn, SimpleNamespace(is_cuda=True,
                                                 dtype=torch.bfloat16))
    assert not fuses_bn_silu(BatchNorm2d(8, dtype=torch.bfloat16), card)
    bn.dp = object()
    assert not fuses_bn_silu(bn, card)
    bn.dp = None
    assert not fuses_bn_silu(bn.eval(), card)


def test_classifiers_keep_batchnorm_then_relu(monkeypatch):
    calls = _spy(monkeypatch)
    clf = MNISTClassifier().train()
    clf(torch.randn(2, 28, 28, 1))        # NHWC, as the JAX classifiers
    assert calls == []


def test_ratio_net_state_dict_keys_unchanged():
    keys = []
    for enc, names in (("encoder_mnist", ["1", "2", "3", "4"]),
                       ("encoder_svhn", [f"{i}{s}" for i in range(1, 5)
                                         for s in "ab"])):
        for nm in names:
            keys += [f"{enc}.conv{nm}.weight", f"{enc}.conv{nm}.bias"]
            keys += [f"{enc}.bn{nm}.{k}" for k in (
                "weight", "bias", "running_mean", "running_var",
                "num_batches_tracked")]
        keys += [f"{enc}.fc.weight", f"{enc}.fc.bias"]
    keys += [f"score_net.{i}.{k}" for i in (0, 1, 4, 5, 8, 9, 11)
             for k in ("weight", "bias")]
    assert list(RatioEstimatorMNISTSVHN().state_dict()) == keys


@pytest.mark.parametrize("B", [128, 127, 1])
@pytest.mark.parametrize("site", list(SITES)[:4] + ["svhn1a", "svhn2a",
                                                   "svhn3a", "svhn4a"])
def test_bn_plan_covers_every_row(site, B):
    """About one reduce CTA an SM, every row in exactly one row block, and
    at most one apply CTA more than the 16-byte vectors ask for."""
    C, H = SITES[site]
    rows = B * H * H
    p = bn_plan(rows, C)
    assert p.slices == -(-C // 32)
    assert p.slices * p.row_blocks <= NUM_SMS + p.slices
    assert p.row_blocks <= -(-rows // ROWS_PER_PASS)
    R = -(-rows // p.row_blocks)
    covered = sorted(r for rb in range(p.row_blocks)
                     for r in range(rb * R, min(rows, rb * R + R)))
    assert covered == list(range(rows))
    assert (p.apply_grid - 1) * 256 * 4 < rows * C


@pytest.mark.parametrize("rows,C", [(0, 32), (10, 30), (10, MAX_C + 4),
                                    (2**25, 64)])
def test_bn_plan_refuses_shapes_the_kernels_do_not_take(rows, C):
    with pytest.raises(ValueError):
        bn_plan(rows, C)
