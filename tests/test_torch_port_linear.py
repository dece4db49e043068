"""ops/linear.py on the CPU: the plain versions of the 3×TF32 linear layer,
its launch plan, and which layers route to it.

The kernels (csrc/linear_tf32x3.cu) run only on the card
(tests/test_torch_port_cuda.py). Here the same autograd Function runs its
plain versions: the forward is F.linear, the backward dy·W, dyᵀ·x and a
sum over rows, held to F.linear's own autograd. The plan's accepted and
refused shapes are those `linear_tf32x3`'s docstring states. SiT's four
token projections are `TokenLinear`, every other linear of the port's nets
stays `layers.Linear`, and SiT's state-dict keys are SiT's own.
"""
import pytest
import torch
import torch.nn.functional as F

from ratio_guided_multimodal_fm_tpu_torch import models
from ratio_guided_multimodal_fm_tpu_torch.models import layers
from ratio_guided_multimodal_fm_tpu_torch.models import sit as sit_mod
from ratio_guided_multimodal_fm_tpu_torch.ops import launch_counts
from ratio_guided_multimodal_fm_tpu_torch.ops.linear import (
    GemmPlan,
    linear_plan,
    linear_tf32x3,
)

TINY = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=96,
            depth=2, num_heads=4, num_classes=10)
# SiT-XL/2's token projections (K, N) and the CPU-size SiT's
XL = {"qkv": (1152, 3456), "proj": (1152, 1152), "fc1": (1152, 4608),
      "fc2": (4608, 1152)}
SMALL = {"qkv": (96, 288), "proj": (96, 96), "fc1": (96, 384),
         "fc2": (384, 96)}


def _operands(shape, K, N, bias, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(*shape, K, generator=g, requires_grad=True)
    w = torch.randn(N, K, generator=g, requires_grad=True)
    b = torch.randn(N, generator=g, requires_grad=True) if bias else None
    return x, w, b


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("shape", [(37,), (3, 16), (2, 5, 7)])
@pytest.mark.parametrize("site", sorted(SMALL))
def test_plain_forward_and_backward_equal_f_linear(site, shape, bias):
    K, N = SMALL[site]
    x, w, b = _operands(shape, K, N, bias)
    got = linear_tf32x3(x, w, b)
    x2, w2, b2 = (None if t is None else t.detach().clone().requires_grad_()
                  for t in (x, w, b))
    want = F.linear(x2, w2, b2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    dy = torch.randn_like(want)
    got.backward(dy)
    want.backward(dy)
    torch.testing.assert_close(x.grad, x2.grad)
    torch.testing.assert_close(w.grad, w2.grad)
    if bias:
        torch.testing.assert_close(b.grad, b2.grad)


def test_plain_backward_skips_what_needs_no_gradient():
    x, w, b = _operands((9,), 8, 12, True)
    x = x.detach()
    linear_tf32x3(x, w, b).sum().backward()
    assert x.grad is None
    torch.testing.assert_close(w.grad, torch.ones(12, 9) @ x)
    torch.testing.assert_close(b.grad, torch.full((12,), 9.0))


@pytest.mark.parametrize("M", [8192, 8190])
@pytest.mark.parametrize("site", sorted(XL))
def test_plan_at_the_sit_xl_shapes(site, M):
    """forward x·Wᵀ over K; dgrad dy·W over N (Wᵀ split); wgrad over M,
    splitting the narrower of x and dy, the product stored as dW or dWᵀ."""
    K, N = XL[site]
    p = linear_plan(M, N, K)
    assert p["forward"] == GemmPlan(M, N, K, False, False, "weight", False)
    assert p["dgrad"] == GemmPlan(M, K, N, False, False, "weight", True)
    if K <= N:
        assert p["wgrad"] == GemmPlan(N, K, M, True, False, "x", True)
    else:
        assert p["wgrad"] == GemmPlan(K, N, M, True, True, "dy", True)
    # the pre-pass transposes the 1,152-wide operand at every site
    wg = p["wgrad"]
    split_width = K if wg.split == "x" else N
    assert split_width == 1152


@pytest.mark.parametrize("M,N,K", [(16, 4, 4), (127, 96, 96), (128, 288, 96),
                                   (8191, 4608, 1152), (17, 12, 4000),
                                   (65535 * 128, 4, 4), (16, 2**20, 4)])
def test_plan_accepts(M, N, K):
    assert set(linear_plan(M, N, K)) == {"forward", "dgrad", "wgrad"}


@pytest.mark.parametrize("M,N,K", [(0, 96, 96), (1, 96, 96), (15, 96, 96),
                                   (16, 98, 96), (16, 96, 94),
                                   (16, 2, 96), (16, 96, 0), (2**20, 2**11, 8),
                                   (16, 2**16, 2**15), (65535 * 128 + 1, 4, 4),
                                   (16, 2**20 + 4, 4), (16, 4, 2**20 + 4)])
def test_plan_raises(M, N, K):
    with pytest.raises(ValueError, match="no plan"):
        linear_plan(M, N, K)


def test_wrapper_raises_on_mismatched_operands():
    x = torch.randn(4, 96)
    with pytest.raises(ValueError, match="does not take"):
        linear_tf32x3(x, torch.randn(288, 95))
    with pytest.raises(ValueError, match="bias"):
        linear_tf32x3(x, torch.randn(288, 96), torch.randn(96))


def test_the_plain_path_counts_no_launch():
    before = launch_counts()
    linear_tf32x3(torch.randn(4, 96), torch.randn(288, 96)).sum()
    after = launch_counts()
    assert after["linear_tf32x3.launches"] == before["linear_tf32x3.launches"]
    assert (after["linear_tf32x3.split_launches"]
            == before["linear_tf32x3.split_launches"])


def test_sit_s2_token_projections_are_token_linear():
    """qkv, proj, fc1 and fc2 of every block; every other linear of SiT
    (adaLN, the time MLP, the final layer) is exactly layers.Linear."""
    with torch.device("meta"):
        m = models.SiT_S_2()
    token = {f"blocks.{i}.{n}" for i in range(12)
             for n in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")}
    seen = set()
    for name, mod in m.named_modules():
        if isinstance(mod, torch.nn.Linear):
            if name in token:
                assert type(mod) is sit_mod.TokenLinear, name
                seen.add(name)
            else:
                assert type(mod) is layers.Linear, name
    assert seen == token


@pytest.mark.parametrize("make", [
    models.FlowMatchingUNetMNIST, models.FlowMatchingUNetSVHN,
    models.FlowMatchingUNet, models.FlowMatchingUNet64,
    models.RatioEstimatorMNIST, models.RatioEstimatorMNISTSVHN,
    models.FlowMatchingModel])
def test_other_nets_keep_layers_linear(make):
    with torch.device("meta"):
        net = make()
    lins = [m for m in net.modules() if isinstance(m, torch.nn.Linear)]
    assert lins
    assert not any(isinstance(m, sit_mod.TokenLinear) for m in lins)


def _sit_keys(depth):
    keys = ["x_embedder.proj.weight", "x_embedder.proj.bias",
            "t_embedder.mlp.0.weight", "t_embedder.mlp.0.bias",
            "t_embedder.mlp.2.weight", "t_embedder.mlp.2.bias",
            "y_embedder.embedding_table.weight"]
    for i in range(depth):
        for n in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2",
                  "adaLN_modulation.1"):
            keys += [f"blocks.{i}.{n}.weight", f"blocks.{i}.{n}.bias"]
    keys += ["final_layer.linear.weight", "final_layer.linear.bias",
             "final_layer.adaLN_modulation.1.weight",
             "final_layer.adaLN_modulation.1.bias"]
    return keys


def test_sit_state_dict_keys_and_a_strict_load_are_unchanged():
    torch.manual_seed(0)
    a = models.SiT(**TINY)
    torch.manual_seed(1)
    b = models.SiT(**TINY)
    sd = a.state_dict()
    assert list(sd) == _sit_keys(TINY["depth"])
    b.load_state_dict(sd, strict=True)
    for k, v in b.state_dict().items():
        assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("dtype,calls", [(torch.float32, 4 * 2),
                                         (torch.bfloat16, 0)])
def test_token_linear_routes_by_dtype(monkeypatch, dtype, calls):
    """In float32 each block's four projections call linear_tf32x3; in
    bfloat16 none does (layers.Linear's F.linear)."""
    seen = []

    def counted(x, w, b=None):
        seen.append(tuple(w.shape))
        return F.linear(x, w, b)

    monkeypatch.setattr(sit_mod, "linear_tf32x3", counted)
    torch.manual_seed(0)
    m = models.SiT(**TINY, dtype=dtype)
    x = torch.randn(2, 4, 8, 8)
    out = m(x, torch.rand(2), torch.randint(0, 10, (2,)))
    assert out.dtype == dtype
    assert len(seen) == calls
    if calls:
        assert set(seen) == {(288, 96), (96, 96), (384, 96), (96, 384)}


def test_token_linear_equals_layers_linear_in_float32():
    torch.manual_seed(0)
    tok = sit_mod.TokenLinear(96, 288)
    lin = layers.Linear(96, 288)
    lin.load_state_dict(tok.state_dict())
    x = torch.randn(2, 16, 96, requires_grad=True)
    x2 = x.detach().clone().requires_grad_()
    y, y2 = tok(x), lin(x2)
    torch.testing.assert_close(y, y2, rtol=0, atol=0)
    dy = torch.randn_like(y)
    y.backward(dy)
    y2.backward(dy)
    torch.testing.assert_close(x.grad, x2.grad)
    torch.testing.assert_close(tok.weight.grad, lin.weight.grad)
    torch.testing.assert_close(tok.bias.grad, lin.bias.grad)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("role", ["forward", "dgrad", "wgrad"])
@pytest.mark.parametrize("M,K,N", [(16, 100, 36), (17, 36, 100),
                                   (37, 96, 288)])
def test_bench_role_calls_run_the_wrapper(M, K, N, role, bias):
    """cli/linear_kernel_bench.py's role calls, which the card tests and
    the bench share: the kernel call goes through `linear_tf32x3` (and its
    Function's backward for dgrad and wgrad), here its plain versions,
    and equals the library product; the float64 product is near both;
    rerunning the backward call gives the same result."""
    from ratio_guided_multimodal_fm_tpu_torch.cli import (
        linear_kernel_bench as LB,
    )

    x, w, dy = LB.operands(M, K, N, torch.device("cpu"))
    b = torch.randn(N) if bias and role == "forward" else None
    kernel, library, exact = LB.role_calls(role, x, w, dy, b)
    got = kernel()
    assert not got.requires_grad
    torch.testing.assert_close(got, library(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got.double(), exact(), rtol=1e-5, atol=1e-5)
    assert torch.equal(kernel(), got)
    errs = LB.role_errors((kernel, library, exact))
    assert set(errs) == {"kernel", "float32", "tf32"}


@pytest.mark.parametrize("errs,holds", [
    (dict(kernel=1e-6, float32=1e-6, tf32=1e-3), True),
    (dict(kernel=3e-6, float32=1e-6, tf32=1e-3), True),
    (dict(kernel=3.1e-6, float32=1e-6, tf32=1e-3), False),
    (dict(kernel=1e-6, float32=1e-6, tf32=5e-6), False)])
def test_bench_check_role_is_the_3xtf32_rule(errs, holds):
    """Within 3× the float32 product's max |err| and under a tenth of the
    TF32 product's, else AssertionError."""
    from ratio_guided_multimodal_fm_tpu_torch.cli import (
        linear_kernel_bench as LB,
    )

    if holds:
        LB.check_role("site", "forward", errs)
    else:
        with pytest.raises(AssertionError, match="3x float32"):
            LB.check_role("site", "forward", errs)
