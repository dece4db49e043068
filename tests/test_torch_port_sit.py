"""SiT (models/sit.py) against the benchmark's plain reference
(portbench/reference/kinds/sit_transformer.py) on the CPU, at a small size
on seeded random weights; SiT-XL/2's layout and size on `meta`; the
class-conditional fused trainer; the pinned attention's counters; the
train CLI on a tiny latents file.

Tolerances: float32 on both sides, the same products in other orders (the
math attention backend scales q and k each by d^-1/4 where the reference
scales q by d^-1/2; LayerNorm and the GEMMs are the same calls): outputs
of size ~3 agree to ~1e-6, so 1e-5 absolute; gradients within 1e-4 of
each leaf's largest reference gradient (the backward sums B·N terms in
another order). The fused step against the single steps takes the same
calls in the same order: bit for bit.
"""
import math
import pathlib

import numpy as np
import pytest
import torch

from portbench.harness.weights import make_params
from portbench.reference import nets
from portbench.reference.kinds import sit_transformer as kind
from ratio_guided_multimodal_fm_tpu_torch.core.prng import derive_seed
from ratio_guided_multimodal_fm_tpu_torch.models import SiT, SiT_S_2, SiT_XL_2
from ratio_guided_multimodal_fm_tpu_torch.ops import launch_counts
from ratio_guided_multimodal_fm_tpu_torch.train import steps as S

torch.set_num_threads(1)

CPU = torch.device("cpu")
TINY = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=96,
            depth=2, num_heads=4, mlp_ratio=4.0, class_dropout_prob=0.1,
            num_classes=10, learn_sigma=True)
XL = dict(TINY, input_size=32, hidden_size=1152, depth=28, num_heads=16,
          num_classes=1000)
S2 = dict(XL, hidden_size=384, depth=12, num_heads=6)


def _pair(arch, seed=5):
    """The port's SiT (built on meta, then loaded) and the reference net,
    on the same weights."""
    P = make_params("sit_transformer", arch, seed, CPU)
    with torch.device("meta"):
        m = SiT(**arch)
    m = m.to_empty(device=CPU)
    m.load_state_dict(P, strict=True)
    return m, nets.Net("sit_transformer", arch,
                       {k: v.clone() for k, v in P.items()})


def _inputs(B=5, arch=TINY, seed=0):
    g = torch.Generator().manual_seed(seed)
    n, c = arch["input_size"], arch["in_channels"]
    return (torch.randn(B, c, n, n, generator=g), torch.rand(B, generator=g),
            torch.randint(0, arch["num_classes"], (B,), generator=g))


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_the_reference(train):
    m, net = _pair(TINY)
    x, t, y = _inputs()
    m.train(train)
    torch.manual_seed(3)          # the label drop's draws, in train mode
    got = m(x, t, y)
    torch.manual_seed(3)
    want = net(x, (t, y), train=train)
    assert got.shape == (5, 4, 8, 8)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    if train:    # some label dropped to the null class: another output
        torch.manual_seed(3)
        drops = torch.rand(5) < TINY["class_dropout_prob"]
        torch.manual_seed(4)
        assert drops.any() != torch.equal(got, m(x, t, y))


def test_every_gradient_matches_the_reference():
    m, net = _pair(TINY)
    x, t, y = _inputs()
    r = torch.randn(5, 4, 8, 8, generator=torch.Generator().manual_seed(1))
    m.train()
    torch.manual_seed(3)
    (m(x, t, y) * r).sum().backward()
    keys = net.trainable()
    for k in keys:
        net.P[k].requires_grad_(True)
    torch.manual_seed(3)
    grads = torch.autograd.grad((net(x, (t, y), train=True) * r).sum(),
                                [net.P[k] for k in keys])
    got = dict(m.named_parameters())
    for k, want in zip(keys, grads):
        scale = float(want.abs().max())
        assert scale > 0, k
        torch.testing.assert_close(got[k].grad, want, rtol=0,
                                   atol=1e-4 * scale, msg=k)


def test_sit_xl_2_is_the_layout_at_its_published_size():
    with torch.device("meta"):
        m = SiT_XL_2()
    sd = m.state_dict()
    assert [(k, tuple(v.shape)) for k, v in sd.items()] == [
        (k, tuple(s)) for k, s in kind.layout(XL)]
    assert sum(p.numel() for p in m.parameters()) == 674_834_720
    assert nets.param_count("sit_transformer", XL) == 674_834_720
    assert "pos_embed" not in sd and m.pos_embed.shape == (1, 256, 1152)


def _published_pos_embed(dim, grid):
    """SiT's get_2d_sincos_pos_embed, as its models.py writes it."""
    def one_d(d, pos):
        omega = np.arange(d // 2, dtype=np.float64)
        omega /= d / 2.
        omega = 1. / 10000 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    g = np.meshgrid(np.arange(grid, dtype=np.float32),
                    np.arange(grid, dtype=np.float32))
    g = np.stack(g, axis=0).reshape([2, 1, grid, grid])
    return np.concatenate([one_d(dim // 2, g[0]), one_d(dim // 2, g[1])],
                          axis=1)


def test_the_position_table_is_built_after_to_empty_and_a_strict_load():
    """SiT-S/2 (33M parameters, SiT-XL/2's grid of 16 × 16 patches)."""
    P = make_params("sit_transformer", S2, 1, CPU)
    with torch.device("meta"):
        m = SiT_S_2()
    m = m.to_empty(device=CPU)
    m.load_state_dict(P, strict=True)
    want = torch.from_numpy(_published_pos_embed(384, 16)).float()
    assert torch.equal(m.pos_embed[0], want)
    assert torch.equal(kind.pos_table(384, 16), want)


def test_the_forward_counts_one_math_attention_call_a_block():
    m, _ = _pair(TINY)
    before = launch_counts()
    m(*_inputs())
    after = launch_counts()
    assert after["sdpa.math_launches"] - before["sdpa.math_launches"] == 2
    assert after["sdpa.efficient_launches"] == before["sdpa.efficient_launches"]


def test_flops_count_every_product():
    """2 × the MACs of every Linear and the patch convolution (forward
    hooks on the port's net, on meta at SiT-XL/2) plus the attention's
    two products; 237,242,843,136 and 8,455,716,864 FLOP a latent."""
    def counted(arch):
        with torch.device("meta"):
            m = SiT(**arch)
            macs = []

            def hook(mod, inp, out):
                w = mod.weight
                macs.append(out.numel() * w[0].numel())
            for mod in m.modules():
                if isinstance(mod, (torch.nn.Linear, torch.nn.Conv2d)):
                    mod.register_forward_hook(hook)
            m(*(t.to("meta") for t in _inputs(2, arch)))
        n = (arch["input_size"] // arch["patch_size"]) ** 2
        attn = 2 * 2 * arch["depth"] * 2 * n * n * arch["hidden_size"]
        return 2 * sum(macs) + attn, attn        # at a batch of 2

    for arch in (TINY, XL):
        total, attn = counted(arch)
        assert kind.flops(arch, 2) == total
        assert kind.attn_flops(arch, 2) == attn
    assert kind.flops(XL, 1) == 237_242_843_136
    assert kind.attn_flops(XL, 1) == 8_455_716_864


def _state(cond, seed=0):
    """SiT at TINY (class-conditional) or a small U-Net with dropout
    (unconditional), moved off their initial values so every leaf moves."""
    from ratio_guided_multimodal_fm_tpu_torch.models.unet import FlexibleUNet

    torch.manual_seed(seed)
    model = SiT(**TINY) if cond else FlexibleUNet(
        in_channels=4, img_size=8, model_channels=8, channel_mult=(1, 2),
        num_res_blocks=1, dropout=0.1)
    with torch.no_grad():           # off SiT's zero init: every leaf moves
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.05)
    return S.create_fm_state(model, CPU, lr=1e-3, ema_decay=0.9999)


@pytest.mark.parametrize("cond", [True, False],
                         ids=["sit_labels", "unet_no_labels"])
def test_the_fused_step_is_k_single_steps(cond):
    """K = 2 sub-steps of the fused trainer (graph=False) equal the single
    step taken twice on the same rows, labels and draws, with the default
    generator seeded once, as the fused step seeds it: with labels through
    SiT, and without them (labels=None, the unconditional nets' path)
    through a U-Net whose dropout reads the same generator."""
    g = torch.Generator().manual_seed(2)
    data = torch.randn(32, 8, 8, 4, generator=g)
    labels = torch.randint(0, 10, (32,), generator=g) if cond else None
    idx = torch.randint(0, 32, (2, 4), generator=g, dtype=torch.int32)
    fused, single = _state(cond), _state(cond)
    loss = S.make_fm_train_multistep(0.9999, graph=False)(
        fused, data, idx, torch.Generator().manual_seed(9), labels=labels)
    step = S.make_fm_train_step(0.9999)
    t = torch.empty(2, 4)
    x0 = torch.empty(2, 4, 8, 8, 4)
    S._draw_fm(9, t, x0)
    S._seed_dropout(CPU, derive_seed(9, 1))
    losses = [step(single, data[idx[j].long()], None, t=t[j], x0=x0[j],
                   y=None if labels is None else labels[idx[j].long()])
              for j in range(2)]
    assert torch.equal(loss, torch.stack(losses).mean())
    for (k, a), b in zip(fused.model.named_parameters(),
                         single.model.parameters()):
        assert torch.equal(a, b), k
    for k in fused.ema:
        assert torch.equal(fused.ema[k], single.ema[k]), k


def test_the_train_cli_takes_sit_s_2_on_a_latents_file(tmp_path, monkeypatch,
                                                        capsys):
    from ratio_guided_multimodal_fm_tpu_torch.cli import train_flow

    rng = np.random.default_rng(0)
    np.savez(tmp_path / "lat.npz",
             latents=rng.uniform(-1, 1, (4, 32, 32, 4)).astype(np.float32),
             labels=rng.integers(0, 1000, 4))
    monkeypatch.chdir(tmp_path)
    state, best, history = train_flow.main(
        ["--model", "sit_s_2", "--latents", "lat.npz", "--batch_size", "2",
         "--epochs", "1", "--device", "cpu", "--ema_decay", "0.9999"])
    out = capsys.readouterr().out
    assert "4 latents" in out
    assert "Fused dispatch: 1 steps/program, 2 programs/epoch" in out
    assert isinstance(state.model, SiT) and len(history) == 1
    assert math.isfinite(best)
    ckpt = pathlib.Path("checkpoints")
    assert (ckpt / "flow_sit_s_2_best.pth").is_file()
    assert (ckpt / "flow_sit_s_2_ema_best.pth").is_file()
    with pytest.raises(SystemExit):
        train_flow.main(["--model", "sit_s_2", "--device", "cpu"])
    with pytest.raises(SystemExit):
        train_flow.main(["--model", "unet", "--device", "cpu"])
