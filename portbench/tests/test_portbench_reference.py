"""The plain reference against the port on the CPU, at a tiny batch: the
published state-dict layout, every net's forward, the guidance step, the
training steps' dropout masks and losses; and the controls' rounding."""
import json

import numpy as np
import pytest
import torch

from conftest import ROOT
from portbench.drivers import common
from portbench.harness.weights import make_params
from portbench.reference import nets, precision, sampler, train
from ratio_guided_multimodal_fm_tpu_torch.ops import guidance as port_guidance
from ratio_guided_multimodal_fm_tpu_torch.train import steps

CPU = torch.device("cpu")
CONFIGS = [json.loads((ROOT / "portbench" / "configs" / f"{n}.json")
                      .read_text())
           for n in ("exp2_mnist32_svhn", "exp1_mnist28_rot90")]
NETS = [pytest.param(c, r, id=f"{c['name']}.{r}") for c in CONFIGS
        for r in c["nets"]]


def _inputs(conf, role, B=2):
    g = torch.Generator().manual_seed(5)
    net = conf["nets"][role]
    if net["kind"] == "unet":
        h, c = net["arch"]["img_size"], net["arch"]["in_channels"]
        return (torch.randn(B, c, h, h, generator=g),
                torch.rand(B, generator=g))
    shapes = [conf["nets"][r]["shape"] for r in ("flow_x", "flow_y")]
    return tuple(torch.randn((B, s[2], s[0], s[1]), generator=g)
                 for s in shapes)


@pytest.mark.parametrize("conf,role", NETS)
def test_forward_equals_the_port(conf, role):
    net = conf["nets"][role]
    P = make_params(net["kind"], net["arch"], 11, CPU)
    port = common.port_net(net, "float32", P, CPU).eval()
    ref = nets.Net(net["kind"], net["arch"],
                   make_params(net["kind"], net["arch"], 11, CPU))
    a, b = _inputs(conf, role)
    with torch.no_grad():
        want = port(a, b)
        got = ref(a, b)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_guidance_equals_the_ports_plain_version():
    g = torch.Generator().manual_seed(3)
    x, y = torch.randn(3, 4, 4, 1, generator=g), torch.randn(3, 4, 4, 3,
                                                             generator=g)
    X1, Y1 = torch.randn(5, 4, 4, 1, generator=g), torch.randn(
        5, 4, 4, 3, generator=g)
    lr = torch.randn(5, generator=g)
    for t in (0.3, 0.9):
        gx, gy, ess = sampler.guidance(x, y, X1, Y1, lr, t)
        px, py, pess, _ = port_guidance.flash_guidance_reference(
            x, y, X1, Y1, lr, t)
        torch.testing.assert_close(gx.float(), px, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(gy.float(), py, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(ess.float(), pess, rtol=1e-4, atol=1e-4)


def test_train_step_masks_and_loss_equal_the_port():
    conf = CONFIGS[0]
    net = conf["nets"]["flow_x"]
    P = make_params(net["kind"], net["arch"], 2, CPU)
    state = steps.create_fm_state(common.port_net(net, "float32", P, CPU),
                                  CPU, lr=1e-4, ema_decay=0.999)
    x1 = torch.rand(3, 32, 32, 1, generator=torch.Generator().manual_seed(1))
    loss = steps.make_fm_train_step(0.999)(
        state, x1, torch.Generator().manual_seed(77))
    ref = nets.Net(net["kind"], net["arch"],
                   make_params(net["kind"], net["arch"], 2, CPU))
    train.seed_dropout(CPU, train.dropout_seed(77))
    want = train.cfm_loss(ref, x1, torch.Generator().manual_seed(77))
    assert float(loss) == pytest.approx(float(want), rel=1e-6)


def test_rounders():
    x = torch.linspace(-3, 3, 1001)
    e8 = (precision._fp8(x) - x).abs().max() / 3
    e32 = (precision._tf32(x) - x).abs().max() / 3
    eb = (x.to(torch.bfloat16).float() - x).abs().max() / 3
    assert e8 > 4 * eb > 0
    assert 0 < e32 < eb
    assert precision.rounder("fp32", CPU) is None
    old = torch.backends.cudnn.allow_tf32
    with precision.tf32_scope("tf32"):
        assert torch.backends.cudnn.allow_tf32
    with precision.tf32_scope("fp32"):
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32 == old


def test_uniform_grid_is_float32():
    ts, dt = sampler.grid(100)
    assert ts.dtype == np.float32 and dt == np.float32(0.01)
    assert ts[37] == np.float32(37) * np.float32(0.01)
