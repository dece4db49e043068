"""The frozen counts of portbench/harness/counts.py: equal to the port's
core/flops.py wherever both count, and to the MACs that the port's own
nets perform, counted by forward hooks."""
import json
import types

import pytest
import torch

import kind_encdec
from conftest import ROOT
from portbench.harness import counts
from ratio_guided_multimodal_fm_tpu_torch import models
from ratio_guided_multimodal_fm_tpu_torch.core import flops

CONFIGS = {n: json.loads((ROOT / "portbench" / "configs" / f"{n}.json")
                         .read_text())
           for n in ("exp2_mnist32_svhn", "exp1_mnist28_rot90")}


def _nets():
    for cname, conf in CONFIGS.items():
        for role, net in conf["nets"].items():
            yield pytest.param(net, id=f"{cname}.{role}")


def test_sampler_call_equals_core_flops():
    e2 = CONFIGS["exp2_mnist32_svhn"]["nets"]
    fx = lambda b: counts.net_flops("unet", e2["flow_x"]["arch"], b)  # noqa
    fy = lambda b: counts.net_flops("unet", e2["flow_y"]["arch"], b)  # noqa
    got = counts.pair_sampler_flops(fx, fy, 512, 256, 100, 32 * 32 * 4)
    assert got == flops.guided_sampler_flops(512, 256, 100)
    assert round(got / 1e12, 1) == 269.3
    e1 = CONFIGS["exp1_mnist28_rot90"]["nets"]["flow_x"]["arch"]
    f1 = lambda b: counts.net_flops("unet", e1, b)  # noqa
    got = counts.pair_sampler_flops(f1, f1, 512, 256, 100, 1568)
    want = flops.pair_sampler_flops(
        lambda b: flops.mnist_unet_flops(b, 28),
        lambda b: flops.mnist_unet_flops(b, 28), 512, 256, 100, 1568)
    assert got == want
    assert round(got / 1e12, 2) == 79.48


@pytest.mark.parametrize("net", _nets())
def test_net_flops_equal_hooked_macs(net):
    """2 × the MACs of every conv and Linear of the port's net at batch 1."""
    with torch.device("meta"):
        m = getattr(models, net["port"])(**net.get("port_kwargs", {}))
    m = m.to_empty(device="cpu").eval()
    total = [0.0]

    def hook(mod, inp, out):
        w = mod.weight
        if isinstance(mod, torch.nn.Conv2d):
            total[0] += 2.0 * out[0].numel() * w[0].numel()
        else:
            total[0] += 2.0 * out[0].numel() * w.shape[1]

    for mod in m.modules():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
            mod.register_forward_hook(hook)
    if net["kind"] == "unet":
        h, c = net["arch"]["img_size"], net["arch"]["in_channels"]
        with torch.no_grad():
            m(torch.zeros(1, c, h, h), torch.zeros(1))
    else:
        h = net["arch"]["img_size"]
        cx, cy = ((net["arch"]["x_channels"], net["arch"]["y_channels"])
                  if net["kind"] == "ratio_gn" else (1, 3))
        with torch.no_grad():
            m(torch.zeros(1, cx, h, h), torch.zeros(1, cy, h, h))
    assert counts.net_flops(net["kind"], net["arch"], 1) == total[0]


@pytest.mark.parametrize("net", _nets())
def test_gn_sites_are_the_nets_groupnorm_modules(net):
    """One site per GroupNormSiLU module, at its channels and map size."""
    with torch.device("meta"):
        m = getattr(models, net["port"])(**net.get("port_kwargs", {}))
    m = m.to_empty(device="cpu").eval()
    seen = []
    for mod in m.modules():
        if type(mod).__name__ == "GroupNormSiLU":
            mod.register_forward_hook(
                lambda mod, inp, out: seen.append((out.shape[1],
                                                   out.shape[2])))
    h = net["arch"]["img_size"]
    with torch.no_grad():
        if net["kind"] == "unet":
            m(torch.zeros(1, net["arch"]["in_channels"], h, h),
              torch.zeros(1))
        elif net["kind"] == "ratio_gn":
            m(torch.zeros(1, 1, h, h), torch.zeros(1, 1, h, h))
        else:
            m(torch.zeros(1, 1, h, h), torch.zeros(1, 3, h, h))
    assert sorted(counts.net_gn_sites(net["kind"], net["arch"])) \
        == sorted(seen)
    want = {"unet": {32: 25, 64: 35}, "ratio_gn": None, "ratio_bn": None}
    if net["kind"] == "unet":
        assert len(seen) == want["unet"][net["arch"]["model_channels"]]


def test_gn_bytes():
    """x read and y written once (+ weight and bias); the backward reads
    x, dy, mean, rstd, weight, bias and writes dx, dγ, dβ once."""
    assert counts.gn_forward_bytes([(64, 32)], 512, 2) == \
        2 * 512 * 64 * 32 * 32 * 2 + 2 * 64 * 4
    assert counts.gn_backward_bytes([(192, 32)], 128, 4) == \
        3 * 128 * 192 * 32 * 32 * 4 + 2 * 128 * 8 * 4 + 4 * 192 * 4


def test_params_match_published_counts():
    from portbench.reference.nets import param_count
    for conf in CONFIGS.values():
        for net in conf["nets"].values():
            assert param_count(net["kind"], net["arch"]) == net["params"]


def test_kind_fixture_flops_equal_hooked_macs():
    """The kind fixture's `flops(arch, 1)`: 2 × the MACs of every
    Conv2d, ConvTranspose2d (k·k·cout a pixel and channel in) and Linear
    of the port's FlowMatchingModel at batch 1, and the port's own count."""
    with torch.device("meta"):
        m = models.FlowMatchingModel()
    m = m.to_empty(device="cpu").eval()
    total = [0.0]

    def hook(mod, inp, out):
        w = mod.weight
        if isinstance(mod, torch.nn.ConvTranspose2d):
            total[0] += 2.0 * inp[0][0].numel() * w[0].numel()
        elif isinstance(mod, torch.nn.Conv2d):
            total[0] += 2.0 * out[0].numel() * w[0].numel()
        else:
            total[0] += 2.0 * out[0].numel() * w.shape[1]

    kinds = (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear)
    hooked = [mod.register_forward_hook(hook) for mod in m.modules()
              if isinstance(mod, kinds)]
    assert len(hooked) == 10
    with torch.no_grad():
        m(torch.zeros(1, 1, 28, 28), torch.zeros(1))
    arch = {"img_channels": 1, "img_size": 28, "feature_dim": 256,
            "time_emb_dim": 128, "norm_eps": 1e-6}
    assert kind_encdec.flops(arch, 1) == total[0]
    assert kind_encdec.flops(arch, 3) == flops.flow_matching_model_flops(3)


@pytest.mark.parametrize("cname", sorted(CONFIGS))
def test_sampler_work_counts_the_flows_as_unets(cname):
    """`drivers/sample.py:work` takes each flow's FLOPs by its own kind:
    for both configurations that is `pair_sampler_flops` with "unet"
    (plus the ratio net's terminal scores), as before."""
    from portbench.drivers import sample

    conf = CONFIGS[cname]
    traffic = json.loads((ROOT / "portbench" / "traffic"
                          / "sample.mcfeng.b512.json").read_text())
    drv = sample.Driver(conf, traffic, 7, torch.device("cpu"))
    work = drv.work(types.SimpleNamespace(rate=1.0))
    n = conf["nets"]
    d = sum(s[0] * s[1] * s[2] for s in (n["flow_x"]["shape"],
                                         n["flow_y"]["shape"]))
    want = counts.pair_sampler_flops(
        lambda b: counts.net_flops("unet", n["flow_x"]["arch"], b),
        lambda b: counts.net_flops("unet", n["flow_y"]["arch"], b),
        drv.B, drv.N, drv.steps, d)
    want += counts.net_flops(n["ratio"]["kind"], n["ratio"]["arch"], drv.N)
    assert work["flops_per_unit"] * drv.B == want
