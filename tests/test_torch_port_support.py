"""The PyTorch port's support modules against the JAX package, on the CPU.

* core/flops.py: every count of the JAX package's core/flops.py equal to
  it (the cases of tests/test_flops.py and a grid around them); the
  encoder-decoder's and the 64-px U-Net's counts equal to 2 × the MACs
  that forward hooks count on the port's own modules;
* core/observability.py: MetricsLogger's JSONL records with the JAX
  logger's keys, profile_trace's Chrome trace and its spans' trace (the
  recorder itself: tests/test_torch_port_spans.py);
* train_flow --metrics_dir and --profile_dir: one JSONL line per epoch
  with the keys the JAX CLI writes, a trace file and a spans file holding
  each epoch step's train.fm.call.
"""
import json
import os

import numpy as np
import pytest
import torch

from ratio_guided_multimodal_fm_tpu.core import flops as jflops
from ratio_guided_multimodal_fm_tpu.core import observability as jobs
from ratio_guided_multimodal_fm_tpu_torch.cli import train_flow
from ratio_guided_multimodal_fm_tpu_torch.core import flops as pflops
from ratio_guided_multimodal_fm_tpu_torch.core import observability as pobs
from ratio_guided_multimodal_fm_tpu_torch.models import (
    FlexibleUNet,
    FlowMatchingModel,
)

torch.set_num_threads(2)


@pytest.mark.parametrize("batch", [1, 64, 256, 512])
def test_unet_counts_equal_jax(batch):
    assert pflops.mnist_unet_flops(batch) == jflops.mnist_unet_flops(batch)
    assert pflops.mnist_unet_flops(batch, 28) == jflops.mnist_unet_flops(
        batch, 28)
    assert pflops.svhn_unet_flops(batch) == jflops.svhn_unet_flops(batch)
    for args in ((32, 1, 32, (1, 2)), (32, 3, 64, (1, 2, 2)),
                 (64, 3, 96, (1, 2, 2, 4)), (16, 1, 8, (1, 2), 1)):
        assert pflops.flexible_unet_flops_per_call(batch, *args) == \
            jflops.flexible_unet_flops_per_call(batch, *args)


@pytest.mark.parametrize("with_phase_a", [True, False])
def test_sampler_count_equals_jax(with_phase_a):
    for b, n, s in ((512, 256, 100), (64, 128, 20), (8, 16, 3)):
        assert pflops.guided_sampler_flops(b, n, s, with_phase_a) == \
            jflops.guided_sampler_flops(b, n, s, with_phase_a)
    with_a = pflops.guided_sampler_flops(512, 256, 100, True)
    without = pflops.guided_sampler_flops(512, 256, 100, False)
    assert 1.3 < with_a / without < 1.7


def test_known_magnitudes():
    assert 1.3e12 < pflops.svhn_unet_flops(512) < 1.6e12
    assert 0.30e12 < pflops.mnist_unet_flops(512) < 0.40e12
    # one 64-px guided chunk at the demo's sizes: ~1.09 PFLOP of convs
    chunk = pflops.unet64_flops(1) * 2 * (128 + 64) * 100
    assert 1.05e15 < chunk < 1.15e15


def _hook_flops(net, *inputs):
    """2 × the MACs of every conv, transposed conv and Linear call."""
    total = [0.0]

    def hook(mod, args, out):
        if isinstance(mod, torch.nn.Linear):
            total[0] += 2.0 * out.numel() * mod.in_features
        elif isinstance(mod, torch.nn.ConvTranspose2d):
            k = mod.kernel_size[0] * mod.kernel_size[1]
            total[0] += 2.0 * args[0].numel() * k * mod.out_channels
        else:
            k = mod.kernel_size[0] * mod.kernel_size[1]
            total[0] += 2.0 * out.numel() * k * mod.in_channels
    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d,
                               torch.nn.Linear))]
    with torch.no_grad():
        net(*inputs)
    for h in hooks:
        h.remove()
    return total[0]


@pytest.mark.parametrize("batch", [1, 3])
def test_model_counts_equal_hooked_macs(batch):
    t = torch.rand(batch)
    fm = _hook_flops(FlowMatchingModel(), torch.zeros(batch, 1, 28, 28), t)
    assert pflops.flow_matching_model_flops(batch) == fm
    u64 = _hook_flops(FlexibleUNet(in_channels=3, img_size=64,
                                   model_channels=8,
                                   channel_mult=(1, 2, 2, 4)),
                      torch.zeros(batch, 3, 64, 64), t)
    assert pflops.unet64_flops(batch, 8) == u64
    assert pflops.pair_sampler_flops(
        pflops.flow_matching_model_flops, pflops.flow_matching_model_flops,
        batch, 2, 5, 784 * 2, False) == 5 * (2 * fm + 4.0 * batch * 2 * 1568)


def test_metrics_logger_records_match_jax(tmp_path):
    for mod, d in ((jobs, tmp_path / "j"), (pobs, tmp_path / "p")):
        log = mod.MetricsLogger(str(d), "flow_x")
        log.log(1, {"loss": np.float32(0.5), "steps_per_sec": 3})
        log.log(2, {"loss": torch.tensor(0.25), "steps_per_sec": 4.0})
        log.close()
    rows = {}
    for tag in ("j", "p"):
        with open(tmp_path / tag / "flow_x.jsonl") as f:
            rows[tag] = [json.loads(line) for line in f]
    assert [set(r) for r in rows["p"]] == [set(r) for r in rows["j"]] == [
        {"step", "time", "loss", "steps_per_sec"}] * 2
    for p, j in zip(rows["p"], rows["j"]):
        assert {k: v for k, v in p.items() if k != "time"} == \
            {k: v for k, v in j.items() if k != "time"}
    log = pobs.MetricsLogger(str(tmp_path / "p"), "flow_x")
    log.log(3, {"loss": 0.125})
    log.close()
    with open(tmp_path / "p" / "flow_x.jsonl") as f:
        assert len(f.readlines()) == 3        # appended


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with pobs.profile_trace(None):
        pass
    for _ in range(2):              # a second trace does not overwrite
        with pobs.profile_trace(str(tmp_path / "prof")):
            with pobs.span("test.matmul"):
                torch.ones(4, 4) @ torch.ones(4, 4)
    files = sorted(os.listdir(tmp_path / "prof"))
    traces = [f for f in files if f.startswith("trace_")]
    assert len(traces) == 2 and len(files) == 4
    with open(tmp_path / "prof" / traces[0]) as f:
        assert "traceEvents" in json.load(f)
    for f in files:
        if f.startswith("spans_"):
            with open(tmp_path / "prof" / f) as fh:
                events = json.load(fh)["traceEvents"]
            assert [e["name"] for e in events if e["ph"] == "X"] == [
                "test.matmul"]


def test_train_flow_metrics_and_profile_dirs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("RGMF_SYNTH_N", "8")
    _, _, hist = train_flow.main([
        "--device", "cpu", "--data_root", str(tmp_path / "data"),
        "--modality", "x", "--epochs", "2", "--batch_size", "4",
        "--metrics_dir", "m", "--profile_dir", "p"])
    with open("m/flow_x.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(set(r) == {"step", "time", "loss", "steps_per_sec"}
               for r in rows)
    assert [r["loss"] for r in rows] == pytest.approx(
        [h["loss"] for h in hist])
    spans, trace = sorted(os.listdir("p"))
    assert trace.startswith("trace_") and spans.startswith("spans_")
    with open(os.path.join("p", spans)) as f:
        calls = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    # one train.fm.call a step: 8 digits in batches of 4, two epochs
    assert [e["name"] for e in calls] == ["train.fm.call"] * 4
    assert len({e["args"]["call_id"] for e in calls}) == 4
