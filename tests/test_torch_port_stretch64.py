"""The 64-px stretch config of the PyTorch port against the JAX package, on
the CPU.

* a narrow 64-px U-Net (FlexibleUNet in=3, mult (1, 2, 2, 4), ch 8),
  Classifier64 (582,026 params) and FlexibleRatioEstimator(3, 3) through
  the weight bridge, float32 to 1e-4; FlowMatchingUNet64's 37,375,683
  params and 45 GroupNorm sites;
* data/natural.py: generate_natural equal to JAX's bit for bit for the
  same seed, and load_natural on the CIFAR-10 and CelebA file layouts of
  tests/test_natural_real.py equal to JAX's (procedural fallback, caching
  and resampling included);
* cli/config5_demo.py --device cpu at ch 8 and a tiny --n, two-net and
  --merged_unet (the same checkpoints, reloaded): results.json with the
  JAX script's keys, finite samples, coherence within one sample;
* cli/stretch64_demo.py --device cpu at ch 8 and a tiny --n: the JAX
  script's results.json keys, finite samples.
"""
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratio_guided_multimodal_fm_tpu.data import natural as jnat
from ratio_guided_multimodal_fm_tpu.models import (
    Classifier64 as JC64,
    FlexibleRatioEstimator as JRatio,
    FlexibleUNet as JUNet,
)
from ratio_guided_multimodal_fm_tpu_torch.cli import config5_demo
from ratio_guided_multimodal_fm_tpu_torch.data import natural as pnat
from ratio_guided_multimodal_fm_tpu_torch.interop import state_dict_from_jax
from ratio_guided_multimodal_fm_tpu_torch.models import (
    Classifier64,
    FlexibleRatioEstimator,
    FlexibleUNet,
    FlowMatchingUNet64,
)
from ratio_guided_multimodal_fm_tpu_torch.models.layers import GroupNormSiLU

torch.set_num_threads(2)

S = (64, 64, 3)
UNET_KW = dict(in_channels=3, img_size=64, model_channels=8,
               channel_mult=(1, 2, 2, 4), num_res_blocks=2, dropout=0.0)


def _init(net, *inputs, seed=0):
    return jax.tree_util.tree_map(np.asarray, dict(jax.jit(net.init)(
        jax.random.PRNGKey(seed), *inputs)))


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def test_unet64_matches_jax():
    jnet = JUNet(**UNET_KW)
    v = _init(jnet, jnp.zeros((1,) + S), jnp.zeros((1,)))
    oc = v["params"]["out_conv"]
    oc["kernel"] = (np.random.RandomState(1).randn(*oc["kernel"].shape)
                    * 0.1).astype(np.float32)
    net = FlexibleUNet(**UNET_KW).eval()
    net.load_state_dict(state_dict_from_jax(v, "unet_64"), strict=True)
    rng = np.random.RandomState(2)
    x, t = rng.randn(2, *S).astype(np.float32), np.array([0.3, 0.8],
                                                         np.float32)
    want = np.asarray(jax.jit(jnet.apply)(v, x, t))
    with torch.no_grad():
        got = net(_nchw(x), torch.from_numpy(t)).permute(0, 2, 3, 1)
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_full_width_unet64_size_and_sites():
    net = FlowMatchingUNet64(in_channels=3)
    assert sum(p.numel() for p in net.parameters()) == 37_375_683
    assert sum(isinstance(m, GroupNormSiLU) for m in net.modules()) == 45


def test_classifier64_matches_jax():
    jnet = JC64()
    v = _init(jnet, jnp.zeros((1,) + S))
    net = Classifier64().eval()
    assert sum(p.numel() for p in net.parameters()) == 582_026
    net.load_state_dict(state_dict_from_jax(v, "classifier_64"), strict=True)
    x = np.random.RandomState(3).randn(3, *S).astype(np.float32)
    want = np.asarray(jax.jit(jnet.apply)(v, x))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_ratio_3x3_at_64px_matches_jax():
    jnet = JRatio(x_channels=3, y_channels=3)
    v = _init(jnet, jnp.zeros((1,) + S), jnp.zeros((1,) + S))
    net = FlexibleRatioEstimator(x_channels=3, y_channels=3).eval()
    net.load_state_dict(state_dict_from_jax(v, "ratio_mnist"), strict=True)
    rng = np.random.RandomState(4)
    x, y = (rng.randn(3, *S).astype(np.float32) for _ in "xy")
    want = np.asarray(jax.jit(lambda a, b: jnet.apply(
        v, a, b, method=jnet.log_ratio))(x, y))
    with torch.no_grad():
        got = net.log_ratio(_nchw(x), _nchw(y))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["objects", "faces"])
def test_generate_natural_bit_for_bit(kind, tmp_path):
    want = jnat.generate_natural(kind, 6, seed=7, root=str(tmp_path),
                                 cache=False)
    got = pnat.generate_natural(kind, 6, seed=7, root=str(tmp_path))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    cached = pnat.generate_natural(kind, 6, seed=7, root=str(tmp_path))
    assert os.listdir(tmp_path / "synthetic_cache") == [
        f"nat_{kind}_6_7_64px.npz"]
    np.testing.assert_array_equal(cached[0], want[0])


def _write_fake_cifar(root, n=64):
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(0)
    with open(os.path.join(d, "data_batch_1"), "wb") as f:
        pickle.dump({b"data": rng.randint(0, 256, (n, 3072), dtype=np.uint8),
                     b"labels": [int(v) for v in rng.randint(0, 10, n)]}, f)


def _write_fake_celeba(root, n=12):
    from PIL import Image

    base = os.path.join(root, "celeba")
    img_dir = os.path.join(base, "img_align_celeba")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.RandomState(1)
    names = ["Black_Hair", "Blond_Hair", "Brown_Hair", "Gray_Hair",
             "Eyeglasses", "Smiling"]
    with open(os.path.join(base, "list_attr_celeba.txt"), "w") as f:
        f.write(f"{n}\n" + " ".join(names) + "\n")
        for i in range(n):
            fname = f"{i:06d}.jpg"
            Image.fromarray(rng.randint(0, 256, (218, 178, 3),
                                        dtype=np.uint8)).save(
                os.path.join(img_dir, fname))
            vals = [-1] * len(names)
            vals[i % 4] = 1
            vals[4] = 1 if i % 2 else -1
            f.write(fname + " " + " ".join(map(str, vals)) + "\n")


@pytest.mark.parametrize("layout,kind,source", [
    (None, "objects", "procedural"), ("cifar", "objects", "cifar10"),
    ("celeba", "faces", "celeba")])
def test_load_natural_matches_jax(tmp_path, layout, kind, source):
    """The port reads each layout as JAX does: the same images and labels
    (and, resampled past the pool, with replacement), cached in the same
    file."""
    jroot, proot = tmp_path / "j", tmp_path / "p"
    for root in (jroot, proot):
        if layout == "cifar":
            _write_fake_cifar(str(root))
        elif layout == "celeba":
            _write_fake_celeba(str(root))
    for n, seed in ((8, 3), (70, 4)):
        want = jnat.load_natural(kind, n, seed, root=str(jroot))
        got = pnat.load_natural(kind, n, seed, root=str(proot))
        assert got[2] == want[2] == source
        assert got[0].shape == (n, 64, 64, 3)
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(a, b)
        again = pnat.load_natural(kind, n, seed, root=str(proot))
        np.testing.assert_array_equal(again[0], got[0])
    assert sorted(os.listdir(proot / "synthetic_cache")) == sorted(
        os.listdir(jroot / "synthetic_cache"))
    if layout == "celeba":
        assert pnat._celeba_class({"Blond_Hair": 1, "Eyeglasses": 1}) == 5


TINY = ["--device", "cpu", "--model_channels", "8", "--n", "80",
        "--batch_size", "32", "--epochs", "1", "--ratio_epochs", "1",
        "--num_samples", "6", "--eval_chunks", "2", "--num_steps", "3",
        "--mc_batch_size", "5", "--gammas", "0", "0.5"]


def test_config5_demo_cli_on_cpu(tmp_path, monkeypatch):
    """Two-net, then --merged_unet on the checkpoints the first run wrote
    (training skipped): the JAX script's result keys, finite samples, and
    coherence within one sample of the two-net run's (the same math in
    bf16 activations)."""
    monkeypatch.chdir(tmp_path)
    first = config5_demo.main(TINY)
    assert sorted(os.listdir("outputs/config5/ckpt")) == [
        "fm_x.pth", "fm_y.pth", "ratio.pth"]
    merged = config5_demo.main(TINY + ["--merged_unet"])
    with open("outputs/config5/results.json") as f:
        assert json.load(f) == json.loads(json.dumps(merged))
    assert set(first) == {"n_train", "fm_params_per_modality",
                          "data_sources", "classifier_acc", "loss_curve",
                          "eval"}
    assert first["data_sources"] == {"objects": "procedural",
                                     "faces": "procedural"}
    assert len(first["loss_curve"]["flow_x"]) == 1
    assert set(first["loss_curve"]["ratio"][0]) == {"loss", "acc_real",
                                                    "acc_fake"}
    assert merged["loss_curve"] == {"flow_x": [], "flow_y": [], "ratio": []}
    for run in (first, merged):
        assert [r["method"] for r in run["eval"]] == ["none", "mc_feng"]
        for r in run["eval"]:
            assert set(r) == {"method", "gamma", "coherence",
                              "label_entropy_objects",
                              "label_entropy_faces", "wall_sec",
                              "samples_per_sec", "finite"}
            assert r["finite"]
    for a, b in zip(first["eval"], merged["eval"]):
        assert abs(a["coherence"] - b["coherence"]) <= 1 / 6 + 1e-9


def test_stretch64_demo_cli_on_cpu(tmp_path, monkeypatch):
    """cli/stretch64_demo.py at ch 8 and a tiny --n: the JAX script's
    results.json keys, finite samples, the flows saved."""
    from ratio_guided_multimodal_fm_tpu_torch.cli import stretch64_demo

    monkeypatch.chdir(tmp_path)
    argv = ["--device", "cpu", "--model_channels", "8", "--n", "48",
            "--batch_size", "16", "--epochs", "1", "--ratio_epochs", "1",
            "--num_steps", "2"]
    res = stretch64_demo.main(argv)
    saved = json.load(open("outputs/stretch64/results.json"))
    assert set(saved) == {"loss_curve", "none_gamma0.0", "mc_feng_gamma0.5",
                          "mc_feng_gamma1.0"}
    assert set(saved["loss_curve"]) == {"flow_x", "flow_y", "ratio"}
    assert len(saved["loss_curve"]["ratio"]) == 1
    for k in ("none_gamma0.0", "mc_feng_gamma0.5", "mc_feng_gamma1.0"):
        assert set(saved[k]) == {"wall_sec", "centroid_coherence", "finite"}
        assert saved[k]["finite"] and 0 <= saved[k]["centroid_coherence"] <= 1
    assert sorted(os.listdir("outputs/stretch64/ckpt")) == ["fm_x.pth",
                                                           "fm_y.pth"]
    assert res["loss_curve"]["flow_x"] == saved["loss_curve"]["flow_x"]
