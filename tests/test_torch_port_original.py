"""The encoder-decoder velocity model (`--model original`) of the PyTorch
port against the JAX package, on the CPU (where the GroupNorm wrapper and
its backward run their plain versions).

* FlowMatchingModel: 9,104,513 params, the keys of the JAX exporter's
  `export_flow_matching_model`, the `fm_original` bridge bit for bit
  against it (the flipped ConvTranspose kernels and the permuted
  flatten and unflatten included);
* the forward in float32 to 1e-4 (non-trivial GroupNorm affines), and in
  bf16 held to the bf16 rule of tests/test_torch_port_bf16.py: the port's
  max |error| against the JAX float32 net at most 1.5x the JAX bf16 net's;
* one CFM train step (t and x_0 from the JAX key's draws, injected): loss
  rtol 1e-4, every gradient max |Δ| <= 1e-4·max|g| + 1e-6;
* `--model original` through the train_flow CLI (one epoch, both
  modalities) and the sample and evaluate CLIs on what it wrote.
Random streams cannot cross frameworks: inputs are made with numpy.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratio_guided_multimodal_fm_tpu.flow import cfm as jcfm
from ratio_guided_multimodal_fm_tpu.interop.torch_export import (
    export_state_dict,
)
from ratio_guided_multimodal_fm_tpu.models.flow_matching import (
    FlowMatchingModel as JFM,
)
from ratio_guided_multimodal_fm_tpu_torch.cli import (
    evaluate,
    sample,
    train_flow,
)
from ratio_guided_multimodal_fm_tpu_torch.cli.common import fm_model
from ratio_guided_multimodal_fm_tpu_torch.interop import state_dict_from_jax
from ratio_guided_multimodal_fm_tpu_torch.models import (
    FlowMatchingModel as PFM,
    MNISTClassifier,
)
from ratio_guided_multimodal_fm_tpu_torch.train.steps import (
    create_fm_state,
    make_fm_train_step,
)

torch.set_num_threads(2)

SHAPE = (28, 28, 1)
BF16_BOUND = 1.5


def _variables(seed=0):
    v = jax.tree_util.tree_map(np.asarray, dict(JFM().init(
        jax.random.PRNGKey(seed), jnp.zeros((1,) + SHAPE), jnp.zeros((1,)))))
    rng = np.random.RandomState(seed + 1)
    for part in v["params"].values():
        for name, p in part.items():
            if name.startswith("gn"):
                p["scale"] = rng.uniform(0.5, 1.5, p["scale"].shape).astype(
                    np.float32)
                p["bias"] = (rng.randn(*p["bias"].shape) * 0.1).astype(
                    np.float32)
    return v


def _port(v, dtype=torch.float32):
    net = PFM(dtype=dtype)
    net.load_state_dict(state_dict_from_jax(v, "fm_original"), strict=True)
    return net.eval()


def _inputs(b=3, seed=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, *SHAPE).astype(np.float32),
            rng.rand(b).astype(np.float32))


def _run(net, x, t):
    with torch.no_grad():
        return net(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(t)).float().permute(0, 2, 3, 1).numpy()


def test_param_count_keys_and_bridge_match_the_exporter():
    v = _variables()
    net = PFM()
    assert sum(p.numel() for p in net.parameters()) == 9_104_513
    exported = export_state_dict(v, "fm_original")
    bridged = state_dict_from_jax(v, "fm_original")
    assert set(net.state_dict()) == set(exported) == set(bridged)
    for k, w in exported.items():
        np.testing.assert_array_equal(bridged[k].numpy(), w, err_msg=k)
        assert tuple(net.state_dict()[k].shape) == w.shape, k
    assert fm_model("original").__class__ is PFM


def test_forward_float32_matches_jax():
    v = _variables(3)
    x, t = _inputs()
    want = np.asarray(JFM().apply(v, x, t))
    np.testing.assert_allclose(_run(_port(v), x, t), want, rtol=1e-4,
                               atol=1e-4)


def test_forward_bf16_within_the_bf16_rule():
    v = _variables(4)
    x, t = _inputs(4, seed=5)
    f32 = np.asarray(JFM().apply(v, x, t), np.float32)
    jb = np.asarray(JFM(dtype=jnp.bfloat16).apply(v, x, t).astype(
        jnp.float32))
    pb = _run(_port(v, torch.bfloat16), x, t)
    err_j, err_p = np.abs(jb - f32).max(), np.abs(pb - f32).max()
    print(f"bf16 parity FlowMatchingModel: port {err_p:.4g}, JAX bf16 "
          f"{err_j:.4g} (ratio {err_p / err_j:.3f})")
    assert err_j > 0 and np.isfinite(pb).all()
    assert err_p <= BF16_BOUND * err_j


def test_cfm_step_loss_and_gradients_match_jax():
    v = _variables(6)
    x1 = np.random.RandomState(7).randn(4, *SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(8)
    kt, kn, _ = jax.random.split(key, 3)
    t = np.array(jax.random.uniform(kt, (4,), jnp.float32))
    x0 = np.array(jax.random.normal(kn, x1.shape, jnp.float32))
    jnet = JFM()

    def loss_fn(params):
        x_t, u = jcfm.interpolate(kn, jnp.asarray(x1), jnp.asarray(t))
        out = jnet.apply({"params": params}, x_t, jnp.asarray(t))
        return jnp.mean((out.astype(jnp.float32) - u.astype(jnp.float32))
                        ** 2)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(
        np.asarray, jgrads)}, "fm_original")
    state = create_fm_state(_port(v), "cpu", lr=1e-4)
    loss = make_fm_train_step()(state, torch.from_numpy(x1),
                                t=torch.from_numpy(t),
                                x0=torch.from_numpy(x0))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    grads = dict(state.model.named_parameters())
    assert set(grads) == set(want)
    for k, g in want.items():
        g = g.numpy()
        got = grads[k].grad.numpy()
        assert np.abs(got - g).max() <= 1e-4 * np.abs(g).max() + 1e-6, k
    assert np.abs(want["decoder.gn1.weight"].numpy()).max() > 0


def test_original_through_train_sample_and_evaluate_clis(tmp_path,
                                                         monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("RGMF_SYNTH_N", "64")
    base = ["--device", "cpu", "--data_root", str(tmp_path / "data"),
            "--model", "original", "--epochs", "1", "--batch_size", "32"]
    for modality in ("x", "y"):
        state, best, hist = train_flow.main(base + ["--modality", modality])
        assert isinstance(state.model, PFM)
        assert np.isfinite(best) and hist[-1]["epoch"] == 1
    assert sorted(os.listdir("checkpoints")) == [
        "flow_x_best.pth", "flow_y_rotate90_best.pth"]
    torch.manual_seed(0)
    from ratio_guided_multimodal_fm_tpu_torch.models import (
        RatioEstimatorMNIST,
    )
    torch.save(RatioEstimatorMNIST().state_dict(),
               "checkpoints/ratio_disc_rotate90_best.pth")
    torch.save(MNISTClassifier().state_dict(),
               "checkpoints/mnist_classifier.pth")
    x1, y1, diags = sample.main([
        "--device", "cpu", "--model", "original", "--guidance_method",
        "mc_feng", "--num_samples", "3", "--num_steps", "2",
        "--mc_batch_size", "4"])
    assert x1.shape == y1.shape == (3,) + SHAPE
    assert torch.isfinite(x1).all() and torch.isfinite(y1).all()
    assert len(diags["ess"]) == 2
    results = evaluate.main([
        "--device", "cpu", "--model", "original", "--num_samples", "4",
        "--num_steps", "2", "--mc_batch_size", "3", "--guidance_methods",
        "none", "mc_feng", "--guidance_strengths", "0.5",
        "--data_root", str(tmp_path / "data")])
    assert [r["method"] for r in results] == ["mc_feng"]
    assert np.isfinite(results[0]["coherence_acc"])


@pytest.mark.parametrize("argv", [["--model", "unet"], ["--merged_unet"]])
def test_original_checkpoint_refuses_the_unet(tmp_path, monkeypatch, argv):
    """The encoder-decoder's .pth does not load as a U-Net (strict keys);
    --merged_unet leaves the encoder-decoder unmerged (no U-Net topology)
    and samples as the two-net run does."""
    monkeypatch.chdir(tmp_path)
    os.makedirs("checkpoints")
    torch.manual_seed(1)
    for name in ("flow_x_best.pth", "flow_y_rotate90_best.pth"):
        torch.save(PFM().state_dict(), os.path.join("checkpoints", name))
    if argv[0] == "--model":
        with pytest.raises(RuntimeError, match="state_dict"):
            sample.main(["--device", "cpu", "--num_steps", "1"] + argv)
        return
    run = ["--device", "cpu", "--model", "original", "--num_samples", "2",
           "--num_steps", "2"]
    a, b = sample.main(run)[:2], sample.main(run + argv)[:2]
    for u, w in zip(a, b):
        assert torch.equal(u, w)
