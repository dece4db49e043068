"""The PyTorch port's models against the JAX package's, on the CPU.

* parameter counts equal the reference's (901,121 / 6,074,371 / 3,327,617);
* the port's state-dict keys are the JAX exporter's keys, and the port's
  weight bridge (interop/from_jax.py) gives the exporter's arrays bit for
  bit, which then load with `load_state_dict(strict=True)`;
* float32 forward parity at full width, B=2, to 1e-4 (the regime of
  tests/test_torch_import.py). The U-Nets' zero-initialised out_conv is
  perturbed first, or the comparison is empty; the ratio net carries
  random non-trivial BatchNorm statistics.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratio_guided_multimodal_fm_tpu import models as jm
from ratio_guided_multimodal_fm_tpu.interop.torch_export import (
    export_state_dict,
)
from ratio_guided_multimodal_fm_tpu_torch import models as pm
from ratio_guided_multimodal_fm_tpu_torch.interop import state_dict_from_jax

torch.set_num_threads(2)

# kind -> (JAX factory, port factory, per-sample input shapes NHWC)
NETS = {
    "unet_mnist": (lambda: jm.FlowMatchingUNetMNIST(img_size=32),
                   lambda: pm.FlowMatchingUNetMNIST(img_size=32),
                   [(32, 32, 1)]),
    "unet_svhn": (jm.FlowMatchingUNetSVHN, pm.FlowMatchingUNetSVHN,
                  [(32, 32, 3)]),
    "ratio_mnist_svhn": (jm.RatioEstimatorMNISTSVHN,
                         pm.RatioEstimatorMNISTSVHN,
                         [(32, 32, 1), (32, 32, 3)]),
}


def _jax_variables(kind, seed=0):
    """JAX init with the parts a fresh init leaves trivial made random:
    out_conv (zero-init) and the BatchNorm running statistics."""
    jax_net, _, shapes = NETS[kind]
    net = jax_net()
    args = [jnp.zeros((1,) + s) for s in shapes]
    if kind.startswith("unet"):
        args.append(jnp.zeros((1,)))
    variables = jax.tree_util.tree_map(
        np.asarray, dict(net.init(jax.random.PRNGKey(seed), *args)))
    rng = np.random.RandomState(seed + 1)
    if kind.startswith("unet"):
        oc = variables["params"]["out_conv"]
        oc["kernel"] = (rng.randn(*oc["kernel"].shape) * 0.1).astype(
            np.float32)
        oc["bias"] = (rng.randn(*oc["bias"].shape) * 0.1).astype(np.float32)
    else:
        def _stats(tree):
            for k, v in tree.items():
                if isinstance(v, dict):
                    _stats(v)
                elif k == "mean":
                    tree[k] = (rng.randn(*v.shape) * 0.3).astype(np.float32)
                else:
                    tree[k] = rng.uniform(0.5, 2.0, v.shape).astype(
                        np.float32)
        _stats(variables["batch_stats"])
    return net, variables


def test_param_counts():
    def n(m):
        return sum(p.numel() for p in m.parameters())

    assert n(pm.FlowMatchingUNetMNIST(img_size=32)) == 901_121
    assert n(pm.FlowMatchingUNetSVHN()) == 6_074_371
    assert n(pm.RatioEstimatorMNISTSVHN()) == 3_327_617


@pytest.mark.parametrize("kind", sorted(NETS))
def test_state_dict_keys_and_weight_bridge(kind):
    _, variables = _jax_variables(kind)
    exported = export_state_dict(variables, kind)
    bridged = state_dict_from_jax(variables, kind)
    port = NETS[kind][1]()
    assert set(port.state_dict()) == set(exported) == set(bridged)
    for k, want in exported.items():
        got = bridged[k].numpy()
        assert got.dtype == np.asarray(want).dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    port.load_state_dict(bridged, strict=True)


@pytest.mark.parametrize("kind", sorted(NETS))
def test_forward_parity_f32(kind):
    net, variables = _jax_variables(kind, seed=3)
    port = NETS[kind][1]().eval()
    port.load_state_dict(state_dict_from_jax(variables, kind), strict=True)
    rng = np.random.RandomState(7)
    xs = [rng.randn(2, *s).astype(np.float32) for s in NETS[kind][2]]
    nchw = [torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs]
    if kind.startswith("unet"):
        t = np.array([0.2, 0.8], np.float32)
        want = np.asarray(net.apply(variables, jnp.asarray(xs[0]),
                                    jnp.asarray(t)))
        with torch.no_grad():
            got = port(nchw[0], torch.from_numpy(t)).permute(0, 2, 3, 1)
    else:
        want = np.asarray(net.apply(variables, *map(jnp.asarray, xs)))
        with torch.no_grad():
            got = port(*nchw)
    assert np.abs(want).max() > 0.05          # the comparison is not empty
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_ratio_log_ratio_matches_jax():
    net, variables = _jax_variables("ratio_mnist_svhn", seed=5)
    rng = np.random.RandomState(9)
    x = rng.randn(3, 32, 32, 1).astype(np.float32)
    y = rng.randn(3, 32, 32, 3).astype(np.float32)
    for loss_type in ("disc", "rulsif"):
        jnet = jm.RatioEstimatorMNISTSVHN(loss_type=loss_type)
        want = np.asarray(jnet.apply(variables, jnp.asarray(x),
                                     jnp.asarray(y), method=jnet.log_ratio))
        port = pm.RatioEstimatorMNISTSVHN(loss_type=loss_type).eval()
        port.load_state_dict(
            state_dict_from_jax(variables, "ratio_mnist_svhn"), strict=True)
        with torch.no_grad():
            got = port.log_ratio(torch.from_numpy(x).permute(0, 3, 1, 2),
                                 torch.from_numpy(y).permute(0, 3, 1, 2))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_bf16_compute_keeps_f32_params():
    net = pm.FlowMatchingUNetMNIST(img_size=32, dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    with torch.no_grad():
        out = net(torch.randn(2, 1, 32, 32), torch.rand(2))
    assert out.dtype == torch.bfloat16 and out.shape == (2, 1, 32, 32)


def test_bridge_rejects_unknown_and_missing_stats():
    _, variables = _jax_variables("unet_mnist")
    with pytest.raises(ValueError, match="unknown model kind"):
        state_dict_from_jax(variables, "fm_unknown")
    for kind in ("ratio_mnist_svhn", "classifier_svhn"):
        with pytest.raises(ValueError, match="batch_stats"):
            state_dict_from_jax({"params": {}}, kind)
