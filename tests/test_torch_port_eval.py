"""The evaluation modules of the PyTorch port against the JAX package, on
the CPU.

* The classifiers (MNISTClassifier, MNISTClassifier32, SVHNClassifier):
  parameter counts, the bridges' keys and values equal to the JAX
  exporter's (the fc1 HWC -> CHW permutation, BatchNorm statistics), and
  logits to 1e-4 through a strict load;
* the transforms, coherence and label entropy (predictions and coherence
  exact, entropies to 1e-6), fid_from_features (1e-6), compute_fid (1e-3
  relative), mc_set_ess, resolve_chunk_policy and _merge_diags on a grid of
  inputs (identical), sample_in_chunks' policy, seeding and MC-set cache;
* the numpy data loaders: the same batches as the JAX package's for the
  same seed (synthetic digits, RGMF_SYNTH_N small);
* both evaluation CLIs end to end on exported checkpoints (2 steps), with
  the JAX CLIs' result keys, and the sample CLIs with 'grad' and
  --mc_refresh 2.
Random streams cannot cross frameworks: inputs are made with numpy.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratio_guided_multimodal_fm_tpu import models as jm
from ratio_guided_multimodal_fm_tpu.data import mnist_dataset as jmd
from ratio_guided_multimodal_fm_tpu.data import mnist_svhn as jms
from ratio_guided_multimodal_fm_tpu.data import transforms as jt
from ratio_guided_multimodal_fm_tpu.eval import chunked as jc
from ratio_guided_multimodal_fm_tpu.eval import coherence as jcoh
from ratio_guided_multimodal_fm_tpu.eval import fid as jfid
from ratio_guided_multimodal_fm_tpu.interop.torch_export import (
    export_state_dict,
)
from ratio_guided_multimodal_fm_tpu_torch import models as pm
from ratio_guided_multimodal_fm_tpu_torch.cli import (
    evaluate,
    evaluate_mnist_svhn,
    sample_mnist_svhn,
)
from ratio_guided_multimodal_fm_tpu_torch.data import mnist_dataset as pmd
from ratio_guided_multimodal_fm_tpu_torch.data import mnist_svhn as pms
from ratio_guided_multimodal_fm_tpu_torch.data import transforms as pt
from ratio_guided_multimodal_fm_tpu_torch.eval import chunked as pc
from ratio_guided_multimodal_fm_tpu_torch.eval import coherence as pcoh
from ratio_guided_multimodal_fm_tpu_torch.eval import fid as pfid
from ratio_guided_multimodal_fm_tpu_torch.interop import state_dict_from_jax

torch.set_num_threads(2)

CLASSIFIERS = {
    "classifier_mnist": (jm.MNISTClassifier, pm.MNISTClassifier,
                         (28, 28, 1), 421_642),
    "classifier_mnist32": (jm.MNISTClassifier32, pm.MNISTClassifier32,
                           (32, 32, 1), 581_450),
    "classifier_svhn": (jm.SVHNClassifier, pm.SVHNClassifier, (32, 32, 3),
                        2_341_514),
}


def _np(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _jax_classifier(kind, seed=0):
    jcls, _, shape, _ = CLASSIFIERS[kind]
    v = jax.tree_util.tree_map(np.asarray, dict(jcls().init(
        jax.random.PRNGKey(seed), jnp.zeros((1,) + shape))))
    if "batch_stats" in v:           # non-trivial running statistics
        rng = np.random.RandomState(seed + 1)
        for st in v["batch_stats"].values():
            st["mean"] = (rng.randn(*st["mean"].shape) * 0.1).astype(
                np.float32)
            st["var"] = rng.uniform(0.5, 2.0, st["var"].shape).astype(
                np.float32)
    return v


def _port_classifier(kind, v):
    net = CLASSIFIERS[kind][1]().eval()
    net.load_state_dict(state_dict_from_jax(v, kind), strict=True)
    return net


@pytest.fixture(scope="module")
def classifiers():
    out = {}
    for kind in CLASSIFIERS:
        v = _jax_classifier(kind)
        out[kind] = (v, _port_classifier(kind, v))
    return out


@pytest.mark.parametrize("kind", sorted(CLASSIFIERS))
def test_classifier_matches_jax(classifiers, kind):
    jcls, _, shape, n_params = CLASSIFIERS[kind]
    v, net = classifiers[kind]
    assert sum(p.numel() for p in net.parameters()) == n_params
    exported = export_state_dict(v, kind)
    bridged = state_dict_from_jax(v, kind)
    assert set(bridged) == set(exported) == set(net.state_dict())
    for k, want in exported.items():
        np.testing.assert_array_equal(bridged[k].numpy(), want, err_msg=k)
    x = _np(5, *shape, seed=1)
    want = np.asarray(jcls().apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert np.ptp(want) > 1e-2
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", jt.TRANSFORM_NAMES)
def test_transforms_match_jax(name):
    x = _np(2, 5, 4, 3, seed=2)
    for fn in ("apply_transform", "inverse_transform"):
        want = np.asarray(getattr(jt, fn)(name, x))
        np.testing.assert_array_equal(getattr(pt, fn)(name, x), want)
        np.testing.assert_array_equal(
            getattr(pt, fn)(name, torch.from_numpy(x)).numpy(), want)


def _linear_classifier(shape, seed):
    """The same logits in both frameworks: a fixed linear map."""
    w = _np(int(np.prod(shape)), 10, seed=seed)

    def jfn(x):
        return jnp.asarray(np.asarray(x).reshape(len(x), -1) @ w)

    def pfn(x):
        return torch.as_tensor(np.asarray(x)).reshape(len(x), -1) @ \
            torch.from_numpy(w)
    return jfn, pfn


@pytest.mark.parametrize("transform", ["rotate90", "flip_h", "invert",
                                       "none"])
def test_coherence_matches_jax(transform):
    x, y = _np(64, 6, 6, 1, seed=3), _np(64, 6, 6, 1, seed=4)
    jfn, pfn = _linear_classifier((6, 6, 1), 5)
    want = jcoh.evaluate_coherence(x, y, jfn, transform)
    got = pcoh.evaluate_coherence(torch.from_numpy(x), torch.from_numpy(y),
                                  pfn, transform)
    _same_metrics(got, want)


def test_coherence_dual_matches_jax():
    x, y = _np(50, 4, 4, 1, seed=6), _np(50, 4, 4, 3, seed=7)
    jx, px = _linear_classifier((4, 4, 1), 8)
    jy, py = _linear_classifier((4, 4, 3), 9)
    _same_metrics(pcoh.evaluate_coherence_dual(x, y, px, py),
                  jcoh.evaluate_coherence_dual(x, y, jx, jy))


def _same_metrics(got, want):
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["pred_x"], want["pred_x"])
    np.testing.assert_array_equal(got["pred_y"], want["pred_y"])
    assert got["coherence_acc"] == want["coherence_acc"]
    assert got["num_samples"] == want["num_samples"]
    for k in ("label_entropy_x", "label_entropy_y"):
        assert abs(got[k] - want[k]) <= 1e-6


@pytest.mark.parametrize("preds", [[0] * 20, list(range(10)) * 3,
                                   [1, 1, 2, 9, 9, 9], []])
def test_label_entropy_matches_jax(preds):
    preds = np.asarray(preds, np.int64)
    assert abs(pcoh.label_entropy(preds) - jcoh.label_entropy(preds)) <= 1e-6


def test_fid_from_features_matches_jax():
    f1, f2 = _np(80, 12, seed=10), _np(70, 12, seed=11, scale=1.3) + 0.2
    want = jfid.fid_from_features(f1, f2)
    assert want > 0.1
    assert abs(pfid.fid_from_features(f1, f2) - want) <= 1e-6 * max(1, want)
    assert abs(pfid.fid_from_features(f1, f1)) <= 1e-6


@pytest.mark.parametrize("kind", ["classifier_mnist", "classifier_svhn"])
def test_compute_fid_matches_jax(kind):
    """fc1 features of both frameworks' classifiers (1e-4) and the FID, in
    batches with a partial last one. fc1's bias is raised so that no unit is
    dead: a constant feature makes the covariances singular, where sqrtm
    amplifies float32 differences of the features without bound."""
    jcls, _, shape, _ = CLASSIFIERS[kind]
    v = _jax_classifier(kind, seed=3)
    v["params"]["fc1"]["bias"] = v["params"]["fc1"]["bias"] + 3.0
    net = _port_classifier(kind, v)
    n_feat = v["params"]["fc1"]["bias"].shape[0]
    real = np.tanh(_np(n_feat + 100, *shape, seed=12))
    gen = np.tanh(_np(n_feat + 90, *shape, seed=13) * 1.5)
    np.testing.assert_allclose(
        pfid.extract_features(net, real[:16]),
        jfid.extract_features(jcls(), v, jnp.asarray(real[:16])),
        rtol=1e-4, atol=1e-4)
    want = jfid.compute_fid(jcls(), v, real, gen, batch_size=128)
    got = pfid.compute_fid(net, real, torch.from_numpy(gen), batch_size=128)
    assert want > 1e-3
    assert abs(got - want) <= 1e-3 * want


def test_mc_set_ess_matches_jax():
    for r in (np.ones(8), np.exp(_np(16, seed=14) * 3), np.zeros(4),
              np.array([np.inf, 1.0])):
        r = r.astype(np.float32)
        assert pc.mc_set_ess(torch.from_numpy(r)) == jc.mc_set_ess(r)


@pytest.mark.parametrize("eval_chunks", ["auto", None, 1, 3, "2", 0])
@pytest.mark.parametrize("has_mc", [True, False])
@pytest.mark.parametrize("auto_chunks", [1, 4])
def test_resolve_chunk_policy_matches_jax(eval_chunks, has_mc, auto_chunks):
    for reason in ({}, {"no_mc_reason": "mc_refresh>1: inside"}):
        assert pc.resolve_chunk_policy(eval_chunks, has_mc, auto_chunks,
                                       **reason) == \
            jc.resolve_chunk_policy(eval_chunks, has_mc, auto_chunks,
                                    **reason)


@pytest.mark.parametrize("sizes", [[3], [3, 3, 2], [4, 4]])
def test_merge_diags_matches_jax(sizes):
    T = 5
    diags = [{"ess": _np(T, n, seed=n + i), "w_max": _np(T, seed=20 + i),
              "w_min": _np(T, seed=30 + i), "g_x_norm": _np(T, seed=40 + i)}
             for i, n in enumerate(sizes)] + [{}]
    want = jc._merge_diags(diags)
    got = pc._merge_diags([{k: torch.from_numpy(v) for k, v in d.items()}
                           for d in diags])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert pc._merge_diags([{}, {}]) == jc._merge_diags([{}, {}]) == {}


def test_sample_in_chunks_policy_seeds_and_cache():
    """The chunk sizes, the per-chunk generators (chunk_seed(seed, ci), the
    MC set's chunk_seed(seed, ci, 7)), the MC-set cache across calls and the
    info keys of the JAX function on the same per-chunk outputs."""
    seen, made = [], []

    def make_mc(gen):
        made.append(gen.initial_seed())
        return (None, None, torch.ones(4))

    def sample_fn(gen, n, mc):
        seen.append((gen.initial_seed(), n, mc is not None))
        ess = torch.full((3, n), float(len(seen)))
        return torch.zeros(n, 2), torch.ones(n, 3), {"ess": ess}

    cache = {}
    x, y, merged, info = pc.sample_in_chunks(sample_fn, make_mc, 10, 5, "cpu",
                                             mc_cache=cache, log_fn=print)
    assert x.shape == (10, 2) and y.shape == (10, 3)
    assert [s[1] for s in seen] == [3, 3, 2, 2]
    assert [s[0] for s in seen] == [pc.chunk_seed(5, ci) for ci in range(4)]
    assert made == [pc.chunk_seed(5, ci, 7) for ci in range(4)]
    assert len(set(made) | {s[0] for s in seen}) == 8
    pc.sample_in_chunks(sample_fn, make_mc, 10, 5, "cpu", mc_cache=cache,
                        log_fn=print)
    assert len(made) == 4                   # the second call hit the cache
    jinfo = jc.sample_in_chunks(
        lambda k, n, mc: (jnp.zeros((n, 2)), jnp.ones((n, 3)),
                          {"ess": jnp.ones((3, n))}),
        lambda k: (None, None, jnp.ones(4)), 10, jax.random.PRNGKey(0),
        log_fn=print)[3]
    assert set(info) == set(jinfo)
    assert info["n_chunks"] == jinfo["n_chunks"] == 4
    assert info["mc_set_ess"] == jinfo["mc_set_ess"] == [4.0] * 4
    _, _, _, one = pc.sample_in_chunks(sample_fn, None, 7, 5, "cpu",
                                       log_fn=print)
    assert one["n_chunks"] == 1 and "mc_set_ess" not in one
    assert seen[-1] == (pc.chunk_seed(5, 0), 7, False)


def test_loaders_match_jax(tmp_path, monkeypatch):
    """The classifier (MNIST-28) and MNIST-32 test batches are the JAX
    loaders' for the same seed, each framework generating its own
    synthetic digits."""
    monkeypatch.setenv("RGMF_SYNTH_N", "200")
    monkeypatch.setenv("RGMF_DEVICE_DATA", "0")
    roots = [str(tmp_path / "jax"), str(tmp_path / "port")]
    for train in (False, True):
        j = jmd.get_classifier_dataloader(100, train, roots[0], seed=3)
        p = pmd.get_classifier_dataloader(100, train, roots[1], seed=3)
        assert len(j) == len(p) > 0
        for bj, bp in zip(j, p):
            for k in ("x", "label"):
                np.testing.assert_array_equal(bp[k], np.asarray(bj[k]))
    j = next(iter(jms.get_mnist32_flow_dataloader(64, False, roots[0])))
    p = next(iter(pms.get_mnist32_flow_dataloader(64, False, roots[1])))
    assert p["x"].shape == (64, 32, 32, 1)
    np.testing.assert_array_equal(p["x"], np.asarray(j["x"]))
    np.testing.assert_array_equal(p["label"], np.asarray(j["label"]))


# ---- the CLIs ------------------------------------------------------------------

EXP1_KEYS = {"method", "guidance_strength", "transform_type", "coherence_acc",
             "num_samples", "label_entropy_x", "label_entropy_y", "n_chunks",
             "chunk_policy"}
MC_KEYS = {"mc_set_ess", "ess_final_mean", "ess_final_min",
           "ess_trajectory_min", "ess_trajectory_mean"}
SMC_KEYS = {"smc_final_ess", "smc_resamples", "smc_churn",
            "smc_resample_tau"}


def _save(root, fname, kind, variables):
    sd = export_state_dict(variables, kind)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               root / "checkpoints" / fname)


@pytest.fixture(scope="module")
def exp2_dir(tmp_path_factory):
    """Experiment 2's classifiers exported from random-init JAX models to
    reference-layout .pth files, as `rgmf-export-torch --out` writes them,
    beside the port's own random-init flows and ratio net (the same keys;
    tests/test_torch_port_isolation.py runs them through the exporter)."""
    root = tmp_path_factory.mktemp("exp2")
    (root / "checkpoints").mkdir()
    torch.manual_seed(0)
    fm_m = pm.FlowMatchingUNetMNIST(img_size=32)
    torch.nn.init.normal_(fm_m.out_conv.weight, std=0.05)
    for net, fname in ((fm_m, "flow_mnist32_best.pth"),
                       (pm.FlowMatchingUNetSVHN(), "flow_svhn_best.pth"),
                       (pm.RatioEstimatorMNISTSVHN(),
                        "ratio_disc_mnist_svhn_best.pth")):
        torch.save(net.state_dict(), root / "checkpoints" / fname)
    _save(root, "mnist32_classifier.pth", "classifier_mnist32",
          _jax_classifier("classifier_mnist32"))
    _save(root, "svhn_classifier.pth", "classifier_svhn",
          _jax_classifier("classifier_svhn"))
    return root


def test_evaluate_mnist_svhn_cli_on_cpu(exp2_dir, monkeypatch):
    monkeypatch.chdir(exp2_dir)
    monkeypatch.setenv("RGMF_SYNTH_N", "200")
    results = evaluate_mnist_svhn.main([
        "--device", "cpu", "--num_samples", "4", "--num_steps", "2",
        "--mc_batch_size", "3", "--guidance_methods", "none", "mc_feng",
        "grad", "mc_feng+grad", "smc", "--guidance_strengths", "0", "0.5",
        "--fid", "--auto_chunks", "2", "--data_root", str(exp2_dir / "data")])
    assert [(r["method"], r["guidance_strength"]) for r in results] == [
        ("none", 0.0), ("mc_feng", 0.0), ("mc_feng", 0.5), ("grad", 0.0),
        ("grad", 0.5), ("mc_feng+grad", 0.0), ("mc_feng+grad", 0.5),
        ("smc", 0.0), ("smc", 0.5)]
    for r in results:
        keys = (EXP1_KEYS - {"transform_type"}) | {"classifier_fid_mnist"}
        if "mc_feng" in r["method"]:
            keys |= MC_KEYS
        if r["method"] == "smc":
            keys |= SMC_KEYS
            # experiment 2's defaults: islands of 8, tau 0.7
            assert r["smc_resample_tau"] == 0.7 and r["smc_churn"] == 1.0
            assert 1.0 <= r["smc_final_ess"] <= 4.0
        assert set(r) == keys, r["method"]
        assert r["n_chunks"] == (2 if "mc_feng" in r["method"] else 1)
        assert np.isfinite(r["classifier_fid_mnist"])
        assert 0.0 <= r["coherence_acc"] <= 1.0
    saved = json.loads((exp2_dir / "outputs" / "mnist_svhn" /
                        "evaluation_results.json").read_text())
    assert saved == results
    x1, y1, _ = sample_mnist_svhn.main([
        "--device", "cpu", "--guidance_method", "grad", "--num_samples", "2",
        "--num_steps", "2"])
    assert x1.shape == (2, 32, 32, 1) and torch.isfinite(y1).all()
    _, _, d = sample_mnist_svhn.main([
        "--device", "cpu", "--guidance_method", "mc_feng", "--num_samples",
        "2", "--num_steps", "2", "--mc_batch_size", "3", "--mc_refresh", "2"])
    assert d["ess"].shape == (2, 2)


def test_evaluate_cli_on_cpu(tmp_path, monkeypatch):
    """Experiment 1 from exported flows, ratio net and classifier (smc with
    the JAX CLI's smc_* keys among the rows); what it refuses: an unknown
    method, and a missing classifier."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("RGMF_SYNTH_N", "200")
    with pytest.raises(SystemExit, match="unknown guidance method"):
        evaluate.main(["--device", "cpu", "--guidance_methods", "bogus"])
    with pytest.raises(SystemExit, match="checkpoint not found"):
        evaluate.main(["--device", "cpu"])
    (tmp_path / "checkpoints").mkdir()
    k = jax.random.PRNGKey(0)
    x, t = jnp.zeros((1, 28, 28, 1)), jnp.zeros((1,))
    for i, fname in enumerate(("flow_x_best.pth", "flow_y_rotate90_best.pth")):
        v = dict(jm.FlowMatchingUNet().init(jax.random.PRNGKey(i), x, t))
        v["params"]["out_conv"]["kernel"] = _np(
            *v["params"]["out_conv"]["kernel"].shape, seed=i, scale=0.05)
        _save(tmp_path, fname, "unet_mnist", v)
    _save(tmp_path, "ratio_disc_rotate90_best.pth", "ratio",
          dict(jm.RatioEstimatorMNIST().init(k, x, x)))
    _save(tmp_path, "mnist_classifier.pth", "classifier_mnist",
          _jax_classifier("classifier_mnist"))
    results = evaluate.main([
        "--device", "cpu", "--num_samples", "3", "--num_steps", "2",
        "--mc_batch_size", "3", "--guidance_methods", "none", "mc_feng+grad",
        "grad", "smc", "--guidance_strengths", "0.5", "--fid",
        "--eval_chunks", "1", "--save_samples", "--smc_group", "2"])
    # 'none' runs at strength 0 only, as in the JAX CLI
    assert [r["method"] for r in results] == ["mc_feng+grad", "grad", "smc"]
    for r in results:
        keys = EXP1_KEYS | {"classifier_fid_x"}
        if r["method"] == "mc_feng+grad":
            keys |= MC_KEYS
        if r["method"] == "smc":
            keys |= SMC_KEYS
            assert r["smc_resample_tau"] == 0.5
            assert 1.0 <= r["smc_final_ess"] <= 3.0
            assert 0.0 <= r["smc_resamples"] <= 2.0
        assert set(r) == keys and r["n_chunks"] == 1
        assert np.isfinite(r["classifier_fid_x"])
    saved = np.load(tmp_path / "outputs" /
                    "samples_grad_gamma0.5_rotate90.npz")
    assert saved["x"].shape == (3, 28, 28, 1)
    assert json.loads((tmp_path / "outputs" / "evaluation_results.json")
                      .read_text()) == results
