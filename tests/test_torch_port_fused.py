"""The fused K-step trainers of the PyTorch port (--fused_steps) against
the port's single steps and the JAX package's fused trainers, on the CPU.

* the index loaders (get_index_chunk_loader, get_ratio_index_loader,
  get_mnist_svhn_ratio_index_loader) equal JAX's bit for bit for the same
  seed and epoch (JAX tests/test_train_fused.py);
* the fused FM step and the fused ratio step (BatchNorm and dropout on)
  equal K port single steps on the same draws, bit for bit;
* JAX's make_fm_train_multistep and make_ratio_train_multistep (dropout
  off) against K port single steps on the draws JAX's sub-step keys give:
  the sub-step losses to rtol 1e-4 and the parameters, EMA and BatchNorm
  running statistics to 1e-4·max|ref| (max over the whole tree), with the
  EMA on and off, at the train CLIs' lr 1e-4 (Adam moves an element whose
  gradient is at float32 rounding level by about ±lr in either framework,
  so the experiment-2 net's conv biases, each followed by a BatchNorm that
  removes it and so with a zero gradient in exact arithmetic, are left
  out of the parameter comparison);
* every fused train CLI at --fused_steps 2 --device cpu on a few
  synthetic digits: the "Fused dispatch" line and the checkpoints;
  --fused_steps with more than one process refused.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratio_guided_multimodal_fm_tpu.data import mnist_dataset as jmd
from ratio_guided_multimodal_fm_tpu.data import mnist_svhn as jms
from ratio_guided_multimodal_fm_tpu.train import steps as jsteps
from ratio_guided_multimodal_fm_tpu_torch.cli import (
    train_flow,
    train_flow_mnist32,
    train_flow_svhn,
    train_ratio,
    train_ratio_mnist_svhn,
)
from ratio_guided_multimodal_fm_tpu_torch.core.prng import derive_seed
from ratio_guided_multimodal_fm_tpu_torch.data import mnist_dataset as pmd
from ratio_guided_multimodal_fm_tpu_torch.data import mnist_svhn as pms
from ratio_guided_multimodal_fm_tpu_torch.interop.from_jax import (
    unet_state_dict,
)
from ratio_guided_multimodal_fm_tpu_torch.train import steps as S
from test_torch_port_ratio_train import (  # noqa: F401 (a fixture)
    FAMILIES,
    _family,
    _to_port,
    no_flax_dropout,
)
from test_torch_port_train import BRIDGE, H, _jax_net, _keys_draws, _port_net

torch.set_num_threads(2)

K, B = 3, 4


@pytest.fixture(scope="module")
def data_roots(tmp_path_factory):
    import os
    os.environ["RGMF_SYNTH_N"] = "300"
    yield [str(tmp_path_factory.mktemp(n)) for n in ("jax", "port")]
    os.environ.pop("RGMF_SYNTH_N")


def _same_chunks(jl, pl, keys=None):
    for e in (0, 1):
        jb, pb = list(jl.epoch(e)), list(pl.epoch(e))
        assert len(jb) == len(pb) == len(jl) == len(pl) > 0
        for a, b in zip(jb, pb):
            for k in (keys or [None]):
                av, bv = (a, b) if k is None else (a[k], b[k])
                assert bv.dtype == np.asarray(av).dtype
                np.testing.assert_array_equal(bv, np.asarray(av), err_msg=k)


@pytest.mark.parametrize("train", [True, False])
def test_index_chunk_loader_matches_jax(train):
    jl = jmd.get_index_chunk_loader(1000, 16, 4, train=train, seed=3)
    pl = pmd.get_index_chunk_loader(1000, 16, 4, train=train, seed=3)
    assert len(pl) == 1000 // 64
    _same_chunks(jl, pl)
    assert next(pl.epoch(0)).shape == (4, 16)


CHUNK_KEYS = ("xidx", "yidx", "is_real")


def test_ratio_index_loader_matches_jax(data_roots):
    jx, jy, jl = jmd.get_ratio_index_loader("rotate90", 16, 3, 0.4, True,
                                            data_roots[0], seed=5)
    px, py, pl = pmd.get_ratio_index_loader("rotate90", 16, 3, 0.4, True,
                                            data_roots[1], seed=5,
                                            device="cpu")
    np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(py.numpy(), np.asarray(jy))
    _same_chunks(jl, pl, CHUNK_KEYS)


def test_mnist_svhn_ratio_index_loader_matches_jax(data_roots):
    jx, jy, jl = jms.get_mnist_svhn_ratio_index_loader(16, 3, 0.5, True,
                                                       data_roots[0], seed=6)
    px, py, pl = pms.get_mnist_svhn_ratio_index_loader(16, 3, 0.5, True,
                                                       data_roots[1], seed=6)
    np.testing.assert_array_equal(px, np.asarray(jx))
    np.testing.assert_array_equal(py, np.asarray(jy))
    _same_chunks(jl, pl, CHUNK_KEYS)


def _fm_pair(ema):
    _, v = _jax_net(0)
    return [S.create_fm_state(_port_net(v), "cpu", lr=1e-3, ema_decay=ema)
            for _ in range(2)]


def _dataset(n=24, shape=(H, H, 1), seed=5):
    return torch.from_numpy(np.random.RandomState(seed).randn(
        n, *shape).astype(np.float32))


def _idx(n=24, seed=6):
    return np.random.RandomState(seed).randint(0, n, (K, B)).astype(np.int32)


def _equal_states(a, b):
    for k, t in a.model.state_dict().items():
        assert torch.equal(t, b.model.state_dict()[k]), k
    for k in (a.ema or {}):
        assert torch.equal(a.ema[k], b.ema[k]), k


@pytest.mark.parametrize("ema", [None, 0.9], ids=["no_ema", "ema"])
def test_fused_fm_equals_k_single_steps(ema):
    fused_state, ref = _fm_pair(ema)
    data, idx = _dataset(), _idx()
    for m in (fused_state.model, ref.model):   # dropout on
        for mod in m.modules():
            if isinstance(mod, torch.nn.Dropout):
                mod.p = 0.1
    gen = torch.Generator().manual_seed(77)
    loss = S.make_fm_train_multistep(ema)(fused_state, data, idx, gen)
    seed = gen.initial_seed()
    S._seed_dropout(torch.device("cpu"), derive_seed(seed, 1))
    single, losses = S.make_fm_train_step(ema), []
    for j in range(K):
        g = torch.Generator().manual_seed(derive_seed(seed, 0, j))
        t = torch.rand((B,), generator=g)
        x0 = torch.randn((B, H, H, 1), generator=g)
        losses.append(single(ref, data[torch.from_numpy(idx[j]).long()],
                             t=t, x0=x0))
    assert torch.equal(loss, torch.stack(losses).mean())
    _equal_states(fused_state, ref)


def test_fused_ratio_equals_k_single_steps():
    """The experiment-2 net: BatchNorm's running statistics and the EMA
    carry through the K sub-steps; dropout on, one seed a macro step."""
    _, _, net, _, _ = _family("mnist_svhn", seed=3)
    states = []
    for _ in range(2):
        torch.manual_seed(0)
        n = type(net)()
        n.load_state_dict(net.state_dict())
        states.append(S.create_ratio_state(n, "cpu", lr=1e-3,
                                           ema_decay=0.9))
    fused_state, ref = states
    xa = _dataset(12, (32, 32, 1), seed=1)
    ya = _dataset(12, (32, 32, 3), seed=2)
    xi, yi = _idx(12, 3), _idx(12, 4)
    real = (np.random.RandomState(5).rand(K, B) < 0.5).astype(np.float32)
    gen = torch.Generator().manual_seed(9)
    met = S.make_ratio_train_multistep("disc", 0.9)(fused_state, xa, ya, xi,
                                                    yi, real, gen)
    S._seed_dropout(torch.device("cpu"), derive_seed(gen.initial_seed(), 1))
    single = S.make_ratio_train_step("disc", 0.9)
    outs = [single(ref, xa[torch.from_numpy(xi[j]).long()],
                   ya[torch.from_numpy(yi[j]).long()], real[j])
            for j in range(K)]
    for k in met:
        assert torch.equal(met[k], torch.stack([o[k] for o in outs]).mean())
    _equal_states(fused_state, ref)
    assert int(fused_state.model.state_dict()[
        "encoder_svhn.bn1a.num_batches_tracked"]) == K


def _before_batchnorm(key):
    """A conv bias that a BatchNorm follows (its exact gradient is 0)."""
    return re.fullmatch(r"encoder_\w+\.conv\w+\.bias", key) is not None


def _close_trees(got, want, start, what=""):
    """Every leaf within 1e-4·max|ref| over the whole reference tree, and
    within 5e-2 of its own update over the K steps in the 2-norm,
    |got − ref| ≤ 5e-2·|ref − start|: a sub-step dropped or repeated moves
    a leaf by about a third of that update (Adam moves an element by about
    lr a step), while the two frameworks' float32 sums leave at most
    1.3e-2 of it (the experiment-2 net's first BatchNorm; 1e-3 at most in
    the U-Net)."""
    scale = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= 1e-4 * scale, what + k
        update = np.linalg.norm((w - start[k]).astype(np.float64).ravel())
        diff = np.linalg.norm((got[k] - w).astype(np.float64).ravel())
        assert diff <= 5e-2 * update, (what + k, diff, update)


@pytest.mark.parametrize("ema", [None, 0.9], ids=["no_ema", "ema"])
def test_jax_fused_fm_matches_port_single_steps(ema):
    jnet, v = _jax_net(0)
    jstate = jsteps.create_fm_state(jnet, jax.random.PRNGKey(0), (H, H, 1),
                                    lr=1e-4, ema_decay=ema)
    jstate = jstate.replace(params=v["params"])
    if ema is not None:
        jstate = jstate.replace(ema_params=v["params"])
    data, idx = _dataset(), _idx()
    key = jax.random.PRNGKey(21)
    fused = jsteps.make_fm_train_multistep(jnet, donate=False,
                                           ema_decay=ema)
    jstate, jloss = fused(jstate, jnp.asarray(data.numpy()),
                          jnp.asarray(idx), key)

    state = S.create_fm_state(_port_net(v), "cpu", lr=1e-4, ema_decay=ema)
    start = {k: p.detach().numpy().copy()
             for k, p in state.model.named_parameters()}
    single, losses = S.make_fm_train_step(ema), []
    for j in range(K):
        t, x0 = _keys_draws(jax.random.fold_in(key, j), B)
        losses.append(single(state, data[torch.from_numpy(idx[j]).long()],
                             t=torch.from_numpy(t), x0=torch.from_numpy(x0)))
    np.testing.assert_allclose(float(torch.stack(losses).mean()),
                               float(jloss), rtol=1e-4)
    want = unet_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, jstate.params)}, **BRIDGE)
    _close_trees({k: p.detach().numpy() for k, p in
                  state.model.named_parameters()},
                 {k: w.numpy() for k, w in want.items()}, start)
    if ema is not None:
        want = unet_state_dict({"params": jax.tree_util.tree_map(
            np.asarray, jstate.ema_params)}, **BRIDGE)
        _close_trees({k: e.numpy() for k, e in state.ema.items()},
                     {k: w.numpy() for k, w in want.items()}, start, "ema ")


@pytest.mark.parametrize("ema", [None, 0.9], ids=["no_ema", "ema"])
def test_jax_fused_ratio_matches_port_single_steps(no_flax_dropout, ema):
    jnet, v, net, _, _ = _family("mnist_svhn", seed=10)
    jstate = jsteps.create_ratio_state(jnet, jax.random.PRNGKey(0),
                                       FAMILIES["mnist_svhn"][3],
                                       FAMILIES["mnist_svhn"][4],
                                       has_batch_stats=True, lr=1e-4,
                                       ema_decay=ema)
    jstate = jstate.replace(params=v["params"],
                            batch_stats=v["batch_stats"])
    if ema is not None:
        jstate = jstate.replace(ema_params=v["params"])
    xa = _dataset(12, (32, 32, 1), seed=1)
    ya = _dataset(12, (32, 32, 3), seed=2)
    xi, yi = _idx(12, 3), _idx(12, 4)
    real = (np.random.RandomState(5).rand(K, B) < 0.5).astype(np.float32)
    fused = jsteps.make_ratio_train_multistep(jnet, "disc",
                                              has_batch_stats=True,
                                              donate=False, ema_decay=ema)
    jstate, jmet = fused(jstate, jnp.asarray(xa.numpy()),
                         jnp.asarray(ya.numpy()), jnp.asarray(xi),
                         jnp.asarray(yi), jnp.asarray(real),
                         jax.random.PRNGKey(4))

    state = S.create_ratio_state(net, "cpu", lr=1e-4, ema_decay=ema)
    start = {k: t.numpy().copy() for k, t in state.model.state_dict().items()}
    single = S.make_ratio_train_step("disc", ema)
    outs = [single(state, xa[torch.from_numpy(xi[j]).long()],
                   ya[torch.from_numpy(yi[j]).long()], real[j])
            for j in range(K)]
    for k in jmet:
        np.testing.assert_allclose(
            float(torch.stack([o[k] for o in outs]).mean()), float(jmet[k]),
            rtol=1e-4, atol=1e-6, err_msg=k)
    want = _to_port(jax.tree_util.tree_map(np.asarray, jstate.params),
                    "mnist_svhn", jax.tree_util.tree_map(
                        np.asarray, jstate.batch_stats))
    got = state.model.state_dict()
    assert sum(map(_before_batchnorm, want)) == 12
    _close_trees({k: t.numpy() for k, t in got.items()},
                 {k: w.numpy() for k, w in want.items()
                  if not k.endswith("num_batches_tracked")
                  and not _before_batchnorm(k)}, start)
    if ema is not None:
        want = _to_port(jax.tree_util.tree_map(np.asarray,
                                               jstate.ema_params),
                        "mnist_svhn", jax.tree_util.tree_map(
                            np.asarray, jstate.batch_stats))
        _close_trees({k: e.numpy() for k, e in state.ema.items()},
                     {k: want[k].numpy() for k in state.ema
                      if not _before_batchnorm(k)}, start, "ema ")


def _cli_env(tmp_path, monkeypatch, n):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("RGMF_SYNTH_N", str(n))
    return ["--device", "cpu", "--data_root", str(tmp_path / "data"),
            "--epochs", "1", "--batch_size", "4", "--fused_steps", "2"]


@pytest.mark.parametrize("cli,argv,n,files", [
    (train_flow, ["--modality", "x", "--save_every", "1"], 16,
     ["flow_x_best.pth", "flow_x_epoch1.pth"]),
    (train_flow_mnist32, ["--save_every", "1"], 16,
     ["flow_mnist32_best.pth", "flow_mnist32_epoch1.pth"]),
    (train_flow_svhn, ["--ema_decay", "0.99"], 16,
     ["flow_svhn_best.pth", "flow_svhn_ema_best.pth"]),
    (train_ratio, ["--loss_type", "rulsif"], 64,
     ["ratio_rulsif_rotate90_best.pth"]),
    (train_ratio_mnist_svhn, [], 64, ["ratio_disc_mnist_svhn_best.pth"]),
], ids=["flow_x", "mnist32", "svhn", "ratio_exp1", "ratio_exp2"])
def test_fused_train_clis_run_on_cpu(tmp_path, monkeypatch, capsys, cli,
                                     argv, n, files):
    _, best, hist = cli.main(_cli_env(tmp_path, monkeypatch, n) + argv)
    out = capsys.readouterr().out
    programs = n // (2 * 4)
    assert (f"Fused dispatch: 2 steps/program, {programs} programs/epoch"
            in out)
    assert np.isfinite(best) and hist[-1]["epoch"] == 1
    import os
    assert sorted(os.listdir("checkpoints")) == files


def test_fused_refused_with_several_processes(tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="single-process only"):
        train_flow_mnist32.main(_cli_env(tmp_path, monkeypatch, 16) + [
            "--coordinator_address", "127.0.0.1:1", "--num_processes", "2",
            "--process_id", "0"])
