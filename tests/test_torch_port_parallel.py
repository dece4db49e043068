"""Multi-process runs of the PyTorch port on the CPU (gloo), the
counterparts of the JAX package's tests/test_multihost.py,
test_multihost_train.py and test_multichip.py:

* `process_batch_slice` and `globalize_batch`: contiguous rank blocks, the
  divisibility error, a two-process global batch assembled back;
* a two-process data-parallel step equal to one process on the whole
  batch (parameters within 1e-5·max|p|, float32 with a different sum
  order; dropout off, as each rank draws its own masks): the FM step with
  an EMA, the experiment-1 ratio net with `rulsif` (the squared global
  mean) and the experiment-2 ratio net with `disc` (BatchNorm on the
  global batch's statistics, the running statistics held too). The
  update is SGD here: Adam divides each gradient element by its size, so
  an element whose gradient is at the sums' rounding level (BatchNorm's
  shift-invariant directions) moves by ±lr whichever the sum order; the
  step's own code (loss shares, the gradient sum, the clip, the EMA, the
  statistics) is the same for either optimizer;
* skewed preemption: one rank sees the flag, both stop at the same step;
* `train_flow_mnist32` as two processes through its multi-process flags:
  the same metrics on both ranks, one set of files.

All two-process cases run in one spawn of two workers (module fixture).
"""
import json
import os

import numpy as np
import pytest
import torch

from _torch_port_workers import run_workers
from ratio_guided_multimodal_fm_tpu_torch.data.sources import (
    load_mnist,
    load_svhn,
)
from ratio_guided_multimodal_fm_tpu_torch.models.unet import FlexibleUNet
from ratio_guided_multimodal_fm_tpu_torch.parallel import (
    make_mesh,
    pad_to_multiple,
    shard_batch,
)
from ratio_guided_multimodal_fm_tpu_torch.parallel.multihost import (
    choose_backend,
    globalize_batch,
    local_ranks,
    maybe_init_distributed,
    process_batch_slice,
    process_info,
)
from ratio_guided_multimodal_fm_tpu_torch.train import steps as S

torch.set_num_threads(2)

B, STEPS = 8, 2

# the cases, shared by the workers and the one-process references below
CASES = """
from ratio_guided_multimodal_fm_tpu_torch.models import (
    RatioEstimatorMNIST, RatioEstimatorMNISTSVHN)
from ratio_guided_multimodal_fm_tpu_torch.models.unet import FlexibleUNet
from ratio_guided_multimodal_fm_tpu_torch.train import steps as S
from ratio_guided_multimodal_fm_tpu_torch.core.prng import RNG

B, STEPS = 8, 2


def no_dropout(m):
    for mod in m.modules():
        if isinstance(mod, torch.nn.Dropout):
            mod.p = 0.0
    return m


def generic(m):
    # every parameter moved off its initial value (the nets start as flax's
    # do: zero biases, a zero out_conv): each leaf is then held at its own
    # scale, and the first step already reaches every layer
    with torch.no_grad():
        for p in m.parameters():
            p.add_(0.1 * torch.randn_like(p))
    return m


def fm_case(adapt):
    torch.manual_seed(0)
    net = generic(FlexibleUNet(in_channels=1, img_size=8, model_channels=8,
                               channel_mult=(1, 2), num_res_blocks=1,
                               dropout=0.0))
    state = S.create_fm_state(net, "cpu", ema_decay=0.9)
    state.optimizer = torch.optim.SGD(state.model.parameters(), lr=0.05)
    state, step, extract = adapt(state, S.make_fm_train_step(0.9),
                                 lambda b: b)
    rng, losses = RNG(5), []
    for i in range(STEPS):
        x = torch.from_numpy(np.random.RandomState(10 + i).randn(
            B, 8, 8, 1).astype(np.float32))
        losses.append(float(step(state, extract(x), rng.generator(0, i))))
    return state, losses


def ratio_case(adapt, kind):
    torch.manual_seed(1)
    if kind == "rulsif":
        net, xs, ys = RatioEstimatorMNIST(loss_type="rulsif"), 28, (28, 1)
        kw = dict(alpha=0.2, lambda_penalty=0.1)
    else:
        net, xs, ys = RatioEstimatorMNISTSVHN(), 32, (32, 3)
        kw = {}
    state = S.create_ratio_state(generic(no_dropout(net)), "cpu",
                                 ema_decay=0.9)
    state.optimizer = torch.optim.SGD(state.model.parameters(), lr=0.05)
    step = S.make_ratio_train_step(kind, ema_decay=0.9, **kw)
    state, step_fn, extract = adapt(
        state, lambda s, b, g: step(s, b["x"], b["y"], b["is_real"], g),
        lambda b: b)
    rng, metrics = RNG(7), []
    for i in range(STEPS):
        r = np.random.RandomState(20 + i)
        b = {"x": torch.from_numpy(r.randn(B, xs, xs, 1).astype(np.float32)),
             "y": torch.from_numpy(r.randn(B, ys[0], ys[0], ys[1]).astype(
                 np.float32)),
             "is_real": torch.from_numpy((r.rand(B) < 0.5).astype(
                 np.float32))}
        m = step_fn(state, extract(b), rng.generator(0, i))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def state_arrays(state):
    out = {"p:" + k: v.detach().numpy() for k, v in
           state.model.state_dict().items()}
    out.update({"e:" + k: v.detach().numpy() for k, v in state.ema.items()})
    return out
"""

WORKER = CASES + """
import json
from ratio_guided_multimodal_fm_tpu_torch.cli.common import multihost_adapt
from ratio_guided_multimodal_fm_tpu_torch.parallel.multihost import (
    globalize_batch)
from ratio_guided_multimodal_fm_tpu_torch.train.loop import train_epochs
from ratio_guided_multimodal_fm_tpu_torch.train.preemption import (
    request_preemption)
import torch.distributed as dist

res = {}
state, res["fm_losses"] = fm_case(multihost_adapt)
np.savez(os.path.join(OUT, f"fm_{RANK}.npz"), **state_arrays(state))
for kind in ("rulsif", "disc"):
    state, res[kind] = ratio_case(multihost_adapt, kind)
    np.savez(os.path.join(OUT, f"{kind}_{RANK}.npz"), **state_arrays(state))

# a global batch assembled back from the ranks' rows
full = torch.arange(12 * 3, dtype=torch.float32).reshape(12, 3)
rows = globalize_batch({"a": full})["a"]
back = torch.zeros_like(full)
back[RANK * 6:(RANK + 1) * 6] = rows
dist.all_reduce(back)
res["assembled"] = bool(torch.equal(back, full))

# skewed preemption: rank 1 alone sees the flag after step 2
torch.manual_seed(0)
net = FlexibleUNet(in_channels=1, img_size=8, model_channels=8,
                   channel_mult=(1, 2), num_res_blocks=1, dropout=0.0)
pstate, pstep, pext = multihost_adapt(S.create_fm_state(net, "cpu"),
                                      S.make_fm_train_step(), lambda b: b)
count = {"n": 0}

def counting(s, x, g):
    out = pstep(s, pext(x), g)
    count["n"] += 1
    if RANK == 1 and count["n"] == 3:
        request_preemption()
    return out

def data_iter(epoch):
    r = np.random.RandomState(100 + epoch)
    for _ in range(6):
        yield torch.from_numpy(r.randn(B, 8, 8, 1).astype(np.float32))

_, _, hist = train_epochs(pstate, counting, data_iter, 2, RNG(3),
                          log_fn=lambda m: None)
res["preempt"] = [count["n"], hist[-1].get("preempted_at_step")]

# the MNIST-32 flow CLI as two processes
from ratio_guided_multimodal_fm_tpu_torch.cli import train_flow_mnist32
_, best, hist = train_flow_mnist32.main([
    "--device", "cpu", "--data_root", os.path.join(OUT, "data"),
    "--epochs", "1", "--batch_size", "4", "--save_every", "1",
    "--coordinator_address", "127.0.0.1:" + os.environ["PORT"],
    "--num_processes", "2", "--process_id", str(RANK)])
res["cli"] = [best, hist[-1]["loss"]]
res["cli_files"] = sorted(os.listdir("checkpoints"))
with open(os.path.join(OUT, f"res_{RANK}.json"), "w") as f:
    json.dump(res, f)
"""


def _single(state, step, extract):
    return state, step, extract


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp")
    os.environ["RGMF_SYNTH_N"] = "16"
    try:
        load_mnist(str(out / "data"), True)   # the cache, written once
        load_svhn(str(out / "data"), True)
        run_workers(WORKER, 2, out, env_extra={"RGMF_SYNTH_N": "16"})
    finally:
        os.environ.pop("RGMF_SYNTH_N")
    res = [json.load(open(out / f"res_{r}.json")) for r in (0, 1)]
    return out, res


def _cases():
    ns = {"np": np, "torch": torch}
    exec(CASES, ns)
    return ns


def _close(out, name, ref):
    for r in (0, 1):
        got = np.load(out / f"{name}_{r}.npz")
        assert sorted(got.files) == sorted(ref)
        for k in ref:
            scale = max(float(np.abs(ref[k]).max()), 1e-30)
            np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                       atol=1e-5 * scale, err_msg=k)


def test_process_batch_slice_contiguous_blocks():
    batch = {"x": np.arange(8), "y": np.arange(16).reshape(8, 2)}
    parts = [process_batch_slice(batch, p, 4) for p in range(4)]
    np.testing.assert_array_equal(np.concatenate([q["x"] for q in parts]),
                                  batch["x"])
    np.testing.assert_array_equal(parts[1]["y"], batch["y"][2:4])
    assert process_batch_slice(batch) is batch        # one process
    with pytest.raises(ValueError, match="not divisible"):
        process_batch_slice({"x": np.arange(6)}, 0, 4)
    with pytest.raises(ValueError, match="not divisible"):
        globalize_batch(torch.zeros(5), 1, 2)
    np.testing.assert_array_equal(globalize_batch(np.arange(6), 2, 3),
                                  [4, 5])


def test_single_process_runtime_is_a_no_op():
    assert not maybe_init_distributed()                       # nothing set
    assert not maybe_init_distributed("127.0.0.1:1")          # no count
    assert not maybe_init_distributed(None, 2, 0)             # no address
    assert not maybe_init_distributed("127.0.0.1:1", 1, 0)    # one process
    assert process_info() == (0, 1)
    assert make_mesh(axis_names=("data", "mc")) is None
    x = torch.arange(6)
    assert torch.equal(shard_batch(None, x), x)
    assert pad_to_multiple(10, 4) == 12


@pytest.mark.parametrize("hosts, device, want, local", [
    # two hosts with a card each: NCCL, each rank on its host's card 0
    ([("a", 1), ("b", 1)], "cuda", "nccl", [(0, 1), (0, 1)]),
    # one host with two cards: NCCL, ranks on cards 0 and 1
    ([("a", 2), ("a", 2)], "cuda", "nccl", [(0, 2), (1, 2)]),
    # two ranks sharing one card: gloo on the CUDA tensors
    ([("a", 1), ("a", 1)], "cuda", "gloo", [(0, 2), (1, 2)]),
    # one host short of cards among two: gloo
    ([("a", 1), ("a", 1), ("b", 2)], "cuda", "gloo",
     [(0, 2), (1, 2), (0, 1)]),
    # the CPU: gloo whatever the cards
    ([("a", 1), ("b", 1)], "cpu", "gloo", [(0, 1), (0, 1)]),
])
def test_backend_and_card_from_ranks_per_host(hosts, device, want, local):
    assert choose_backend(hosts, device, nccl_available=True) == want
    assert choose_backend(hosts, device, nccl_available=False) == "gloo"
    assert [local_ranks(hosts, r) for r in range(len(hosts))] == local


def test_two_process_global_batch_assembly(dp_run):
    _, res = dp_run
    assert res[0]["assembled"] and res[1]["assembled"]


def test_dp_fm_step_matches_one_process_with_ema(dp_run):
    out, res = dp_run
    c = _cases()
    state, losses = c["fm_case"](_single)
    _close(out, "fm", c["state_arrays"](state))
    for r in (0, 1):
        np.testing.assert_allclose(res[r]["fm_losses"], losses, rtol=1e-5)


@pytest.mark.parametrize("kind", ["rulsif", "disc"],
                         ids=["exp1_rulsif", "exp2_batchnorm"])
def test_dp_ratio_step_matches_one_process(dp_run, kind):
    out, res = dp_run
    c = _cases()
    state, metrics = c["ratio_case"](_single, kind)
    ref = c["state_arrays"](state)
    if kind == "disc":    # the running statistics moved and are held
        assert any("running_mean" in k for k in ref)
    _close(out, kind, ref)
    for r in (0, 1):
        for got, want in zip(res[r][kind], metrics):
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           atol=1e-6, err_msg=k)


def test_dp_skewed_preemption_agrees(dp_run):
    _, res = dp_run
    # rank 1 saw the flag after its third step; both stopped there
    assert res[0]["preempt"] == res[1]["preempt"] == [3, 3]


def test_dp_train_cli_two_processes(dp_run):
    _, res = dp_run
    assert res[0]["cli"] == res[1]["cli"]
    assert np.isfinite(res[0]["cli"][0])
    assert res[0]["cli_files"] == ["flow_mnist32_best.pth",
                                   "flow_mnist32_epoch1.pth"]


def test_multihost_adapt_single_process_unchanged():
    from ratio_guided_multimodal_fm_tpu_torch.cli.common import (
        multihost_adapt,
    )

    torch.manual_seed(0)
    state = S.create_fm_state(FlexibleUNet(
        in_channels=1, img_size=8, model_channels=8, channel_mult=(1, 2),
        num_res_blocks=1), "cpu")
    step, extract = object(), object()
    assert multihost_adapt(state, step, extract) == (state, step, extract)
    assert state.dp is None
