"""Flow-matching training of a class-conditional velocity net (SiT), as
`cli/train_flow.py --model sit_*` takes it: `make_fm_train_multistep`
with the dataset's labels on the card, K steps a call, the first call
eagerly, then one CUDA graph replay a call.

Everything of `train_flow.Driver` (traffic keys, rows, seeds, the check's
numbers and controls), and:
* labels uniform over the net's `num_classes`, one a row of the dataset,
  made on the card from the seed;
* each call passes them to the step (`labels=`), which gathers each
  sub-step's rows of them on the device, beside the latents;
* the reference's loss takes the same t, x_0, rows and labels, and draws
  its label drop from the device's default generator seeded as the
  trainer under test seeds it (once a call), so both drop the same labels;
* `work()` adds `attn_flops` (3 × the forward's two attention products,
  the kind's `attn_flops`, over the examples of the profiled stretch, as
  `mfu.train` counts) and `attn_calls` (the set-up's attention calls by
  backend, from the program's `ops` counters; {} where it has none).
"""
from __future__ import annotations

import torch

from portbench.drivers import train_flow
from portbench.harness import counts
from portbench.harness.compare import norms
from portbench.harness.seeds import derive
from portbench.harness.weights import make_params
from portbench.reference import kinds
from portbench.reference import train as ref
from portbench.reference.nets import Net
from portbench.reference.precision import tf32_scope

ATTN_COUNTERS = ("sdpa.efficient_launches", "sdpa.math_launches")


def make_labels(n: int, classes: int, seed: int,
                device: torch.device) -> torch.Tensor:
    """n labels uniform over [0, classes), int64."""
    g = torch.Generator(device).manual_seed(seed)
    return torch.randint(0, classes, (n,), generator=g, device=device)


def attn_counts() -> dict:
    """The program's attention counters (`ops.launch_counts`), {} where
    it has none."""
    from ratio_guided_multimodal_fm_tpu_torch.ops import launch_counts

    got = launch_counts()
    return {k: got[k] for k in ATTN_COUNTERS if k in got}


def cond_cfm_loss(net: Net, x1: torch.Tensor, y: torch.Tensor,
                  generator: torch.Generator, precision: str = "fp32",
                  keep: int = None) -> torch.Tensor:
    """`reference.train.cfm_loss` with the labels y passed to the net
    (train mode: SiT's label drop) beside t."""
    B = x1.shape[0]
    t = torch.rand((B,), generator=generator, dtype=torch.float32,
                   device=x1.device)
    x0 = torch.randn(x1.shape, generator=generator, dtype=torch.float32,
                     device=x1.device)
    tb = t.reshape(B, 1, 1, 1)
    x_t = (1.0 - tb) * x0 + tb * x1
    v = net(x_t.permute(0, 3, 1, 2), (t, y), precision,
            train=True).permute(0, 2, 3, 1)
    return torch.mean(((v - (x1 - x0)) ** 2)[:keep])


class Driver(train_flow.Driver):
    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device, sizes: dict = None):
        super().__init__(config, traffic, seed, device, sizes)
        self.classes = self.net["arch"]["num_classes"]

    # ------------------------------------------------------------ program
    def setup(self) -> None:
        self.labels = make_labels(self.n_data, self.classes,
                                  derive(self.seed, "labels", self.role),
                                  self.device)
        before = attn_counts()
        super().setup()
        self.attn_calls = {k: n - before[k]
                           for k, n in attn_counts().items()}

    def _call(self, c: int):
        g = torch.Generator(self.device).manual_seed(self._call_seed(c))
        return self.step(self.state, self.data, self._rows(c), g,
                         labels=self.labels)

    def work(self, window) -> dict:
        net = self.net
        out = super().work(window)
        out.update(attn_flops=counts.TRAIN_FLOP_FACTOR * kinds.load(
            net["kind"]).attn_flops(net["arch"],
                                    self.K * self.B * self.traced_calls),
            attn_calls=self.attn_calls)
        return out

    # ---------------------------------------------------------- reference
    def _reference(self, precision: str, keep: int = None) -> dict:
        """`train_flow.Driver._reference` with the labels."""
        net, dev = self.net, self.device
        P = make_params(net["kind"], net["arch"],
                        derive(self.seed, "weights", self.role), dev)
        model = Net(net["kind"], net["arch"], P)
        keys = model.trainable()
        p0 = {k: P[k].clone() for k in keys}
        ref.trainable(P, keys)
        adam = ref.Adam(P, keys, self.lr)
        ema = ref.Ema(P, keys, self.ema_decay)
        losses, grad0, moment = [], None, None
        with tf32_scope(precision):
            for c in range(self.check_calls):
                rows = self._rows(c)
                ref.seed_dropout(dev, ref.dropout_seed(self._call_seed(c)))
                total = 0.0
                for j, g in enumerate(self._generators(c)):
                    loss = cond_cfm_loss(
                        model, self.data.index_select(0, rows[j]),
                        self.labels.index_select(0, rows[j]), g, precision,
                        keep)
                    grads = dict(zip(keys, torch.autograd.grad(
                        loss, [P[n] for n in keys])))
                    if grad0 is None:
                        grad0 = norms(grads)
                    adam.step(grads)
                    ema.update()
                    total += float(loss.detach())
                losses.append(total / self.K)
                if c == 0:
                    moment = norms(adam.m)
        return {"p0": p0, "grad": grad0, "moment": moment, "losses": losses,
                "change": norms({k: P[k] - p0[k] for k in keys}),
                "ema": norms({k: ema.e[k] - p0[k] for k in keys})}
