"""Flow-matching training of one velocity net, as the train CLIs take it
with `--fused_steps K`: `make_fm_train_multistep(ema_decay)` on a
`create_fm_state(model, device, lr, ema_decay)` state (Adam, EMA); each
call takes K steps over K batches of rows of the dataset on the card, the
first call eagerly, then one CUDA graph replay a call.

Traffic keys: net (the configuration's role), batch, fused_steps, lr,
ema_decay, check_calls. The dataset (configuration key `data`, images of
the net's shape) is made on the card from the seed; each epoch visits it
in an order drawn from the seed, so the rows of an epoch all differ. Each
call's generator is seeded from the seed and the call's position; the
trainer under test draws t, x_0 and the dropout masks from it.

Set-up takes the first `check_calls` calls through the window's own call
and feed (the eager warm-up and capture, then the first replay), keeping
Adam's first moment after the first call and the parameters and EMA after
the last; the window goes on from that same state. The reference then
takes those steps from the same weights, batches and draws:
* loss_gap: each call's (mean) loss, relative;
* moment_gap: `compare.leaf_gap` of Adam's first moment after the first
  call, a fixed mix of the call's K gradients, which the graph keeps
  inside;
* step_gap / ema_gap: `leaf_gap` of the parameters' and the EMA's change
  over the calls, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (`compare.moving_leaves`).
"""
from __future__ import annotations

import torch

from portbench.drivers import common
from portbench.harness import counts
from portbench.harness.compare import (
    leaf_gap,
    moving_leaves,
    norms,
    reading,
    rel_gap,
)
from portbench.harness.seeds import derive
from portbench.harness.weights import make_images, make_params
from portbench.reference import train as ref
from portbench.reference.nets import Net
from portbench.reference.precision import tf32_scope


class Driver:
    unit = "samples"
    sync_each = False
    traced_calls = 6
    subjects = ("lower", "half_batch", "fp32_cl")

    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device, sizes: dict = None):
        sizes = sizes or {}
        self.seed, self.device = seed, device
        self.role = traffic["net"]
        self.net = config["nets"][self.role]
        self.B = sizes.get("batch", traffic["batch"])
        self.K = sizes.get("fused_steps", traffic["fused_steps"])
        self.n_data = sizes.get("data", config["data"][self.role])
        self.lr, self.ema_decay = traffic["lr"], traffic["ema_decay"]
        self.check_calls = traffic["check_calls"]
        self.dtype = config["train_dtype"]
        self.per_epoch = self.n_data // (self.K * self.B)
        self.orders = {}
        self.next = self.check_calls

    def _rows(self, c: int) -> torch.Tensor:
        """Call c's rows of the dataset, [K, B]."""
        e, j = divmod(c, self.per_epoch)
        if e not in self.orders:
            g = torch.Generator(self.device).manual_seed(
                derive(self.seed, "epoch", e))
            self.orders = {e: torch.randperm(self.n_data, generator=g,
                                             device=self.device)}
        n = self.K * self.B
        return self.orders[e][j * n:(j + 1) * n].view(self.K, self.B)

    def _call_seed(self, c: int) -> int:
        return derive(self.seed, "step", c)

    # ------------------------------------------------------------ program
    def setup(self) -> None:
        from ratio_guided_multimodal_fm_tpu_torch.train.steps import (
            create_fm_state,
            make_fm_train_multistep,
        )

        common.build_kernels(self.device)
        net = self.net
        P = make_params(net["kind"], net["arch"],
                        derive(self.seed, "weights", self.role), self.device)
        self.state = create_fm_state(
            common.port_net(net, self.dtype, P, self.device), self.device,
            lr=self.lr, ema_decay=self.ema_decay)
        del P
        self.data = make_images((self.n_data,) + common.shape(net),
                                derive(self.seed, "data", self.role),
                                self.device)
        self.step = make_fm_train_multistep(self.ema_decay)
        names = dict(self.state.model.named_parameters())
        losses = []
        for c in range(self.check_calls):
            losses.append(self._call(c))
            if c == 0:
                st = self.state.optimizer.state
                self.moment = {n: st[p]["exp_avg"].clone()
                               if p in st else torch.zeros_like(p)
                               for n, p in names.items()}
        self.after = {n: p.detach().clone() for n, p in names.items()}
        self.ema_after = {n: e.clone() for n, e in self.state.ema.items()}
        self.losses = [float(v) for v in losses]

    def _call(self, c: int):
        g = torch.Generator(self.device).manual_seed(self._call_seed(c))
        return self.step(self.state, self.data, self._rows(c), g)

    def call(self, i: int) -> int:
        self.next = self.check_calls + i + 1
        self._call(self.next - 1)
        return self.K * self.B

    def traced(self) -> int:
        """The calls that follow the window's, for the profiler."""
        for i in range(self.traced_calls):
            self._call(self.next + i)
        return self.K * self.B * self.traced_calls

    def work(self, window) -> dict:
        net = self.net
        sites = counts.net_gn_sites(net["kind"], net["arch"])
        item = common.DTYPES[self.dtype].itemsize
        return {"kind": "train", "units_per_s": window.rate,
                "flops_per_unit": counts.TRAIN_FLOP_FACTOR
                * counts.net_flops(net["kind"], net["arch"], 1),
                "gn_bwd_bytes": self.traced_calls * self.K
                * counts.gn_backward_bytes(sites, self.B, item)}

    def free(self) -> None:
        del self.state, self.step

    # ---------------------------------------------------------- reference
    def _generators(self, c: int):
        """The generators of call c's steps, as the trainer under test
        draws from them."""
        dev, seed = self.device, self._call_seed(c)
        return [torch.Generator(dev).manual_seed(ref.position_seed(seed, 0, j))
                for j in range(self.K)]

    def _reference(self, precision: str, keep: int = None) -> dict:
        """The set-up's calls in the reference: the first gradient's leaf
        norms, Adam's first moment after the first call, the losses, and
        the leaf norms of the parameters' and the EMA's change."""
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
                    x1 = self.data.index_select(0, rows[j])
                    loss = ref.cfm_loss(model, x1, g, precision, keep)
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

    def check(self, limits: dict, subject: str = None) -> list:
        """The readings of the set-up's calls against the reference. With
        a `subject`, of a stand-in in the program's place instead: "lower"
        the control (the reference one precision below the
        configuration's), "half_batch" the reference with the loss over
        half the batch, "fp32_cl" the reference with other float32
        convolution algorithms."""
        want = self._reference("fp32")
        if subject is None:
            p0 = want["p0"]
            got = {"losses": self.losses, "moment": norms(self.moment),
                   "change": norms({k: self.after[k] - p0[k] for k in p0}),
                   "ema": norms({k: self.ema_after[k] - p0[k] for k in p0})}
        else:
            got = self._reference(*SUBJECTS[subject](self))
        moving = moving_leaves(want["grad"])
        stat = limits.get("leaf_stat", "worst")
        limits = limits["limits"]
        out = [reading("loss_gap", max(rel_gap(a, b) for a, b in
                                       zip(got["losses"], want["losses"])),
                       limits["loss_gap"])]
        for name, key, keys in (("moment_gap", "moment", None),
                                ("step_gap", "change", moving),
                                ("ema_gap", "ema", moving)):
            value, detail = leaf_gap(got[key], want[key], keys, stat)
            out.append(reading(name, value, limits[name], detail))
        return out


SUBJECTS = {"lower": lambda d: (common.LOWER[d.dtype],),
            "half_batch": lambda d: ("fp32", d.B // 2),
            "fp32_cl": lambda d: ("fp32_cl",)}
