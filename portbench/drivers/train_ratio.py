"""Ratio-net training as the train CLIs take it with `--fused_steps K`:
`make_ratio_train_multistep(loss_type, ema_decay)` on a
`create_ratio_state(model, device, lr, clip_norm, ema_decay)` state; each
call gathers K batches of (x, y) pairs from both modalities on the card
and takes K optimizer steps (the disc or rulsif loss, the global-norm
clip, Adam, the EMA, BatchNorm's running statistics): the first call
eagerly, then as one CUDA graph replay a call.

Traffic keys: net, batch, fused_steps, lr, ema_decay, clip_norm,
loss_type, real_fake_ratio, check_calls. Both modalities (configuration
key `data`: the x and y flows' datasets) are made on the card from the
seed; each call's K × B rows of x and of y follow per-epoch orders drawn
from the seed (so an epoch's rows all differ), and each batch row is real
or fake in the ratio given, in an order drawn from the seed.

Set-up takes the first `check_calls` calls through the window's own call
and feed: the first is the eager warm-up and the capture, the second the
first replay. It keeps Adam's first moment after the first call, and the
parameters, BatchNorm's running statistics and the EMA after the last.
The reference takes those check_calls × K steps from the same weights,
rows and dropout seeds:
* loss_gap: each call's mean loss, relative;
* moment_gap: `compare.leaf_gap` of Adam's first moment after the first
  call (the graph keeps the steps' gradients inside the replay, so the
  first moment, a fixed mix of the first call's K gradients, stands for
  them);
* step_gap / stats_gap / ema_gap: `leaf_gap` of the change of the
  parameters (leaves that move: `compare.moving_leaves` on the reference's
  first gradient), of BatchNorm's running statistics and of the EMA.
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

STATS = ("running_mean", "running_var")


class Driver:
    unit = "samples"
    sync_each = False
    traced_calls = 6
    subjects = ("lower", "half_batch", "fp32_cl")

    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device, sizes: dict = None):
        sizes = sizes or {}
        self.seed, self.device, self.traffic = seed, device, traffic
        self.net = config["nets"][traffic["net"]]
        self.B = sizes.get("batch", traffic["batch"])
        self.K = sizes.get("fused_steps", traffic["fused_steps"])
        self.n = {r: sizes.get("data", config["data"][r])
                  for r in ("flow_x", "flow_y")}
        self.shapes = {r: common.shape(config["nets"][r])
                       for r in ("flow_x", "flow_y")}
        self.check_calls = traffic["check_calls"]
        self.dtype = config["train_dtype"]
        self.orders = {}
        self.next = self.check_calls

    def _feed(self, c: int):
        """Call c's (x rows [K, B], y rows [K, B], is_real [K, B])."""
        rows = []
        for r in ("flow_x", "flow_y"):
            per = self.n[r] // (self.K * self.B)
            e, j = divmod(c, per)
            if (r, e) not in self.orders:
                g = torch.Generator(self.device).manual_seed(
                    derive(self.seed, "epoch", r, e))
                self.orders[r, e] = torch.randperm(
                    self.n[r], generator=g, device=self.device)
                self.orders.pop((r, e - 1), None)
            rows.append(self.orders[r, e][j * self.K * self.B:(j + 1)
                                          * self.K * self.B].view(self.K,
                                                                  self.B))
        g = torch.Generator(self.device).manual_seed(
            derive(self.seed, "real", c))
        n_real = round(self.B * self.traffic["real_fake_ratio"])
        order = torch.rand((self.K, self.B), generator=g,
                           device=self.device).argsort(dim=1)
        return rows[0], rows[1], (order < n_real).to(torch.float32)

    def _call_seed(self, c: int) -> int:
        return derive(self.seed, "call", c)

    # ------------------------------------------------------------ program
    def setup(self) -> None:
        from ratio_guided_multimodal_fm_tpu_torch.train.steps import (
            create_ratio_state,
            make_ratio_train_multistep,
        )

        common.build_kernels(self.device)
        net, t = self.net, self.traffic
        P = make_params(net["kind"], net["arch"],
                        derive(self.seed, "weights", t["net"]), self.device)
        self.state = create_ratio_state(
            common.port_net(net, self.dtype, P, self.device), self.device,
            lr=t["lr"], clip_norm=t["clip_norm"], ema_decay=t["ema_decay"])
        del P
        self.data = {r: make_images((self.n[r],) + self.shapes[r],
                                    derive(self.seed, "data", r),
                                    self.device)
                     for r in ("flow_x", "flow_y")}
        self.step = make_ratio_train_multistep(
            t["loss_type"], ema_decay=t["ema_decay"])
        model = self.state.model
        names = dict(model.named_parameters())
        losses = []
        for c in range(self.check_calls):
            losses.append(self._call(c)["loss"])
            if c == 0:
                st = self.state.optimizer.state
                self.moment = {n: st[p]["exp_avg"].clone()
                               if p in st else torch.zeros_like(p)
                               for n, p in names.items()}
        self.after = {n: p.detach().clone() for n, p in names.items()}
        self.stats_after = {n: b.detach().clone()
                            for n, b in model.named_buffers()
                            if n.endswith(STATS)}
        self.ema_after = {n: e.clone() for n, e in self.state.ema.items()}
        self.losses = [float(v) for v in losses]

    def _call(self, c: int):
        xi, yi, real = self._feed(c)
        g = torch.Generator(self.device).manual_seed(self._call_seed(c))
        return self.step(self.state, self.data["flow_x"],
                         self.data["flow_y"], xi, yi, real, g)

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
    def _reference(self, precision: str, keep: int = None) -> dict:
        net, dev, t = self.net, self.device, self.traffic
        P = make_params(net["kind"], net["arch"],
                        derive(self.seed, "weights", t["net"]), dev)
        model = Net(net["kind"], net["arch"], P)
        keys = model.trainable()
        stats = [k for k in P if k.endswith(STATS)]
        p0 = {k: P[k].clone() for k in keys + stats}
        ref.trainable(P, keys)
        adam = ref.Adam(P, keys, t["lr"])
        ema = ref.Ema(P, keys, t["ema_decay"])
        losses, grad0, moment = [], None, None
        with tf32_scope(precision):
            for c in range(self.check_calls):
                xi, yi, real = self._feed(c)
                ref.seed_dropout(dev, ref.dropout_seed(self._call_seed(c)))
                total = 0.0
                for j in range(self.K):
                    loss = ref.disc_loss(
                        model, self.data["flow_x"].index_select(0, xi[j]),
                        self.data["flow_y"].index_select(0, yi[j]), real[j],
                        precision, keep)
                    grads = list(torch.autograd.grad(
                        loss, [P[k] for k in keys]))
                    if grad0 is None:
                        grad0 = norms(dict(zip(keys, grads)))
                    ref.clip_(grads, t["clip_norm"])
                    adam.step(dict(zip(keys, grads)))
                    ema.update()
                    total += float(loss.detach())
                losses.append(total / self.K)
                if c == 0:
                    moment = norms(adam.m)
        return {"p0": p0, "grad": grad0, "moment": moment,
                "losses": losses,
                "change": norms({k: P[k] - p0[k] for k in keys}),
                "stats": norms({k: P[k] - p0[k] for k in stats}),
                "ema": norms({k: ema.e[k] - p0[k] for k in keys})}

    def check(self, limits: dict, subject: str = None) -> list:
        """The readings of the set-up's calls against the reference; with
        a `subject`, of a stand-in in the program's place (as in
        train_flow.Driver.check)."""
        want = self._reference("fp32")
        if subject is None:
            p0 = want["p0"]
            got = {"losses": self.losses, "moment": norms(self.moment),
                   "change": norms({k: self.after[k] - p0[k]
                                    for k in want["change"]}),
                   "stats": norms({k: self.stats_after[k] - p0[k]
                                   for k in want["stats"]}),
                   "ema": norms({k: self.ema_after[k] - p0[k]
                                 for k in want["ema"]})}
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
                                ("stats_gap", "stats", None),
                                ("ema_gap", "ema", moving)):
            if want[key]:
                value, detail = leaf_gap(got[key], want[key], keys, stat)
                out.append(reading(name, value, limits[name], detail))
        return out


SUBJECTS = {"lower": lambda d: (common.LOWER[d.dtype],),
            "half_batch": lambda d: ("fp32", d.B // 2),
            "fp32_cl": lambda d: ("fp32_cl",)}
