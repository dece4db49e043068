"""Back-to-back calls of the guided sampler, the users' unit of
evaluation: `make_guided_sampler_p(...)(params, generator, B)` with a
fresh MC set each call (phase A: N_mc pairs from the two flows, scored
by the ratio net; phase B: B pairs integrated with the guidance).

Traffic keys: guidance_method, guidance_strength, batch, mc_batch,
num_steps, check_steps_a, check_steps_b.

What a call produced is recorded without copies: the velocity and ratio
functions handed to the sampler keep a reference to the states they are
called with at the steps drawn from the seed (and the next ones), and the
call returns x_1, y_1 and the per-step ESS. After the window the
reference follows the last call of the window step by step from those
states (the program's own), over every row:
* start_exact: the initial and MC noise equal the seed's draws;
* phase_a_gap / phase_b_gap: `compare.row_gap` of the drawn steps of phase
  A (each flow alone) and of phase B (the guided pair, x and y one row);
  the last step of each phase is always drawn, so x_1, y_1 and the MC set
  are covered;
* ratio_gap: the widest gap of the MC set's log r̂ from the reference's,
  in nats (so the relative error of r̂, which weighs the candidates).
The ESS of the drawn phase-B steps is compared too and printed beside
phase_b_gap (`ess_gap`, relative), but not held to a limit: random nets'
MC candidates lie far apart, so the weights are one-hot on both sides past
the first steps and the number cannot tell the control from the program.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict

import torch

from portbench.drivers import common
from portbench.harness import counts
from portbench.harness.compare import reading, row_gap
from portbench.harness.seeds import derive, draw_steps
from portbench.harness.weights import make_params
from portbench.reference import sampler as ref
from portbench.reference.nets import Net

ROLES = ("flow_x", "flow_y", "ratio")
WARM_STEPS = 2


class Recorder:
    """Keeps the states that a call hands to the velocity and ratio
    functions at the wanted steps (references, no copies)."""

    def __init__(self, steps: int, want_a: Dict[str, set], want_b: set):
        self.steps, self.want_a, self.want_b = steps, want_a, want_b
        self.cur = self.last = None

    def begin(self, seed: int) -> None:
        self.cur = {"seed": seed, "a_flow_x": {}, "a_flow_y": {},
                    "b_flow_x": {}, "b_flow_y": {}}
        self.n = {"flow_x": 0, "flow_y": 0}

    def velocity(self, role: str, apply):
        def fn(model, x, t):
            i = self.n[role]
            self.n[role] = i + 1
            if i < self.steps:
                if i in self.want_a[role]:
                    self.cur["a_" + role][i] = x
            elif i - self.steps in self.want_b:
                self.cur["b_" + role][i - self.steps] = x
            return apply(model, x, t)
        return fn

    def ratio(self, apply):
        def fn(model, x, y):
            out = apply(model, x, y)
            self.cur["a_flow_x"][self.steps] = x
            self.cur["a_flow_y"][self.steps] = y
            self.cur["log_r"] = out
            return out
        return fn

    def end(self, x1, y1, diags) -> None:
        self.cur["b_flow_x"][self.steps] = x1
        self.cur["b_flow_y"][self.steps] = y1
        self.cur["ess"] = diags.get("ess")
        self.last = self.cur


class Driver:
    unit = "pairs"
    sync_each = True
    subjects = ("lower",)

    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device, sizes: dict = None):
        sizes = sizes or {}
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        self.nets = config["nets"]
        self.B = sizes.get("batch", traffic["batch"])
        self.N = sizes.get("mc_batch", traffic["mc_batch"])
        self.steps = sizes.get("num_steps", traffic["num_steps"])
        self.gamma = float(traffic["guidance_strength"])
        self.dtypes = config["sample_dtype"]
        self.want_a = {r: draw_steps(seed, "check_a_" + r, self.steps,
                                     traffic["check_steps_a"])
                       for r in ("flow_x", "flow_y")}
        self.want_b = draw_steps(seed, "check_b", self.steps,
                                 traffic["check_steps_b"])

    # ------------------------------------------------------------ program
    def setup(self) -> None:
        from ratio_guided_multimodal_fm_tpu_torch.cli.common import (
            ratio_log_fn,
            velocity_fn,
        )
        from ratio_guided_multimodal_fm_tpu_torch.core.device import (
            place_model,
        )
        from ratio_guided_multimodal_fm_tpu_torch.sample.guided import (
            GuidedSamplerConfig,
            make_guided_sampler_p,
        )

        common.build_kernels(self.device)
        models = []
        for role in ROLES:
            net = self.nets[role]
            P = make_params(net["kind"], net["arch"],
                            derive(self.seed, "weights", role), self.device)
            models.append(place_model(common.port_net(
                net, self.dtypes[role], P, self.device), self.device))
        self.models = tuple(models)
        cfg = GuidedSamplerConfig(
            guidance_method=self.traffic["guidance_method"],
            guidance_strength=self.gamma, num_steps=self.steps,
            mc_batch_size=self.N,
            x_shape=common.shape(self.nets["flow_x"]),
            y_shape=common.shape(self.nets["flow_y"]))
        want = {r: set(ks) | {k + 1 for k in ks} | {0}
                for r, ks in self.want_a.items()}
        self.rec = Recorder(self.steps, want, set(self.want_b)
                            | {k + 1 for k in self.want_b} | {0})

        def velocity(model, x, t):
            return velocity_fn(model)(x, t)

        def log_r(model, x, y):
            return ratio_log_fn(model)(x, y)

        self.sampler = make_guided_sampler_p(
            self.rec.velocity("flow_x", velocity),
            self.rec.velocity("flow_y", velocity), cfg, self.rec.ratio(log_r))
        # the cell's shapes once: every Euler step of a phase runs the same
        # shapes, so two steps a phase build and choose all that the
        # window's calls use
        warm = make_guided_sampler_p(
            velocity, velocity, dataclasses.replace(cfg, num_steps=WARM_STEPS),
            log_r)
        warm(self.models, torch.Generator(self.device).manual_seed(
            derive(self.seed, "warm")), self.B)
        common.sync(self.device)

    def _one(self, seed: int) -> int:
        self.rec.begin(seed)
        x1, y1, diags = self.sampler(
            self.models, torch.Generator(self.device).manual_seed(seed),
            self.B)
        self.rec.end(x1, y1, diags)
        return self.B

    def call(self, i: int) -> int:
        return self._one(derive(self.seed, "call", i))

    def traced(self) -> int:
        """One more call, for the profiler; the window's last call stays
        the one that is checked."""
        kept = self.rec.last
        self._one(derive(self.seed, "traced"))
        self.rec.last = kept
        return self.B

    def work(self, window) -> dict:
        n = self.nets
        fx, fy = (functools.partial(counts.net_flops, n[r]["kind"],
                                    n[r]["arch"])
                  for r in ("flow_x", "flow_y"))
        d = sum(math.prod(common.shape(n[r])) for r in ("flow_x", "flow_y"))
        flops = counts.pair_sampler_flops(fx, fy, self.B, self.N,
                                          self.steps, d)
        flops += counts.net_flops(n["ratio"]["kind"], n["ratio"]["arch"],
                                  self.N)
        gn = 0.0
        for role in ROLES:
            net = n[role]
            sites = counts.net_gn_sites(net["kind"], net["arch"])
            item = common.DTYPES[self.dtypes[role]].itemsize
            if role == "ratio":
                gn += counts.gn_forward_bytes(sites, self.N, item)
            else:
                gn += self.steps * (counts.gn_forward_bytes(sites, self.B,
                                                            item)
                                    + counts.gn_forward_bytes(sites, self.N,
                                                              item))
        return {"kind": "sample", "units_per_s": window.rate,
                "flops_per_unit": flops / self.B,
                "euler_steps": self.steps, "gn_fwd_bytes": gn}

    def free(self) -> None:
        del self.sampler, self.models
        self.rec.cur = None

    # ---------------------------------------------------------- reference
    def check(self, limits: dict, subject: str = None) -> list:
        """The readings of the window's last call against the reference;
        with subject "lower", of the control (the reference one precision
        below each net's) in the program's place."""
        rec, dev = self.rec.last, self.device
        lower = subject == "lower"
        limits = limits["limits"]
        nets = {}
        for role in ROLES:
            net = self.nets[role]
            nets[role] = Net(net["kind"], net["arch"], make_params(
                net["kind"], net["arch"], derive(self.seed, "weights", role),
                dev))
        prec = {r: common.LOWER[self.dtypes[r]] if lower else "fp32"
                for r in ROLES}
        g = torch.Generator(dev).manual_seed(rec["seed"])
        xs, ys = (common.shape(self.nets[r]) for r in ("flow_x", "flow_y"))
        draws = [torch.randn((n,) + s, generator=g, dtype=torch.float32,
                             device=dev)
                 for n, s in ((self.B, xs), (self.B, ys), (self.N, xs),
                              (self.N, ys))]
        start = max(float((a - b).abs().max()) for a, b in zip(
            draws, (rec["b_flow_x"][0], rec["b_flow_y"][0],
                    rec["a_flow_x"][0], rec["a_flow_y"][0])))
        out = [reading("start_exact", start, limits["start_exact"])]

        gap_a = 0.0
        for role in ("flow_x", "flow_y"):
            states = rec["a_" + role]
            for k in self.want_a[role]:
                want = ref.phase_a_step(nets[role], states[k], k, self.steps)
                got = (ref.phase_a_step(nets[role], states[k], k, self.steps,
                                        prec[role])
                       if lower else states[k + 1])
                gap_a = max(gap_a, row_gap(got, want, states[k]))
        out.append(reading("phase_a_gap", gap_a, limits["phase_a_gap"]))

        mc_x1 = rec["a_flow_x"][self.steps]
        mc_y1 = rec["a_flow_y"][self.steps]
        log_r = ref.scores(nets["ratio"], mc_x1, mc_y1)
        got_log_r = (ref.scores(nets["ratio"], mc_x1, mc_y1, prec["ratio"])
                     if lower else rec["log_r"].to(torch.float32))
        out.append(reading("ratio_gap", float((got_log_r - log_r).abs().max()),
                           limits["ratio_gap"]))

        gap_b = ess_gap = 0.0
        for k in self.want_b:
            x, y = rec["b_flow_x"][k], rec["b_flow_y"][k]
            rx, ry, ress = ref.phase_b_step(
                nets["flow_x"], nets["flow_y"], x, y, mc_x1, mc_y1, log_r,
                k, self.steps, self.gamma)
            if lower:
                px, py, pess = ref.phase_b_step(
                    nets["flow_x"], nets["flow_y"], x, y, mc_x1, mc_y1,
                    got_log_r, k, self.steps, self.gamma,
                    (prec["flow_x"], prec["flow_y"]))
            else:
                px, py = rec["b_flow_x"][k + 1], rec["b_flow_y"][k + 1]
                pess = rec["ess"][k]
            gap_b = max(gap_b, row_gap(_pair(px, py), _pair(rx, ry),
                                       _pair(x, y)))
            ess_gap = max(ess_gap, float(
                ((pess.double() - ress).abs() / ress).max()))
        out.append(reading("phase_b_gap", gap_b, limits["phase_b_gap"],
                           {"ess_gap": ess_gap}))
        return out


def _pair(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """One row per pair: x and y side by side."""
    B = x.shape[0]
    return torch.cat([x.reshape(B, -1), y.reshape(B, -1)], 1)
