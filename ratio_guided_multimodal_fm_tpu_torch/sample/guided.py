"""Ratio-guided bimodal sampling (port of sample/guided.py).

Two phases, as in the JAX package:

* Phase A draws N_mc independent pairs from the two flows and scores them
  with the ratio net: the MC set (mc_x1, mc_y1, r̂ = exp(log r̂)).
* Phase B integrates both flows from noise; with mc_feng guidance each step
  mixes the velocities with the importance-weighted guidance term
  (Feng et al. Alg. 2): v ← (1−γ)·v + γ·g, gated on t > 1e-3. With grad
  guidance (alone, or after the mc_feng mixing in 'mc_feng+grad') each step
  adds γ_g·∇ Σ log r̂(x_t, y_t), differentiated by torch.autograd with
  respect to the state only (the GroupNorm+SiLU kernel's backward on the
  card), gated like JAX: t > 1e-3, t < grad_t_max, optionally ×σ_t².
* mc_refresh = K > 1 splits phase B into K segments, each with a fresh MC
  set drawn from the sampler's generator in segment order.

The guidance runs through the `ops.guidance.flash_guidance` wrapper at every
step (the JAX package's Pallas branch): the kernel on the card, its plain
version on the CPU. The sampler state and the guidance math are float32;
the velocity nets run in their own compute dtype. Public functions take
and return NHWC tensors; random draws come from an explicit
`torch.Generator`, on whose device the sampler runs. `init_noise=` and
`mc_set=` inject the random inputs (random streams cannot cross
frameworks, so the parity tests inject both).

Merged-pair evaluation (models/merged.py): `fm_pair_apply` binds the two
models into one pair function (x, y, t) -> (v_x, v_y) once per sampler
call, which evaluates both velocity nets in one network in phase B and
integrates both modalities in one loop in phase A (flow/cfm.py:
ode_scan_pair). The random draws keep the two-net order, so both paths
give the same samples up to float32 rounding.

A sharded MC axis (parallel/sharded_guidance.py): with an mc process
group each rank holds a shard of the MC set, and the guidance runs in
tensor ops (`mc_feng_guidance`) whose reductions over N_mc become global
all-reduces over the group (the JAX package's pmax / psum / pmin): kernel
A reduces over its own shard only, so that path does not launch it, as the
JAX package drops its Pallas kernel there.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ratio_guided_multimodal_fm_tpu_torch.core.device import (
    device_of,
    resolve_device,
)
from ratio_guided_multimodal_fm_tpu_torch.core.guards import check_finite
from ratio_guided_multimodal_fm_tpu_torch.flow.cfm import (
    SOLVERS,
    TIME_GRIDS,
    make_time_grid,
    ode_scan,
    ode_scan_pair,
)
from ratio_guided_multimodal_fm_tpu_torch.ops.guidance import (
    EPS_T,   # guidance gate and sigma floor, ref flow_utils.py:224,279
    flash_guidance,
)

# exp(log r̂) must stay float32-finite: cap log r̂ at 80 (e^80 ≈ 5.5e34).
LOG_R_F32_MAX = 80.0

GUIDANCE_METHODS = ("none", "mc_feng", "grad", "mc_feng+grad")
MC_METHODS = ("mc_feng", "mc_feng+grad")
GRAD_METHODS = ("grad", "mc_feng+grad")


def _flat(x):
    return x.reshape(x.shape[0], -1)


def _row_norm_mean(x):
    return torch.linalg.vector_norm(_flat(x), dim=1).mean()


def safe_exp_log_r(log_r: torch.Tensor) -> torch.Tensor:
    """exp(log r̂) clamped to stay float32-finite (cap LOG_R_F32_MAX)."""
    return torch.exp(torch.clamp(log_r, max=LOG_R_F32_MAX))


def mc_feng_guidance(x_t, y_t, mc_x1, mc_y1, mc_ratios, t: float,
                     mc_group=None):
    """One step of Feng et al. Alg. 2 guidance in the reference's ratio form
    (three 1e-10 floors, per-row max stabilisation), float32 matmuls.

    Returns (g_x, g_y, diagnostics) like the JAX function. With `mc_group`
    (a torch.distributed group) mc_x1 / mc_y1 / mc_ratios hold this rank's
    shard of the MC set (the shards in rank order make the whole set) and
    every reduction over N runs over the group: the row max and the
    extrema (MAX / MIN), p̄, Z̄, Σw, Σw·X1, Σw·Y1 and Σw² (SUM), and the
    argmax with ties toward the largest global index. The sampler uses
    `flash_guidance` on an unsharded set, whose softmax form is the same
    function.
    """
    f32 = torch.float32
    xt, yt = _flat(x_t).to(f32), _flat(y_t).to(f32)
    X1, Y1 = _flat(mc_x1).to(f32), _flat(mc_y1).to(f32)
    r = mc_ratios.to(f32)
    n_local = X1.shape[0]
    n_shards, shard = 1, 0
    if mc_group is not None:
        n_shards = dist.get_world_size(mc_group)
        shard = dist.get_rank(mc_group)
    n = n_local * n_shards
    t32 = np.float32(t)
    sigma = np.float32(1.0) - t32 + np.float32(EPS_T)

    def reduce(v, op=dist.ReduceOp.SUM):
        if mc_group is not None:
            dist.all_reduce(v, op=op, group=mc_group)
        return v

    xt2 = (xt * xt).sum(1, keepdim=True)
    yt2 = (yt * yt).sum(1, keepdim=True)
    X12 = (X1 * X1).sum(1)[None, :]
    Y12 = (Y1 * Y1).sum(1)[None, :]
    cross = xt @ X1.T + yt @ Y1.T
    sq = (xt2 + yt2 - float(np.float32(2.0) * t32) * cross
          + float(t32 * t32) * (X12 + Y12))
    log_p = -0.5 * sq / float(sigma * sigma)

    m = reduce(log_p.max(dim=1, keepdim=True).values, dist.ReduceOp.MAX)
    p = torch.exp(log_p - m)
    if mc_group is None:
        p_bar = p.sum(1, keepdim=True) / n + 1e-10
        Z_bar = (r[None, :] * p).sum(1, keepdim=True) / n + 1e-10
    else:
        sums = reduce(torch.cat([p.sum(1, keepdim=True),
                                 (r[None, :] * p).sum(1, keepdim=True)], 1))
        p_bar = sums[:, :1] / n + 1e-10
        Z_bar = sums[:, 1:] / n + 1e-10
    w = (r[None, :] / Z_bar) * (p / p_bar)
    w = w / (reduce(w.sum(1, keepdim=True)) + 1e-10)
    check_finite(w, "mc_feng importance weights")

    w_total = w.sum(1, keepdim=True)
    w_sq = (w * w).sum(1, keepdim=True)
    wx, wy = w @ X1, w @ Y1
    if mc_group is not None:
        dx = wx.shape[1]
        tot = reduce(torch.cat([wx, wy, w_total, w_sq], 1))
        wx, wy = tot[:, :dx], tot[:, dx:-2]
        w_total, w_sq = tot[:, -2:-1], tot[:, -1:]
    g_x = (wx - w_total * xt) / float(sigma)
    g_y = (wy - w_total * yt) / float(sigma)
    ess = (w_total * w_total) / (w_sq + 1e-10)
    w_argmax = w.argmax(dim=1)
    w_min, w_max = w.min(), w.max()
    if mc_group is not None:
        loc_val = w.max(dim=1).values
        hi = reduce(torch.cat([loc_val, w_max[None]]), dist.ReduceOp.MAX)
        w_max = hi[-1]
        w_min = reduce(w_min.clone(), dist.ReduceOp.MIN)
        # ties toward the largest global index, on every rank alike
        w_argmax = reduce(torch.where(loc_val >= hi[:-1],
                                      w_argmax + shard * n_local,
                                      torch.full_like(w_argmax, -1)),
                          dist.ReduceOp.MAX)
    diag = {
        "ess": ess[:, 0],
        "w_argmax": w_argmax,
        "w_min": w_min,
        "w_max": w_max,
        "Z_bar_mean": Z_bar.mean(),
        "g_x_norm": _row_norm_mean(g_x),
        "g_y_norm": _row_norm_mean(g_y),
    }
    return g_x.reshape(x_t.shape), g_y.reshape(y_t.shape), diag


@dataclasses.dataclass(frozen=True)
class GuidedSamplerConfig:
    """Same fields as the JAX config, minus `use_pallas` (dispatch follows
    the tensors' device) and `scan_unroll` (no scan in eager PyTorch)."""

    guidance_method: str = "none"     # GUIDANCE_METHODS
    guidance_strength: float = 0.0
    num_steps: int = 100
    mc_batch_size: int = 64
    x_shape: Tuple[int, ...] = (28, 28, 1)   # HWC, per sample
    y_shape: Tuple[int, ...] = (28, 28, 1)
    # optional |log r̂| clip for the MC ratios (None = reference parity)
    log_ratio_clip: Optional[float] = None
    # optional ESS floor: per-trajectory γ_eff = γ·min(1, ESS/ess_floor)
    ess_floor: Optional[float] = None
    # grad term: strength (None: guidance_strength), 'const' or 'sigma'
    # (×σ_t²), and the gate t < grad_t_max (1.0: none)
    grad_strength: Optional[float] = None
    grad_scale: str = "const"
    grad_t_max: float = 1.0
    solver: str = "euler"             # 'euler' | 'midpoint' | 'heun'
    time_grid: str = "uniform"        # flow/cfm.py:make_time_grid
    grid_power: float = 2.0
    # fresh MC sets along each trajectory (mc_feng methods); 1 = reference
    # protocol. The JAX config documents it as measured harmful.
    mc_refresh: int = 1


def _validate(cfg: GuidedSamplerConfig, guided: bool) -> None:
    if cfg.guidance_method not in GUIDANCE_METHODS:
        raise ValueError(f"guidance_method must be one of "
                         f"{GUIDANCE_METHODS}, got {cfg.guidance_method!r}")
    if cfg.mc_refresh < 1:
        raise ValueError(f"mc_refresh must be >= 1, got {cfg.mc_refresh}")
    if (cfg.mc_refresh > 1 and guided and cfg.guidance_method in MC_METHODS
            and cfg.num_steps % cfg.mc_refresh):
        raise ValueError(f"mc_refresh={cfg.mc_refresh} must divide num_steps="
                         f"{cfg.num_steps} (equal refresh segments)")
    if cfg.solver not in SOLVERS:
        raise ValueError(f"solver must be one of {SOLVERS}, "
                         f"got {cfg.solver!r}")
    if cfg.time_grid not in TIME_GRIDS:
        raise ValueError(f"time_grid must be one of {TIME_GRIDS}, "
                         f"got {cfg.time_grid!r}")
    if cfg.solver == "heun" and guided:
        raise ValueError(
            "solver='heun' is unguided-only: its endpoint eval at t=1.0 "
            "divides the mc_feng conditional velocity by ε — use "
            "'midpoint' with guidance")


def _grad_log_ratio(log_ratio_fn: Callable, x_t, y_t):
    """∇ Σ float32(log r̂(x_t, y_t)) with respect to the state only:
    detached copies of x_t and y_t are the only inputs of autograd.grad, so
    no parameter .grad is written."""
    with torch.enable_grad():
        x = x_t.detach().requires_grad_(True)
        y = y_t.detach().requires_grad_(True)
        total = log_ratio_fn(x, y).to(torch.float32).sum()
        g_x, g_y = torch.autograd.grad(total, (x, y))
    return g_x, g_y


def _make_guided_step(fm_x_fn: Callable, fm_y_fn: Callable,
                      cfg: GuidedSamplerConfig, mc_set,
                      log_ratio_fn: Optional[Callable] = None,
                      fm_pair_fn: Optional[Callable] = None,
                      mc_group=None) -> Callable:
    """Build step(x_t, y_t, t, dt) -> (x_t, y_t, diag) for phase B. `t`,
    `dt` are float32 scalars; `mc_set` is None unless the method mixes in
    mc_feng guidance, `log_ratio_fn` None unless it adds the grad term;
    `fm_pair_fn` (x, y, t) -> (v_x, v_y), where given, evaluates both
    velocity nets in place of fm_x_fn and fm_y_fn. With `mc_group` the MC
    set is this rank's shard and the guidance is `mc_feng_guidance` over
    the group (no kernel A); without it, `flash_guidance`."""
    grad_gamma = np.float32(cfg.grad_strength if cfg.grad_strength
                            is not None else cfg.guidance_strength)
    if mc_set is not None:
        mc_x1, mc_y1, mc_ratios = mc_set
        mc_x1 = mc_x1.to(torch.float32).contiguous()
        mc_y1 = mc_y1.to(torch.float32).contiguous()
        # log r̂ hoisted out of the loop (invariant across steps)
        mc_log_r = torch.log(torch.clamp(mc_ratios.to(torch.float32),
                                         min=1e-30)).contiguous()
        check_finite(mc_log_r, "mc_feng log ratios")

    def grad_gate(t) -> float:
        """γ_g·[t > ε]·[t < grad_t_max]·(σ_t² for 'sigma'), in float32."""
        gate = grad_gamma if t > np.float32(EPS_T) else np.float32(0.0)
        if cfg.grad_t_max < 1.0:
            gate = gate * np.float32(t < np.float32(cfg.grad_t_max))
        if cfg.grad_scale == "sigma":
            sig = np.float32(1.0) - t + np.float32(EPS_T)
            gate = gate * sig * sig
        return float(gate)

    def mixed_velocity(x_t, y_t, t):
        tb = torch.full((x_t.shape[0],), float(t), dtype=torch.float32,
                        device=x_t.device)
        if fm_pair_fn is not None:
            v_x, v_y = fm_pair_fn(x_t, y_t, tb)
            v_x, v_y = v_x.to(torch.float32), v_y.to(torch.float32)
        else:
            v_x = fm_x_fn(x_t, tb).to(torch.float32)
            v_y = fm_y_fn(y_t, tb).to(torch.float32)
        diag = {}
        if mc_set is not None and mc_group is not None:
            g_x, g_y, diag = mc_feng_guidance(x_t, y_t, mc_x1, mc_y1,
                                              mc_ratios, float(t), mc_group)
            ess = diag["ess"]
            diag["v_x_norm"] = _row_norm_mean(v_x)
            diag["v_y_norm"] = _row_norm_mean(v_y)
        elif mc_set is not None:
            g_x, g_y, ess, l = flash_guidance(x_t, y_t, mc_x1, mc_y1,
                                              mc_log_r, float(t))
            diag = {
                "ess": ess,
                "w_max": (1.0 / (l + 1e-30)).max(),
                "g_x_norm": _row_norm_mean(g_x),
                "g_y_norm": _row_norm_mean(g_y),
                "v_x_norm": _row_norm_mean(v_x),
                "v_y_norm": _row_norm_mean(v_y),
            }
        if mc_set is not None:
            # guidance gate t > ε (ref :273), compared in float32; a float32
            # per-trajectory tensor so 1 - gate rounds as in JAX
            gate = torch.full((x_t.shape[0],) + (1,) * (x_t.dim() - 1),
                              cfg.guidance_strength
                              if t > np.float32(EPS_T) else 0.0,
                              dtype=torch.float32, device=x_t.device)
            if cfg.ess_floor is not None:
                gate = gate * torch.clamp(ess / cfg.ess_floor, 0.0,
                                          1.0).reshape(gate.shape)
            v_x = (1.0 - gate) * v_x + gate * g_x
            v_y = (1.0 - gate) * v_y + gate * g_y
        if log_ratio_fn is not None:
            # at every step, gated or not: a non-finite gradient is not
            # hidden by a zero gate
            g_x, g_y = _grad_log_ratio(log_ratio_fn, x_t, y_t)
            gate = grad_gate(t)
            v_x = v_x + gate * g_x
            v_y = v_y + gate * g_y
        return v_x, v_y, diag

    def step(x_t, y_t, t, dt):
        v_x, v_y, diag = mixed_velocity(x_t, y_t, t)
        if cfg.solver == "midpoint":
            # re-evaluate the full mixed field at the half step; the
            # diagnostics stay on the t-grid (first evaluation)
            half = np.float32(0.5) * dt
            v_x, v_y, _ = mixed_velocity(x_t + float(half) * v_x,
                                         y_t + float(half) * v_y, t + half)
        elif cfg.solver == "heun":   # unguided only (validated)
            v_x2, v_y2, _ = mixed_velocity(x_t + float(dt) * v_x,
                                           y_t + float(dt) * v_y, t + dt)
            v_x = 0.5 * (v_x + v_x2)
            v_y = 0.5 * (v_y + v_y2)
        return x_t + v_x * float(dt), y_t + v_y * float(dt), diag

    return step


def _stack_diags(diags: list) -> dict:
    if not diags or not diags[0]:
        return {}
    return {k: torch.stack([d[k] for d in diags]) for k in diags[0]}


def make_guided_sampler_p(fm_x_apply: Callable, fm_y_apply: Callable,
                          cfg: GuidedSamplerConfig,
                          log_ratio_apply: Optional[Callable] = None,
                          fm_pair_apply: Optional[Callable] = None,
                          data_shard: Tuple[int, int] = (0, 1),
                          mc_shard: Tuple[int, int] = (0, 1),
                          mc_group=None):
    """Build the guided sampler with the models as call arguments:

        sampler(params, generator, num_samples, mc_set=None,
                init_noise=None) -> (x1, y1, diags)

    params = (model_x, model_y, ratio_model); fm_*_apply(model, x NHWC,
    t [B]) -> v NHWC and log_ratio_apply(ratio_model, x, y) -> [B]. The
    sampler runs on `generator.device`. diags holds per-step stacked
    tensors ([num_steps] or [num_steps, B]) when the method mixes in
    mc_feng guidance, else {}. Random draws, in order: the initial noise,
    then per MC set (one, or one per segment with mc_refresh > 1) the x
    and the y candidates' noise.

    fm_pair_apply(model_x, model_y) -> (x, y, t [B]) -> (v_x, v_y) opts
    into merged-pair evaluation (models/merged.py:merged_pair_apply); it
    is bound once per call. Mergeable nets share a topology, so it needs
    x_shape == y_shape.

    One rank of a ('data', 'mc') mesh (parallel/sharded_guidance.py):
    `data_shard` = (index, size) keeps rows [i·B/n, (i+1)·B/n) of the
    batch, `mc_shard` = (index, size) the same block of the MC set, and
    `mc_group` (the ranks of the mc axis, None for an axis of one) makes
    the guidance's reductions over N_mc global. Every draw is made in full
    and then sliced, so the rows are those of the one-process sampler; x1,
    y1 and diags are this rank's rows.
    """
    guided = cfg.guidance_method != "none" and log_ratio_apply is not None
    _validate(cfg, guided)
    if fm_pair_apply is not None and tuple(cfg.x_shape) != tuple(cfg.y_shape):
        raise ValueError(
            "fm_pair_apply (merged-pair evaluation) requires x_shape == "
            f"y_shape, got {cfg.x_shape} vs {cfg.y_shape}: mergeable nets "
            "share a topology (models/merged.py:can_merge)")
    use_mc = guided and cfg.guidance_method in MC_METHODS
    use_grad = guided and cfg.guidance_method in GRAD_METHODS
    (di, n_data), (mi, n_mc) = data_shard, mc_shard
    if cfg.mc_batch_size % n_mc:
        raise ValueError(f"mc_batch_size {cfg.mc_batch_size} not divisible "
                         f"by the mc axis size {n_mc}")
    per_mc = cfg.mc_batch_size // n_mc
    shard = slice(mi * per_mc, (mi + 1) * per_mc)

    @torch.no_grad()
    def sampler(params, generator: torch.Generator, num_samples: int,
                mc_set=None, init_noise=None):
        if num_samples % n_data:
            raise ValueError(f"num_samples {num_samples} not divisible by "
                             f"the data axis size {n_data}")
        per = num_samples // n_data
        rows = slice(di * per, (di + 1) * per)
        device = device_of(generator)
        model_x, model_y, ratio_model = params

        def fm_x_fn(x, t):
            return fm_x_apply(model_x, x, t)

        def fm_y_fn(y, t):
            return fm_y_apply(model_y, y, t)

        def log_ratio_fn(x, y):
            return log_ratio_apply(ratio_model, x, y)

        fm_pair_fn = (None if fm_pair_apply is None
                      else fm_pair_apply(model_x, model_y))
        f32 = torch.float32
        if init_noise is not None:
            x_t, y_t = (a.to(device=device, dtype=f32)[rows]
                        for a in init_noise)
        else:
            x_t = torch.randn((num_samples,) + tuple(cfg.x_shape),
                              generator=generator, dtype=f32,
                              device=device)[rows]
            y_t = torch.randn((num_samples,) + tuple(cfg.y_shape),
                              generator=generator, dtype=f32,
                              device=device)[rows]

        def gen_mc():
            # Phase A: N_mc independent pairs and their terminal ratios
            return generate_mc_set(fm_x_fn, fm_y_fn, log_ratio_fn, generator,
                                   cfg.mc_batch_size, cfg.x_shape,
                                   cfg.y_shape, cfg.num_steps,
                                   cfg.log_ratio_clip, cfg.solver,
                                   cfg.time_grid, cfg.grid_power,
                                   fm_pair_fn=fm_pair_fn, shard=shard)

        K = cfg.mc_refresh if use_mc else 1
        if K > 1 and mc_set is not None:
            raise ValueError(
                "mc_refresh > 1 regenerates the MC set internally — a "
                "caller-provided mc_set is contradictory (pass mc_set=None, "
                "or use mc_refresh=1 to amortize one set)")
        ts, dts = make_time_grid(cfg.num_steps, cfg.time_grid,
                                 cfg.grid_power)
        seg = cfg.num_steps // K
        if use_mc and mc_set is not None:
            mc_set = tuple(a.to(device)[shard] for a in mc_set)
        diags = []
        for k in range(K):
            if use_mc and (K > 1 or mc_set is None):
                mc_set = gen_mc()
            step = _make_guided_step(fm_x_fn, fm_y_fn, cfg,
                                     mc_set if use_mc else None,
                                     log_ratio_fn if use_grad else None,
                                     fm_pair_fn, mc_group)
            for t, dt in zip(ts[k * seg:(k + 1) * seg],
                             dts[k * seg:(k + 1) * seg]):
                x_t, y_t, diag = step(x_t, y_t, t, dt)
                diags.append(diag)
        return x_t, y_t, _stack_diags(diags)

    return sampler


def make_guided_sampler(fm_x_fn: Callable, fm_y_fn: Callable,
                        cfg: GuidedSamplerConfig,
                        log_ratio_fn: Optional[Callable] = None,
                        fm_pair_fn: Optional[Callable] = None, **shard_kw):
    """The closure form of `make_guided_sampler_p`, with the models baked
    into fm_*_fn(x, t [B]) -> v, log_ratio_fn(x, y) -> [B] and
    fm_pair_fn(x, y, t [B]) -> (v_x, v_y):

        sampler(generator, num_samples, mc_set=None, init_noise=None)
            -> (x1, y1, diags)

    The same draws in the same order as `make_guided_sampler_p`, so the two
    agree bit for bit. `shard_kw` (data_shard, mc_shard, mc_group) goes to
    `make_guided_sampler_p`: the port's counterpart of JAX's `mc_axis`."""
    inner = make_guided_sampler_p(
        lambda _, x, t: fm_x_fn(x, t), lambda _, y, t: fm_y_fn(y, t), cfg,
        None if log_ratio_fn is None else (lambda _, x, y: log_ratio_fn(x, y)),
        fm_pair_apply=None if fm_pair_fn is None else (
            lambda _mx, _my: fm_pair_fn),
        **shard_kw)

    def sampler(generator: torch.Generator, num_samples: int, mc_set=None,
                init_noise=None):
        return inner((None, None, None), generator, num_samples, mc_set,
                     init_noise)

    return sampler


@torch.no_grad()
def generate_mc_set(fm_x_fn: Callable, fm_y_fn: Callable,
                    log_ratio_fn: Callable, generator: torch.Generator,
                    mc_batch_size: int, x_shape, y_shape,
                    num_steps: int = 100,
                    log_ratio_clip: Optional[float] = None,
                    solver: str = "euler", time_grid: str = "uniform",
                    grid_power: float = 2.0,
                    fm_pair_fn: Optional[Callable] = None,
                    shard: slice = slice(None)):
    """Phase A alone: (mc_x1, mc_y1, mc_ratios), so one MC set can serve
    several guidance strengths (the set is independent of γ).
    `fm_pair_fn` (merged-pair evaluation) integrates both modalities in one
    loop when their shapes match. The x then the y noise of the whole set
    is drawn either way; `shard` keeps a block of it (one rank's share of
    a sharded MC axis)."""
    x0, y0 = (torch.randn((mc_batch_size,) + tuple(shp),
                          generator=generator, dtype=torch.float32,
                          device=generator.device)[shard]
              for shp in (x_shape, y_shape))
    if fm_pair_fn is not None and tuple(x_shape) == tuple(y_shape):
        mc_x1, mc_y1 = ode_scan_pair(fm_pair_fn, x0, y0, num_steps, solver,
                                     time_grid, grid_power)
    else:
        mc_x1 = ode_scan(fm_x_fn, x0, num_steps, solver, time_grid,
                         grid_power)
        mc_y1 = ode_scan(fm_y_fn, y0, num_steps, solver, time_grid,
                         grid_power)
    log_r = log_ratio_fn(mc_x1, mc_y1).to(torch.float32)
    if log_ratio_clip is not None:
        log_r = torch.clamp(log_r, -log_ratio_clip, log_ratio_clip)
    return mc_x1, mc_y1, safe_exp_log_r(log_r)


def sample_bimodal_guided(
    fm_x_fn: Callable,
    fm_y_fn: Callable,
    log_ratio_fn: Optional[Callable] = None,
    guidance_method: str = "none",
    guidance_strength: float = 0.0,
    num_samples: int = 16,
    num_steps: int = 100,
    mc_batch_size: int = 64,
    x_shape: Tuple[int, ...] = (28, 28, 1),
    y_shape: Tuple[int, ...] = (28, 28, 1),
    generator: Optional[torch.Generator] = None,
    return_diagnostics: bool = False,
    mc_set=None,
    log_ratio_clip: Optional[float] = None,
    ess_floor: Optional[float] = None,
    solver: str = "euler",
    time_grid: str = "uniform",
    grid_power: float = 2.0,
    device=None,
    mc_refresh: int = 1,
    grad_strength: Optional[float] = None,
    grad_scale: str = "const",
    grad_t_max: float = 1.0,
    fm_pair_fn: Optional[Callable] = None,
):
    """The reference's argument surface (flow_utils.py:178-213) with closures
    fm_*_fn(x NHWC, t [B]) and log_ratio_fn(x, y), plus the JAX package's
    grad_* and mc_refresh knobs. `fm_pair_fn` (x, y, t) -> (v_x, v_y) opts
    into merged-pair evaluation (models/merged.py). Returns (x1, y1) NHWC
    (plus diagnostics). Runs on `device` (default cuda) with a generator
    seeded 42 unless `generator` is given."""
    if generator is None:
        generator = torch.Generator(resolve_device(device)).manual_seed(42)
    cfg = GuidedSamplerConfig(
        guidance_method=guidance_method,
        guidance_strength=guidance_strength, num_steps=num_steps,
        mc_batch_size=mc_batch_size, x_shape=tuple(x_shape),
        y_shape=tuple(y_shape), log_ratio_clip=log_ratio_clip,
        ess_floor=ess_floor, solver=solver, time_grid=time_grid,
        grid_power=grid_power, mc_refresh=mc_refresh,
        grad_strength=grad_strength, grad_scale=grad_scale,
        grad_t_max=grad_t_max)
    sampler = make_guided_sampler_p(
        lambda _, x, t: fm_x_fn(x, t), lambda _, y, t: fm_y_fn(y, t), cfg,
        None if log_ratio_fn is None else (lambda _, x, y: log_ratio_fn(x, y)),
        fm_pair_apply=None if fm_pair_fn is None else (
            lambda _x, _y: fm_pair_fn))
    x1, y1, diags = sampler((None, None, None), generator, num_samples,
                            mc_set)
    if return_diagnostics:
        return x1, y1, diags
    return x1, y1
