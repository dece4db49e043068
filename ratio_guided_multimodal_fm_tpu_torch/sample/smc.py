"""SMC (particle-filter) ratio guidance (port of sample/smc.py).

The B pairs being sampled are the particles of a Feynman-Kac flow whose
terminal target is the tempered coupled joint p_x(x)·p_y(y)·r̂(x, y)^γ:

* **Proposal**: the two flow ODEs with a marginal-preserving Langevin churn.
  For the rectified-flow path the marginal score follows from the velocity,
  ∇log p_t(x_t) = −(x_t − t·v)/(1 − t), so with β_t = churn·(1 − t)² the
  drift correction is −churn·(1 − t)·(x − t·v)·dt and the noise std is
  √(2·churn·dt)·(1 − t). `churn_iters` k > 1 adds k − 1 pure Langevin
  iterations at t + dt (a fresh velocity evaluation each), skipped on the
  step that reaches t = 1.
* **Potential**: the ratio net at the endpoint prediction x̂1 = x_t + (1−t)·v;
  the log-weights gather telescoping increments γ·(log r̂_k − log r̂_{k−1}),
  from the second step on.
* **Selection**: systematic resampling where the ESS of the log-weights
  falls below resample_tau·B, inside a window of t (or of the step
  fraction); `resample_group` G > 0 resamples within independent islands of
  G particles (the batch padded with −inf-weight phantoms to a multiple of
  G), 0 resamples the whole population.

The time grid, the window and the churn-mixing gate are host values, so
they are Python branches; the ESS test, the resampling decision and the
indices stay on the device (`torch.where`, `torch.searchsorted`,
`index_select`), so the step loop never waits for the device. The sampler
runs under `torch.no_grad()`.

Conventions as in sample/guided.py: NHWC in and out, float32 state, the
velocity nets in their own dtype cast to float32, random draws from an
explicit `torch.Generator` on whose device the sampler runs. The draws come
in the JAX sampler's order: the initial x, the initial y; then per step the
resampling uniform(s) ([NG] in island mode, one in global mode), the churn
normals for x and y (churn > 0), and 2·(churn_iters − 1) mixing normals on
steps whose t + dt stays below 1. Random streams cannot cross frameworks:
`init_noise=` injects the initial state and `step_noise=` every per-step
draw.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ratio_guided_multimodal_fm_tpu_torch.core.device import (
    device_of,
    resolve_device,
)
from ratio_guided_multimodal_fm_tpu_torch.flow.cfm import (
    TIME_GRIDS,
    make_time_grid,
)

# heun's t=1 endpoint evaluation meets the churn term's 1/(1−t); midpoint's
# half step keeps every evaluation inside [0, 1)
SMC_SOLVERS = ("euler", "midpoint")
RESAMPLE_WINDOWS = ("t", "step")
F32 = torch.float32


def flow_score(x_t: torch.Tensor, v: torch.Tensor, t) -> torch.Tensor:
    """Marginal score ∇log p_t(x_t) = −(x_t − t·v)/(1 − t + 1e-3) from the
    rectified-flow velocity (the 1e-3 floor is the sampler's σ floor)."""
    t = torch.as_tensor(t, dtype=F32, device=x_t.device)
    return -(x_t - t * v) / (1.0 - t + 1e-3)


def systematic_resample_idx(w: torch.Tensor, u) -> torch.Tensor:
    """Systematic resampling: for normalised weights w [..., B] and one
    uniform u [...] per row, B indices per row with counts in
    {⌊B·w_i⌋, ⌈B·w_i⌉}; the identity for uniform weights and any u in
    [0, 1). The last cdf entry is raised to at least 1 (cumsum rounding)."""
    b = w.shape[-1]
    u = torch.as_tensor(u, dtype=F32, device=w.device)
    cdf = torch.cumsum(w, dim=-1)
    cdf = torch.cat([cdf[..., :-1], cdf[..., -1:].clamp(min=1.0)], dim=-1)
    # (u + i) / b as a true division: a CUDA tensor divided by a Python
    # scalar is a product with its reciprocal
    positions = ((u[..., None] + torch.arange(b, dtype=F32, device=w.device))
                 / torch.full((), float(b), dtype=F32, device=w.device))
    idx = torch.searchsorted(cdf.contiguous(), positions.contiguous(),
                             right=True)
    return idx.clamp(0, b - 1)


@dataclasses.dataclass(frozen=True)
class SMCSamplerConfig:
    """The JAX config's fields and defaults, minus `scan_unroll` (no scan in
    eager PyTorch). guidance_strength is the tempering exponent γ."""

    guidance_strength: float = 1.0
    num_steps: int = 100
    x_shape: Tuple[int, ...] = (28, 28, 1)
    y_shape: Tuple[int, ...] = (28, 28, 1)
    churn: float = 1.0               # β_t = churn·(1−t)²; 0: ODE proposal
    churn_iters: int = 1             # Langevin iterations per ODE step
    resample_tau: float = 0.5        # resample where ESS < tau·B
    resample_t_min: float = 0.2      # ... inside [t_min, t_max]
    resample_t_max: float = 0.9
    resample_window: str = "t"       # 't': raw t; 'step': i/num_steps
    resample_group: int = 16         # island size G; 0: one population
    log_ratio_clip: Optional[float] = None
    solver: str = "euler"
    time_grid: str = "uniform"
    grid_power: float = 2.0


def _validate(cfg: SMCSamplerConfig) -> None:
    if cfg.solver not in SMC_SOLVERS:
        raise ValueError(f"SMC solver must be one of {SMC_SOLVERS}, "
                         f"got {cfg.solver!r}")
    if cfg.time_grid not in TIME_GRIDS:
        raise ValueError(f"time_grid must be one of {TIME_GRIDS}, "
                         f"got {cfg.time_grid!r}")
    if cfg.resample_window not in RESAMPLE_WINDOWS:
        raise ValueError("resample_window must be 't' or 'step', "
                         f"got {cfg.resample_window!r}")


def _ess(w: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.sum(w * w, dim=-1)


def _softmax(lw: torch.Tensor) -> torch.Tensor:
    """exp(lw − max) / Σ over the last axis, as jax.nn.softmax forms it
    (a quotient, not a product with the reciprocal)."""
    e = torch.exp(lw - lw.max(dim=-1, keepdim=True).values)
    return e / e.sum(dim=-1, keepdim=True)


class _Islands:
    """Island-mode constants on the device: B particles in NG groups of G,
    phantom slots (−inf log-weight) padding the last group."""

    def __init__(self, b: int, g: int, tau: float, device):
        self.b, self.g = b, g
        self.ng = -(-b // g)
        n = self.ng * g
        real = (torch.arange(n, device=device) < b).view(self.ng, g)
        self.n_real = real.sum(dim=1)                          # int64 [NG]
        self.threshold = tau * self.n_real.to(F32)             # f32 [NG]
        self.offsets = (torch.arange(self.ng, device=device) * g)[:, None]
        self.identity = torch.arange(n, device=device).view(self.ng, g)
        self.ng_f32 = torch.full((), float(self.ng), dtype=F32, device=device)

    def padded(self, logw: torch.Tensor) -> torch.Tensor:
        """[NG, G] log-weights with −inf in the phantom slots."""
        lwp = torch.full((self.ng * self.g,), float("-inf"), dtype=F32,
                         device=logw.device)
        lwp[:self.b] = logw
        return lwp.view(self.ng, self.g)

    def ess(self, logw: torch.Tensor):
        """(per-group weights [NG, G], per-group ESS [NG])."""
        wg = _softmax(self.padded(logw))
        return wg, _ess(wg)


def _draws(generator, cfg: SMCSamplerConfig, islands: Optional[_Islands],
           x_shape, y_shape, mix: int):
    """One step's draws from `generator`, in the JAX sampler's order:
    (uniform(s), churn normal x, churn normal y, [(mixing x, mixing y)])."""
    dev = generator.device
    u = torch.rand((islands.ng,) if islands else (), generator=generator,
                   dtype=F32, device=dev)
    nx = ny = None
    if cfg.churn > 0.0:
        nx = torch.randn(x_shape, generator=generator, dtype=F32, device=dev)
        ny = torch.randn(y_shape, generator=generator, dtype=F32, device=dev)
    pairs = [(torch.randn(x_shape, generator=generator, dtype=F32, device=dev),
              torch.randn(y_shape, generator=generator, dtype=F32, device=dev))
             for _ in range(mix)]
    return u, nx, ny, pairs


def make_smc_sampler_p(fm_x_apply: Callable, fm_y_apply: Callable,
                       cfg: SMCSamplerConfig, log_ratio_apply: Callable):
    """Build the SMC sampler with the models as call arguments:

        sampler(params, generator, num_samples, init_noise=None,
                step_noise=None) -> (x1, y1, diags)

    params = (model_x, model_y, ratio_model); fm_*_apply(model, x NHWC,
    t [B]) -> v NHWC and log_ratio_apply(ratio_model, x, y) -> [B]. The
    sampler runs on `generator.device`. `step_noise`, where given, holds one
    (u, noise_x, noise_y, mixing) tuple per step in place of the draws (the
    module docstring's order; noise_x/y None without churn, mixing a list of
    (x, y) normal pairs, empty where the gate is closed).

    diags: per-step [T] tensors 'smc_ess' (population ESS; the sum of the
    islands' ESS in island mode), 'resampled' (0/1; the fraction of islands
    that resampled in island mode), 'log_r_mean' (mean endpoint log-ratio),
    'logw_spread' (max − min log-weight after selection), and the scalar
    'final_ess' of the terminal weights (reported, not resampled).
    """
    _validate(cfg)
    gamma = float(cfg.guidance_strength)
    churn = float(cfg.churn)
    extra = max(int(cfg.churn_iters) - 1, 0) if churn > 0.0 else 0
    tau = float(cfg.resample_tau)
    t_min, t_max = np.float32(cfg.resample_t_min), np.float32(
        cfg.resample_t_max)
    half, one = np.float32(0.5), np.float32(1.0)
    root_2c = np.float32(2.0 * churn)
    churn32 = np.float32(churn)

    @torch.no_grad()
    def sampler(params, generator: torch.Generator, num_samples: int,
                init_noise=None, step_noise: Optional[Sequence] = None):
        device = device_of(generator)
        model_x, model_y, ratio_model = params

        def fm_x(x, tb):
            return fm_x_apply(model_x, x, tb).to(F32)

        def fm_y(y, tb):
            return fm_y_apply(model_y, y, tb).to(F32)

        def log_r(x, y):
            lr = log_ratio_apply(ratio_model, x, y).to(F32)
            if cfg.log_ratio_clip is not None:
                lr = torch.clamp(lr, -cfg.log_ratio_clip, cfg.log_ratio_clip)
            return lr

        if init_noise is not None:
            x_t, y_t = (a.to(device=device, dtype=F32) for a in init_noise)
        else:
            x_t = torch.randn((num_samples,) + tuple(cfg.x_shape),
                              generator=generator, dtype=F32, device=device)
            y_t = torch.randn((num_samples,) + tuple(cfg.y_shape),
                              generator=generator, dtype=F32, device=device)
        b = x_t.shape[0]
        g = int(cfg.resample_group or 0)
        islands = _Islands(b, g, tau, device) if g > 0 else None
        b_f32 = torch.full((), float(b), dtype=F32, device=device)
        global_threshold = float(np.float32(tau * b))
        ts, dts = make_time_grid(cfg.num_steps, cfg.time_grid, cfg.grid_power)
        # step fractions as the uniform grid's ts: f32(i)·f32(1/N)
        fracs = (np.arange(cfg.num_steps, dtype=np.float32)
                 * np.float32(1.0 / cfg.num_steps))

        logw = torch.zeros((b,), dtype=F32, device=device)
        l_prev = torch.zeros((b,), dtype=F32, device=device)
        diags = {k: [] for k in ("smc_ess", "resampled", "log_r_mean",
                                 "logw_spread")}
        for i, (t, dt, frac) in enumerate(zip(ts, dts, fracs)):
            tb = torch.full((b,), float(t), dtype=F32, device=device)
            v_x, v_y = fm_x(x_t, tb), fm_y(y_t, tb)

            # potential: the endpoint prediction's log-ratio, telescoping
            sig = one - t
            l_now = log_r(x_t + float(sig) * v_x, y_t + float(sig) * v_y)
            if t > 0.0:      # the first step only sets the baseline
                logw = logw + gamma * (l_now - l_prev)
            l_prev = l_now

            t_next = t + dt
            sig_n = one - t_next
            mix = extra if sig_n > np.float32(1e-6) else 0
            if step_noise is not None:
                u, nx, ny, mixing = step_noise[i]
                u = torch.as_tensor(u).to(device, F32)
            else:
                u, nx, ny, mixing = _draws(generator, cfg, islands,
                                           x_t.shape, y_t.shape, mix)

            # selection: the ESS on the device; the window on the host
            gate = frac if cfg.resample_window == "step" else t
            in_window = bool(t_min <= gate <= t_max)
            if islands is not None:
                wg, ess_g = islands.ess(logw)
                ess = ess_g.sum()
                if in_window:
                    do_g = ess_g < islands.threshold                # [NG]
                    idx_g = systematic_resample_idx(wg, u)
                    # the cdf guard pins the last (phantom) slot: clamp into
                    # the real prefix
                    idx_g = torch.minimum(idx_g, islands.n_real[:, None] - 1)
                    idx = torch.where(do_g[:, None], idx_g + islands.offsets,
                                      islands.identity).reshape(-1)[:b]
                    lw = islands.padded(logw)
                    logw = torch.where(do_g[:, None], torch.zeros_like(lw),
                                       lw).reshape(-1)[:b]
                    resampled = do_g.to(F32).sum() / islands.ng_f32
                else:
                    resampled = torch.zeros((), dtype=F32, device=device)
            else:
                w = _softmax(logw)
                ess = _ess(w)
                if in_window:
                    do = ess < global_threshold
                    idx = torch.where(do, systematic_resample_idx(w, u),
                                      torch.arange(b, device=device))
                    logw = torch.where(do, torch.zeros_like(logw), logw)
                    resampled = do.to(F32)
                else:
                    resampled = torch.zeros((), dtype=F32, device=device)
            if in_window:
                x_t, y_t = x_t.index_select(0, idx), y_t.index_select(0, idx)
                v_x, v_y = v_x.index_select(0, idx), v_y.index_select(0, idx)
                l_prev = l_prev.index_select(0, idx)

            # proposal: the flow step (+ the midpoint's half-step evaluation)
            if cfg.solver == "midpoint":
                hdt = float(half * dt)
                th = torch.full((b,), float(t + half * dt), dtype=F32,
                                device=device)
                a_x = fm_x(x_t + hdt * v_x, th)
                a_y = fm_y(y_t + hdt * v_y, th)
            else:
                a_x, a_y = v_x, v_y
            x_new = x_t + a_x * float(dt)
            y_new = y_t + a_y * float(dt)
            if churn > 0.0:
                drift = float(churn32 * sig)
                std = float(np.sqrt(root_2c * dt) * sig)
                x_new = (x_new - drift * (x_t - float(t) * v_x) * float(dt)
                         + std * nx.to(device, F32))
                y_new = (y_new - drift * (y_t - float(t) * v_y) * float(dt)
                         + std * ny.to(device, F32))

            # extra Langevin mixing at t + dt, a fresh velocity each
            if mix:
                tb_n = torch.full((b,), float(t_next), dtype=F32,
                                  device=device)
                drift_n = float(churn32 * sig_n * dt)
                std_n = float(np.sqrt(root_2c * dt) * sig_n)
                for mx, my in mixing:
                    x_new = (x_new - drift_n * (x_new - float(t_next)
                                                * fm_x(x_new, tb_n))
                             + std_n * mx.to(device, F32))
                    y_new = (y_new - drift_n * (y_new - float(t_next)
                                                * fm_y(y_new, tb_n))
                             + std_n * my.to(device, F32))
            x_t, y_t = x_new, y_new

            diags["smc_ess"].append(ess)
            diags["resampled"].append(resampled)
            diags["log_r_mean"].append(l_now.sum() / b_f32)
            diags["logw_spread"].append(logw.max() - logw.min())

        out = {k: torch.stack(v) for k, v in diags.items()}
        # residual terminal weights are reported, not resampled: a final
        # resample would emit exact duplicates with no churn left
        if islands is not None:
            out["final_ess"] = islands.ess(logw)[1].sum()
        else:
            out["final_ess"] = _ess(_softmax(logw))
        return x_t, y_t, out

    return sampler


def make_smc_sampler(fm_x_fn: Callable, fm_y_fn: Callable,
                     cfg: SMCSamplerConfig, log_ratio_fn: Callable):
    """make_smc_sampler_p over closures fm_*_fn(x, t) and log_ratio_fn(x, y):
    sampler(generator, num_samples, init_noise=None, step_noise=None)."""
    inner = make_smc_sampler_p(lambda _, x, t: fm_x_fn(x, t),
                               lambda _, y, t: fm_y_fn(y, t), cfg,
                               lambda _, x, y: log_ratio_fn(x, y))

    def sampler(generator: torch.Generator, num_samples: int,
                init_noise=None, step_noise=None):
        return inner((None, None, None), generator, num_samples, init_noise,
                     step_noise)

    return sampler


def sample_bimodal_smc(
    fm_x_fn: Callable,
    fm_y_fn: Callable,
    log_ratio_fn: Callable,
    guidance_strength: float = 1.0,
    num_samples: int = 16,
    num_steps: int = 100,
    x_shape: Tuple[int, ...] = (28, 28, 1),
    y_shape: Tuple[int, ...] = (28, 28, 1),
    generator: Optional[torch.Generator] = None,
    churn: float = 1.0,
    churn_iters: int = 1,
    resample_tau: float = 0.5,
    resample_t_min: float = 0.2,
    resample_t_max: float = 0.9,
    resample_group: int = 16,
    resample_window: str = "t",
    log_ratio_clip: Optional[float] = None,
    solver: str = "euler",
    time_grid: str = "uniform",
    grid_power: float = 2.0,
    return_diagnostics: bool = False,
    device=None,
):
    """The JAX wrapper's surface with closures fm_*_fn(x NHWC, t [B]) and
    log_ratio_fn(x, y). Returns (x1, y1) NHWC (plus diagnostics). Runs on
    `device` (default cuda) with a generator seeded 42 unless `generator`
    is given."""
    if generator is None:
        generator = torch.Generator(resolve_device(device)).manual_seed(42)
    cfg = SMCSamplerConfig(
        guidance_strength=guidance_strength, num_steps=num_steps,
        x_shape=tuple(x_shape), y_shape=tuple(y_shape), churn=churn,
        churn_iters=churn_iters, resample_tau=resample_tau,
        resample_t_min=resample_t_min, resample_t_max=resample_t_max,
        resample_group=resample_group, resample_window=resample_window,
        log_ratio_clip=log_ratio_clip, solver=solver, time_grid=time_grid,
        grid_power=grid_power)
    x1, y1, diags = make_smc_sampler(fm_x_fn, fm_y_fn, cfg, log_ratio_fn)(
        generator, num_samples)
    if return_diagnostics:
        return x1, y1, diags
    return x1, y1
