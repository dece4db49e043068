"""Conditional flow matching (port of flow/cfm.py): the training loss
and the flow-ODE integration (time grids and solvers).

The JAX package integrates with one `lax.scan`; here the loop is a Python
loop over a host-side time grid, so every step's t is a Python float and
nothing syncs with the device per step. The path is the rectified flow
x_t = (1-t)·x_0 + t·x_1, integrated from x_0 ~ N(0, I) at t=0 to t=1; the
CFM target is u = x_1 − x_0. Random streams cannot cross frameworks, so the
loss takes x_0 and t injected, or a `torch.Generator` that draws them.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

SOLVERS = ("euler", "midpoint", "heun")


def interpolate(x1: torch.Tensor, t: torch.Tensor,
                x0: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
    """(x_t, u) = ((1-t)·x_0 + t·x_1, x_1 − x_0) for x1 [B, ...] and t [B],
    in x1's dtype; x_0 ~ N(0, I) is `x0` or drawn from `generator`."""
    if x0 is None:
        x0 = torch.randn(x1.shape, generator=generator, dtype=x1.dtype,
                         device=x1.device)
    tb = t.to(x1.dtype).reshape(t.shape + (1,) * (x1.dim() - 1))
    return (1.0 - tb) * x0 + tb * x1, x1 - x0


def cfm_loss(velocity_fn: Callable, x1: torch.Tensor,
             t: Optional[torch.Tensor] = None,
             x0: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Monte-Carlo CFM objective of one batch: mean((v(x_t, t) − u)²) in
    float32, t ~ U(0, 1) and x_0 ~ N(0, I) injected or drawn from
    `generator` (t first, then x_0). velocity_fn: (x_t, t) -> v."""
    if t is None:
        t = torch.rand((x1.shape[0],), generator=generator, dtype=x1.dtype,
                       device=x1.device)
    x_t, u = interpolate(x1, t, x0, generator)
    v = velocity_fn(x_t, t)
    return torch.mean((v.to(torch.float32) - u.to(torch.float32)) ** 2)

TIME_GRIDS = ("uniform", "late", "early", "cosine")


def make_time_grid(num_steps: int, kind: str = "uniform",
                   power: float = 2.0) -> Tuple[np.ndarray, np.ndarray]:
    """Per-step (ts, dts) float32 numpy arrays, bit-identical to the JAX
    package's grids: t_i = g(i/N), dt_i = g((i+1)/N) − g(i/N).

      'uniform' — g(s)=s, computed as f32(i)·f32(1/N) (reference grid)
      'late'    — g(s)=1−(1−s)^p: dense near t=1
      'early'   — g(s)=s^p: dense near t=0
      'cosine'  — g(s)=(1−cos πs)/2: dense at both ends
    """
    if kind not in TIME_GRIDS:
        raise ValueError(f"time grid must be one of {TIME_GRIDS}, "
                         f"got {kind!r}")
    if kind == "uniform":
        dt = np.float32(1.0 / num_steps)
        ts = np.arange(num_steps, dtype=np.float32) * dt
        return ts, np.full((num_steps,), dt, np.float32)
    s = np.linspace(0.0, 1.0, num_steps + 1)
    if kind == "late":
        g = 1.0 - (1.0 - s) ** power
    elif kind == "early":
        g = s ** power
    else:  # cosine
        g = 0.5 * (1.0 - np.cos(np.pi * s))
    g[0], g[-1] = 0.0, 1.0
    return g[:-1].astype(np.float32), (g[1:] - g[:-1]).astype(np.float32)


def _ode_step(velocity_fn: Callable, x: torch.Tensor, t: np.float32,
              dt: np.float32, solver: str) -> torch.Tensor:
    """One solver step of the float32 state x from t to t+dt. `t` and `dt`
    are float32 scalars; scalar arithmetic stays in float32 as in JAX."""
    B = x.shape[0]

    def vel(xx, tt):
        tb = torch.full((B,), float(tt), dtype=torch.float32, device=x.device)
        return velocity_fn(xx, tb).to(torch.float32)

    v = vel(x, t)
    half = np.float32(0.5) * dt
    if solver == "midpoint":
        v = vel(x + float(half) * v, t + half)
    elif solver == "heun":
        v = 0.5 * (v + vel(x + float(dt) * v, t + dt))
    return x + v * float(dt)


def ode_scan(velocity_fn: Callable, x0: torch.Tensor, num_steps: int = 100,
             solver: str = "euler", grid: str = "uniform",
             grid_power: float = 2.0) -> torch.Tensor:
    """Integrate x0 at t=0 to x1 at t=1: velocity_fn(x [B,...], t [B]) -> v.

    Solvers: 'euler' (reference, 1 eval/step), 'midpoint' and 'heun'
    (2 evals/step, O(dt²)); 'heun' evaluates at t=1.0 on its last step.
    """
    if solver not in SOLVERS:
        raise ValueError(f"solver must be one of {SOLVERS}, got {solver!r}")
    ts, dts = make_time_grid(num_steps, grid, grid_power)
    x = x0.to(torch.float32)
    for t, dt in zip(ts, dts):
        x = _ode_step(velocity_fn, x, t, dt, solver)
    return x


def euler_scan(velocity_fn: Callable, x0: torch.Tensor,
               num_steps: int = 100) -> torch.Tensor:
    """The JAX package's alias: `ode_scan` with the reference's Euler
    solver."""
    return ode_scan(velocity_fn, x0, num_steps, solver="euler")


def ode_scan_pair(pair_fn: Callable, x0: torch.Tensor, y0: torch.Tensor,
                  num_steps: int = 100, solver: str = "euler",
                  grid: str = "uniform", grid_power: float = 2.0):
    """Integrate both modalities' flows together: pair_fn(x, y, t [B]) ->
    (v_x, v_y), as a merged velocity function (models/merged.py) evaluates
    both nets in one call. Same grid, solvers and float32 arithmetic as
    `ode_scan`. Returns (x1, y1)."""
    if solver not in SOLVERS:
        raise ValueError(f"solver must be one of {SOLVERS}, got {solver!r}")
    ts, dts = make_time_grid(num_steps, grid, grid_power)
    B = x0.shape[0]

    def vel(xx, yy, tt):
        tb = torch.full((B,), float(tt), dtype=torch.float32,
                        device=x0.device)
        v_x, v_y = pair_fn(xx, yy, tb)
        return v_x.to(torch.float32), v_y.to(torch.float32)

    x, y = x0.to(torch.float32), y0.to(torch.float32)
    for t, dt in zip(ts, dts):
        v_x, v_y = vel(x, y, t)
        half = np.float32(0.5) * dt
        if solver == "midpoint":
            v_x, v_y = vel(x + float(half) * v_x, y + float(half) * v_y,
                           t + half)
        elif solver == "heun":
            v_x2, v_y2 = vel(x + float(dt) * v_x, y + float(dt) * v_y,
                             t + dt)
            v_x, v_y = 0.5 * (v_x + v_x2), 0.5 * (v_y + v_y2)
        x, y = x + v_x * float(dt), y + v_y * float(dt)
    return x, y


def euler_scan_pair(pair_fn: Callable, x0: torch.Tensor, y0: torch.Tensor,
                    num_steps: int = 100):
    """The JAX package's alias: `ode_scan_pair` with the reference's Euler
    solver."""
    return ode_scan_pair(pair_fn, x0, y0, num_steps, solver="euler")


def euler_sample(velocity_fn: Callable, generator: torch.Generator,
                 shape: tuple, num_steps: int = 100, solver: str = "euler",
                 grid: str = "uniform", grid_power: float = 2.0):
    """Draw x0 ~ N(0, I) of `shape` from `generator` (on its device) and
    integrate it prior→data."""
    x0 = torch.randn(shape, generator=generator, dtype=torch.float32,
                     device=generator.device)
    return ode_scan(velocity_fn, x0, num_steps, solver, grid, grid_power)
