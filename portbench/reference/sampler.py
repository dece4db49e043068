"""One step of the guided sampler, in plain PyTorch (Feng et al. Alg. 2 as
the published sampler runs it: src/utils/flow_utils.py).

Euler on the reference's uniform grid: t_k = float32(k) · float32(1/T),
dt = float32(1/T), x_{k+1} = x_k + v · dt in float32. With mc_feng at
strength γ and t_k > 1e-3, v = (1-γ)·v_net + γ·g with

    σ = 1 - t + 1e-3,  log p_n = -(|x - t·X1_n|² + |y - t·Y1_n|²) / (2σ²),
    w = softmax_n(log r̂_n + log p_n),  g_x = (Σ_n w_n X1_n - x) / σ,

taken in float64 (the exact yardstick), and ESS = 1 / Σ w². Phase A is
the same step without guidance. Inputs and outputs are NHWC."""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.nets import Net, nhwc_scores, nhwc_velocity
from portbench.reference.precision import tf32_scope

EPS_T = 1e-3
ROWS = 128     # rows a block, so a full-size batch fits beside anything


def grid(num_steps: int):
    dt = np.float32(1.0 / num_steps)
    return np.arange(num_steps, dtype=np.float32) * dt, dt


@torch.no_grad()
def velocity(net: Net, x: torch.Tensor, t: float,
             precision: str = "fp32") -> torch.Tensor:
    out = []
    with tf32_scope(precision):
        for i in range(0, x.shape[0], ROWS):
            xb = x[i:i + ROWS].to(torch.float32)
            tb = torch.full((xb.shape[0],), float(t), dtype=torch.float32,
                            device=x.device)
            out.append(nhwc_velocity(net, xb, tb, precision))
    return torch.cat(out)


@torch.no_grad()
def scores(net: Net, x: torch.Tensor, y: torch.Tensor,
           precision: str = "fp32") -> torch.Tensor:
    with tf32_scope(precision):
        return torch.cat([nhwc_scores(net, x[i:i + ROWS].to(torch.float32),
                                      y[i:i + ROWS].to(torch.float32),
                                      precision)
                          for i in range(0, x.shape[0], ROWS)])


@torch.no_grad()
def guidance(x, y, mc_x1, mc_y1, log_r, t: float):
    """(g_x, g_y, ess) in float64 for NHWC states x, y [B, ...] and the MC
    set (mc_x1, mc_y1 [N, ...], log r̂ [N])."""
    f64 = torch.float64
    B, N = x.shape[0], mc_x1.shape[0]
    xt, yt = x.reshape(B, -1).to(f64), y.reshape(B, -1).to(f64)
    X1, Y1 = mc_x1.reshape(N, -1).to(f64), mc_y1.reshape(N, -1).to(f64)
    t = float(np.float32(t))
    sigma = 1.0 - t + EPS_T
    sq = ((xt * xt).sum(1, keepdim=True) + (yt * yt).sum(1, keepdim=True)
          - 2.0 * t * (xt @ X1.T + yt @ Y1.T)
          + t * t * ((X1 * X1).sum(1) + (Y1 * Y1).sum(1))[None, :])
    w = torch.softmax(log_r.to(f64)[None, :] - 0.5 * sq / sigma ** 2, dim=1)
    g_x = (w @ X1 - xt) / sigma
    g_y = (w @ Y1 - yt) / sigma
    ess = 1.0 / (w * w).sum(1)
    return g_x.reshape(x.shape), g_y.reshape(y.shape), ess


def phase_a_step(net: Net, x: torch.Tensor, k: int, num_steps: int,
                 precision: str = "fp32") -> torch.Tensor:
    ts, dt = grid(num_steps)
    return x + velocity(net, x, ts[k], precision) * float(dt)


def phase_b_step(net_x: Net, net_y: Net, x, y, mc_x1, mc_y1, log_r,
                 k: int, num_steps: int, gamma: float,
                 precision=("fp32", "fp32")):
    """(x_{k+1}, y_{k+1}, ess) of a guided step from (x_k, y_k)."""
    ts, dt = grid(num_steps)
    t = ts[k]
    v_x = velocity(net_x, x, t, precision[0])
    v_y = velocity(net_y, y, t, precision[1])
    g_x, g_y, ess = guidance(x, y, mc_x1, mc_y1, log_r, t)
    if t > np.float32(EPS_T):
        v_x = (1.0 - gamma) * v_x + gamma * g_x.to(torch.float32)
        v_y = (1.0 - gamma) * v_y + gamma * g_y.to(torch.float32)
    return x + v_x * float(dt), y + v_y * float(dt), ess
