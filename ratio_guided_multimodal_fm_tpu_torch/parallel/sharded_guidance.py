"""Guided sampling over a ('data', 'mc') mesh of ranks (port of
parallel/sharded_guidance.py).

* 'data' axis: the sample batch is split; each rank integrates its own
  rows. Every rank holds all the weights, so the velocity evaluations need
  no communication.
* 'mc' axis: the Monte-Carlo guidance set is split; each rank runs phase
  A on its shard only, and the guidance's reductions over N_mc (row max,
  p̄, Z̄, Σw·X1, ...) become all-reduces over the mc group
  (sample/guided.py:mc_feng_guidance), exactly. This lets N_mc grow past
  one card's memory. Kernel A reduces over its own shard only, so with an
  mc group larger than one the step computes the guidance in tensor ops
  (the JAX package drops its Pallas kernel there too); with an mc group of
  one each rank launches kernel A on its data rows against the whole set.

Random draws: every rank draws the FULL initial noise (x, then y) and the
FULL MC noise (x, then y) from its generator in the single-process
sampler's order, then keeps its rows and its MC shard; so, for generators
seeded alike, the sampler equals the single-process one
(sample/guided.py:make_guided_sampler_p) up to the order of the sums. The
outputs are assembled on every rank (an all-reduce of the zero-padded
rows: the collectives stay all_reduce, which gloo takes for CUDA tensors).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from ratio_guided_multimodal_fm_tpu_torch.parallel.mesh import (
    axis_group,
    axis_index,
    axis_size,
)
from ratio_guided_multimodal_fm_tpu_torch.sample.guided import (
    MC_METHODS,
    GuidedSamplerConfig,
    make_guided_sampler_p,
)


def _assemble(local: torch.Tensor, total: int, row0: int, write: bool
              ) -> torch.Tensor:
    """The whole [total, ...] tensor on every rank from each data shard's
    rows (written by the mc-index-0 rank of each data shard)."""
    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return local
    full = torch.zeros((total,) + tuple(local.shape[1:]), dtype=local.dtype,
                       device=local.device)
    if write:
        full[row0:row0 + local.shape[0]] = local
    dist.all_reduce(full)
    return full


def make_distributed_guided_sampler_p(
    fm_x_apply: Callable,            # (model_x, x, t) -> v
    fm_y_apply: Callable,
    cfg: GuidedSamplerConfig,
    log_ratio_apply: Optional[Callable],  # (ratio_model, x, y) -> [B]
    mesh,
    data_axis: str = "data",
    mc_axis: str = "mc",
):
    """The sampler with the models as arguments:

        sampler(params, generator, num_samples, mc_set=None,
                init_noise=None, return_diagnostics=False) -> (x1, y1)

    params = (model_x, model_y, ratio_model); `mesh` a parallel/mesh.py
    mesh (None: one process). num_samples must divide by the 'data' axis
    size, cfg.mc_batch_size by the 'mc' axis size. `init_noise` (the full
    (x, y) noise) and `mc_set` (the full (mc_x1, mc_y1, r̂)) replace the
    draws; each rank keeps its rows and its shard. The outputs are the
    whole batch on every rank; with `return_diagnostics` also this rank's
    per-step diagnostics of its rows. The body is the one-process sampler
    (sample/guided.py:make_guided_sampler_p) on this rank's coordinates."""
    guided = cfg.guidance_method != "none" and log_ratio_apply is not None
    if cfg.mc_refresh > 1 and guided and cfg.guidance_method in MC_METHODS:
        raise ValueError(
            "mc_refresh > 1 is not supported with a sharded mc_axis — use "
            "the single-set distributed sampler or mc_refresh=1")
    n_data, di = axis_size(mesh, data_axis), axis_index(mesh, data_axis)
    mi = axis_index(mesh, mc_axis)
    local = make_guided_sampler_p(
        fm_x_apply, fm_y_apply, cfg, log_ratio_apply,
        data_shard=(di, n_data), mc_shard=(mi, axis_size(mesh, mc_axis)),
        mc_group=axis_group(mesh, mc_axis))

    def sampler(params, generator: torch.Generator, num_samples: int,
                mc_set=None, init_noise=None,
                return_diagnostics: bool = False):
        x_t, y_t, diags = local(params, generator, num_samples, mc_set,
                                init_noise)
        row0 = di * (num_samples // n_data)
        x1 = _assemble(x_t, num_samples, row0, mi == 0)
        y1 = _assemble(y_t, num_samples, row0, mi == 0)
        if return_diagnostics:
            return x1, y1, diags
        return x1, y1

    return sampler


def make_distributed_guided_sampler(fm_x_fn: Callable, fm_y_fn: Callable,
                                    cfg: GuidedSamplerConfig,
                                    log_ratio_fn: Optional[Callable], mesh,
                                    data_axis: str = "data",
                                    mc_axis: str = "mc"):
    """Closure form (the models bound in the callables): sampler(generator,
    num_samples, mc_set=None, init_noise=None, return_diagnostics=False)."""
    inner = make_distributed_guided_sampler_p(
        lambda _, x, t: fm_x_fn(x, t), lambda _, y, t: fm_y_fn(y, t), cfg,
        None if log_ratio_fn is None else (lambda _, x, y: log_ratio_fn(x, y)),
        mesh, data_axis=data_axis, mc_axis=mc_axis)

    def sampler(generator: torch.Generator, num_samples: int, mc_set=None,
                init_noise=None, return_diagnostics: bool = False):
        return inner((None, None, None), generator, num_samples, mc_set,
                     init_noise, return_diagnostics)

    return sampler
