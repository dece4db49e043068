"""One CUDA graph over a fused K-step train body (the card's counterpart
of the JAX package's lax.scan over K optimizer steps).

`TrainGraph(fn, static)`: `fn(static, check)` is the K-step body (the K
gathers, K × forward, backward, clip, Adam and EMA, the mean loss) reading
its inputs from the `static` tensors, which the caller refills before each
`run()`:

* the first `run()` is a real macro step of the run, eager, on a side
  stream (PyTorch's capture recipe: the lazy set-up of the libraries, the
  optimizer's state and the kernels' libraries happen here, outside the
  capture); then the same body is captured once into the graph;
* every later `run()` replays the graph: one launch from the host for the
  whole macro step.

The body may not synchronise with the host (no `.item()`, no NaN check
inside: `check` is False under capture and the caller checks the output
after the replay) and may not copy from the host. Its random draws are
the caller's (into `static`, before the run) or the device's default
generator (dropout), which a graph advances on each replay from the seed
the caller sets before it.

Spans (core/observability.py): `train.graph.warmup` (the eager macro step,
until its device work has drained), `train.graph.capture` (the
`torch.cuda.graph` block) and `train.graph.replay` (a replay and the
outputs' copies).

Launch counts: the ops wrappers count the kernels that run when they are
called, so the eager warm-up counts and neither the capture (which only
records) nor a replay (which does not pass through them) does; the
replays' launches are read from a profiler trace (chip_smoke.py, phase
5k).

`fused_macro_step` is the part the fused trainers of train/steps.py share:
one macro step either as the eager loop or on the cached graph of its
model, K, B and data.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ratio_guided_multimodal_fm_tpu_torch.core.guards import (
    check_finite,
    nan_checks_enabled,
)
from ratio_guided_multimodal_fm_tpu_torch.core.observability import span


class TrainGraph:
    """A K-step body captured once and replayed per macro step."""

    def __init__(self, fn: Callable, static: Dict[str, torch.Tensor]):
        self.fn = fn
        self.static = static
        self.graph = None
        self.out = None
        self.replays = 0

    def run(self):
        """The macro step's outputs (a tensor or a dict of them, copies of
        the graph's static outputs)."""
        if self.graph is None:
            return self._warm_up_and_capture()
        with span("train.graph.replay"):
            self.graph.replay()
            self.replays += 1
            return _clone(self.out)

    def _warm_up_and_capture(self):
        device = next(iter(self.static.values())).device
        with span("train.graph.warmup"):
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                out = self.fn(self.static, True)      # a real macro step
            torch.cuda.current_stream(device).wait_stream(side)
            # torch.cuda.graph synchronises on entry anyway: done here, the
            # warm-up's device work falls inside its own span
            torch.cuda.synchronize(device)
        graph = torch.cuda.CUDAGraph()
        with span("train.graph.capture"):
            with torch.cuda.graph(graph):
                self.out = self.fn(self.static, False)
        self.graph = graph
        return out


def _clone(out):
    if isinstance(out, dict):
        return {k: v.clone() for k, v in out.items()}
    return out.clone()


def make_capturable(optimizer: torch.optim.Optimizer) -> None:
    """Switch an Adam to capturable=True: its step count lives on the
    parameters' device, so bias correction is computed there in float32
    (inside a CUDA graph, not frozen into it). A step count already taken
    moves to the device."""
    for group in optimizer.param_groups:
        if group.get("capturable"):
            continue
        group["capturable"] = True
        for p in group["params"]:
            st = optimizer.state.get(p)
            if st and "step" in st:
                st["step"] = torch.as_tensor(
                    st["step"], dtype=torch.float32).to(p.device)


def fused_macro_step(graphs: Dict[tuple, TrainGraph], state,
                     graph: Optional[bool], *, key: tuple, body: Callable,
                     inputs: Dict[str, torch.Tensor],
                     buffers: Callable[[], Dict[str, torch.Tensor]],
                     prepare: Callable[[Dict[str, torch.Tensor]], None],
                     loss: Callable, what: str):
    """One macro step of a fused trainer: `body(static, check)` over the
    tensors `inputs` (on the model's device) and the draw buffers that
    `buffers()` allocates, after `prepare(static)` has drawn into the
    buffers and seeded the dropout.

    On a card Adam becomes capturable first. On the CPU, or with graph
    False, the body runs as it is, with its NaN checks. Otherwise (graph
    None or True) the TrainGraph of (id(state.model), *key) in `graphs`,
    made on first use with `inputs` as its static tensors, takes `inputs`
    into its static tensors, is prepared and runs; where NaN checks are on,
    `loss(out)` is checked after it (named `what`)."""
    device = next(iter(inputs.values())).device
    if device.type == "cuda":
        make_capturable(state.optimizer)
    if not (device.type == "cuda" if graph is None else graph):
        static = {**inputs, **buffers()}
        prepare(static)
        return body(static, True)
    key = (id(state.model),) + key
    g = graphs.get(key)
    if g is None:
        g = graphs[key] = TrainGraph(body, {**inputs, **buffers()})
    for k, v in inputs.items():
        g.static[k].copy_(v, non_blocking=True)
    prepare(g.static)
    out = g.run()
    if nan_checks_enabled():
        check_finite(loss(out), what)
    return out
