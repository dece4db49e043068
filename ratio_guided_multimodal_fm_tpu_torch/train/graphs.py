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

Launch counts: the ops wrappers count the kernels that run when they are
called, so the eager warm-up counts and neither the capture (which only
records) nor a replay (which does not pass through them) does; the
replays' launches are read from a profiler trace (chip_smoke.py, phase
5k).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch


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
        self.graph.replay()
        self.replays += 1
        return _clone(self.out)

    def _warm_up_and_capture(self):
        device = next(iter(self.static.values())).device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            out = self.fn(self.static, True)      # a real macro step
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.out = self.fn(self.static, False)
        self.graph = graph
        return out


def _clone(out):
    if isinstance(out, dict):
        return {k: v.clone() for k, v in out.items()}
    return out.clone()
