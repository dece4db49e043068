"""Kinds of net beyond the three that `nets.py` and `counts.py` hold
(`unet`, `ratio_gn`, `ratio_bn`): each one file, `kinds/<kind>.py`, found
by the `kind` a configuration names. A kind file imports torch and the
benchmark's reference only (nothing of the program, nothing of JAX) and
defines:

* `layout(arch)`: the published state-dict keys and shapes, in order
  (the weights are one `randn` cut in this order);
* `forward(o, arch, a, b)`: plain float32 PyTorch on `nets._Ops` `o`,
  whose `o.conv` and `o.dense` are used for every convolution and dense
  layer and `o.r` (None in float32) rounds the inputs of any other product
  of the kind's own, so that a control's precision reaches every product;
* `flops(arch, batch)`: the forward's FLOPs at `batch` (2 × MACs of its
  convolutions and dense layers and of its own products);
* optionally `gn_sites(arch)`: its GroupNorm+SiLU sites as (C, H) per
  example; none where it is not defined.
"""
from __future__ import annotations

import importlib
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent


def load(kind: str) -> ModuleType:
    """The module of `kind`: `portbench.reference.kinds.<kind>`."""
    name = f"{__name__}.{kind}"
    path = HERE / f"{kind}.py"
    if not kind.isidentifier():
        raise ValueError(f"unknown net kind {kind!r}: no {path}")
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"unknown net kind {kind!r}: no {path}") from None
