"""What every driver takes from the program under test: its kernels'
build, its device rules, its nets built from the benchmark's weights."""
from __future__ import annotations

from typing import Dict

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the control: the precision below the one a net is served in
LOWER = {"bfloat16": "fp8", "float32": "tf32"}


def build_kernels(device: torch.device) -> None:
    """Build the port's CUDA kernels into its fixed directory inside the
    checkout (only what is not built yet)."""
    if device.type == "cuda":
        from ratio_guided_multimodal_fm_tpu_torch.ops import _build
        _build.build_all()


def resolve(device) -> torch.device:
    """The program's own device rule: float32 stays IEEE (TF32 off)."""
    from ratio_guided_multimodal_fm_tpu_torch.core.device import (
        resolve_device,
    )
    return resolve_device(device)


def port_net(net: dict, dtype: str, P: Dict[str, torch.Tensor],
             device: torch.device) -> torch.nn.Module:
    """The port's model class named by the configuration, at `dtype`,
    holding the benchmark's weights P (published state-dict keys)."""
    from ratio_guided_multimodal_fm_tpu_torch import models

    ctor = getattr(models, net["port"])
    with torch.device("meta"):
        m = ctor(dtype=DTYPES[dtype], **net.get("port_kwargs", {}))
    m = m.to_empty(device=device)
    m.load_state_dict(P, strict=True)
    return m


def shape(net: dict):
    return tuple(net["shape"])


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
