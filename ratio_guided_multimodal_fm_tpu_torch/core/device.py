"""Device selection: the card by default, the CPU only when asked for.

Every entry point of the port resolves its device here. With no argument
it is `cuda`; without a GPU that is an error, never a silent CPU run —
tests and CPU users pass `device="cpu"` (CLI: `--device cpu`).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def pin_fp32_precision() -> None:
    """Keep float32 matrix products and convolutions in IEEE float32.

    cuDNN runs float32 convolutions in TF32 by default (about three decimal
    digits), and the JAX reference pins float32 dots to HIGHEST precision
    (its sampler's guidance math loses ~3% in g otherwise). Both switches
    are process-wide; the port's entry paths set them on every call.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Return the torch device an entry point runs on (default `cuda`).

    Raises RuntimeError when a CUDA device is requested (explicitly or by
    default) and none is available.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: this port runs on the GPU by "
            "default; pass device='cpu' (CLI: --device cpu) to run on the "
            "CPU instead")
    pin_fp32_precision()
    return dev


def place_model(model: torch.nn.Module, device: torch.device):
    """Move a model to `device` for inference: eval mode, 4-D params in
    channels_last memory (the layout the card's bf16 convolutions run in),
    params frozen, so that gradient guidance, which differentiates log r̂
    with respect to the state, forms no parameter gradient (the GroupNorm
    backward then writes dx alone)."""
    return model.to(device=device, memory_format=torch.channels_last).eval(
    ).requires_grad_(False)


def place_for_training(model: torch.nn.Module, device: torch.device):
    """Move a model to `device` for training: train mode (dropout on),
    4-D params in channels_last memory, params trainable, so that every
    GroupNorm site forms dx, dγ and dβ."""
    return model.to(device=device, memory_format=torch.channels_last).train(
    ).requires_grad_(True)


def device_of(generator: Optional[torch.Generator]) -> torch.device:
    """The device a `torch.Generator` draws on."""
    if generator is None:
        raise ValueError("a torch.Generator is required")
    return resolve_device(generator.device)
