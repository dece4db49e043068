"""The one seam between the kernel wrappers of `ops/` and the C entry points
of `csrc/`: binding, launch, error check and launch counters.

`Kernel(lib, name, argtypes)` is the entry point `rgmf_<name>` of
csrc/<lib>.cu, whose arguments are `argtypes` followed by the device index
and the CUDA stream, and which returns a CUDA error code. Calling it with
the tensor the launch works on (`on`) and the launch's plan:

* binds the entry point once (the library is built and loaded on first use
  by `_build.load`);
* appends `on`'s device index and the current CUDA stream of its device;
* raises RuntimeError on a non-zero code, naming the kernel, the CUDA
  error code and its string (the library's `rgmf_cuda_error_string`,
  csrc/c_api.cuh, bound the same way), and the plan;
* bumps the counter `counter = (function, attribute)` by one if the launch
  ran eagerly (`count`).

Counters: `counters(fn, *attrs)` declares `fn.<attr>` for each attribute,
at 0, and registers it in COUNTERS, which `ops.launch_counts` reads.
`count` adds 1 only where the work runs now: a CUDA graph's capture only
records the kernels and its replays run them without passing through the
wrappers, so neither counts (a graph's launches are read from a profiler
trace).

Entry points that are not launches (`bind`) take no device or stream and
are called as they are: the occupancy queries and `rgmf_last_error`.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from ratio_guided_multimodal_fm_tpu_torch.ops import _build

PTR, INT, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

_bound: Dict[Tuple[str, str], Callable] = {}
# (function, attribute) of every launch counter, as `counters` declared them
COUNTERS: List[Tuple[Callable, str]] = []


def bind(lib: str, name: str, argtypes: Sequence, restype=INT) -> Callable:
    """The C function rgmf_<name> of csrc/<lib>.cu, its argument and result
    types set, bound once."""
    key = (lib, name)
    if key not in _bound:
        fn = getattr(_build.load(lib), f"rgmf_{name}")
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _bound[key] = fn
    return _bound[key]


def error_string(lib: str, err: int) -> str:
    """cudaGetErrorString of `err`, through csrc/<lib>.cu's library."""
    return bind(lib, "cuda_error_string", [INT], ctypes.c_char_p)(
        err).decode()


def device_index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def device_and_stream(t: torch.Tensor) -> Tuple[int, int]:
    """(device index, current CUDA stream handle) of t's device."""
    return (device_index(t.device),
            torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> int | None:
    """t's data pointer, None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


def counters(fn: Callable, *attrs: str) -> None:
    """Declare launch counters fn.<attr>, each 0, in COUNTERS."""
    for attr in attrs:
        setattr(fn, attr, 0)
        COUNTERS.append((fn, attr))


def eager(device: torch.device) -> bool:
    """Whether work issued now on `device` runs now: False while a CUDA
    graph capture records the current stream."""
    return (device.type != "cuda"
            or not torch.cuda.is_current_stream_capturing())


def count(fn: Callable, attr: str, device: torch.device) -> None:
    """fn.<attr> += 1 where the launch just issued on `device` ran
    eagerly."""
    if eager(device):
        setattr(fn, attr, getattr(fn, attr) + 1)


class Kernel:
    """A launch entry point rgmf_<name> of csrc/<lib>.cu (see the top)."""

    def __init__(self, lib: str, name: str, argtypes: Sequence):
        self.lib = lib
        self.name = name
        self.argtypes = [*argtypes, INT, PTR]     # + device index, stream

    def __call__(self, *args, on: torch.Tensor, plan,
                 counter: Tuple[Callable, str]) -> None:
        fn = bind(self.lib, self.name, self.argtypes)
        err = fn(*args, *device_and_stream(on))
        if err != 0:
            raise RuntimeError(
                f"{self.name} kernel launch failed: CUDA error {err} "
                f"({error_string(self.lib, err)}), {plan}")
        count(*counter, on.device)
