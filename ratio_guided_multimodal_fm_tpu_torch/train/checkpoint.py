"""Checkpoints as torch `.pth` files in the reference layout (port of
train/checkpoint.py; the JAX package writes Orbax directories).

* a bare state dict (the EMA weights, experiment 1's best and periodic
  saves, the ratio nets and classifiers with their BatchNorm buffers; a
  BatchNorm net's EMA file is `ema_state_dict`), or
* a resumable training dict {'model_state_dict', 'optimizer_state_dict',
  'epoch', 'best_loss'} (ref train_flow_svhn.py:165-170),

both of which the sample and evaluate CLIs read with
cli/common.py:load_state_dict, and the JAX package's
interop/torch_import.py:import_state_dict imports. Names follow the
reference (path_utils.py:7-32, None parts dropped), with `.pth`:
checkpoints/flow_svhn_best.pth, flow_svhn_ema_best.pth,
flow_svhn_epoch10.pth. Every save goes to a temporary name in the same
directory and is renamed over the target, so a crash never leaves a torn
file. In a multi-process run rank 0 alone writes and every rank waits at
a barrier until it has (every rank makes the same saves).

`save_checkpoint(..., async_save=True)` copies the tensors to the host at
once and writes on one background thread, so a save overlaps the next
epoch; `wait_for_saves()` blocks until every such save is on disk (and
re-raises the writer's error), and `load_checkpoint` waits first, as the
JAX package's Orbax saves do.
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, List, Optional

import torch

CHECKPOINT_DIR = "checkpoints"


def checkpoint_path(model_type: str, *parts, base_dir: str = CHECKPOINT_DIR):
    """Reference-layout .pth name (JAX get_checkpoint_path; save_checkpoint
    makes the directory), None parts dropped:
    ('flow', 'y', 'rotate90', None, 'ema', 'best') ->
    checkpoints/flow_y_rotate90_ema_best.pth."""
    name = "_".join([model_type] + [str(a) for a in parts if a is not None])
    return os.path.join(base_dir, f"{name}.pth")


def get_checkpoint_path(model_type: str, *parts,
                        base_dir: str = CHECKPOINT_DIR) -> str:
    """The JAX package's name for `checkpoint_path`. The JAX function also
    creates `base_dir`; this one does not (save_checkpoint makes the
    directory when it writes)."""
    return checkpoint_path(model_type, *parts, base_dir=base_dir)


def checkpoint_exists(path: str) -> bool:
    return os.path.isfile(path)


def ema_checkpoint_path(path: str) -> str:
    """The EMA sibling of a checkpoint: `_ema` before the final name part
    of the basename ('runs/flow_x_best.pth' -> 'runs/flow_x_ema_best.pth'),
    the name the sample and evaluate CLIs read with --ema."""
    d, base = os.path.split(path)
    stem, ext = os.path.splitext(base)
    head, _, tail = stem.rpartition("_")
    new = f"{head}_ema_{tail}" if head else f"{stem}_ema"
    return os.path.join(d, new + ext)


def to_cpu(obj: Any) -> Any:
    """`obj` with every tensor detached and copied to the host (dicts,
    lists and tuples walked), so a file loads on any device."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_cpu(v) for v in obj)
    return obj


def _write(path: str, host_obj: Any) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    torch.save(host_obj, tmp)
    os.replace(tmp, path)


class _AsyncWriter:
    """One background thread that writes host copies in the order they
    were handed over, and the saves not yet waited for."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending: List[Future] = []
        self.requested = 0      # async saves since the last wait, any rank

    def submit(self, path: str, host_obj: Any) -> None:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="checkpoint-writer")
            self._pending.append(self._pool.submit(_write, path, host_obj))

    def wait(self) -> Optional[BaseException]:
        """Waits for every pending write; returns the first one's error."""
        with self._lock:
            pending, self._pending = self._pending, []
            self.requested = 0
        first = None
        for f in pending:
            err = f.exception()
            if err is not None and first is None:
                first = err
        return first


_writer = _AsyncWriter()


def save_checkpoint(path: str, obj: Any, async_save: bool = False) -> None:
    """torch.save of `obj` (tensors moved to the host) to a temporary name
    beside `path`, then an atomic rename over it; multi-process: by rank 0,
    the others waiting at a barrier. With `async_save` the host copy is
    made now (later steps cannot change what is saved) and the write runs
    on the background thread; the barrier then moves into
    `wait_for_saves`."""
    from ratio_guided_multimodal_fm_tpu_torch.parallel.multihost import (
        barrier,
        is_writer,
    )

    if async_save:
        _writer.requested += 1
        if is_writer():
            _writer.submit(path, to_cpu(obj))
        return
    if is_writer():
        _write(path, to_cpu(obj))
    barrier()


def wait_for_saves() -> None:
    """Block until every async save is on disk; raise the first write's
    error here. Multi-process: every rank makes the same saves, so every
    rank that made one meets the others at a barrier once rank 0's files
    are written."""
    from ratio_guided_multimodal_fm_tpu_torch.parallel.multihost import (
        barrier,
    )

    if not _writer.requested:
        return
    err = _writer.wait()
    barrier()
    if err is not None:
        raise err


def load_checkpoint(path: str) -> Any:
    """A checkpoint's contents on the host (tensors, numbers, dicts), after
    any async save in flight is on disk."""
    wait_for_saves()
    return torch.load(path, map_location="cpu", weights_only=True)


def save_train_checkpoint(path: str, state, epoch: int,
                          best_loss: float) -> None:
    """The resumable full-dict layout (ref train_flow_svhn.py:165-170)."""
    save_checkpoint(path, {
        "model_state_dict": state.model.state_dict(),
        "optimizer_state_dict": state.optimizer.state_dict(),
        "epoch": int(epoch),
        "best_loss": float(best_loss),
    })


def ema_state_dict(state) -> dict:
    """The EMA sibling of `state.model` as a full reference-layout state
    dict: the EMA parameters with the model's *current* buffers (BatchNorm
    running statistics and `num_batches_tracked`), as the JAX CLIs pair
    `ema_params` with the current `batch_stats` (the running averages are
    already an EMA of the activation moments). For a net without buffers
    it is the EMA alone. A strict `load_state_dict` takes it."""
    return {k: state.ema.get(k, v)
            for k, v in state.model.state_dict().items()}


def load_params(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Strict-load either layout's weights into `model`: key names and
    shapes must match exactly (load_state_dict(strict=True) raises)."""
    sd = load_checkpoint(path)
    if isinstance(sd, dict) and "model_state_dict" in sd:
        sd = sd["model_state_dict"]
    model.load_state_dict(sd, strict=True)
    return model
