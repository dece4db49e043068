"""Multi-process runtime on torch.distributed (port of parallel/
multihost.py).

One Python process per rank; `maybe_init_distributed` joins them into one
process group, and every rank runs the same program on its own rows of
the global batch. The pieces:

* `maybe_init_distributed` — idempotent entry point; the same resolution
  order as the JAX package (arguments, then the RGMF_COORDINATOR,
  RGMF_NUM_PROCESSES and RGMF_PROCESS_ID variables, then single-process),
  a no-op unless a coordinator is given and there is more than one
  process. The ranks first tell each other their host and its card count
  through the coordinator's store; the backend is NCCL when every rank
  has a card of its own on its host (rank r takes card `local rank`, its
  index among the ranks of its host) and gloo otherwise: on the CPU, and
  when ranks share a card (NCCL refuses two ranks on one device; gloo
  reduces CUDA tensors through the host). The port's collectives are all_reduce (SUM,
  MAX, MIN) and broadcast, the ones gloo takes for CUDA tensors.
* `process_batch_slice` / `globalize_batch` — rank p's contiguous block
  [p·B/P, (p+1)·B/P) of an identically seeded global batch (B must divide
  by P), so the rows of all ranks together are the one-process batch.
* `DataParallel` — what a data-parallel train step needs: the rows, the
  sums over ranks (with gradients where the loss needs them: a global
  mean, BatchNorm's global statistics), the gradient all-reduce, and one
  agreed flag (preemption).

Every rank seeds identically, so the initial parameters agree with no
broadcast (`DataParallel.assert_replicated` checks that once).
"""
from __future__ import annotations

import os
import socket
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def _resolve(coordinator_address, num_processes, process_id):
    coordinator_address = coordinator_address or os.environ.get(
        "RGMF_COORDINATOR")
    if num_processes is None and os.environ.get("RGMF_NUM_PROCESSES"):
        num_processes = int(os.environ["RGMF_NUM_PROCESSES"])
    if process_id is None and os.environ.get("RGMF_PROCESS_ID"):
        process_id = int(os.environ["RGMF_PROCESS_ID"])
    return coordinator_address, num_processes, process_id


def multi_process_requested(coordinator_address: Optional[str] = None,
                            num_processes: Optional[int] = None,
                            process_id: Optional[int] = None) -> bool:
    """True when the arguments and variables ask for more than one
    process (what `maybe_init_distributed` would join)."""
    coord, n, _ = _resolve(coordinator_address, num_processes, process_id)
    return bool(coord) and bool(n) and n > 1


def local_ranks(hosts: Sequence[Tuple[str, int]], rank: int
                ) -> Tuple[int, int]:
    """(local rank, ranks on its host) of `rank`, given every rank's
    (host name, card count) in rank order."""
    same = [r for r, (h, _) in enumerate(hosts) if h == hosts[rank][0]]
    return same.index(rank), len(same)


def choose_backend(hosts: Sequence[Tuple[str, int]], device,
                   nccl_available: Optional[bool] = None) -> str:
    """'nccl' when every rank gets a card of its own on its host (each
    host has at least as many cards as ranks), else 'gloo'. `hosts` is
    every rank's (host name, card count) in rank order."""
    if nccl_available is None:
        nccl_available = dist.is_nccl_available()
    if device is None or torch.device(device).type != "cuda" or not (
            nccl_available):
        return "gloo"
    per_host = Counter(h for h, _ in hosts)
    return ("nccl" if all(n <= dict(hosts)[h] for h, n in per_host.items())
            else "gloo")


def _exchange_hosts(store, n: int, pid: int) -> List[Tuple[str, int]]:
    """Every rank's (host name, card count), through the store."""
    store.set(f"rgmf_host/{pid}",
              f"{socket.gethostname()}|{torch.cuda.device_count()}")
    hosts = []
    for r in range(n):
        name, count = store.get(f"rgmf_host/{r}").decode().rsplit("|", 1)
        hosts.append((name, int(count)))
    return hosts


def maybe_init_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device=None) -> bool:
    """Join the process group when configured; returns True if multi-
    process. Safe to call more than once and in single-process runs.

    `device` is where the program runs ('cuda' or 'cpu'); it picks the
    backend (`choose_backend`), and with NCCL a rank takes the card of its
    local rank. Ends with a barrier, so the ranks leave in step."""
    coord, n, pid = _resolve(coordinator_address, num_processes, process_id)
    if not coord or not n or n <= 1:
        return False
    if dist.is_initialized():
        return True
    if pid is None:
        raise ValueError("multi-process run: --process_id (or "
                         "RGMF_PROCESS_ID) is required with "
                         f"--num_processes {n}")
    # the store init_method="tcp://..." would make, made first so the
    # ranks can tell each other their hosts before the backend is chosen
    store, _, _ = next(dist.rendezvous(
        f"tcp://{coord}?rank={pid}&world_size={n}"))
    hosts = _exchange_hosts(store, n, pid)
    local, per_host = local_ranks(hosts, pid)
    backend = choose_backend(hosts, device)
    if backend == "nccl":
        torch.cuda.set_device(local)
    print(f"torch.distributed: rank {pid} of {n} (local rank {local} of "
          f"{per_host} on {hosts[pid][0]}), backend {backend} "
          f"({'one card per rank' if backend == 'nccl' else 'the CPU or a shared card'}), "
          f"tcp://{coord}", flush=True)
    dist.init_process_group(backend, store=store, world_size=n, rank=pid)
    dist.barrier()
    return True


def process_info() -> Tuple[int, int]:
    """(rank, number of processes); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_device(device) -> torch.device:
    """The card this rank runs on: with NCCL the card of its local rank,
    else `device` as given (ranks that share a card use its index)."""
    device = torch.device(device)
    if (device.type == "cuda" and dist.is_initialized()
            and dist.get_backend() == "nccl"):
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _rows(v, pi: int, pc: int, key=None):
    if len(v) % pc:
        raise ValueError(
            f"global batch axis {len(v)} not divisible by process_count "
            f"{pc}" + (f" (key {key!r})" if key is not None else ""))
    n = len(v) // pc
    return v[pi * n:(pi + 1) * n]


def process_batch_slice(batch: Dict[str, object],
                        process_index: Optional[int] = None,
                        process_count: Optional[int] = None
                        ) -> Dict[str, object]:
    """Rank p's rows of a global batch dict: the contiguous block
    [p·B/P, (p+1)·B/P) of every entry (B must divide by P). Batches are
    shuffled with a shared seed, so contiguity adds no skew."""
    pi, pc = process_info()
    pi = pi if process_index is None else process_index
    pc = pc if process_count is None else process_count
    if pc == 1:
        return batch
    return {k: _rows(v, pi, pc, k) for k, v in batch.items()}


def globalize_batch(batch, process_index: Optional[int] = None,
                    process_count: Optional[int] = None):
    """This rank's rows of a full, identically seeded batch: a tensor, a
    numpy array, or a dict of them (the JAX function builds a globally
    sharded array from the same rows; here each rank keeps its own)."""
    pi, pc = process_info()
    pi = pi if process_index is None else process_index
    pc = pc if process_count is None else process_count
    if pc == 1:
        return batch
    if isinstance(batch, dict):
        return {k: _rows(v, pi, pc, k) for k, v in batch.items()}
    return _rows(batch, pi, pc)


def global_data_mesh():
    """1-D ('data',) mesh over every rank (parallel/mesh.py:make_mesh)."""
    from ratio_guided_multimodal_fm_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(axis_names=("data",))


class DataParallel:
    """A rank's view of a data-parallel run over `group` (default: every
    rank). Each rank's train step sees its own rows; its loss is its share
    of the global loss (numerators over its rows, denominators over the
    global batch), so the gradient all-reduced with SUM is the one-process
    gradient of the whole batch."""

    def __init__(self, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = dist.get_backend(group)

    def rows(self, x):
        """This rank's contiguous block of the first axis."""
        return _rows(x, self.rank, self.size)

    def sum_grad(self, x: torch.Tensor) -> torch.Tensor:
        """Σ over ranks, differentiable (a global mean, BatchNorm's
        statistics): its backward all-reduces the gradient, so with each
        rank's loss its share of the global loss the ranks' gradients sum
        to the global one."""
        from torch.distributed.nn.functional import all_reduce

        return all_reduce(x, group=self.group)

    @torch.no_grad()
    def total(self, x: torch.Tensor) -> torch.Tensor:
        """Σ over ranks of a detached tensor (counts, reported metrics)."""
        x = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=self.group)
        return x

    @torch.no_grad()
    def sync_grads(self, grads: Iterable[torch.Tensor]) -> None:
        """Σ over ranks of every gradient, in place, as one flat
        all_reduce."""
        grads = list(grads)
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.group)
        torch._foreach_copy_(grads, [c.view_as(g) for c, g in zip(
            flat.split([g.numel() for g in grads]), grads)])

    def _host_device(self) -> torch.device:
        """Where a host-side collective's tensor lives: the card under
        NCCL, the CPU under gloo."""
        if self.backend == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def agree(self, local: bool) -> bool:
        """True on every rank when any rank says True (all_reduce MAX of
        one flag; a host collective, on the card under NCCL)."""
        f = torch.tensor([int(bool(local))], dtype=torch.int32,
                         device=self._host_device())
        dist.all_reduce(f, op=dist.ReduceOp.MAX, group=self.group)
        return bool(f.item())

    @torch.no_grad()
    def assert_replicated(self, tensors: Iterable[torch.Tensor],
                          what: str = "parameters") -> None:
        """Raise unless every rank holds the same values (max and min of
        each checksum over ranks agree): the identically seeded inits."""
        sums = torch.stack([t.detach().double().sum() for t in tensors]
                           ).to(self._host_device())
        hi, lo = sums.clone(), sums.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=self.group)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=self.group)
        if not torch.equal(hi, lo):
            raise RuntimeError(f"data-parallel ranks disagree on the "
                               f"initial {what}: seed every rank alike")


def barrier() -> None:
    """Wait for every rank (no-op single-process)."""
    if process_info()[1] > 1:
        dist.barrier()


def is_writer() -> bool:
    """Rank 0 writes files; the others wait at a barrier."""
    return process_info()[0] == 0

