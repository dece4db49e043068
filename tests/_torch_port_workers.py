"""Spawning torch.distributed workers for the port's multi-process tests:
`run_workers(script, n, tmp)` runs `script` in n fresh processes joined by
gloo on a free local port (RANK, WORLD and PORT in the environment; the
repository on sys.path), each with a timeout of its own, and fails with
their output if any exits non-zero."""
import os
import socket
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HEADER = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from ratio_guided_multimodal_fm_tpu_torch.parallel.multihost import (
        maybe_init_distributed)
    RANK, WORLD = int(os.environ["RANK_ID"]), int(os.environ["WORLD_N"])
    assert maybe_init_distributed("127.0.0.1:" + os.environ["PORT"], WORLD,
                                  RANK, device="cpu")
    OUT = os.environ["OUT_DIR"]
""")


# leave the group together: a rank that exits while gloo's threads still
# serve the others can abort at interpreter shutdown
FOOTER = textwrap.dedent("""
    import torch.distributed as _dist
    if _dist.is_initialized():
        _dist.barrier()
        _dist.destroy_process_group()
""")


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_workers(body: str, n: int, out_dir, timeout: int = 240,
                env_extra=None):
    script = HEADER.format(repo=REPO) + textwrap.dedent(body) + FOOTER
    path = os.path.join(str(out_dir), "worker.py")
    with open(path, "w") as f:
        f.write(script)
    port = str(free_port())
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK_ID=str(r), WORLD_N=str(n), PORT=port,
                   OUT_DIR=str(out_dir), OMP_NUM_THREADS="1",
                   **(env_extra or {}))
        procs.append(subprocess.Popen(
            [sys.executable, path], env=env, cwd=str(out_dir),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    bad = [(r, p.returncode, o) for r, (p, o) in enumerate(zip(procs, outs))
           if p.returncode != 0]
    assert not bad, "\n".join(f"rank {r} exit {rc}:\n{o[-4000:]}"
                              for r, rc, o in bad)
    return outs
