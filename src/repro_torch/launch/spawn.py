"""Local process groups: one process a rank, started by ``spawn``."""

from __future__ import annotations

import datetime
import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("nccl", "gloo")


def _rank_main(rank, fn, world, backend, tmp, args, timeout):
    kw = {}
    if backend == "nccl":
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'store')}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout), **kw)
    try:
        out = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def spawn_ranks(fn, world: int, args=(), *, backend: str, timeout: float = 600.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` local processes joined in
    one process group; return the ranks' results in rank order.

    The processes start by ``spawn``, never ``fork`` (the caller may hold a
    CUDA context), meet through a ``file://`` store in a temporary
    directory, and each calls ``destroy_process_group`` when ``fn`` returns
    or raises.  ``backend="nccl"``: one rank a card, rank ``r`` on
    ``cuda:r`` (given to ``init_process_group`` as ``device_id``); more
    ranks than cards raise ``ValueError``.  ``backend="gloo"``: CPU
    processes.  ``fn`` is pickled by name (a module-level function) and its
    result must go through ``torch.save``.

    A rank that raises makes this raise, and the other ranks are ended; if
    the ranks outlast ``timeout`` seconds, every one is ended and this
    raises ``TimeoutError``.  The same timeout bounds each collective.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    if backend == "nccl" and world > torch.cuda.device_count():
        raise ValueError(f"{world} NCCL ranks on {torch.cuda.device_count()} cards: "
                         "one rank a card, never more ranks than cards")
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        ctx = mp.start_processes(_rank_main, args=(fn, world, backend, tmp, args, timeout),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world} ranks still running after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
