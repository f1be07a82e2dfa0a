"""Atomic, asynchronous checkpoints with restore onto another device.

Counterpart of ``repro/checkpoint/manager.py``, with the same layout on
disk, so a checkpoint either package writes restores in the other:

    <dir>/step_<N>.tmp/            — written first
        manifest.json              — step, leaf names, shapes, dtypes, processes, time
        proc_<P>.npz               — this process's leaves, keys "0" … "n-1"
    <dir>/step_<N>/                — renamed from the .tmp after fsync

A tree is nested dicts, tuples and lists of tensors.  Its leaves are named
and ordered as ``jax.tree_util`` flattens the same tree: dict keys sorted,
sequence positions by index, the names the path joined by ``/``.  The
(parameters, AdamW state) pair ``(model.tree(), opt.state_tree(...))`` is
named ``0/<param path>``, ``1/count``, ``1/m/<param path>`` and
``1/v/<param path>``, as the JAX ``(params, AdamWState)`` pair is.

``save`` copies every leaf to host memory before it returns (on the card
the device-to-host copy is that copy; a CPU tensor is cloned, since the
port's optimizer updates parameters and moments in place), then writes on
a background thread.  A bfloat16 leaf is written as the JAX manager writes
one: its 2-byte patterns as numpy's ``V2``, ``"bfloat16"`` in the manifest.
``restore`` matches the file's leaves to the target tree by name and
refuses a missing, extra, mis-shaped or mis-typed leaf; each leaf is read
by the manifest's dtype (a ``V2`` leaf of the JAX manager's included) and
placed on ``device``.  Beyond the JAX manager, the data files are fsynced
before the directory, the parent directory after the rename, and a write
that fails raises from the next ``wait`` or ``save``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(name, leaf) pairs in ``jax.tree_util``'s order."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += _flatten(v, f"{prefix}/{k}" if prefix else k)
    return out


def _unflatten(tree, leaves: dict, prefix: str = ""):
    """``tree``'s structure with the leaf of each name taken from ``leaves``."""
    def name(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, name(k)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(v, leaves, name(i)) for i, v in enumerate(tree))
    return leaves[prefix]


def _dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a torch dtype (``"float32"``, ``"bfloat16"``)."""
    return str(dtype).replace("torch.", "")


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that shares no memory with it."""
    t = t.detach()
    host = t.cpu() if t.device.type != "cpu" else t.clone()
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(np.dtype("V2"))
    return host.numpy()


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    """A leaf as read from the file (``V2`` or numpy's bfloat16 for a
    ``"bfloat16"`` leaf) as a CPU tensor of ``dtype``."""
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's index, as ``jax.process_index()`` gives it: the
    default group's rank when one is up, else 0."""
    return dist.get_rank() if _group_up() else 0


def process_count() -> int:
    """The number of processes, as ``jax.process_count()`` gives it."""
    return dist.get_world_size() if _group_up() else 1


class CheckpointManager:
    """Checkpoints of a tree of tensors under ``directory``, the last
    ``keep`` kept.  ``timings`` lists, a save each, its step, the snapshot's
    seconds, the write's seconds (``None`` while the write runs) and the
    bytes of this process's file."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.process = process_index()
        self.timings: List[dict] = []

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        """Snapshot every leaf to host memory, then write (on a background
        thread unless ``blocking``).  Waits for the previous write first."""
        self.wait()
        t0 = time.perf_counter()
        named = _flatten(tree)
        host = [_to_host(leaf) for _, leaf in named]
        meta = {
            "step": step,
            "names": [n for n, _ in named],
            "shapes": [list(a.shape) for a in host],
            "dtypes": [_dtype_name(leaf.dtype) for _, leaf in named],
            "n_processes": process_count(),
            "time": time.time(),
        }
        record = {"step": step, "snapshot_s": time.perf_counter() - t0, "write_s": None,
                  "bytes": sum(a.nbytes for a in host)}
        self.timings.append(record)

        def write():
            t1 = time.perf_counter()
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            data = os.path.join(tmp, f"proc_{self.process}.npz")
            np.savez(data, **{str(i): a for i, a in enumerate(host)})
            _fsync(data)
            if self.process == 0:
                manifest = os.path.join(tmp, "manifest.json")
                with open(manifest, "w") as f:
                    json.dump(meta, f)
                _fsync(manifest)
            _fsync(tmp)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            _fsync(self.dir)
            self._gc()
            record["write_s"] = time.perf_counter() - t1

        if blocking:
            write()
            return

        def run():
            try:
                write()
            except Exception as e:  # handed to the caller by wait()
                self._error = e

        self._thread = threading.Thread(target=run, name=f"checkpoint-writer-{step}",
                                        daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Wait for the background write; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"checkpoint write under {self.dir} failed") from err

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_tree: Any, device=None) -> Tuple[Any, int]:
        """The checkpoint of ``step`` in the structure of ``target_tree``
        (whose leaves give the names, shapes and dtypes expected), each leaf
        a tensor on ``device`` (default the CPU).  Returns (tree, step)."""
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            meta = json.load(f)
        want = {n: leaf for n, leaf in _flatten(target_tree)}
        names = meta["names"]
        missing = [n for n in want if n not in names]
        extra = [n for n in names if n not in want]
        if missing or extra:
            raise ValueError(f"checkpoint {path} does not match the target tree: leaves "
                             f"missing {missing[:5]}, extra {extra[:5]}")
        for n, shape, dtype in zip(names, meta["shapes"], meta["dtypes"]):
            leaf = want[n]
            if list(leaf.shape) != shape or _dtype_name(leaf.dtype) != dtype:
                raise ValueError(f"checkpoint leaf {n!r} is {dtype}{shape}, the target's "
                                 f"{_dtype_name(leaf.dtype)}{list(leaf.shape)}")
        data = os.path.join(path, f"proc_{self.process}.npz")

        def read(i):          # a file handle a thread: the leaves are read at once
            with np.load(data) as npz:
                return npz[str(i)]

        leaves = {}
        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
            for n, shape, dtype, a in zip(names, meta["shapes"], meta["dtypes"],
                                          pool.map(read, range(len(names)))):
                if list(a.shape) != shape:
                    raise ValueError(f"checkpoint leaf {n!r}: the file holds {list(a.shape)}, "
                                     f"the manifest says {shape}")
                leaves[n] = _from_host(a, dtype).to(device or "cpu")
        return _unflatten(target_tree, leaves), meta["step"]
