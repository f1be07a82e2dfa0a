"""Build a CUDA source of the port into a shared library with ``nvcc``.

Each kernel library is compiled at first use for ``sm_90a`` into a
directory keyed by a hash of its source and flags, under the git-ignored
``build/`` beside its module, and loaded with ``ctypes``.  The compiler's
output (``-Xptxas -v``: registers, shared memory and spills per kernel) is
kept in ``nvcc.log`` beside the library.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc(src: Path) -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            f"nvcc not found (PATH or /usr/local/cuda/bin): the kernels are "
            f"built from {src.name} at first use")
    return found


def library_path(src: Path, name: str) -> Path:
    """Where the library built from ``src`` lives: keyed by source and flags."""
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return src.parent.parent / "build" / key.hexdigest()[:16] / f"lib{name}.so"


def build(src: Path, name: str) -> Path:
    """Compile ``src`` unless this source was already built; return the
    library path."""
    path = library_path(src, name)
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [nvcc(src), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    (path.parent / "nvcc.log").write_text(done.stdout + done.stderr)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name} ({done.returncode}):\n{done.stderr}")
    os.replace(tmp, path)
    return path
