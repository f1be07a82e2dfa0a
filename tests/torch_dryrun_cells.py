"""The port's side of ``tests/test_torch_dryrun.py``, run as a subprocess
(the dry run holds a fake process group; none may outlive its process).

``python tests/torch_dryrun_cells.py host`` prints, for reduced configs at
the 1 x 1 host mesh, each dry-run record beside the bytes of the real
step's tensors and ``FlopCounterMode``'s count of the real (plain) step on
the CPU.  ``python tests/torch_dryrun_cells.py mesh`` prints the records of
the 2 x 2 cells that the JAX side (``tests/torch_dryrun_jax_cells.py``)
compiles, and ``trips`` a small sig Gram cell's record (its two row
blocks traced whole).  One JSON object on the last line.  Imports no JAX.
"""

from __future__ import annotations

import json
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.launch import dryrun as D
from repro_torch.launch.shapes import ShapePreset, microbatch_policy
from repro_torch.models import build_model, get_config
from repro_torch.models.params import tree_map

#: (arch, kind, seq, batch) of the cells both sides trace
MESH_CELLS = [("deepseek-7b", "decode", 64, 8), ("deepseek-7b", "prefill", 64, 4),
              ("mamba2-780m", "decode", 64, 8), ("qwen2-moe-a2.7b", "decode", 64, 8)]
HOST_CELLS = [("deepseek-7b", "decode", 32, 2), ("mamba2-780m", "decode", 32, 2),
              ("qwen2-moe-a2.7b", "decode", 32, 2), ("recurrentgemma-2b", "decode", 32, 2),
              ("deepseek-7b", "prefill", 32, 2), ("deepseek-7b", "train", 32, 4)]


def _bytes(tree) -> int:
    return D.local_bytes(tree)


def real_step(arch: str, kind: str, seq: int, batch: int):
    """(argument bytes, flops) of the plain step on real CPU tensors."""
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.serve.step import compute_params, make_decode_step, make_prefill_step
    from repro_torch.train.step import make_train_step
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    tokens = torch.zeros((batch, seq if kind != "decode" else 1), dtype=torch.int64)
    with FlopCounterMode(display=False) as fc:
        if kind == "decode":
            compute = compute_params(model)
            caches = model.cache_init(batch, seq)
            args = (compute, caches, tokens)
            make_decode_step(model, params=compute)(caches, tokens, seq - 1)
        elif kind == "prefill":
            compute = compute_params(model)
            args = (compute, {"tokens": tokens})
            make_prefill_step(model, params=compute)({"tokens": tokens})
        else:
            opt = AdamW(list(model.parameters()), lr=cosine_schedule(3e-4, 100, 10000),
                        moment_dtype=cfg.moment_dtype)
            zeros = tree_map(lambda p: torch.zeros_like(p, dtype=opt.moment_dtype),
                             model.tree())
            batch_ = {"tokens": tokens, "labels": tokens}
            args = (model.tree(), {"m": zeros, "v": zeros}, batch_)
            n_mb = microbatch_policy(cfg, batch, 1)
            make_train_step(model, opt, num_microbatches=n_mb)(batch_)
    return _bytes(args), fc.get_total_flops()


def main(mode: str):
    out = {}
    if mode == "host":
        for arch, kind, seq, batch in HOST_CELLS:
            cfg = get_config(arch).reduced()
            rec = D.run_cell(cfg, ShapePreset(f"{kind}_{seq}", kind, seq, batch), (1, 1),
                             ("data", "model"), arch=arch)
            arg, flops = real_step(arch, kind, seq, batch)
            out[f"{arch}/{kind}"] = {"record": rec, "real_argument_bytes": arg,
                                     "real_flops": flops}
    elif mode == "mesh":
        for arch, kind, seq, batch in MESH_CELLS:
            cfg = get_config(arch).reduced()
            out[f"{arch}/{kind}"] = D.run_cell(cfg, ShapePreset(f"{kind}_{seq}", kind, seq, batch),
                                               (2, 2), ("data", "model"), arch=arch)
    elif mode == "trips":
        out["sig_fwd"] = D.run_cell(get_config("sigkernel-workload"),
                                    ShapePreset("sig_small", "sig_fwd", 16, 8), (2, 2),
                                    ("data", "model"))
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1])
