"""The ranks' side of ``tests/test_torch_mesh_values.py``: each family's
reduced model run on a real gloo mesh, its parameters, optimizer state,
batches and caches DTensors laid out by the sharding rules, its steps
under ``logical_rules`` (the path the dry run traces, here on real values).

Each rank of a ``repro_torch.launch.spawn_ranks`` group imports this module
by name, so it imports torch, numpy and the port only.  A case is a plain
dict of the arch, the parameters (a state dict) and the numpy inputs;
rank 0 returns every output gathered whole (``full_tensor``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.launch.shapes import ShapePreset, cache_shape_for
from repro_torch.models import build_model, get_config
from repro_torch.models.params import tree_items, tree_map
from repro_torch.optim.adamw import AdamW
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.api import logical_rules
from repro_torch.train.step import make_train_step



def lr(step: int) -> float:
    """The AdamW learning rate of both sides' train steps."""
    return 1e-3


def whole(t):
    """A DTensor gathered whole, as a detached CPU tensor."""
    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().clone()


def flat(tree) -> dict:
    return {name: whole(t) for name, t in tree_items(tree)}


def case_model(case):
    """The case's model on the CPU, with its parameters."""
    cfg = get_config(case["arch"]).reduced().replace(**case.get("replace", {}))
    model = build_model(cfg, device="cpu")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in case["state"].items()})
    return model


def tensors(d) -> dict:
    return {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v for k, v in d.items()}


def run_case(case, mesh) -> dict:
    """Loss, metrics and gradients; prefill logits and caches; each decode
    step's logits and the caches after the last; the parameters after one
    train step of ``case["n_mb"]`` microbatches: all on ``mesh``."""
    model = case_model(case)
    cfg = model.cfg
    rules = SH.rules_for(cfg, "pod" in mesh.mesh_dim_names)
    mp = "pod" in mesh.mesh_dim_names

    def place_batch(b):
        b = tensors(b)
        arrays = {k: v for k, v in b.items() if torch.is_tensor(v)}
        out = SH.distribute(arrays, SH.batch_shardings(arrays, cfg, mesh, mp), mesh)
        return dict(b, **out)

    tree = model.tree()
    specs = SH.param_shardings(tree, cfg, mesh, mp)
    dmodel = type(model)(cfg, SH.distribute(tree, specs, mesh))
    out = {}
    with logical_rules(rules), implicit_replication():
        compute = tree_map(lambda t: t.detach().requires_grad_(), dmodel.tree())
        leaves = [t for _, t in tree_items(compute)]
        loss, metrics = dmodel.loss(place_batch(case["train"]), params=compute)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        out["loss"] = whole(loss)
        out["metrics"] = {k: whole(v) for k, v in metrics.items()}
        out["grads"] = {name: whole(g) for (name, _), g in zip(tree_items(compute), grads)}

        prompt = case["prompt"]
        B, S = prompt["tokens"].shape
        meta = cache_shape_for(cfg, ShapePreset("p", "decode", case["max_len"], B))
        caches = SH.distribute(model.cache_init(B, case["max_len"]),
                               SH.cache_shardings(meta, cfg, mesh, mp), mesh)
        logits, caches = dmodel.prefill(place_batch(dict(prompt, max_len=case["max_len"])),
                                        caches=caches)
        out["prefill_logits"] = whole(logits)
        out["prefill_caches"] = flat(caches)
        out["decode_logits"] = []
        for i, tok in enumerate(case["decode"].T):
            toks = place_batch({"tokens": tok[:, None]})["tokens"]
            logits, caches = dmodel.decode(caches, toks, S + i)
            out["decode_logits"].append(whole(logits))
        out["decode_caches"] = flat(caches)

        opt = AdamW(list(dmodel.parameters()), lr=lr)
        step = make_train_step(dmodel, opt, num_microbatches=case["n_mb"], param_pspecs=specs)
        out["step_loss"] = whole(step(place_batch(case["train"]))["loss"])
        out["stepped"] = flat(dmodel.tree())
    return out


def mesh_rank(rank, world, cases, mesh_shape) -> dict:
    """Every case on a ``mesh_shape`` mesh over ("data", "model"); rank 0's
    result holds the outputs, the others' ``None``."""
    torch.set_num_threads(1)
    mesh = init_device_mesh("cpu", tuple(mesh_shape), mesh_dim_names=("data", "model"))
    out = {name: run_case(case, mesh) for name, case in cases.items()}
    return out if rank == 0 else None


def plain_outputs(case) -> dict:
    """:func:`run_case`'s outputs from the plain path on one device."""
    model = case_model(case)
    out = {}
    compute = tree_map(lambda t: t.detach().requires_grad_(), model.tree())
    leaves = [t for _, t in tree_items(compute)]
    loss, metrics = model.loss(tensors(case["train"]), params=compute)
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    out["loss"] = loss.detach()
    out["metrics"] = {k: v.detach() for k, v in metrics.items()}
    out["grads"] = {name: g for (name, _), g in zip(tree_items(compute), grads)}
    prompt = case["prompt"]
    S = prompt["tokens"].shape[1]
    logits, caches = model.prefill(tensors(dict(prompt, max_len=case["max_len"])))
    out["prefill_logits"] = logits
    out["prefill_caches"] = flat(caches)
    out["decode_logits"] = []
    for i, tok in enumerate(case["decode"].T):
        logits, caches = model.decode(caches, torch.as_tensor(tok[:, None]), S + i)
        out["decode_logits"].append(logits)
    out["decode_caches"] = flat(caches)
    opt = AdamW(list(model.parameters()), lr=lr)
    step = make_train_step(model, opt, num_microbatches=case["n_mb"])
    out["step_loss"] = step(tensors(case["train"]))["loss"].detach()
    out["stepped"] = flat(model.tree())
    return out
