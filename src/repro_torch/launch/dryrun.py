"""Multi-pod dry run: trace every (arch × shape × mesh) cell on fake devices.

Counterpart of ``repro/launch/dryrun.py``.  It proves the distribution
config is coherent without the hardware: each cell's step runs once over a
256- or 512-device DeviceMesh on a fake process group held by this one
process (:func:`repro_torch.launch.mesh.fake_group`), every tensor a
``FakeTensorMode`` tensor, so nothing is allocated and no collective moves
a byte.  That is the tool's nature, as the JAX dry run's 512 fake XLA host
devices are: it is a CPU tool, and never runs on the card.

How a cell runs:

* the model is built under ``FakeTensorMode`` (as
  :func:`repro_torch.launch.shapes.cache_shape_for` builds it); every
  parameter, optimizer, batch and cache leaf becomes a DTensor laid out by
  its spec (:mod:`repro_torch.parallel.sharding`), its local shard a fake
  tensor of one device's share;
* the step runs under ``logical_rules(rules_for(cfg, multi_pod))`` and
  ``implicit_replication()``: a train step
  (:func:`repro_torch.train.step.make_train_step` with
  ``microbatch_policy``'s count, bf16 accumulation for bf16 masters, the
  gradients laid out as their parameters), a prefill or a decode step at
  position ``seq - 1`` (the full cache, as the JAX step's masked attention
  reads it).  Parameters are gathered over their fsdp axes at use; the
  per-head and per-sequence cores run on each device's shards
  (:func:`repro_torch.parallel.api.local_call`);
* the sig cells run the paper's Gram on each device's (rows, columns) tile
  (the JAX cell's ``shard_map``), or the exact-gradient MMD through it;
  each Goursat solve is one ``torch.library`` op whose fake implementation
  gives its output's shape, so every row block is traced (a device's flops
  are its pairwise products exactly, ``tests/test_torch_dryrun.py``).
  Every loop is traced step by step.

The record keeps the JAX field names where a field has a counterpart:

* ``compile_s``: the seconds to trace the step;
* ``flops``: one device's flops as ``FlopCounterMode`` counts them (its
  formulas: matmuls, convolutions, attention; no elementwise work, which
  XLA's ``cost_analysis`` flops include), and ``hlo_dot_flops`` the
  matmuls' share of it (``mm``, ``addmm``, ``bmm``, ``baddbmm``).
  ``FlopCounterMode`` over DTensors counts the global op, so
  :class:`DeviceFlops` counts a device's share: an op on local tensors
  (inside a device's own program) by its own shapes, and an op on DTensors
  by the global count divided by the number of devices its output's
  placements split the work over (a shard or a partial sum on a mesh axis;
  a replicated axis repeats the work on every device);
* ``argument_bytes`` / ``output_bytes``: the bytes of one device's shards
  of the step's arguments (the parameters the step takes, the optimizer
  state, the batch, the caches) and of its outputs; ``alias_bytes`` the
  outputs written in place of arguments (the parameters and the optimizer
  state of a train step, the caches of a decode step), as the JAX step
  donates them;
* ``collectives``: by kind (XLA's names), each ``count``, ``out_bytes`` and
  ``traffic``, the bytes a device sends on its links by the JAX analysis'
  ring estimates, counted by :class:`Collectives`, a ``CommDebugMode``;
* ``num_microbatches`` and ``batch_shard`` for train cells.

``temp_bytes``, ``peak_bytes_per_device`` and ``generated_code_bytes``
come from XLA's ``memory_analysis``, ``hlo_bytes`` from its
``cost_analysis``: they have no counterpart and are ``null``.  A cell the
port cannot run is recorded as the JAX dry run records one (``"error"``),
with the op and the port's ``file:line`` where it failed, and the sweep
carries on.

Usage (CPU only)::

    python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k [--multipod]
    python -m repro_torch.launch.dryrun --all --out dryrun_results.json
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import sys
import time
import traceback
from typing import Dict, Optional, Tuple

import torch

from ..models import build_model, get_config
from ..models.params import tree_map
from ..parallel import sharding as SH
from ..parallel.api import local_call, logical_rules
from . import shapes as SHP
from .mesh import fake_group

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
DOT_OPS = ("mm", "addmm", "bmm", "baddbmm")
NULL_FIELDS = ("hlo_bytes", "peak_bytes_per_device", "temp_bytes", "generated_code_bytes")


def mesh_layout(multi_pod: bool) -> Tuple[Tuple[int, ...], Tuple[str, ...], str]:
    """(shape, axes, name) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model"), "2x16x16"
    return (16, 16), ("data", "model"), "16x16"


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

def _device_modes():
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    from torch.utils.flop_counter import flop_registry

    aten = torch.ops.aten
    skip = {aten.sym_is_contiguous.default, aten.is_contiguous.default,
            aten.is_contiguous.memory_format, aten.is_strides_like_format.default,
            aten.is_non_overlapping_and_dense.default, aten.size.default,
            aten.sym_size.default, aten.stride.default, aten.sym_stride.default,
            aten.storage_offset.default, aten.sym_storage_offset.default,
            aten.numel.default, aten.sym_numel.default, aten.dim.default,
            torch.ops.prim.layout.default}

    class DeviceFlops(TorchDispatchMode):
        """One device's flops: ``FlopCounterMode``'s formulas (and its
        decompositions), an op on DTensors divided by the devices its
        output's placements split it over."""

        def __init__(self):
            super().__init__()
            self.flops = 0
            self.dot_flops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func in skip:
                return NotImplemented
            if isinstance(func, torch._ops.HigherOrderOperator):
                return func(*args, **kwargs)
            packet = func._overloadpacket
            if packet not in flop_registry and func is not torch.ops.prim.device.default:
                with self:
                    r = func.decompose(*args, **kwargs)
                    if r is not NotImplemented:
                        return r
            out = func(*args, **kwargs)
            if packet in flop_registry:
                n = flop_registry[packet](*args, **kwargs, out_val=out)
                dt = next((t for t in tree_flatten(out)[0] if isinstance(t, DTensor)), None)
                if dt is not None:
                    split = math.prod(dt.device_mesh.size(i) for i, p in enumerate(dt.placements)
                                      if p.is_shard() or p.is_partial())
                    n = n // split if n % split == 0 else n / split
                self.flops += n
                if packet.__name__ in DOT_OPS:
                    self.dot_flops += n
            return out

    class Collectives(CommDebugMode):
        """``CommDebugMode`` that also sums each collective's result bytes
        and link traffic by kind (ring estimates, result R bytes, group of
        n: all-gather R(n-1)/n, reduce-scatter R(n-1), all-reduce
        2R(n-1)/n, all-to-all R(n-1)/n)."""

        def __init__(self):
            super().__init__()
            self.stats = {c: {"count": 0, "out_bytes": 0.0, "traffic": 0.0} for c in KINDS}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is NotImplemented or isinstance(func, torch._ops.HigherOrderOperator):
                return out
            ns, name = func.namespace, func._overloadpacket.__name__
            kind = next((k for k, key in (("all-gather", "all_gather"),
                                          ("reduce-scatter", "reduce_scatter"),
                                          ("all-reduce", "all_reduce"),
                                          ("all-to-all", "all_to_all")) if key in name), None)
            if kind is None or "c10d" not in ns:
                return out
            from torch.distributed.distributed_c10d import _resolve_process_group
            group = [a for a in list(args) + list((kwargs or {}).values()) if isinstance(a, str)]
            n = _resolve_process_group(group[-1]).size()
            R = sum(t.numel() * t.element_size() for t in tree_flatten(out)[0]
                    if isinstance(t, torch.Tensor))
            factor = {"all-gather": (n - 1) / n, "reduce-scatter": n - 1,
                      "all-reduce": 2 * (n - 1) / n, "all-to-all": (n - 1) / n}[kind]
            st = self.stats[kind]
            st["count"] += 1
            st["out_bytes"] += float(R)
            st["traffic"] += float(R * factor)
            return out

    return DeviceFlops, Collectives


def local_bytes(tree) -> int:
    """Bytes of one device's shards of the tensors in ``tree`` (nested
    dicts, lists, tuples); a plain tensor counts whole, a non-tensor 0."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    if isinstance(tree, DTensor):
        t = tree._local_tensor
        return t.numel() * t.element_size()
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def _zeros_like_meta(tree):
    """A tree of meta tensors as zeros of their shapes and dtypes on the CPU
    (fake tensors under the caller's ``FakeTensorMode``)."""
    return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype), tree)


def _where(exc: BaseException) -> Dict[str, str]:
    """The op a failure names and the innermost frame of the port it came
    from, as ``src/repro_torch/...py:line``."""
    msg = str(exc)
    m = re.search(r"aten\.[\w.]+", msg)
    op = m.group(0) if m else f"{type(exc).__name__}: {msg.splitlines()[0] if msg else ''}"
    where = ""
    for fr in traceback.extract_tb(exc.__traceback__):
        # the innermost frame of the port's own code, not of this module's counters
        if (f"{os.sep}repro_torch{os.sep}" in fr.filename
                and not fr.filename.endswith(os.path.join("launch", "dryrun.py"))):
            path = fr.filename[fr.filename.index(f"{os.sep}repro_torch{os.sep}") + 1:]
            where = f"src/{path}:{fr.lineno}"
    return {"op": op[:300], "where": where}


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def _lm_step(cfg, shape, mesh, multi_pod: bool, rules, fake, alloc, device):
    """(step, args, donated, meta) of a model cell: ``step()`` runs it.
    Global shapes are built under ``fake``; the local shards are allocated
    under ``alloc`` on ``device`` (``fake`` itself in the dry run)."""
    from ..optim.adamw import AdamW, cosine_schedule
    from ..serve.step import compute_params, make_decode_step, make_prefill_step
    from ..train.step import apply_param_dtype, make_train_step

    def place(tree, specs):
        with alloc:
            return SH.distribute_zeros(tree, specs, mesh, device=device)

    with fake:
        model = build_model(cfg, device="cpu")
        tree = model.tree()
        if shape.kind == "train":
            tree = apply_param_dtype(tree, cfg)
    p_specs = SH.param_shardings(tree, cfg, mesh, multi_pod)
    dmodel = type(model)(cfg, place(tree, p_specs))
    del model, tree

    def place_batch(spec_tree):
        with fake:
            b = _zeros_like_meta(spec_tree)
        return place(b, SH.batch_shardings(b, cfg, mesh, multi_pod))

    if shape.kind == "train":
        opt = AdamW(list(dmodel.parameters()), lr=cosine_schedule(3e-4, 100, 10000),
                    moment_dtype=cfg.moment_dtype)
        mdt = getattr(torch, cfg.moment_dtype)
        with fake:
            zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=mdt), dmodel.tree())
        state = {"m": zeros, "v": zeros}
        dstate = place(state, SH.param_shardings(state, cfg, mesh, multi_pod))
        with alloc:
            opt.load_state_tree(dmodel.tree(), dict(dstate, count=0))
        batch = place_batch(SHP.train_input_specs(cfg, shape))
        bspec = SH.physical_spec(("batch",), (shape.batch,), mesh, rules)
        axes = () if bspec[0] is None else (
            (bspec[0],) if isinstance(bspec[0], str) else tuple(bspec[0]))
        bshard = math.prod(SH.mesh_shape(mesh)[a] for a in axes)
        n_mb = SHP.microbatch_policy(cfg, shape.batch, bshard)
        accum = "bfloat16" if cfg.param_dtype == "bfloat16" else "float32"
        step_fn = make_train_step(dmodel, opt, num_microbatches=n_mb, param_pspecs=p_specs,
                                  accum_dtype=accum)
        live = {"params": dmodel.tree(),
                "opt": [opt.state[p] for p in dmodel.parameters()]}
        return ((lambda: step_fn(batch)), (live, batch), live,
                {"num_microbatches": n_mb, "batch_shard": bshard})

    with alloc:
        compute = compute_params(dmodel)
    with fake:
        caches = _zeros_like_meta(SHP.cache_shape_for(cfg, shape))
    caches = place(caches, SH.cache_shardings(caches, cfg, mesh, multi_pod))
    if shape.kind == "prefill":   # the caches it fills are outputs, laid out here
        batch = place_batch(SHP.prefill_input_specs(cfg, shape))
        step_fn = make_prefill_step(dmodel, params=compute)
        return (lambda: step_fn(batch, caches)), (compute, batch), None, {}

    tokens = place_batch({"tokens": SHP.decode_input_specs(cfg, shape, None)["tokens"]})
    step_fn = make_decode_step(dmodel, params=compute)
    return ((lambda: step_fn(caches, tokens["tokens"], shape.seq - 1)),
            (compute, caches, tokens), caches, {})


def _sig_step(shape, mesh, multi_pod: bool, alloc, device):
    """The paper's own cells: the forward Gram on each device's (rows of X,
    rows of Y) tile, or the exact-gradient MMD through the reference
    Gram."""
    from torch.distributed.tensor import Replicate

    from ..configs.sigkernel_workload import GRAM_ENGINE_DEFAULTS
    from ..core.gram import sigkernel_gram
    L, B, d = shape.seq, shape.batch, 8
    rules = SH.rules_for(None, multi_pod)
    specs = {"X": SH.physical_spec(("batch",), (B,), mesh, rules),
             "Y": SH.physical_spec(("model",), (B,), mesh, rules)}
    with alloc:
        xy = SH.distribute_zeros({"X": torch.empty((B, L, d), device="meta"),
                                  "Y": torch.empty((B, L, d), device="meta")},
                                 specs, mesh, device=device)
    X, Y = xy["X"], xy["Y"]
    rows, cols, tile = ("batch", None, None), ("model", None, None), ("batch", "model")

    if shape.kind == "sig_fwd":
        def step():
            return local_call(lambda x, y: sigkernel_gram(x, y, **GRAM_ENGINE_DEFAULTS),
                              (X, Y), (rows, cols), (tile,), ((B, B),))
        return step, (X, Y), None, {}

    def step():
        Xr = X.detach().requires_grad_()
        K = local_call(lambda x, y: sigkernel_gram(x, y, backend="reference"), (Xr, Y),
                       (rows, cols), (tile,), ((B, B),))
        loss = K.mean()
        g, = torch.autograd.grad(loss, Xr)
        return (loss.redistribute(X.device_mesh, [Replicate()] * X.device_mesh.ndim),
                g.redistribute(X.device_mesh, X.placements))
    return step, (X, Y), None, {}


def run_cell(cfg, shape: SHP.ShapePreset, mesh_shape: Tuple[int, ...],
             axes: Tuple[str, ...], *, arch: Optional[str] = None,
             mesh_name: Optional[str] = None, device: str = "cpu",
             repeats: int = 0) -> Dict:
    """One cell's record: ``cfg``'s step at ``shape`` over a fake mesh of
    ``mesh_shape`` devices named ``axes``, as this process's rank 0.

    ``device="cuda"`` runs rank 0's share for real on the card instead: its
    shards are zeros there, its collectives the fake group's (they move
    nothing), so the counts are the dry run's and the step's time is one
    device's compute.  ``repeats`` steps timed with CUDA events follow the
    counted one; their milliseconds come back as ``"ms"``, the local cache
    bytes as ``"cache_bytes"``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    multi_pod = "pod" in axes
    n = math.prod(mesh_shape)
    real = device != "cpu"
    DeviceFlops, Collectives = _device_modes()
    with fake_group(n):
        mesh = init_device_mesh(device, mesh_shape, mesh_dim_names=axes)
        rules = SH.rules_for(None if cfg.family == "sigkernel" else cfg, multi_pod)
        fake = FakeTensorMode()
        alloc = contextlib.nullcontext() if real else fake
        if cfg.family == "sigkernel":
            step, args, donated, meta = _sig_step(shape, mesh, multi_pod, alloc, device)
        else:
            step, args, donated, meta = _lm_step(cfg, shape, mesh, multi_pod, rules, fake,
                                                 alloc, device)
        arg_bytes = local_bytes(args)
        comm, flops = Collectives(), DeviceFlops()
        with alloc:
            t0 = time.perf_counter()
            with logical_rules(rules), implicit_replication(), comm, flops:
                out = step()
            t1 = time.perf_counter()
            alias = local_bytes(donated)
            out_bytes = local_bytes(out) + alias if shape.kind == "train" else local_bytes(out)
        timed = []
        if real:
            del out
            for _ in range(repeats):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                torch.cuda.synchronize()
                with logical_rules(rules), implicit_replication():
                    start.record()
                    step()
                    end.record()
                torch.cuda.synchronize()
                timed.append(start.elapsed_time(end))
    record = {"arch": arch or cfg.name, "shape": shape.name,
              "mesh": mesh_name or "x".join(map(str, mesh_shape)),
              "compile_s": round(t1 - t0, 1),
              "flops": float(flops.flops), "hlo_dot_flops": float(flops.dot_flops),
              "argument_bytes": int(arg_bytes), "output_bytes": int(out_bytes),
              "alias_bytes": int(alias), "collectives": comm.stats,
              "comm_debug_total": comm.get_total_counts(), "n_chips": n,
              **{k: None for k in NULL_FIELDS}, **meta}
    if real:
        record.update(device=device, ms=timed,
                      cache_bytes=int(alias) if shape.kind == "decode" else None)
    return record


def build_cell(arch: str, shape_name: str, multi_pod: bool):
    """(runner, None), or (None, the skip reason), as the JAX function."""
    cfg = get_config(arch)
    shape = SHP.SHAPES.get(shape_name) or SHP.SIG_SHAPES[shape_name]
    skip = SHP.cell_supported(cfg, shape)
    if skip:
        return None, skip
    mesh_shape, axes, name = mesh_layout(multi_pod)
    return (lambda: run_cell(cfg, shape, mesh_shape, axes, arch=arch, mesh_name=name)), None


def cells(all_cells: bool, arch=None, shape=None, multi_pod=False):
    """The sweep's (arch, shape, multi_pod) cells, in the JAX dry run's order."""
    from ..configs import ASSIGNED
    if not all_cells:
        return [(arch, shape, multi_pod)]
    out = [(a, s, mp) for a in ASSIGNED for s in SHP.SHAPES for mp in (False, True)]
    out += [("sigkernel-workload", s, mp) for s in SHP.SIG_SHAPES for mp in (False, True)]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    results = []
    if args.out and os.path.exists(args.out):  # resume partial sweeps
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results}

    def flush():
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)

    t_all = time.perf_counter()
    for arch, shape, mp in cells(args.all, args.arch, args.shape, args.multipod):
        mesh_name = mesh_layout(mp)[2]
        if (arch, shape, mesh_name) in done:
            continue
        tag = f"{arch} x {shape} x {mesh_name}"
        try:
            run, skip = build_cell(arch, shape, mp)
            if skip:
                print(f"SKIP {tag}: {skip}", flush=True)
                results.append({"arch": arch, "shape": shape, "mesh": mesh_name,
                                "skipped": skip})
                flush()
                continue
            print(f"RUN  {tag} ...", flush=True)
            t0 = time.perf_counter()
            res = run()
            gb = 1 << 30
            print(f"  ok in {time.perf_counter() - t0:.1f}s (trace {res['compile_s']}s)  "
                  f"dot_flops={res['hlo_dot_flops']:.3e}  "
                  f"args/device={res['argument_bytes'] / gb:.2f}GiB  "
                  f"coll={sum(c['traffic'] for c in res['collectives'].values()) / gb:.3f}GiB",
                  flush=True)
            results.append(res)
        except Exception as e:  # record failures, keep sweeping
            where = _where(e)
            print(f"FAIL {tag}: {where['op']} at {where['where']}", flush=True)
            traceback.print_exc()
            results.append({"arch": arch, "shape": shape, "mesh": mesh_name,
                            "error": str(e)[:2000], **where})
        flush()

    print(f"sweep: {len(results)} entries in {time.perf_counter() - t_all:.1f}s", flush=True)
    if args.out:
        print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
