"""The JAX side of ``tests/test_torch_dryrun.py``: the JAX package's step for
each cell of ``tests/torch_dryrun_cells.py``'s ``MESH_CELLS``, laid out by
its own ``param_shardings`` / ``batch_shardings`` / ``cache_shardings`` over
``jax.make_mesh((2, 2), ("data", "model"))``, compiled and read with
``cost_analysis()`` and ``repro.launch.hlo_analysis.analyze``, as the JAX dry
run's runner reads a cell (its ``build_cell`` fixes the 16 x 16 meshes).

Run it in a process whose ``XLA_FLAGS`` give 4 host devices
(``repro.launch.mesh.simulated_mesh_env(4)``); it prints one JSON object.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp

from repro.launch import shapes as SHP
from repro.launch.hlo_analysis import analyze
from repro.models import build_model, get_config
from repro.parallel import sharding as SH
from repro.parallel.api import logical_rules
from repro.serve.step import make_decode_step, make_prefill_step
from torch_dryrun_cells import MESH_CELLS


def cell(arch: str, kind: str, seq: int, batch: int):
    cfg = get_config(arch).reduced()
    shape = SHP.ShapePreset(f"{kind}_{seq}", kind, seq, batch)
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    rules = SH.rules_for(cfg, False)
    model = build_model(cfg)
    params = jax.eval_shape(model.init, jax.ShapeDtypeStruct((2,), jnp.uint32))
    p_shard = SH.param_shardings(params, cfg, mesh, False)
    if kind == "prefill":
        step = make_prefill_step(model)
        batch_spec = SHP.prefill_input_specs(cfg, shape)
        b_shard = SH.batch_shardings(batch_spec, cfg, mesh, False)
        cache = jax.eval_shape(lambda p, b: step(p, b)[1], params, batch_spec)
        c_shard = SH.cache_shardings(cache, cfg, mesh, False)
        jitted = jax.jit(step, in_shardings=(p_shard, b_shard), out_shardings=(None, c_shard))
        args = (params, batch_spec)
    else:
        step = make_decode_step(model)
        cache = SHP.cache_shape_for(model, cfg, shape)
        c_shard = SH.cache_shardings(cache, cfg, mesh, False)
        spec = SHP.decode_input_specs(cfg, shape, cache)
        tok = SH.batch_shardings({"tokens": spec["tokens"]}, cfg, mesh, False)["tokens"]
        jitted = jax.jit(step, in_shardings=(p_shard, c_shard, tok, SH.replicated(mesh)),
                         out_shardings=(tok, None, c_shard), donate_argnums=(1,))
        args = (params, cache, spec["tokens"], spec["cur_len"])
    with mesh, logical_rules(rules):
        compiled = jitted.lower(*args).compile()
    cost = compiled.cost_analysis()
    if isinstance(cost, list):
        cost = cost[0] if cost else {}
    mem = compiled.memory_analysis()
    hlo = analyze(compiled.as_text())
    return {"flops": float(cost.get("flops", -1)), "hlo_dot_flops": float(hlo.flops),
            "argument_bytes": int(mem.argument_size_in_bytes),
            "collectives": hlo.collective}


def main():
    out = {}
    for arch, kind, seq, batch in MESH_CELLS:
        try:
            out[f"{arch}/{kind}"] = cell(arch, kind, seq, batch)
        except Exception as e:  # a cell JAX cannot compile is reported, not hidden
            out[f"{arch}/{kind}"] = {"error": f"{type(e).__name__}: {e}"[:500]}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
