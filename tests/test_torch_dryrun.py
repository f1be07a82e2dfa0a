"""The port's multi-pod dry run (``repro_torch.launch.dryrun``) held to the
JAX package's.

* The cell list and its skip reasons equal the JAX dry run's ``--all``
  list (84 cells, 16 skipped), built here from ``repro.launch.shapes`` and
  ``repro.configs.ASSIGNED`` as its ``main`` builds it (importing
  ``repro.launch.dryrun`` would set ``XLA_FLAGS`` for this process).
* At the 1 x 1 host mesh a record's ``argument_bytes`` and ``flops`` equal
  the bytes of the real step's tensors and ``FlopCounterMode``'s count of
  the real step on the CPU, to the unit (reduced configs, subprocess).
* At a 2 x 2 mesh a record is held to the JAX package's own step for the
  same cell, laid out by its own sharding rules and compiled over four
  simulated host devices (``tests/torch_dryrun_jax_cells.py``):
  - ``hlo_dot_flops`` equal JAX's (``hlo_analysis``) to the unit for the
    dense and SSM cells.  The MoE decode cell's exceed them: its eight
    tokens form one group, which does not split over the data axis, so
    every data rank runs the group's dispatch, expert and combine products
    whole, where XLA splits their d_model dim over the idle data axis.
    Held to within 30% and above JAX's;
  - ``flops`` (matmuls only) at most XLA's ``cost_analysis`` flops, which
    add the elementwise work, for those same dense and SSM cells;
  - ``argument_bytes`` equal JAX's but for the tokens (int64 in the port,
    int32 in JAX) and JAX's int32 ``cur_len`` (a Python int in the port;
    XLA drops it from the SSM decode, which does not read it).
* A sig Gram's row blocks, each solve one op, traced whole give a device's
  pairwise products exactly (2 x 2 mesh, 8 paths of 16 points in d = 8: a
  4 x 4 tile in 2 row blocks, 2·(16-1)²·8 flops a pair), its tile's bytes
  and no collective.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs import ASSIGNED as JASSIGNED
from repro.launch import shapes as JSHP
from repro.launch.mesh import simulated_mesh_env
from repro.models import get_config as jget_config
from repro_torch.launch import dryrun as D

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"


def _env(extra=None):
    env = dict(os.environ if extra is None else extra)
    env["PYTHONPATH"] = os.pathsep.join([str(SRC), str(TESTS), env.get("PYTHONPATH", "")])
    env.setdefault("OMP_NUM_THREADS", "2")
    return env


def _start(args, env):
    return subprocess.Popen([sys.executable, *args], cwd=TESTS, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _result(proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs():
    """Both sides' subprocesses, started at once."""
    procs = {"host": _start(["torch_dryrun_cells.py", "host"], _env()),
             "mesh": _start(["torch_dryrun_cells.py", "mesh"], _env()),
             "trips": _start(["torch_dryrun_cells.py", "trips"], _env()),
             "jax": _start(["torch_dryrun_jax_cells.py"],
                           _env(dict(simulated_mesh_env(4), JAX_PLATFORMS="cpu")))}
    return {k: _result(p) for k, p in procs.items()}


def test_cells_and_skips_match_jax():
    want = []
    for arch in JASSIGNED:
        for shape in JSHP.SHAPES:
            for mp in (False, True):
                want.append((arch, shape, mp, JSHP.cell_supported(jget_config(arch),
                                                                  JSHP.SHAPES[shape])))
    for shape in JSHP.SIG_SHAPES:
        for mp in (False, True):
            want.append(("sigkernel-workload", shape, mp,
                         JSHP.cell_supported(jget_config("sigkernel-workload"),
                                             JSHP.SIG_SHAPES[shape])))
    got = [(a, s, mp, D.build_cell(a, s, mp)[1]) for a, s, mp in D.cells(True)]
    assert got == want
    assert len(got) == 84 and sum(skip is not None for *_, skip in got) == 16
    assert [D.mesh_layout(mp)[2] for *_, mp, _ in got[:2]] == ["16x16", "2x16x16"]


def test_host_mesh_records_equal_the_real_step(runs):
    assert len(runs["host"]) == 6
    for name, r in runs["host"].items():
        rec = r["record"]
        assert rec["argument_bytes"] == r["real_argument_bytes"], name
        assert rec["flops"] == r["real_flops"], name
        assert rec["hlo_dot_flops"] <= rec["flops"]
        assert all(rec[k] is None for k in D.NULL_FIELDS)
        assert all(c["count"] == 0 for c in rec["collectives"].values()), name
        if name.endswith("train"):
            assert rec["alias_bytes"] > 0 and rec["num_microbatches"] >= 1


def test_mesh_records_match_the_jax_step(runs):
    port, jax_ = runs["mesh"], runs["jax"]
    assert set(port) == set(jax_)
    for name, j in jax_.items():
        assert "error" not in j, (name, j)
        p = port[name]
        arch, kind = name.split("/")
        if arch == "qwen2-moe-a2.7b":
            assert j["hlo_dot_flops"] <= p["hlo_dot_flops"] <= 1.3 * j["hlo_dot_flops"], name
        else:
            assert p["hlo_dot_flops"] == j["hlo_dot_flops"], name
            assert p["flops"] <= j["flops"], name
        batch, seq = (8, 1) if kind == "decode" else (4, 64)
        ssm = arch == "mamba2-780m"                   # its batch is on data and model
        tokens = batch // (4 if ssm else 2) * seq     # a device's tokens
        cur_len = 4 if kind == "decode" and not ssm else 0   # XLA drops an unread one
        assert p["argument_bytes"] - j["argument_bytes"] == tokens * 4 - cur_len, name
        assert p["n_chips"] == 4 and sum(c["count"] for c in p["collectives"].values()) > 0


@pytest.mark.parametrize("cell", ["sig_fwd"])
def test_trip_counting_matches_the_unrolled_trace(runs, cell):
    rec = runs["trips"][cell]
    assert rec["flops"] == rec["hlo_dot_flops"] == 4 * 4 * 2 * (16 - 1) ** 2 * 8
    assert rec["argument_bytes"] == 2 * 4 * 16 * 8 * 4 and rec["output_bytes"] == 4 * 4 * 4
    assert all(c["count"] == 0 for c in rec["collectives"].values())
