"""The benchmark's process: no JAX in it, no result without a card or
without the program, and (marked ``gpu``) a short run on the card."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]

_PROBE = """
import sys, time
sys.path[:0] = [{root!r}, {src!r}]
from sigbench import device, harness
from sigbench.tests import tiny
if __name__ == "__main__":
    out = harness.run(tiny.cell({cell!r}), 5, 0.2, False, time.time(), dev_type="cpu",
                      fault={fault!r})
    print(out["correct"], device.forbidden_modules(), out["_held"], device.held(out))
"""


def _probe(tmp_path, cell, fault=None):
    script = tmp_path / "probe.py"
    script.write_text(_PROBE.format(root=str(ROOT), src=str(ROOT / "src"), cell=cell,
                                    fault=fault))
    done = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          timeout=300, cwd=tmp_path,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert done.returncode == 0, done.stderr[-2000:]
    return done.stdout.split("\n")[-2]


@pytest.mark.parametrize("cell", ["gram.mmd2-train", "pairs.sigkernel-train",
                                  "gram4.mmd2-sharded-train"])
def test_fresh_process_holds_no_jax(tmp_path, cell):
    """The run's process and, in the sharded cell, each of its two gloo
    ranks hold no module of JAX or of the JAX package."""
    assert _probe(tmp_path, cell) == "True [] [] []"


def test_a_rank_that_holds_jax_is_found(tmp_path):
    line = _probe(tmp_path, "gram4.mmd2-sharded-train", "sigbench.tests.faults:holds_flax")
    assert line == "True [] ['flax'] ['flax']"


def test_forbidden_names_compare_whole_top_level_names():
    from sigbench.device import forbidden_modules
    mods = {"repro_torch": 1, "repro_torch.core": 1, "reprox": 1, "repro": 1,
            "jax.numpy": 1, "jaxlib": 1, "flax.linen": 1}
    assert forbidden_modules(mods) == ["flax.linen", "jax.numpy", "jaxlib", "repro"]


def _run(cwd, *extra):
    return subprocess.run([sys.executable, "sigbench/run.py", "--workload", "gram.mmd2-test",
                           "--seed", "2147483659", "--seconds", "1", *extra],
                          capture_output=True, text=True, timeout=300, cwd=cwd)


def test_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "sigbench", tmp_path / "sigbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    done = _run(tmp_path)
    assert done.returncode != 0 and done.stdout.strip() == ""


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    done = _run(ROOT)
    assert done.returncode == 3 and done.stdout.strip() == ""
    assert "needs 1 CUDA card" in done.stderr


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_short_run_on_the_card(card):
    done = _run(ROOT)
    assert done.returncode == 0, done.stderr[-3000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "check"
