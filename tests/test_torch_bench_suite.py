"""The port's bench suite (``repro_torch.bench``) on the CPU, and its parity
with the JAX package's (``repro.bench``).

The first ten tests mirror ``tests/test_bench_suite.py`` on one smoke run
(``device="cpu"``, one repeat): the document is well formed and
schema-versioned, self-comparison is green, and slowdowns, accuracy losses
and missing entries are flagged with a nonzero exit.  Then the parity with
the JAX package: the cell tables of every mode, the smoke entry names (those
of the committed JAX smoke baseline ``BENCH_PR10.json`` without the
``pallas*`` entries, whose counterparts run on the card only), the analytic
roofline counts of every entry of every mode, and the §3.4 continuous adjoint
``solve_goursat_grad_pde_approx`` on shared Δ (float64 1e-10, float32 5e-5).
"""

import copy
import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bench import roofline as jroofline
from repro.bench import workloads as jworkloads
from repro_torch.bench import compare, roofline, suite, timer, workloads
from repro_torch.bench.__main__ import default_out
from repro_torch.bench.__main__ import main as bench_main

# the modules, not the functions of the same name the packages export
jsk = importlib.import_module("repro.core.sigkernel")
tsk = importlib.import_module("repro_torch.core.sigkernel")

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def smoke_doc(tmp_path_factory):
    """One smoke-suite run on the CPU shared by every test in this module;
    its autotune workloads write a cache of their own, never the home
    directory's."""
    from repro_torch.bench import autotune
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(autotune.ENV_CACHE, str(tmp_path_factory.mktemp("cache") / "autotune.json"))
        mp.delenv(autotune.ENV_DISABLE, raising=False)
        yield suite.run_suite("smoke", repeats=1, device="cpu")


def _gated_time_entry(doc):
    for e in doc["entries"]:
        if e["kind"] == "time" and e.get("meta", {}).get("gate", True) \
                and e["seconds"] > 0:
            return e
    raise AssertionError("no gated timing entry in the smoke document")


def test_smoke_document_shape(smoke_doc):
    assert smoke_doc["schema"] == suite.SCHEMA
    assert smoke_doc["mode"] == "smoke"
    fp = smoke_doc["fingerprint"]
    assert fp["platform"] == "cpu" and fp["torch"] == torch.__version__
    assert "jax" not in fp
    assert timer.machine_key("cpu") == f"cpu|cpu|{fp['device_memory']}"
    assert smoke_doc["launches"] == {}  # the plain versions launch no kernel
    names = [e["name"] for e in smoke_doc["entries"]]
    assert len(names) == len(set(names))
    kinds = {e["kind"] for e in smoke_doc["entries"]}
    assert kinds == {"time", "accuracy", "check"}
    # the acceptance-critical sections are present
    assert "calibration_matmul_scan" in names
    assert any(n.startswith("smoke_gram_") for n in names)
    assert any(n.startswith("gradacc_") for n in names)
    assert "distgram_mesh_invariance_wall" in names
    for e in smoke_doc["entries"]:
        assert "roofline" in e
        if e["kind"] == "time" and e["meta"].get("op") in ("signature", "sigkernel", "gram"):
            assert e["roofline"]["source"] == "analytic"
            assert 0 < e["roofline"]["frac_bound"]


def test_write_load_roundtrip(smoke_doc, tmp_path):
    path = tmp_path / "bench.json"
    suite.write_json(smoke_doc, str(path))
    assert suite.load_json(str(path))["entries"] == smoke_doc["entries"]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": 999, "entries": []}))
    with pytest.raises(ValueError, match="schema"):
        suite.load_json(str(bad))


def test_markdown_summary_lists_entries(smoke_doc):
    md = suite.markdown_summary(smoke_doc)
    assert "calibration_matmul_scan" in md
    assert "µs/call" in md
    assert "table2_B4_L16_d4_fwd_wavefront" in roofline.markdown_summary(smoke_doc)


def test_unknown_mode_rejected():
    with pytest.raises(ValueError, match="mode"):
        suite.run_suite("warp", device="cpu")


def test_compare_self_is_green(smoke_doc):
    regressions, _ = compare.compare_docs(smoke_doc, smoke_doc)
    assert regressions == []


def test_compare_flags_big_slowdown(smoke_doc):
    slow = copy.deepcopy(smoke_doc)
    victim = _gated_time_entry(slow)
    victim["seconds"] = victim["seconds"] * 1000 + 1.0
    regressions, _ = compare.compare_docs(smoke_doc, slow)
    assert any(r.startswith("SLOWER " + victim["name"]) for r in regressions)
    # ...but generous tolerances swallow plausible shared-runner noise
    noisy = copy.deepcopy(smoke_doc)
    _gated_time_entry(noisy)["seconds"] *= 1.5
    regressions, _ = compare.compare_docs(smoke_doc, noisy)
    assert regressions == []


def test_compare_normalizes_uniform_machine_speed(smoke_doc):
    slower_box = copy.deepcopy(smoke_doc)
    for e in slower_box["entries"]:
        if e["kind"] == "time":
            e["seconds"] *= 4.0  # a uniformly 4x slower machine
    regressions, notes = compare.compare_docs(smoke_doc, slower_box)
    assert regressions == []
    assert any("machine-speed factor" in n for n in notes)
    # the same 4x, compared raw, would trip the 2.5x gate somewhere
    regressions, _ = compare.compare_docs(smoke_doc, slower_box,
                                          normalize=False)
    assert regressions != []


def test_compare_flags_accuracy_regression(smoke_doc):
    worse = copy.deepcopy(smoke_doc)
    victim = next(e for e in worse["entries"]
                  if e["kind"] == "accuracy"
                  and e.get("meta", {}).get("gate", True))
    victim["value"] = 0.5
    regressions, _ = compare.compare_docs(smoke_doc, worse)
    assert any(r.startswith("LESS-ACCURATE " + victim["name"])
               for r in regressions)


def test_compare_flags_missing_entries(smoke_doc):
    shrunk = copy.deepcopy(smoke_doc)
    dropped = shrunk["entries"].pop()
    regressions, _ = compare.compare_docs(smoke_doc, shrunk)
    assert any(dropped["name"] in r for r in regressions)
    regressions, notes = compare.compare_docs(smoke_doc, shrunk,
                                              allow_missing=True)
    assert regressions == []
    assert any(dropped["name"] in n for n in notes)


def test_compare_cli_exit_codes(smoke_doc, tmp_path):
    base = tmp_path / "base.json"
    suite.write_json(smoke_doc, str(base))
    assert compare.main([str(base), str(base), "--quiet"]) == 0
    slow = copy.deepcopy(smoke_doc)
    victim = _gated_time_entry(slow)
    victim["seconds"] = victim["seconds"] * 1000 + 1.0
    slow_path = tmp_path / "slow.json"
    suite.write_json(slow, str(slow_path))
    assert compare.main([str(base), str(slow_path), "--quiet"]) == 1
    # a JAX-package document against one of the port's: refused
    assert compare.main([os.path.join(ROOT, "BENCH_PR10.json"), str(base), "--quiet"]) == 2
    with pytest.raises(ValueError, match="refusing"):
        compare.compare_docs(suite.load_json(os.path.join(ROOT, "BENCH_PR10.json")),
                             smoke_doc)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", workloads.MODES)
def test_cli_default_out_is_never_the_jax_baseline(mode):
    assert default_out(mode) == f"BENCH_TORCH_{mode}.json"
    assert default_out(mode) != "BENCH_PR10.json"


def test_cli_refuses_the_card_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_main(["--smoke", "--out", "-"])
    with pytest.raises(RuntimeError, match="CUDA"):
        suite.run_suite("smoke", repeats=1)


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("table", ["_TABLE1_CELLS", "_TABLE2_CELLS", "_GRAM_CELLS",
                                   "_RBF_CELLS", "_RAGGED_CELLS", "_DISTGRAM_CELLS",
                                   "_TABLE3_CELLS", "_GRADACC_CELLS", "_PATH_CELLS",
                                   "_FRONTIER_CELLS", "_SCHEME_CELLS"])
def test_cell_tables_equal_jax(table):
    assert getattr(workloads, table) == getattr(jworkloads, table)
    assert set(getattr(workloads, table)) == set(workloads.MODES)


def test_autotune_constants_equal_jax():
    """The autotune round trip's shapes, the scheme budget, and the suite's
    workload order (``src/repro/bench/suite.py:26-50``) are the JAX
    package's."""
    from repro.bench import suite as jsuite
    assert workloads._AUTOTUNE_SMOKE_SHAPES == jworkloads._AUTOTUNE_SMOKE_SHAPES
    assert workloads._SCHEME_COARSE_BUDGET == jworkloads._SCHEME_COARSE_BUDGET
    for mode in workloads.MODES:
        assert [f.__name__ for f in suite.WORKLOAD_SETS[mode]] == \
            [f.__name__ for f in jsuite.WORKLOAD_SETS[mode]]


def test_figure_sweeps_equal_jax():
    """``workloads.py:518`` and ``:540-542`` of the JAX package, whose sweeps
    are inline constants."""
    assert workloads._FIG1_CELLS == {"quick": (8, 128, 5), "full": (32, 1024, 5)}
    assert list(workloads._FIG1_DEPTHS) == list(range(2, 8))
    assert workloads._FIG2_CELLS == {"quick": ((8, 5), [32, 64, 128, 256]),
                                     "full": ((32, 5), [128, 256, 512, 1024, 2048])}


def test_smoke_names_equal_the_jax_baseline(smoke_doc):
    with open(os.path.join(ROOT, "BENCH_PR10.json"), encoding="utf-8") as f:
        jax_doc = json.load(f)
    want = {e["name"] for e in jax_doc["entries"] if "pallas" not in e["name"]}
    assert {e["name"] for e in smoke_doc["entries"]} == want


def test_the_run_follows_the_plan(smoke_doc):
    assert [(e["name"], e["kind"], e["meta"]) for e in smoke_doc["entries"]] == \
        workloads.plan("smoke", "cpu")


@pytest.mark.parametrize("mode", workloads.MODES)
def test_card_plan_adds_the_gpu_rows(mode):
    """On the card every planned entry of the CPU plan is there too, and the
    ``gpu`` rows stand where the JAX package has its ``pallas`` rows."""
    card = {n for n, _, _ in workloads.plan(mode, "cuda")}
    cpu = {n for n, _, _ in workloads.plan(mode, "cpu")}
    assert cpu - {"distgram_mesh_invariance_wall"} <= card
    for b in ("gpu", "gpu_fused"):
        for (B, L, d) in workloads._GRAM_CELLS[mode]:
            assert f"table2_gram_B{B}_L{L}_d{d}_dense_{b}" in card
            assert f"table2_gram_B{B}_L{L}_d{d}_symmetric_{b}" in card


@pytest.mark.parametrize("mode", workloads.MODES)
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_analytic_counts_equal_jax(mode, device):
    plan = workloads.plan(mode, device)
    assert plan
    for name, _, meta in plan:
        assert roofline.analytic_counts(name, meta) == \
            jroofline.analytic_counts(name, meta), name


def test_budget_skips_only_the_plain_loops_at_full():
    skipped = sorted(n for mode in workloads.MODES for n, k, m in workloads.plan(mode, "cuda")
                     if k == "check" and workloads.over_budget(n, m))
    assert skipped == ["table2_B128_L1024_d32_bwd_autodiff",
                       "table2_B128_L1024_d32_fwd_rowscan",
                       "table2_B128_L512_d16_bwd_autodiff",
                       "table2_B128_L512_d16_fwd_rowscan"]


def _shared_delta(B, L, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, 3)) * 0.3
    y = rng.normal(size=(B, L, 3)) * 0.3
    dx, dy = np.diff(x, axis=1), np.diff(y, axis=1)
    return np.einsum("bid,bjd->bij", dx, dy)


@pytest.mark.parametrize("lam", [0, 1, 2])
@pytest.mark.parametrize("dtype, tol", [("float64", 1e-10), ("float32", 5e-5)])
def test_pde_approx_matches_jax(lam, dtype, tol):
    delta = _shared_delta(3, 7, lam).astype(dtype)
    gbar = np.linspace(0.5, 1.5, 3).astype(dtype)
    with jax.enable_x64(dtype == "float64"):
        jd = jnp.asarray(delta)
        jgrid = jsk.solve_goursat(jd, lam, lam, return_grid=True)
        want = np.asarray(jsk.solve_goursat_grad_pde_approx(jd, jgrid, jnp.asarray(gbar),
                                                            lam, lam))
    td = torch.from_numpy(delta)
    tgrid = tsk.solve_goursat(td, lam, lam, return_grid=True)
    got = tsk.solve_goursat_grad_pde_approx(td, tgrid, torch.from_numpy(gbar), lam, lam)
    assert got.dtype == td.dtype and got.shape == td.shape
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= tol, err


def test_pde_approx_is_the_o_h_baseline():
    """§3.4: the exact one-pass backward matches autograd; the continuous
    adjoint does not (float64)."""
    delta = torch.from_numpy(_shared_delta(2, 9, 5))
    grid = tsk.solve_goursat(delta, 1, 1, return_grid=True)
    gbar = torch.ones(2, dtype=delta.dtype)
    dl = delta.clone().requires_grad_()
    d_true, = torch.autograd.grad(tsk.solve_goursat(dl, 1, 1).sum(), dl)
    exact = tsk.solve_goursat_grad(delta, grid, gbar, 1, 1)
    approx = tsk.solve_goursat_grad_pde_approx(delta, grid, gbar, 1, 1)
    scale = float(d_true.abs().max())
    assert float((exact - d_true).abs().max()) / scale < 1e-12
    assert float((approx - d_true).abs().max()) / scale > 1e-3
