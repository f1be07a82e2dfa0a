"""The port's bench suite in smoke mode on the card.

Needs a CUDA card and skips without one; imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_bench_gpu.py

The document names the card, holds the ``gpu`` / ``gpu_fused`` rows of the
Gram sweep, the smoke checks (every check ran: the suite asserts them) and
the three autotune workloads (the round trip timing the CUDA backends, both
frontiers on the card's exact engine), and compares green with itself.  The
autotune workloads write a cache of their own.
"""

import pytest
import torch

from repro_torch.bench import autotune, compare, suite, workloads
from repro_torch.core import dispatch

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def card_doc(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the suite's gpu rows run the CUDA kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(autotune.ENV_CACHE, str(tmp_path_factory.mktemp("cache") / "autotune.json"))
        mp.delenv(autotune.ENV_DISABLE, raising=False)
        yield suite.run_suite("smoke", repeats=1, device="cuda")


def test_smoke_suite_on_the_card(card_doc):
    fp = card_doc["fingerprint"]
    assert fp["platform"] == "cuda"
    assert fp["device_kind"] == torch.cuda.get_device_name(0)
    assert fp["n_devices"] == torch.cuda.device_count()
    names = [e["name"] for e in card_doc["entries"]]
    assert names == [n for n, _, _ in workloads.plan("smoke", "cuda")]
    for b in ("gpu", "gpu_fused"):
        assert f"smoke_gram_{b}" in names and f"smoke_sigkernel_{b}" in names
        assert f"ragged_gram_B4_L12_d3_agreement_{b}" in names
        for kind in ("dense", "symmetric"):
            e = next(e for e in card_doc["entries"]
                     if e["name"] == f"table2_gram_B4_L12_d3_{kind}_{b}")
            assert e["kind"] == "time" and e["seconds"] > 0
            assert e["roofline"]["source"] == "analytic"
            assert e["roofline"]["peak_bandwidth"] == 3.35e12
    assert "distgram_mesh_invariance_wall" in names
    launched = {k for by_kernel in card_doc["launches"].values() for k in by_kernel}
    assert {"fwd", "fwd_cps", "bwd", "gram_fused", "fwd_fused"} <= launched
    assert compare.compare_docs(card_doc, card_doc)[0] == []


def test_autotune_workloads_on_the_card(card_doc):
    """The round trip timed every exact backend, the CUDA kernels included,
    and both frontiers ran on the card's exact engine and launched it."""
    by_name = {e["name"]: e for e in card_doc["entries"]}
    for op in ("sigkernel", "gram"):
        for b in ("gpu", "gpu_fused", "antidiag", "reference"):
            assert by_name[f"autotune_{op}_{b}"]["seconds"] > 0
        assert by_name[f"autotune_{op}_winner"]["derived"].startswith("winner=")
    for wl in ("approx_frontier", "scheme_frontier"):
        exact = by_name[f"{wl}_exact"]["derived"].removeprefix("backend=")
        # Nyström's exact solves run on the kernels whatever the exact engine
        if wl == "approx_frontier" or dispatch.get(exact).needs_cuda:
            assert card_doc["launches"][wl], wl
    assert by_name["scheme_frontier_order2_c1_f32_rel_err"]["value"] <= \
        workloads._SCHEME_COARSE_BUDGET
    for p in ("nystroem", "rff"):
        assert by_name[f"approx_frontier_{p}_r8_rel_err"]["value"] < 1.0
