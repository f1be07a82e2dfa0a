"""The port's example scripts from their command lines, on the CPU.

``examples/quickstart_torch.py``, ``examples/serve_sig_features_torch.py``
(8 flush rounds) and ``examples/gram_matrix_distributed_torch.py`` on a
gloo group of 2 ranks run with ``--device cpu``; every error line they
print is below 1e-4 (the JAX quickstart's own bar), the quickstart says
that the CUDA backends need the card, and the server's admission check
holds.  ``examples/serve_lm_torch.py`` has its tests in
``tests/test_torch_serve_lm.py``.
"""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
ERR_BAR = 1e-4


def run(script, *args):
    # two CPU threads a script: the gloo ranks split them, and the test
    # workers share the host's cores
    done = subprocess.run([sys.executable, f"examples/{script}", "--device", "cpu", *args],
                          capture_output=True, text=True, cwd=ROOT, timeout=300,
                          env={**os.environ, "PYTHONPATH": "src", "OMP_NUM_THREADS": "2"})
    assert done.returncode == 0, done.stdout + done.stderr
    return done.stdout


def err_values(out):
    """The number after every ``err:`` on the printed lines."""
    return [float(m) for m in re.findall(r"err: ([-+0-9.eE]+)", out)]


def test_quickstart_runs_on_the_cpu():
    out = run("quickstart_torch.py")
    errs = err_values(out)
    assert len(errs) == 3, out                 # chen, logsig combine, symmetric Gram
    assert all(0 <= e < ERR_BAR for e in errs), out
    for line in ("signature: (8, 120)", "log-signature: (8, 32) vs signature: (8, 120)",
                 "logsig grad finite: True", "grad wrt paths: (4, 50, 3) finite: True",
                 "ragged == truncated: True", "bucketed length: 64 = 64",
                 "gpu / gpu_fused backends: the CUDA kernels need the card; skipped on the CPU"):
        assert line in out.splitlines(), (line, out)
    dsig = float(re.search(r"d gram.sum / d sigma: (\S+)", out).group(1))
    assert dsig == dsig and dsig != 0.0


def test_serve_sig_features_runs_on_the_cpu():
    out = run("serve_sig_features_torch.py", "--ticks", "8")
    assert out.startswith("serve_sig_features: 8 streams x 8 ticks, depth 3, d 3, "
                          "lead_lag=False, device cpu")
    for what in ("flush + full signature", "rolling(16) windows", "rff features (rank 32)"):
        assert re.search(re.escape(what) + r"\s+p50\s+[0-9.]+ ms\s+p95\s+[0-9.]+ ms", out), out
    m = re.search(r"admission: (\d+) flushes -> (\d+) batched groups \((\d+) stream-updates "
                  r"coalesced, (\d+) solo/growth\)", out)
    flushes, groups, coalesced, solo = map(int, m.groups())
    assert flushes == 8 and groups + solo <= 2 * flushes + 8
    assert coalesced + solo == 8 * 8


def test_gram_matrix_distributed_runs_on_gloo():
    out = run("gram_matrix_distributed_torch.py", "--world", "2")
    lines = out.splitlines()
    assert lines[0] == "ranks: 2 (gloo), mesh: {'data': 2, 'model': 1}"
    errs = err_values(out)
    assert len(errs) == 2 and all(0 <= e < ERR_BAR for e in errs), out
    asym = float(re.search(r"max asymmetry: (\S+)", out).group(1))
    assert asym < ERR_BAR
    for line in ("ragged sharded gram: (32, 32) finite: True",
                 "streaming grad: (32, 64, 4) finite: True", "ranks agree: True"):
        assert line in lines, (line, out)
    assert re.search(r"mmd2 dense \S+  streaming \S+  match: True", out), out


@pytest.mark.parametrize("script", ["quickstart_torch.py", "serve_sig_features_torch.py",
                                    "gram_matrix_distributed_torch.py",
                                    "serve_lm_torch.py"])
def test_examples_run_on_the_card_by_default(script):
    """Without --device the examples ask for the card, and raise here."""
    done = subprocess.run([sys.executable, "-c",
                           "import runpy, sys, torch; torch.cuda.is_available = lambda: False; "
                           f"sys.argv = ['{script}']; "
                           f"runpy.run_path('examples/{script}', run_name='__main__')"],
                          capture_output=True, text=True, cwd=ROOT, timeout=120,
                          env={**os.environ, "PYTHONPATH": "src"})
    assert done.returncode != 0
    assert "device='cpu'" in done.stderr, done.stderr
