"""The port's public surface against its committed snapshot.

``tests/api_surface_torch.txt`` lists ``repro_torch.__all__`` and the
``__all__`` of its public subpackages, sorted a package at a time.  A
change to the surface updates the file in the same commit.  (The JAX
package's pytree contract has no counterpart here.)
"""

import importlib
import inspect
import os

import pytest

SURFACE_FILE = os.path.join(os.path.dirname(__file__), "api_surface_torch.txt")
PACKAGES = ("repro_torch", "repro_torch.core", "repro_torch.stream", "repro_torch.serve",
            "repro_torch.parallel", "repro_torch.launch", "repro_torch.data",
            "repro_torch.models", "repro_torch.configs", "repro_torch.optim",
            "repro_torch.checkpoint",
            "repro_torch.train", "repro_torch.bench",
            "repro_torch.kernels", "repro_torch.kernels.sigkernel_pde",
            "repro_torch.kernels.signature", "repro_torch.spans")


def live_surface():
    out = []
    for pkg in PACKAGES:
        out += sorted(f"{pkg}.{n}" for n in importlib.import_module(pkg).__all__)
    return out


def test_api_surface_matches_snapshot():
    with open(SURFACE_FILE, encoding="utf-8") as f:
        committed = [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
    assert live_surface() == committed, (
        "the port's public API changed: update tests/api_surface_torch.txt in the "
        "same commit")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_all_names_exist(pkg):
    mod = importlib.import_module(pkg)
    assert len(set(mod.__all__)) == len(mod.__all__)
    for name in mod.__all__:
        assert hasattr(mod, name), f"{pkg}.{name}"


#: names of the JAX package's surface the port leaves out: the deprecated
#: alias of the row-blocked Gram (ROADMAP Queue A)
NOT_PORTED = {"sigkernel_gram_blocked"}


@pytest.mark.parametrize("pkg", ["repro", "repro.core"])
def test_the_jax_packages_names_exist_in_the_port(pkg):
    """Every name ``repro.__all__`` and ``repro.core.__all__`` export exists in
    the port's counterpart, but the deprecated alias (the JAX pytree
    contract has no names there)."""
    ref = importlib.import_module(pkg)
    port = importlib.import_module(pkg.replace("repro", "repro_torch", 1))
    missing = [n for n in ref.__all__ if n not in NOT_PORTED and not hasattr(port, n)]
    assert not missing, f"{port.__name__} lacks {missing}"
    exported = [n for n in ref.__all__ if n not in NOT_PORTED and not n.startswith("__")
                and not inspect.ismodule(getattr(ref, n))]
    assert not [n for n in exported if n not in port.__all__]


def test_counters_and_aux_loss_live_where_the_jax_package_has_them():
    from repro_torch.core import dispatch, losses
    for name in ("count_pair_solves", "count_scan_steps", "count_combines",
                 "record_pair_solves", "record_scan_steps", "record_combines"):
        assert callable(getattr(dispatch, name))
    assert callable(losses.sig_aux_loss)
    from repro_torch.stream import coalesced_update, trace_counts  # noqa: F401
    from repro_torch.serve import SigFeatureServer  # noqa: F401
