"""The port's §4 transforms against the JAX package's, on shared numpy inputs.

Both packages get the same float32 paths; the comparisons hold to rtol 1e-6
(the arithmetic is the same elementwise float32 operations; the absolute
floor of 1e-7 covers time-grid entries that cancel to near zero).
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro.core.config import TransformPipeline as JaxPipeline
from repro_torch.core import transforms as ttf
from repro_torch.core.config import TransformPipeline, configs_from_reference

jtf = importlib.import_module("repro.core.transforms")

RTOL, ATOL = 1e-6, 1e-7

PIPELINES = {
    "identity": dict(),
    "basepoint": dict(basepoint=True),
    "lead_lag": dict(lead_lag=True),
    "time_aug": dict(time_aug=True, t0=0.5, t1=2.0),
    "all": dict(basepoint=True, lead_lag=True, time_aug=True, t0=-1.0, t1=3.0),
}

#: (lengths, align): dense, and ragged with each alignment
LAYOUTS = {
    "dense": (None, "start"),
    "ragged_start": (np.array([9, 2, 5]), "start"),
    "ragged_end": (np.array([9, 2, 5]), "end"),
}


def _pipelines(kw):
    """The JAX pipeline and the port's, carried across as field values."""
    jp = JaxPipeline(**kw)
    fields = {k: np.asarray(v) for k, v in dataclasses.asdict(jp).items()}
    return jp, configs_from_reference({"transforms": fields})["transforms"]


def _paths(seed=0, B=3, L=9, d=2):
    return np.random.default_rng(seed).normal(size=(B, L, d)).astype(np.float32)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("pipe", sorted(PIPELINES))
def test_pipeline_increments_matches_jax(pipe, layout):
    jp, tp = _pipelines(PIPELINES[pipe])
    lengths, align = LAYOUTS[layout]
    x = _paths()
    want = np.asarray(jtf.pipeline_increments(x, jp, lengths, align=align))
    got = ttf.pipeline_increments(torch.from_numpy(x), tp,
                                  None if lengths is None else torch.from_numpy(lengths),
                                  align=align)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("pipe", sorted(PIPELINES))
def test_transform_path_matches_jax(pipe, layout):
    jp, tp = _pipelines(PIPELINES[pipe])
    lengths, align = LAYOUTS[layout]
    x = _paths(1)
    want = np.asarray(jtf.transform_path(x, jp, lengths, align=align))
    got = ttf.transform_path(torch.from_numpy(x), tp, lengths, align=align)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("L", [3, 8, 9, 20])
def test_pad_ragged_matches_jax(L):
    x = _paths(2, B=2, L=L)
    lengths = np.array([L, 2])
    jx, jl = jtf.pad_ragged(x, lengths)
    tx, tl = ttf.pad_ragged(torch.from_numpy(x), lengths)
    assert tx.shape == jx.shape and tx.shape[1] == ttf.bucket_length(L)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_ragged_increments_ignore_padding_content():
    """NaN padding past each true length never reaches the stream."""
    x = _paths(3)
    lengths = np.array([9, 4, 6])
    poisoned = x.copy()
    for b, n in enumerate(lengths):
        poisoned[b, n:] = np.nan
    _, tp = _pipelines(PIPELINES["all"])
    clean = ttf.pipeline_increments(torch.from_numpy(x), tp, lengths, align="end")
    dirty = ttf.pipeline_increments(torch.from_numpy(poisoned), tp, lengths, align="end")
    np.testing.assert_array_equal(clean.numpy(), dirty.numpy())


def test_time_augment_bf16_grid_built_in_f32():
    x = np.zeros((1, 4096, 1), np.float32)
    got = ttf.time_augment(torch.from_numpy(x).to(torch.bfloat16))
    want = np.asarray(jtf.time_augment(np.asarray(x, dtype="bfloat16")), np.float32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_transformed_sizes_match_jax():
    for kw in PIPELINES.values():
        jp, tp = _pipelines(kw)
        assert tp.transformed_dim(3) == jp.transformed_dim(3)
        assert tp.transformed_steps(10) == jp.transformed_steps(10)
        assert isinstance(tp, TransformPipeline)


@pytest.mark.parametrize("bad, err", [
    (np.array([1, 5, 5]), ValueError), (np.array([5, 5, 10]), ValueError),
    (np.array([5.0, 5.0, 5.0]), TypeError), (np.array([5, 5]), ValueError)])
def test_invalid_lengths_raise(bad, err):
    with pytest.raises(err):
        ttf.pipeline_increments(torch.from_numpy(_paths()), TransformPipeline(), bad)
