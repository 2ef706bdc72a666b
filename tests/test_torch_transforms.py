"""The port's path transforms (``sigkernel_tpu_torch.transforms``) against
the JAX package's numpy pipeline on CPU float64, bit for bit, and against
the benchmark's reference transforms (``bench_torch/transforms_ref.py``),
written apart from both."""
import numpy as np
import pytest
import torch

from sigkernel_tpu import transforms as jt

import sigkernel_tpu_torch as skt
from bench_torch import transforms_ref


def _paths(batch, length, dim, seed=0, scale=0.4):
    rng = np.random.default_rng(seed + 7 * length + dim)
    steps = rng.normal(size=(batch, length, dim)) * scale / np.sqrt(length)
    return np.cumsum(steps, axis=1)


@pytest.mark.parametrize("at", [False, True])
@pytest.mark.parametrize("ll", [False, True])
@pytest.mark.parametrize("scale", [1.0, 0.1, 3.7])
@pytest.mark.parametrize("length", [1, 2, 5, 9, 144])
def test_transform_is_the_jax_pipeline_bit_for_bit(at, ll, scale, length):
    x = _paths(3, length, 4)
    got = skt.transform(torch.from_numpy(x), at=at, ll=ll, scale=scale)
    want = jt.transform(x, at=at, ll=ll, scale=scale)
    assert got.dtype == torch.float64
    assert got.shape == want.shape == (3, (2 * length - 1) if ll else length,
                                       (8 if ll else 4) + at)
    assert torch.equal(got, torch.from_numpy(want))


@pytest.mark.parametrize("init,total", [(0.0, 1.0), (0.3, 2.5), (-1.25, 1e-3),
                                        (0.0, 5e-324)])
@pytest.mark.parametrize("length", [1, 2, 7, 144, 287])
def test_add_time_spaces_as_numpy_linspace(init, total, length):
    """(0, 5e-324): the step underflows to 0, numpy's other branch."""
    x = _paths(2, length, 3)
    got = skt.AddTime(init, total).fit_transform(torch.from_numpy(x))
    want = np.asarray(jt.AddTime(init, total).fit_transform(x))
    assert torch.equal(got, torch.from_numpy(want))


@pytest.mark.parametrize("length", [1, 3, 144])
def test_lead_lag_is_the_jax_embedding(length):
    x = _paths(2, length, 9)
    got = skt.LeadLag().fit_transform(torch.from_numpy(x))
    want = np.asarray(jt.LeadLag().fit_transform(x))
    assert torch.equal(got, torch.from_numpy(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_transform_keeps_dtype_and_gives_a_new_tensor(dtype):
    x = torch.from_numpy(_paths(2, 6, 3)).to(dtype)
    before = x.clone()
    for at in (False, True):
        for ll in (False, True):
            y = skt.transform(x, at=at, ll=ll)
            assert y.dtype == dtype and y.device == x.device
            assert y.data_ptr() != x.data_ptr()
    assert torch.equal(x, before)


@pytest.mark.parametrize("at", [False, True])
@pytest.mark.parametrize("ll", [False, True])
@pytest.mark.parametrize("length", [1, 2, 9, 144])
def test_transform_matches_the_benchmark_reference(at, ll, length):
    """The reference spaces its time channel as ``k / (n - 1)``, numpy as
    ``k * (1 / (n - 1))`` with the last point set to 1: they may differ by
    an ulp of 1; every other entry is a copy of a scaled point."""
    x = torch.from_numpy(_paths(3, length, 9))
    got = skt.transform(x, at=at, ll=ll, scale=0.1)
    want = transforms_ref.transform(x, at=at, ll=ll, scale=0.1)
    assert got.shape == want.shape
    if at:
        assert (got[..., 0] - want[..., 0]).abs().max() <= 2.3e-16
        got, want = got[..., 1:], want[..., 1:]
    assert torch.equal(got, want)
