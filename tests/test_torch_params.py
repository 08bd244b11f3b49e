"""Port parameters, distances and the device rule against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cokriging_tpu.cov.params import MaternParams as JParams, ParamSpec as JSpec
from cokriging_tpu.kernels import distance as JD
from cokriging_tpu_torch.cov.params import MaternParams, ParamSpec
from cokriging_tpu_torch.kernels import distance as TD
from cokriging_tpu_torch.utils.config import resolve_device
from cokriging_tpu_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)


@pytest.mark.parametrize("p", [1, 2, 3])
def test_params_round_trip_matches_jax(p):
    rng = np.random.default_rng(p)
    spec = JSpec(n_procs=p)
    flat = rng.uniform(0.3, 2.0, spec.n_params)
    jp = JParams.from_flat(jnp.asarray(flat), spec=spec)
    tp = params_from_numpy(np.asarray(jp.to_flat()), n_procs=p)
    np.testing.assert_array_equal(tp.to_flat().numpy(), np.asarray(jp.to_flat()))
    for name in ("sigma", "nu", "len_scale", "nugget", "rho"):
        np.testing.assert_array_equal(
            getattr(tp, name).numpy(), np.asarray(getattr(jp, name))
        )
    tspec = ParamSpec(n_procs=p)
    assert tspec.names() == spec.names()
    for a, b in zip(tspec.bounds(), spec.bounds()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        MaternParams.default(p).to_flat().numpy(), np.asarray(JParams.default(p).to_flat())
    )
    assert tp.astype(torch.float32).to_flat().dtype == torch.float32


def test_from_flat_is_differentiable():
    x = torch.tensor([1.2, 0.8, 1.5, 1.1, 2.0, 300.0, 250.0, 350.0, 0.04, 0.02, -0.5],
                     dtype=torch.float64, requires_grad=True)
    p = MaternParams.from_flat(x)
    (p.nu[1, 0] + 2 * p.rho[0, 1] + p.len_scale[1, 1]).backward()
    expect = np.zeros(11)
    expect[[3, 10, 7]] = [1.0, 2.0, 1.0]
    np.testing.assert_array_equal(x.grad.numpy(), expect)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_distances_match_jax(dtype):
    rng = np.random.default_rng(0)
    a = np.column_stack([rng.uniform(24, 50, 40), rng.uniform(-124, -67, 40)]).astype(dtype)
    b = np.concatenate([a[:5], a[5:30] + 0.3]).astype(dtype)
    tol = dict(rtol=1e-12, atol=1e-9) if dtype == np.float64 else dict(rtol=2e-4, atol=2e-2)
    for jf, tf in ((JD.haversine_matrix, TD.haversine_matrix),
                   (JD.euclidean_matrix, TD.euclidean_matrix)):
        ref = np.asarray(jf(jnp.asarray(a), jnp.asarray(b)))
        got = tf(torch.as_tensor(a), torch.as_tensor(b)).numpy()
        assert got.dtype == dtype
        np.testing.assert_allclose(got, ref, **tol)
        # identical points snap to exact zero in both packages
        np.testing.assert_array_equal(got[np.arange(5), np.arange(5)], 0.0)
        np.testing.assert_array_equal(got == 0.0, ref == 0.0)


def test_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
