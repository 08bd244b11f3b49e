"""The port's ``bench`` (``cokriging_tpu_torch/bench.py``) against the JAX
package's root ``bench.py`` on the CPU: the month's inputs bit-equal, the NLL
axis' evaluation against JAX's ``_nll_value_and_grad`` in float64 (chip_smoke
(c)'s bars), and the NLL axis raising where its point does not factor. The
CLI's ``bench`` is in tests/test_torch_cli.py; ``run_pipeline`` as a whole is
held against the JAX package by tests/test_torch_pipeline.py and, at full
size on the card, by tests/test_torch_bench_month.py."""

import importlib.util
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cokriging_tpu.cov.params import MaternParams as JParams
from cokriging_tpu.estimate.nll import _nll_value_and_grad, joint_distance_blocks
from cokriging_tpu_torch import bench as TB

ROOT = Path(__file__).resolve().parents[1]
N = 100  # observations per process

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_bench():
    """The root bench.py as a module. Its import sets a global 'ignore'
    warnings filter, which ``catch_warnings`` takes back."""
    spec = importlib.util.spec_from_file_location("_jax_bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    with warnings.catch_warnings():
        spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_build_inputs_bit_equal_to_bench_py(jax_bench, monkeypatch, dtype, seed):
    monkeypatch.setattr(jax_bench, "N_PER_PROC", N)
    monkeypatch.setattr(TB, "N_PER_PROC", N)
    want = [np.asarray(a) for a in jax_bench.build_inputs(dtype, noise_seed=seed)]
    got = TB.build_inputs(dtype, noise_seed=seed)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(got[1], TB.build_inputs(dtype, noise_seed=seed + 1)[1])


def test_nll_axis_evaluation_matches_jax(jax_bench, monkeypatch):
    """The axis' timed evaluation (x0 (1 + 0.01)) on the timed run's month
    against the JAX package's at the same point: value rtol 1e-10, gradient
    rtol 1e-7 / atol 1e-10. On the CPU no kernel launches."""
    monkeypatch.setattr(jax_bench, "N_PER_PROC", N)
    monkeypatch.setattr(TB, "NLL_REPS", 1)
    c1, v1, c2, v2 = TB.build_inputs(np.float64, noise_seed=2, n=N)
    rate, rec = TB.nll_evals_per_sec(c1, v1, c2, v2, "cpu")
    assert rate == 1.0 / rec["seconds"][0] and not any(rec["launches"].values())
    x = rec["x"][0]
    x0 = np.array(JParams.default(2).to_flat())
    x0[5:8] = 700.0
    np.testing.assert_array_equal(x, x0 * (1.0 + 0.01))
    jc1, jv1, jc2, jv2 = jax_bench.build_inputs(np.float64, noise_seed=2)
    jv, jg = _nll_value_and_grad(jnp.asarray(x), joint_distance_blocks([jc1, jc2], geodesic=True),
                                 jnp.concatenate([jv1, jv2]), JParams.default(2).spec,
                                 jnp.zeros(2 * N), TB.NLL_JITTER)
    np.testing.assert_allclose(rec["values"][0], float(jv), rtol=1e-10)
    np.testing.assert_allclose(rec["grads"][0], np.asarray(jg), rtol=1e-7, atol=1e-10)


def test_nll_axis_raises_where_the_point_does_not_factor(monkeypatch):
    """Sites duplicated within a process, nuggets 0 and no jitter: the
    covariance is singular, every evaluation is the penalty, and the axis
    raises instead of reporting a rate of penalty evaluations."""
    monkeypatch.setattr(TB, "NLL_JITTER", 0.0)
    c1, v1, c2, v2 = TB.build_inputs(np.float64, n=20)
    c1, v1 = np.concatenate([c1, c1]), np.concatenate([v1, v1])
    with pytest.raises(RuntimeError, match="non-PD penalty"):
        TB.nll_evals_per_sec(c1, v1, c2, v2, "cpu")
