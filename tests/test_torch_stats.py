"""The port's space-time statistics (``stats/spacetime.py``, NaN-masked
torch reductions) against the JAX package's (``cokriging_tpu.stats``), on
the CPU in float64, on small (4, 3, 60) cubes with ~35% NaN holes, a lagged
dependence between the two cubes, a cell with too few pairs for ``tau`` and
an all-NaN cell. Bars: 1e-12 relative (the same masked sums in another
order); lags and counts exactly."""

import numpy as np
import pytest
import torch

from cokriging_tpu import stats as JS
from cokriging_tpu_torch import stats as TS

torch.set_num_threads(1)

T = 60
LAG = 3


@pytest.fixture(scope="module")
def cubes():
    rng = np.random.default_rng(12)
    base = rng.normal(size=(4, 3, T + LAG))
    trend = np.linspace(0.0, 2.0, T)
    z1 = base[..., :T] + trend + 0.1 * rng.normal(size=(4, 3, T))
    z2 = -0.8 * base[..., LAG:] + 0.5 * trend + 0.1 * rng.normal(size=(4, 3, T))
    for z in (z1, z2):
        z[rng.uniform(size=z.shape) < 0.35] = np.nan
    z1[0, 0, 5:] = np.nan  # few valid pairs: tau removes it
    z2[1, 2] = np.nan  # an all-NaN series
    return z1, z2


def _close(a, b, rtol=1e-12):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=rtol, atol=1e-14, equal_nan=True)


def test_detrend_regression_and_counts_match_jax(cubes):
    z1, _ = cubes
    r_t, s_t = TS.detrend(z1, device="cpu")
    r_j, s_j = JS.detrend(z1)
    _close(r_t, r_j)
    _close(s_t, s_j)
    np.testing.assert_array_equal(TS.count_valid(z1, device="cpu"), JS.count_valid(z1))
    _close(TS.simple_linear_regression(z1[2, 1], device="cpu"),
           JS.simple_linear_regression(z1[2, 1]))


@pytest.mark.parametrize("lag,tau", [(0, None), (2, 30), (LAG, 20), (-2, None)])
def test_lagged_xcor_and_xcov_match_jax(cubes, lag, tau):
    z1, z2 = cubes
    for t_fn, j_fn in ((TS.xcor_nd, JS.xcor_nd), (TS.xcov_nd, JS.xcov_nd),
                       (TS.apply_xcor, JS.apply_xcor),
                       (TS.apply_cross_covariance, JS.apply_cross_covariance)):
        _close(t_fn(z1, z2, lag=lag, tau=tau, device="cpu"), j_fn(z1, z2, lag=lag, tau=tau))
    for t_fn, j_fn in ((TS.xcor_1d, JS.xcor_1d), (TS.xcov_1d, JS.xcov_1d)):
        for cell in ((0, 0), (2, 1), (1, 2)):
            _close(t_fn(z1[cell], z2[cell], lag=lag, tau=tau, device="cpu"),
                   j_fn(z1[cell], z2[cell], lag=lag, tau=tau))


def test_optimal_lags_match_jax(cubes):
    z1, z2 = cubes
    got = TS.optim_lag_nd(z1, z2, lag_bnds=(0, 8), tau=15, device="cpu")
    want = JS.optim_lag_nd(z1, z2, lag_bnds=(0, 8), tau=15)
    np.testing.assert_array_equal(got["optim_lag"], want["optim_lag"])
    _close(got["xcor"], want["xcor"])
    assert (got["optim_lag"][np.isfinite(got["xcor"])] == LAG).mean() > 0.5
    one = TS.optim_lag_1d(z1[3, 0], z2[3, 0], lag_bnds=(0, 8), tau=20, device="cpu")
    ref = JS.optim_lag_1d(z1[3, 0], z2[3, 0], lag_bnds=(0, 8), tau=20)
    assert one["optim_lag"] == ref["optim_lag"]
    _close(one["xcor"], ref["xcor"])


def test_get_stats_and_get_stats_df_match_jax(cubes):
    import pandas as pd

    z1, z2 = cubes
    got = TS.get_stats({"sif": z1, "xco2": z2}, device="cpu")
    want = JS.get_stats({"sif": z1, "xco2": z2})
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])
    frame = pd.DataFrame({"time": np.arange(T), "sif": z1[2, 2], "xco2": z2[2, 2]})
    t = TS.get_stats_df(frame, lags=(0, 1, 3), tau=10, device="cpu")
    j = JS.get_stats_df(frame, lags=(0, 1, 3), tau=10)
    assert list(t.columns) == list(j.columns)
    _close(t.to_numpy(np.float64), j.to_numpy(np.float64))


def test_statistics_default_to_the_card(cubes, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.get_stats({"sif": cubes[0]})
