"""The port's kriging-vs-cokriging comparison
(``experiments/modelling_comparison.py``) against the JAX package's
``examples/modelling_comparison.py``, on the CPU in float64: the
synthesizer's frames, then each stage of ``run_comparison`` on the JAX
run's own frames at a cut size (every 24th land cell, 30 Adam steps): the
fields and their variograms, the Adam fits from the same estimates, and the
predictions and LOOCV residuals of both models at the JAX-fitted
parameters. ``tests/test_torch_modelling_comparison_main.py`` runs the
port's whole ``main`` at the JAX test's size and holds it to that test's
gates."""

import json
import sys
import warnings
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))

import modelling_comparison as JMC  # noqa: E402

from cokriging_tpu_torch.cov.matern import MultivariateMatern  # noqa: E402
from cokriging_tpu_torch.data.grids import main_coords_array  # noqa: E402
from cokriging_tpu_torch.estimate.empirical import VarioConfig, empirical_variograms  # noqa: E402
from cokriging_tpu_torch.estimate.wls import fit_wls, moment_init  # noqa: E402
from cokriging_tpu_torch.experiments import modelling_comparison as MC  # noqa: E402
from cokriging_tpu_torch.fields.field import MultiField, apply_timedelta  # noqa: E402
from cokriging_tpu_torch.predict.local import LocalPredictor  # noqa: E402
from cokriging_tpu_torch.utils.convert import params_from_numpy  # noqa: E402

torch.set_num_threads(2)

STRIDE, MAXITER = 24, 30  # the cut size of the stage checks
TIMESTAMP = "2019-05-01"
# the model, its fields' arguments and its variogram config, per model
MODELS = {
    "uni": dict(procs=1, data=lambda fx, fs: ([fs], ["sif"], [["evi"]]), i=0,
                stamp=apply_timedelta(TIMESTAMP, -1), deltas=[0]),
    "biv": dict(procs=2, data=lambda fx, fs: ([fx, fs], ["xco2", "sif"], [["lon", "lat"], ["evi"]]),
                i=1, stamp=TIMESTAMP, deltas=[0, -1]),
}


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's frames (6 months, seed 0) and its
    ``run_comparison`` on them at the cut size."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fx, fs = JMC.synthesize_conus_months(seed=0)
        out = JMC.run_comparison(seed=0, pred_stride=STRIDE, maxiter=MAXITER, df_xco2=fx,
                                 df_sif=fs)
    return fx, fs, out


@pytest.fixture(scope="module")
def port_fields(jax_run):
    """The port's fields and variograms of both models on the JAX frames."""
    fx, fs, _ = jax_run
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name, m in MODELS.items():
            mf = MultiField.from_dataframes(*m["data"](fx, fs), timestamp=m["stamp"],
                                            timedeltas=m["deltas"],
                                            main_coords=main_coords_array()).astype(torch.float64)
            est = empirical_variograms(mf, VarioConfig(max_dist=1.5e3, n_bins=15,
                                                       n_procs=m["procs"]), device="cpu")
            out[name] = (mf, est)
    return out


def test_synthesizer_frames_match_jax():
    """Two months: the same rows, times and NaN mask (the draw order of
    numpy's generator), every value within 1e-9."""
    want = JMC.synthesize_conus_months(seed=3, months=2)
    got = MC.synthesize_conus_months(seed=3, months=2, device="cpu")
    for g, w in zip(got, want):
        assert list(g.columns) == list(w.columns) and len(g) == len(w)
        assert (g["time"] == w["time"]).all()
        for col in g.columns.drop("time"):
            a, b = g[col].to_numpy(np.float64), w[col].to_numpy(np.float64)
            assert np.array_equal(np.isnan(a), np.isnan(b)), col
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-9, err_msg=col)
    assert got[1]["sif"].isna().any() and not got[1]["sif"].isna().all()


@pytest.mark.parametrize("model", sorted(MODELS))
def test_fields_and_variograms_match_jax(jax_run, port_fields, model):
    """Each model's fields equal the JAX package's (built from the same
    frames) and its variograms equal the JAX run's, within 1e-10."""
    from cokriging_tpu.data.grids import main_coords_array as jmain
    from cokriging_tpu.fields import MultiField as JMultiField

    fx, fs, out = jax_run
    m = MODELS[model]
    mf, est = port_fields[model]
    jmf = JMultiField.from_dataframes(*m["data"](fx, fs), timestamp=m["stamp"],
                                      timedeltas=m["deltas"], main_coords=jmain())
    for f, jf in zip(mf.fields, jmf.fields):
        for attr in ("coords_main", "values_main"):
            np.testing.assert_allclose(getattr(f, attr).numpy(), np.asarray(getattr(jf, attr)),
                                       rtol=0, atol=1e-10, err_msg=attr)
    jest = out[f"fit_{model}"].estimate
    assert list(map(tuple, est.pairs)) == list(map(tuple, jest.pairs))
    np.testing.assert_array_equal(np.asarray(est.bin_counts), np.asarray(jest.bin_counts))
    for attr in ("bin_centers", "bin_means"):
        np.testing.assert_allclose(np.asarray(getattr(est, attr)), np.asarray(getattr(jest, attr)),
                                   rtol=1e-10, atol=1e-10, err_msg=attr)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_adam_fits_match_jax(jax_run, port_fields, model):
    """The Adam WLS fit of each model's estimate, 30 steps from its moment
    start with the smoothnesses moved off nu = 1.5 (there the reference's
    CF2 dK/dnu jumps across the order, so the last-ulp rounding of the box
    transform in each package would decide the fit; tests/test_torch_wls.py
    does the same): the JAX package's parameters and cost within
    tests/test_torch_wls.py's rtol 1e-6."""
    import jax.numpy as jnp
    from cokriging_tpu.cov.params import MaternParams as JParams
    from cokriging_tpu.estimate.wls import fit_wls as jfit_wls

    _, _, out = jax_run
    _, est = port_fields[model]
    x0 = moment_init(est).to_flat().numpy().copy()
    p = MODELS[model]["procs"]
    x0[p:p + p * (p + 1) // 2] = (1.3, 1.1, 1.2)[:p * (p + 1) // 2]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jparams, jfit = jfit_wls(out[f"fit_{model}"].estimate,
                                 init=JParams.from_flat(jnp.asarray(x0), n_procs=p),
                                 method="adam", maxiter=MAXITER, theoretical=False)
    params, fit = fit_wls(est, init=params_from_numpy(x0, n_procs=p), method="adam",
                          maxiter=MAXITER, device="cpu")
    np.testing.assert_allclose(params.to_flat().numpy(), np.asarray(jparams.to_flat()), rtol=1e-6)
    np.testing.assert_allclose(fit.cost, jfit.cost, rtol=1e-6)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_predictions_and_loocv_match_jax(jax_run, port_fields, model):
    """At the JAX-fitted parameters, the port's data-scale predictions at
    every 24th land cell (the ``evi`` covariate frame) and its LOOCV frame
    equal the JAX run's within 1e-8, row for row."""
    _, _, out = jax_run
    m = MODELS[model]
    mf, _ = port_fields[model]
    pcoords, cov_pred = MC.prediction_frame(STRIDE)
    flat = np.array(out[f"params_{model}"].to_flat())
    lp = LocalPredictor(MultivariateMatern(m["procs"], params_from_numpy(flat, n_procs=m["procs"])),
                        mf, covariates=cov_pred, device="cpu")
    kind = "krig" if model == "uni" else "cokrig"
    pred, want = lp(m["i"], pcoords, max_dist=1e3), out[f"df_{kind}"]
    assert list(pred.columns) == list(want.columns) and len(pred) == len(want) == len(pcoords)
    np.testing.assert_array_equal(pred[["lat", "lon"]].to_numpy(), want[["lat", "lon"]].to_numpy())
    for col in ("pred", "pred_err"):
        np.testing.assert_allclose(pred[col], want[col], rtol=0, atol=1e-8, err_msg=col)
    cv, want = lp.cross_validation(m["i"], max_dist=1e3), out[f"cv_{kind}"]
    assert list(cv.columns) == list(want.columns) and len(cv) == len(want)
    for col in ("data", "pred", "residual", "pred_err"):
        np.testing.assert_allclose(cv[col], want[col], rtol=0, atol=1e-8, err_msg=col)


def test_prediction_frame_is_the_jax_scripts():
    """The cells and the ``evi`` covariate frame the JAX script builds from
    ``prediction_coords()``."""
    from cokriging_tpu.data.grids import prediction_coords

    pcoords, cov_pred = MC.prediction_frame(6)
    want = prediction_coords().iloc[::6]
    pd.testing.assert_frame_equal(pcoords, want, check_dtype=True)
    np.testing.assert_array_equal(cov_pred["evi"], JMC._evi_surface(want["lat"].values,
                                                                    want["lon"].values))


def test_jax_manifest_is_the_recorded_file():
    ref = json.loads((ROOT / "results" / "modelling_comparison.json").read_text())
    assert {k: ref[k] for k in MC.JAX_MANIFEST} == MC.JAX_MANIFEST
    assert MC.TRUE_FLAT == JMC.TRUE_FLAT


def test_sizes():
    assert MC.sizes_for(torch.device("cpu")) == dict(months=6, pred_stride=6, maxiter=250)
    assert MC.sizes_for(torch.device("cuda"), months=2) == dict(months=2, pred_stride=1,
                                                                maxiter=600)
    with pytest.raises(TypeError):
        MC.sizes_for(torch.device("cpu"), n_cells=3)
