"""The port's simulation experiment
(``experiments/simulation_experiment.py``, ``python -m cokriging_tpu_torch
sim``) at a small size on the CPU in float64: its draws are the JAX
package's (``experiments/reference_draws.py`` against ``jax.random`` and the
JAX simulator), it writes only ``torch_*`` names, and its truth-model
statistics on the drawn sample equal the JAX package's ``JointPredictor``
on the same fields (rtol 1e-8)."""

import jax
import numpy as np
import pytest
import torch

from cokriging_tpu.cov import MaternParams as JParams
from cokriging_tpu.cov import MultivariateMatern as JMod
from cokriging_tpu.fields.field import Field as JField
from cokriging_tpu.fields.field import MultiField as JMultiField
from cokriging_tpu.predict import JointPredictor as JJointPredictor
from cokriging_tpu.sim import BivariateRandomField as JRandomField
from cokriging_tpu.sim import CartesianGrid as JGrid
from cokriging_tpu_torch.experiments import reference_draws as RD
from cokriging_tpu_torch.experiments import simulation_experiment as SE

torch.set_num_threads(1)

SMALL = dict(nx=11, sample_size=20, n_bins=6, wls_maxiter=60, nll_maxiter=20, vecchia_m=8,
             vecchia_maxiter=10)


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    out = tmp_path_factory.mktemp("results")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("COKRIGING_RESULTS_DIR", str(out))
        mp.delenv("COKRIGING_NO_RECORD", raising=False)
        rf, samples, stats = SE.main(device="cpu", **SMALL)
    return out, rf, samples, stats


def test_experiment_writes_only_its_own_names(ran):
    import json

    out, _, _, stats = ran
    written = sorted(p.relative_to(out).as_posix() for p in out.rglob("*") if p.is_file())
    assert written == ["figures/" + f"torch_sim_{k}.png" for k in
                       ("err_ratio", "loocv", "prediction", "samples", "variograms")] + [
        "torch_simulation_experiment.json"]
    manifest = json.loads((out / "torch_simulation_experiment.json").read_text())
    for key in ("truth_flat", "wls_flat", "nll_flat", "vecchia_flat", "mspe",
                "loocv_coverage_95", "loocv_z_std", "stage_s"):
        assert key in manifest, key
    assert manifest["backend"] == "cpu" and manifest["sizes"]["nx"] == SMALL["nx"]
    assert stats["vecchia_rho_gap"] < SE.RHO_TOL
    assert np.isfinite(stats["nll_flat"]).all() and np.isfinite(stats["wls_flat"]).all()


def test_truth_model_statistics_match_jax(ran):
    """The same sample through the JAX JointPredictor: the truth model's
    MSPE against the truth, its LOOCV coverage and z spread."""
    _, rf, samples, stats = ran

    def fields(ks):
        return JMultiField(fields=[JField.from_arrays(samples[k][["x", "y"]].values,
                                                      samples[k][f"Z{k}"].values, f"Z{k}")
                                   for k in ks])

    pc = rf.coords.values
    truth = rf.fields[0]["value"].values
    jp = JJointPredictor(JMod(params=JParams.from_flat(np.array(SE.TRUTH))), fields([0, 1]))
    pred = jp(0, pc, postprocess=False)["pred"].values
    np.testing.assert_allclose(stats["mspe"]["cokriging"], np.nanmean((truth - pred) ** 2),
                               rtol=1e-8)
    cv = jp.cross_validation(0, postprocess=False)
    z = (cv["residual"] / cv["pred_err"]).replace([np.inf, -np.inf], np.nan).dropna()
    np.testing.assert_allclose(stats["loocv_coverage_95"], float((np.abs(z) < 1.96).mean()),
                               rtol=1e-8)
    np.testing.assert_allclose(stats["loocv_z_std"], float(z.std()), rtol=1e-8)


@pytest.mark.parametrize("seed", [0, 8, 42, 2**33 + 5])
def test_reference_normals_are_jax_random(seed):
    """Keys and splits exact; normals within 1e-13 (scipy's erfinv against
    XLA's in the tails), at an odd length."""
    jkey = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(jkey), np.array(RD.prng_key(seed)))
    jkey, jsub = jax.random.split(jkey)
    key, sub = RD.split(RD.prng_key(seed))
    np.testing.assert_array_equal(np.asarray(jsub), np.array(sub))
    np.testing.assert_array_equal(np.asarray(jkey), np.array(key))
    want = np.asarray(jax.random.normal(jsub, (1001,), np.float64))
    np.testing.assert_allclose(RD.normal(sub, 1001), want, rtol=0, atol=1e-13)


def test_draw_is_the_jax_scripts_realization(ran):
    """The experiment's truth field and sample against the JAX simulator's
    at the same size and seeds (the two Cholesky factors' rounding apart)."""
    _, rf, samples, _ = ran
    jrf = JRandomField(JMod(params=JParams.from_flat(np.array(SE.TRUTH))),
                       JGrid(xcount=SMALL["nx"], ycount=SMALL["nx"]), seed=SE.SIZES["seed"])
    jsamples = jrf.sample(size=SMALL["sample_size"], epsilon=[SE.EPS, SE.EPS],
                          seed=SE.SIZES["sample_seed"])
    for k in range(2):
        np.testing.assert_allclose(rf.fields[k]["value"].values, jrf.fields[k]["value"].values,
                                   rtol=0, atol=1e-12)
        np.testing.assert_array_equal(samples[k][["x", "y"]].values, jsamples[k][["x", "y"]].values)
        np.testing.assert_allclose(samples[k][f"Z{k}"].values, jsamples[k][f"Z{k}"].values,
                                   rtol=0, atol=1e-12)
