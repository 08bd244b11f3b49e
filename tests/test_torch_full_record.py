"""The port's 71-month record workflow (``experiments/full_record.py``)
against the JAX package's ``examples/full_record.py``, on the CPU in
float64: the record's months as fields (a month missing from one process
skipped, the same exception types as the JAX package), their variograms,
and the batched WLS fit with the record's options (each month from its
own moment start, rho bounded at +-0.95, the Cauchy-Schwarz penalty at
weight 1, the parsimonious projection after it) on three months against
the JAX package's ``fit_wls_batch``. ``tests/test_torch_full_record_main.py``
runs the port's whole ``main`` at the script's CPU sizes."""

import json
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))

import modelling_comparison as JMC  # noqa: E402

from cokriging_tpu_torch.cov.params import ParamSpec  # noqa: E402
from cokriging_tpu_torch.estimate import wls as TW  # noqa: E402
from cokriging_tpu_torch.estimate.empirical import VarioConfig, empirical_variograms  # noqa: E402
from cokriging_tpu_torch.experiments import full_record as FR  # noqa: E402
from cokriging_tpu_torch.fields.field import MultiField  # noqa: E402

torch.set_num_threads(2)

MONTHS = 3  # the record's first three months
OPTIONS = dict(maxiter=300, validity_weight=1.0, per_month_init=True)


@pytest.fixture(scope="module")
def record():
    """The JAX package's frames of a 3-month record and its fields and
    variograms (as its script builds them), the port's fields and
    variograms of the same frames, and each package's batched fit of them
    with the record's options, unprojected and projected."""
    from cokriging_tpu.cov.params import ParamSpec as JSpec
    from cokriging_tpu.data.grids import main_coords_array as jmain
    from cokriging_tpu.estimate import VarioConfig as JConfig
    from cokriging_tpu.estimate import empirical_variograms as jemp
    from cokriging_tpu.estimate.wls import fit_wls_batch as jfit_batch
    from cokriging_tpu.estimate.wls import moment_init as jmoment
    from cokriging_tpu.fields import MultiField as JMultiField

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fx, fs = JMC.synthesize_conus_months(seed=0, months=MONTHS)
        mfs, stamps = FR.month_fields(fx, fs, torch.float64)
        ests = [empirical_variograms(mf, VarioConfig(max_dist=1.5e3, n_bins=15, n_procs=2),
                                     device="cpu") for mf in mfs]
        jmfs = [JMultiField.from_dataframes([fx, fs], ["xco2", "sif"], [["lon", "lat"], ["evi"]],
                                            timestamp=ts, timedeltas=[0, -1], main_coords=jmain())
                for ts in stamps]
        jests = [jemp(mf, JConfig(max_dist=1.5e3, n_bins=15, n_procs=2)) for mf in jmfs]
        jspec = JSpec(n_procs=2, rho_bounds=(-FR.RHO_BOUND, FR.RHO_BOUND))
        jfit = jfit_batch(jests, init=jmoment(jests[0], spec=jspec),
                          project_validity="parsimony", **OPTIONS)
        spec = ParamSpec(n_procs=2, rho_bounds=(-FR.RHO_BOUND, FR.RHO_BOUND))
        fit = TW.fit_wls_batch(ests, init=TW.moment_init(ests[0], spec=spec),
                               project_validity="parsimony", device="cpu", **OPTIONS)
    return dict(frames=(fx, fs), stamps=stamps, mfs=mfs, ests=ests, jmfs=jmfs, jests=jests,
                jfit=jfit, fit=fit, spec=spec)


def test_month_fields_and_variograms_match_jax(record):
    """Every month of the record (the first XCO2 month has no SIF month
    before it, so it is not a stamp), its fields and its variograms."""
    assert record["stamps"] == ["2019-02-01", "2019-03-01", "2019-04-01"]
    for mf, jmf in zip(record["mfs"], record["jmfs"]):
        for f, jf in zip(mf.fields, jmf.fields):
            np.testing.assert_allclose(f.values_main.numpy(), np.asarray(jf.values_main),
                                       rtol=0, atol=1e-10)
    for est, jest in zip(record["ests"], record["jests"]):
        np.testing.assert_array_equal(np.asarray(est.bin_counts), np.asarray(jest.bin_counts))
        for attr in ("bin_centers", "bin_means"):
            np.testing.assert_allclose(np.asarray(getattr(est, attr)),
                                       np.asarray(getattr(jest, attr)), rtol=1e-10, atol=1e-10)


def test_a_missing_month_raises_what_the_jax_package_raises(record):
    """A stamp whose SIF month (k - 1) is not in the record, and one past
    the record's end: the JAX script skips a month on KeyError or ValueError,
    and the port raises the same type in both cases; ``month_fields`` skips
    them."""
    from cokriging_tpu.fields import MultiField as JMultiField

    fx, fs = record["frames"]
    args = ([fx, fs], ["xco2", "sif"], [["lon", "lat"], ["evi"]])
    for stamp in ("2019-01-01", "2019-05-01"):
        with pytest.raises(Exception) as want:
            JMultiField.from_dataframes(*args, timestamp=stamp, timedeltas=[0, -1])
        with pytest.raises(Exception) as got:
            MultiField.from_dataframes(*args, timestamp=stamp, timedeltas=[0, -1])
        assert type(got.value) is type(want.value) and isinstance(got.value, (KeyError, ValueError))
    mfs, used = FR.month_fields(fx, fs, torch.float64, stamps=["2019-01-01", "2019-02-01",
                                                               "2019-05-01"])
    assert used == ["2019-02-01"] and len(mfs) == 1


def test_batched_fit_with_the_records_options_matches_jax(record):
    """The costs within 1e-6, the same converged flags, the rho track
    within 1e-3 and the projected flat vectors within 5e-3 of their size:
    each month starts at nu = 1.5, where the reference's CF2 dK/dnu jumps,
    so the two packages' 300-iteration trajectories part in the last places
    and end apart along the converged fits' flat directions (a nugget
    2.4e-3 apart at costs 1e-8 apart)."""
    (jp, jc, jconv), (tp, tc, tconv) = record["jfit"], record["fit"]
    assert len(tp) == MONTHS and tc.shape == (MONTHS,) and tconv.dtype == bool
    rho, jrho = (np.array([float(p.rho[0, 1]) for p in ps]) for ps in (tp, jp))
    np.testing.assert_allclose(rho, jrho, rtol=0, atol=1e-3)
    assert np.all(np.abs(rho) <= FR.RHO_BOUND)
    np.testing.assert_allclose(tc, np.asarray(jc), rtol=1e-6)
    np.testing.assert_array_equal(tconv, np.asarray(jconv))
    for a, b in zip(tp, jp):
        b = np.asarray(b.to_flat())
        np.testing.assert_allclose(a.to_flat().numpy(), b, rtol=5e-3, atol=1e-6)


def test_parsimony_projection_matches_jax(record, monkeypatch):
    """The port's projection of each month's fit equals the JAX package's
    ``project_to_valid(..., parsimony=True)`` of the same flat vector
    (1e-10): the fit itself is held above."""
    from cokriging_tpu.cov import MaternParams as JParams
    from cokriging_tpu.cov.spectral import project_to_valid

    ests, spec = record["ests"], record["spec"]
    xs = np.stack([np.asarray(p.to_flat()) for p in record["jfit"][0]])
    xs[:, 4] *= 0.8  # nu12 below the Gneiting floor, where the projection acts
    monkeypatch.setattr(TW, "fit_wls_batch_arrays",
                        lambda *a, **k: (xs, np.zeros(len(xs)), np.ones(len(xs), bool)))
    got, _, _ = TW.fit_wls_batch(ests, init=TW.moment_init(ests[0], spec=spec),
                                 project_validity="parsimony", device="cpu")
    for a, x in zip(got, xs):
        want = project_to_valid(JParams.from_flat(x, spec=None), parsimony=True)
        np.testing.assert_allclose(a.to_flat().numpy(), np.asarray(want.to_flat()), rtol=0,
                                   atol=1e-10)
        assert float(a.nu[0, 1]) >= 0.5 * float(a.nu[0, 0] + a.nu[1, 1]) - 1e-12


def test_jax_manifest_is_the_recorded_file():
    ref = json.loads((ROOT / "results" / "full_record.json").read_text())
    assert {k: ref[k] for k in FR.JAX_MANIFEST} == FR.JAX_MANIFEST
    assert FR.N_MONTHS == 71 == len(FR.JAX_MANIFEST["rho_track"])


def test_sizes(monkeypatch):
    monkeypatch.delenv("FULL_RECORD_MONTHS", raising=False)
    assert FR.sizes_for(torch.device("cpu")) == dict(months=8, n_pred_months=1, pred_stride=8)
    assert FR.sizes_for(torch.device("cuda")) == dict(months=71, n_pred_months=3, pred_stride=1)
    monkeypatch.setenv("FULL_RECORD_MONTHS", "5")
    assert FR.sizes_for(torch.device("cuda"))["months"] == 5
    assert FR.sizes_for(torch.device("cpu"), months=4)["months"] == 4
    with pytest.raises(TypeError):
        FR.sizes_for(torch.device("cpu"), maxiter=3)
