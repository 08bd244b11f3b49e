"""Trivariate cokriging: three co-varying processes end to end.

Counterpart of ``examples/trivariate_demo.py`` (``main``), with its truth,
its sizes and its stages, at p = 3 (21 parameters, six (cross-)variogram
groups, a 3 x 3-block joint covariance):

1. simulate the trivariate Matern cofield (rho = -0.6, 0.4, -0.2) on a
   41 x 41 grid of the unit square (a 5,043^2 joint covariance, one
   Cholesky) and sample 280 observations per process, semi-colocated, with
   measurement error eps = 0.1;
2. the six empirical (cross-)variograms (12 bins to 0.6, Euclidean) of three
   sample draws (seeds 11, 12, 13), pooled: their means averaged and their
   counts summed;
3. the moment initializer, then the composite WLS fit by scipy's L-BFGS-B
   (maxiter 400) over the 21 parameters;
4. cokrige process 1 (SIF) at every third grid cell from all three
   processes with the true model (``JointPredictor``), and krige it from
   its own data alone (the p = 1 baseline);
5. where ``local`` is set (the script's ``TRIVARIATE_DEMO_LOCAL=1``), the
   local predictor at radius 0.5 against the joint solution.

``recovery`` is tests/test_trivariate.py's parameter recovery on its own
data: the truth's 3 x 3-block covariance on a 31 x 31 grid, four numpy
draws (seed 7) observed at every cell, their six variograms (12 bins to
0.5) pooled, the moment initializer and the same WLS fit.

The gates: ``main`` holds the script's (cokriging's MSPE at most 1.02 times
kriging's) and the prediction gates of tests/test_trivariate.py (the joint
MSPE below 0.3; the local predictions finite, their MSPE within 0.05 of the
joint one); ``recovery`` holds the test's fit gates (the fitted rho with
the true signs and within 0.25, sigma within 0.3 of 1, the diagonal length
scales within 0.1 of 0.2) on the data they were written for. The demo's own
fit (three draws of 280 samples) is recorded against those bars but not
held to them: the JAX package's fit of the same draw misses them as well
(rho_12 of the wrong sign; ``tools/torch_trivariate_fits.py`` runs both
packages' fits).

The draw is the JAX script's: ``ReferenceDrawField`` takes the JAX
simulator's normals (``PRNGKey(seed)`` for the cofield, a split of
``PRNGKey(sample seed + 1)`` per process for the noise), the locations
numpy's generator. Everything runs in float64, the JAX demo's dtype, on
``device``: on the card the variograms go through ``variogram.cu`` (one
launch per pass over all six), every covariance block through
``matern.cu``.

Sizes: ``CARD_SIZES`` on the card, ``CPU_SIZES`` on the CPU (both the
script's); the environment knob ``TRIVARIATE_DEMO_LOCAL`` sets ``local``,
and keyword arguments of ``main`` override both. The manifest
``torch_trivariate_demo.json`` and, where matplotlib is installed, the
figures ``torch_trivariate_*.png`` go through ``utils.results``
(``COKRIGING_RESULTS_DIR`` and ``COKRIGING_NO_RECORD`` apply).

    python -m cokriging_tpu_torch.experiments.trivariate_demo [--device cuda|cpu]

runs ``main``, then ``recovery``.
"""

import argparse
import importlib.util

import numpy as np
import torch

from cokriging_tpu_torch.experiments import Stages, resolve_sizes

# flat order for p = 3: sigma(3), nu(6), len_scale(6), nugget(3), rho(01, 02, 12)
TRUE_RHO = (-0.6, 0.4, -0.2)
TRUTH = [1.0, 1.0, 1.0] + [1.5] * 6 + [0.2] * 6 + [0.05] * 3 + list(TRUE_RHO)
BOUNDS = dict(len_scale_bounds=(0.02, 2.0), sigma_bounds=(0.2, 3.0))
EPS = 0.1
NAMES = ["XCO2", "SIF", "EVI"]
SEEDS = (11, 12, 13)  # the cofield's seed, then the pooled sample draws
N_BINS, MAX_DIST, PRED_STRIDE, LOCAL_MAX_DIST = 12, 0.6, 3, 0.5  # the script's
# tests/test_trivariate.py's recovery: grid side, numpy seed, draws, bins to
# RECOVERY_MAX_DIST (N_BINS of them), the fit's maxiter
RECOVERY_GRID, RECOVERY_SEED, RECOVERY_REPS, RECOVERY_MAX_DIST, RECOVERY_MAXITER = 31, 7, 4, 0.5, 400

#: the script's sizes, on the card and on the CPU alike
CARD_SIZES = dict(grid=41, size=280, maxiter=400, local=0)
CPU_SIZES = CARD_SIZES
ENV = dict(local="TRIVARIATE_DEMO_LOCAL")


def sizes_for(device, **sizes) -> dict:
    """The run's sizes on ``device``: the script's, its environment knob
    over them, then ``sizes``."""
    return resolve_sizes(device, CARD_SIZES, CPU_SIZES, sizes, ENV)


def simulate(grid_n, device):
    """The truth model, the trivariate cofield on the grid_n x grid_n grid
    of the unit square (the JAX script's draw, seed 11) and the spec:
    (model, random field, spec)."""
    from cokriging_tpu_torch.cov.matern import MultivariateMatern
    from cokriging_tpu_torch.cov.params import MaternParams, ParamSpec
    from cokriging_tpu_torch.experiments.reference_draws import ReferenceDrawField
    from cokriging_tpu_torch.sim import CartesianGrid

    spec = ParamSpec(n_procs=3, **BOUNDS)
    truth = MaternParams.from_flat(torch.tensor(TRUTH, dtype=torch.float64), spec=spec)
    model = MultivariateMatern(params=truth)
    grid = CartesianGrid(xcount=grid_n, ycount=grid_n, device=device)
    return model, ReferenceDrawField(model, grid, seed=SEEDS[0], device=device), spec


def pooled_variograms(rf, size, device):
    """The six empirical (cross-)variograms of the three sample draws
    (``SEEDS``; ``N_BINS`` bins to ``MAX_DIST``), pooled (``pool``)."""
    from cokriging_tpu_torch.estimate.empirical import VarioConfig, empirical_variograms

    cfg = VarioConfig(max_dist=MAX_DIST, n_bins=N_BINS, geodesic=False)
    return pool([empirical_variograms(rf.to_fields(rf.sample(size=size, epsilon=(EPS,), seed=s)),
                                      cfg, device=device)
                 for s in SEEDS])


def pool(ests):
    """Estimates of several draws pooled as the script and
    tests/test_trivariate.py pool them: the first one, with the draws' mean
    bin means and summed bin counts."""
    est = ests[0]
    est.bin_means = np.mean([e.bin_means for e in ests], axis=0)
    est.bin_counts = np.sum([e.bin_counts for e in ests], axis=0)
    return est


def fit(est, maxiter, device):
    """The script's and the test's fit of a pooled p = 3 estimate: the
    moment initializer, then the composite WLS fit by scipy's L-BFGS-B
    (``maxiter``) over the 21 parameters in ``BOUNDS``. Returns (init,
    params, result)."""
    from cokriging_tpu_torch.cov.params import ParamSpec
    from cokriging_tpu_torch.estimate.wls import fit_wls, moment_init

    if not (est.config.n_procs == 3 and len(est.pairs) == 6):
        raise AssertionError(f"{est.config.n_procs} processes, pairs {est.pairs}")
    init = moment_init(est, spec=ParamSpec(n_procs=3, **BOUNDS))
    params, result = fit_wls(est, init=init, method="scipy", maxiter=maxiter, device=device)
    return init, params, result


def univariate_model(truth):
    """The p = 1 baseline: process 1's own sigma, nu, length scale and
    nugget from the truth."""
    from cokriging_tpu_torch.cov.matern import MultivariateMatern
    from cokriging_tpu_torch.cov.params import MaternParams

    flat = [float(truth.sigma[1]), float(truth.nu[1, 1]), float(truth.len_scale[1, 1]),
            float(truth.nugget[1])]
    return MultivariateMatern(
        params=MaternParams.default(1).with_flat(torch.tensor(flat, dtype=torch.float64)))


def _figures(samples, result):
    """The script's two figures, as ``torch_trivariate_*``, where
    matplotlib is installed. Returns whether they were written."""
    if importlib.util.find_spec("matplotlib") is None:
        print("figures not written: matplotlib is not installed", flush=True)
        return False
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from cokriging_tpu_torch.plot import plot_samples, plot_variograms
    from cokriging_tpu_torch.utils.results import save_figure

    for name, fig in (("torch_trivariate_samples", plot_samples(samples, titles=NAMES)),
                      ("torch_trivariate_variograms", plot_variograms(result, names=NAMES))):
        save_figure(fig, name)
        plt.close(fig)
    return True


def recovery_draws(device):
    """tests/test_trivariate.py's data: the truth's 3 x 3-block covariance
    on the ``RECOVERY_GRID`` x ``RECOVERY_GRID`` grid of the unit square
    (``block_covariance`` on ``device``, float64), its numpy Cholesky factor
    and ``RECOVERY_REPS``
    draws from numpy's generator (``RECOVERY_SEED``), observed at every
    cell: (coordinates, [[z0, z1, z2] per draw])."""
    from cokriging_tpu_torch.cov.matern import block_covariance
    from cokriging_tpu_torch.cov.params import MaternParams, ParamSpec
    from cokriging_tpu_torch.sim import CartesianGrid

    truth = MaternParams.from_flat(torch.tensor(TRUTH, dtype=torch.float64),
                                   spec=ParamSpec(n_procs=3, **BOUNDS)).to(device=device)
    grid = CartesianGrid(xcount=RECOVERY_GRID, ycount=RECOVERY_GRID, device=device)
    d, n = grid.dist, grid.count
    with torch.no_grad():
        chol = np.linalg.cholesky(block_covariance(truth, [[d, d, d]] * 3, h_grad=False).cpu().numpy())
    rng = np.random.default_rng(RECOVERY_SEED)
    reps = []
    for _ in range(RECOVERY_REPS):
        z = chol @ rng.normal(size=3 * n)
        reps.append([z[:n], z[n: 2 * n], z[2 * n:]])
    return np.column_stack([grid.coords["x"].values, grid.coords["y"].values]), reps


def recovery_estimate(device):
    """The six variograms (``N_BINS`` bins to ``RECOVERY_MAX_DIST``) of
    each of the ``recovery_draws``, pooled (``pool``)."""
    from cokriging_tpu_torch.estimate.empirical import VarioConfig, empirical_variograms
    from cokriging_tpu_torch.fields.field import Field, MultiField

    coords, reps = recovery_draws(device)
    cfg = VarioConfig(max_dist=RECOVERY_MAX_DIST, n_bins=N_BINS, geodesic=False)
    return pool([empirical_variograms(MultiField(fields=[Field.from_arrays(coords, z, f"Z{k}")
                                                         for k, z in enumerate(zs)]), cfg, device=device)
                 for zs in reps])


def fit_summary(params, result):
    """A fit's flat vector, WLS cost, rho (01, 02, 12), sigma and diagonal
    length scales."""
    flat = params.to_flat().detach().cpu().numpy().astype(np.float64)
    return {"fitted_flat": flat.tolist(), "wls_cost": float(result.cost),
            "rho": params.rho.detach().cpu().numpy()[[0, 0, 1], [1, 2, 2]].tolist(),
            "sigma": params.sigma.detach().cpu().numpy().tolist(),
            "len_scale_diag": params.len_scale.detach().cpu().numpy()[[0, 1, 2], [0, 1, 2]].tolist()}


def fit_gates(summary):
    """tests/test_trivariate.py's fit gates on a ``fit_summary``: {gate:
    passed}."""
    rho, truth = np.asarray(summary["rho"]), np.asarray(TRUE_RHO)
    return {
        "rho signs": bool(np.all(np.sign(rho) == np.sign(truth))),
        "rho within 0.25": bool(np.all(np.abs(rho - truth) <= 0.25)),
        "sigma within 0.3 of 1": bool(np.all(np.abs(np.asarray(summary["sigma"]) - 1.0) <= 0.3)),
        "diagonal length scales within 0.1 of 0.2":
            bool(np.all(np.abs(np.asarray(summary["len_scale_diag"]) - 0.2) <= 0.1)),
    }




def gates(record):
    """The prediction gates ``main`` holds on its record: {gate: passed}.
    The script's and tests/test_trivariate.py's, the local ones where the
    local predictor ran."""
    out = {
        "cokriging MSPE <= 1.02 kriging MSPE": record["mspe_tri"] <= 1.02 * record["mspe_uni"],
        "joint MSPE < 0.3": record["mspe_tri"] < 0.3,
    }
    if record["local"]:
        out["local predictions finite"] = record["local_finite_frac"] == 1.0
        out["local MSPE within 0.05 of the joint"] = abs(
            record["mspe_local"] - record["mspe_tri"]) <= 0.05
    return out


def main(device=None, stages=None, **sizes):
    """The demo on ``device`` (the card unless ``device="cpu"``) at the
    script's sizes (``sizes_for``; any of ``CARD_SIZES``' keys as
    keywords). ``stages``: a ``Stages`` on that device, or None for a new
    one. Raises AssertionError where a gate fails (``gates``). Returns the
    run's record: the fit (``fit_summary``) and where it stands against
    tests/test_trivariate.py's bars, the MSPEs, the mean pred-err ratio,
    the local-vs-joint MSD, the gates, the stage seconds, launches and peak
    memory."""
    from cokriging_tpu_torch.fields.field import MultiField
    from cokriging_tpu_torch.predict.joint import JointPredictor
    from cokriging_tpu_torch.predict.local import LocalPredictor
    from cokriging_tpu_torch.utils.config import resolve_device
    from cokriging_tpu_torch.utils.results import record_manifest

    dev = resolve_device(device)
    s = sizes_for(dev, **sizes)
    stages = stages or Stages(dev)
    print(f"backend={dev.type} dtype=float64 grid={s['grid']}x{s['grid']} size={s['size']} "
          f"local={s['local']}", flush=True)

    # 1. simulate the truth and sample it
    model, rf, spec = simulate(s["grid"], dev)
    samples = rf.sample(size=s["size"], epsilon=(EPS,))
    mf = rf.to_fields(samples)
    stages("simulate")

    # 2. the six (cross-)variogram groups of three draws, pooled
    est = pooled_variograms(rf, s["size"], dev)
    stages("variograms")

    # 3. moment init, then the composite WLS fit
    init, params, result = fit(est, s["maxiter"], dev)
    stages("fit_wls")
    fitted = fit_summary(params, result)
    print("true rho :", np.round(TRUE_RHO, 3))
    print("fitted   :", np.round(fitted["rho"], 3))

    # 4. cokrige SIF (process 1) from all three; krige it from its own data
    pc = rf.coords.values[::PRED_STRIDE]
    tv = rf.truth_at(1, pc)
    tri = JointPredictor(model, mf, device=dev)(1, pc, postprocess=False)
    stages("joint_prediction")
    uni = JointPredictor(univariate_model(model.params), MultiField(fields=[mf.fields[1]]),
                         device=dev)(0, pc, postprocess=False)
    stages("univariate_baseline")
    mspe_tri = float(np.mean((tri.pred - tv) ** 2))
    mspe_uni = float(np.mean((uni.pred - tv) ** 2))
    err_ratio = float(np.mean(tri.pred_err) / np.mean(uni.pred_err))
    print(f"MSPE trivariate cokriging: {mspe_tri:.4f}")
    print(f"MSPE univariate kriging  : {mspe_uni:.4f}")
    print(f"mean pred-err ratio (tri/uni): {err_ratio:.3f}")

    # 5. the local predictor against the exact joint solution
    record_local = {}
    if s["local"]:
        loc = LocalPredictor(model, mf, device=dev)(1, pc, max_dist=LOCAL_MAX_DIST, postprocess=False)
        stages("local_prediction")
        gap = float(np.mean((loc.pred - tri.pred) ** 2))
        print(f"local-vs-joint MSD (wide radius): {gap:.5f}")
        record_local = {"local_vs_joint_msd": gap,
                        "local_finite_frac": float(np.isfinite(loc.pred).mean()),
                        "mspe_local": float(np.mean((loc.pred - tv) ** 2)),
                        "mean_neighbourhood": float(np.mean(loc.n_neighbors))}
    figures = _figures(samples, result)
    stages.skip()

    record = {
        "dtype": "float64",
        "sizes": s,
        "local": bool(s["local"]),
        "truth_flat": TRUTH,
        "init_flat": init.to_flat().detach().cpu().numpy().tolist(),
        **fitted,
        "param_names": list(spec.names()),
        "demo_fit_against_test_bars": fit_gates(fitted),
        "n_pred": int(len(pc)),
        "mspe_tri": mspe_tri,
        "mspe_uni": mspe_uni,
        "err_ratio": err_ratio,
        **record_local,
        "figures": figures,
        "stage_s": dict(stages.seconds),
        "launches": dict(stages.launches),
        "peak_mib": dict(stages.peak_mib),
        "wall_total_s": sum(stages.seconds.values()),
    }
    record["gates"] = gates(record)
    record_manifest("torch_trivariate_demo", record)
    failed = [k for k, ok in record["gates"].items() if not ok]
    if failed:
        raise AssertionError(f"gates failed: {failed} (MSPE {mspe_tri:.4f} / {mspe_uni:.4f})")
    return record


def recovery(device=None, stages=None):
    """tests/test_trivariate.py's parameter recovery on ``device`` (the
    card unless ``device="cpu"``): ``recovery_estimate`` at the test's
    sizes, then ``fit`` (maxiter ``RECOVERY_MAXITER``), as one stage,
    ``recovery_fit``, of ``stages`` (a new ``Stages`` if None). Raises
    AssertionError where a fit gate fails (``fit_gates``). Returns the
    fit's ``fit_summary`` with its gates and the stage's seconds and
    launches."""
    from cokriging_tpu_torch.utils.config import resolve_device

    dev = resolve_device(device)
    stages = stages or Stages(dev)
    _, params, result = fit(recovery_estimate(dev), RECOVERY_MAXITER, dev)
    stages("recovery_fit")
    record = fit_summary(params, result)
    print("recovery fit (tests/test_trivariate.py's data): rho", np.round(record["rho"], 3), "sigma",
          np.round(record["sigma"], 3), "diagonal length scales",
          np.round(record["len_scale_diag"], 3), flush=True)
    record.update(gates=fit_gates(record), stage_s=stages.seconds["recovery_fit"],
                  launches=stages.launches["recovery_fit"])
    failed = [k for k, ok in record["gates"].items() if not ok]
    if failed:
        raise AssertionError(f"recovery gates failed: {failed} (rho {record['rho']}, sigma "
                             f"{record['sigma']}, diagonal l {record['len_scale_diag']})")
    return record


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    device = ap.parse_args().device
    main(device)
    recovery(device)
