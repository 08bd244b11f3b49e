"""Simulation experiment: truth-model cokriging against kriging on a
simulated cofield (the reference's research/simulation_experiment.ipynb).

Counterpart of ``examples/simulation_experiment.py``, with its stages at its
sizes. It simulates a bivariate Gaussian cofield from known parameters on a
51 x 51 grid, samples it semi-colocated with measurement error (100 sites per
process), then:

- fits the parameters back by composite WLS (12 bins to 1.0), by the exact
  NLL (``fit_nll_device``: jitter 1e-8, maxiter 150) and by Vecchia (m = 15,
  maxiter 40, on the float64 fields), and requires the Vecchia fit's rho
  within 0.25 of the truth;
- predicts with the truth model (joint cokriging) and compares MSPE / MAPE
  against univariate kriging (error-ratio map);
- runs LOOCV and reports the 95% coverage of the standardized residuals.

The draw is the JAX script's realization: its normals come from the JAX
package's PRNG reproduced with numpy (``reference_draws``), so the truth
field and the sample equal the script's up to the Cholesky factors'
rounding, and the statistics compare with its manifest. Every stage after
the draw runs on ``device`` in the port's compute dtype
(``utils.config.compute_dtype``: float32 on the card, float64 on the CPU);
the draw and the Vecchia fit stay float64. The draw (``simulate``) and the
stages after it (``run``) are separate, so a caller can hand the stages any
sample. Output goes through ``utils.results`` under names of its own: the
manifest ``torch_simulation_experiment.json`` (statistics, stage seconds,
the card's name and power limit) and, where matplotlib is installed, figures
``torch_sim_*.png`` (``COKRIGING_RESULTS_DIR`` and ``COKRIGING_NO_RECORD``
apply).

    python -m cokriging_tpu_torch sim [--device cpu]
"""


import numpy as np
import torch

from cokriging_tpu_torch.experiments import Stages

# truth parameters (research/simulation_experiment.ipynb cell 3)
TRUTH = [1.0, 1.0, 1.5, 1.5, 1.5, 0.2, 0.2, 0.2, 0.0, 0.0, -0.6]
EPS = 0.1
# the fits' start and box (unit-square scale, not km)
INIT = [1.0, 1.0, 1.5, 1.5, 1.5, 0.1, 0.1, 0.1, 0.01, 0.01, 0.0]
SPEC_BOUNDS = dict(sigma_bounds=(0.1, 3.0), len_scale_bounds=(0.02, 1.0), nugget_bounds=(0.0, 0.5))
RHO_TOL = 0.25  # the Vecchia fit's |rho - truth| bound

#: the script's sizes
SIZES = dict(nx=51, sample_size=100, seed=42, sample_seed=7, n_bins=12, wls_maxiter=500,
             nll_maxiter=150, vecchia_m=15, vecchia_maxiter=40)


def simulate(nx=51, sample_size=100, seed=42, sample_seed=7, device=None):
    """The truth cofield on the nx x nx unit grid and its semi-colocated
    sample with measurement error EPS: (random field, per-process sample
    frames). The draws are the JAX script's (``reference_draws``: its
    PRNG reproduced), on the port's cofield (the covariance through the
    Matern kernel, its Cholesky factor on ``device``, float64)."""
    from cokriging_tpu_torch.cov.matern import MultivariateMatern
    from cokriging_tpu_torch.cov.params import MaternParams
    from cokriging_tpu_torch.experiments.reference_draws import ReferenceDrawField
    from cokriging_tpu_torch.sim import CartesianGrid

    mod = MultivariateMatern(params=MaternParams.from_flat(torch.tensor(TRUTH, dtype=torch.float64)))
    grid = CartesianGrid(xcount=nx, ycount=nx, device=device)
    rf = ReferenceDrawField(mod, grid, seed=seed, device=device)
    return rf, rf.sample(size=sample_size, epsilon=[EPS, EPS], seed=sample_seed)


def _flat(params):
    return params.to_flat().detach().cpu().numpy().astype(np.float64)


def run(rf, samples, device=None, n_bins=12, wls_maxiter=500, nll_maxiter=150, vecchia_m=15,
        vecchia_maxiter=40, stages=None):
    """The stages after the draw on ``rf``'s truth and ``samples``: the three
    fits, truth-model joint cokriging against kriging at every grid cell,
    LOOCV, and the figures (where matplotlib is installed; otherwise a
    printed notice and ``figures`` False in the statistics). Returns the
    statistics, unrounded: the fitted flats, ``mspe`` / ``mape`` of both
    predictors against the truth, ``loocv_coverage_95`` and
    ``loocv_z_std``. Raises when the Vecchia fit's rho misses the truth by
    ``RHO_TOL`` or more."""
    import importlib.util

    from cokriging_tpu_torch.cov.matern import MultivariateMatern
    from cokriging_tpu_torch.cov.params import MaternParams, ParamSpec
    from cokriging_tpu_torch.estimate.empirical import VarioConfig, empirical_variograms
    from cokriging_tpu_torch.estimate.nll import fit_nll_device
    from cokriging_tpu_torch.estimate.vecchia import fit_vecchia
    from cokriging_tpu_torch.estimate.wls import fit_wls
    from cokriging_tpu_torch.predict.joint import JointPredictor
    from cokriging_tpu_torch.utils.config import compute_dtype, resolve_device
    from cokriging_tpu_torch.utils.results import save_figure

    dev = resolve_device(device)
    stages = stages or Stages(dev)
    figures = importlib.util.find_spec("matplotlib") is not None
    if figures:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from cokriging_tpu_torch import plot
    else:
        print("figures not written: matplotlib is not installed", flush=True)

    def figure(draw, name, *args, **kw):
        if figures:
            fig = getattr(plot, draw)(*args, **kw)
            save_figure(fig, name)
            plt.close(fig)

    figure("plot_samples", "torch_sim_samples", samples)
    # the zero-nugget draw needed float64; the stages after it run in the
    # compute dtype, the small-n Vecchia fit in float64 (its rho axis stalls
    # on float32 gradient noise at this n)
    dtype = compute_dtype(dev)
    mf_f64 = rf.to_fields(samples)
    mf = mf_f64.astype(dtype)
    mod_truth = MultivariateMatern(params=rf.mod.params.astype(dtype))
    spec = ParamSpec(2, **SPEC_BOUNDS)
    init = MaternParams.from_flat(torch.tensor(INIT, dtype=torch.float64), spec=spec)

    est = empirical_variograms(mf, VarioConfig(max_dist=1.0, n_bins=n_bins, geodesic=False),
                               device=dev)
    p_wls, res_wls = fit_wls(est, init=init, maxiter=wls_maxiter, device=dev)
    figure("plot_variograms", "torch_sim_variograms", res_wls, names=["Z0", "Z1"])
    print("WLS fit:  ", np.round(_flat(p_wls), 3).tolist())
    stages("WLS fit")

    p_nll, info = fit_nll_device(mf, init=init, jitter=1e-8, maxiter=nll_maxiter, device=dev)
    print("NLL fit:  ", np.round(_flat(p_nll), 3).tolist())
    print("truth:    ", TRUTH, f"(NLL {info['nll']:.2f}, {info['n_iter']} iters)")
    stages("exact NLL fit")

    p_vec, info_v = fit_vecchia(mf_f64, init=init, m=vecchia_m, maxiter=vecchia_maxiter,
                                main=False, device=dev)
    rho_vec = float(p_vec.rho[0, 1])
    print("Vecchia:  ", np.round(_flat(p_vec), 3).tolist(),
          f"(m={info_v['m']}, nll {info_v['nll']:.2f})")
    if not abs(rho_vec - TRUTH[-1]) < RHO_TOL:
        raise AssertionError(f"Vecchia fit's rho {rho_vec:.4f} misses the truth {TRUTH[-1]} by "
                             f"{RHO_TOL} or more")
    stages("Vecchia fit")

    pcoords = rf.coords.values
    jp = JointPredictor(mod_truth, mf, device=dev)
    pred_biv = jp(0, pcoords, postprocess=False)
    figure("plot_sim_pred", "torch_sim_prediction", rf, pred_biv)
    truth_vals = rf.fields[0]["value"].values
    diff = truth_vals - pred_biv.pred
    print(f"cokriging MSPE {np.nanmean(diff**2):.4f}  MAPE {np.nanmean(np.abs(diff)):.4f}")
    stages("joint cokriging")

    mod_uni = MultivariateMatern(1, MaternParams.from_flat(
        torch.tensor([TRUTH[0], TRUTH[2], TRUTH[5], TRUTH[8]], dtype=dtype),
        spec=ParamSpec(n_procs=1)))
    pred_uni = JointPredictor(mod_uni, rf.to_fields(samples, i=0).astype(dtype), device=dev)(
        0, pcoords, postprocess=False)
    diff_u = truth_vals - pred_uni.pred
    print(f"kriging   MSPE {np.nanmean(diff_u**2):.4f}  MAPE {np.nanmean(np.abs(diff_u)):.4f}")
    figure("plot_err_ratio", "torch_sim_err_ratio", pred_biv, pred_uni)

    cv = jp.cross_validation(0, postprocess=True)
    z = (cv["residual"] / cv["pred_err"]).replace([np.inf, -np.inf], np.nan).dropna()
    cover = float((np.abs(z) < 1.96).mean())
    print(f"LOOCV 95% coverage: {cover:.3f} (z std {z.std():.3f})")
    figure("plot_cv_resid", "torch_sim_loocv", cv, "Z0")
    stages("LOOCV + figures")
    return {
        "truth_flat": TRUTH,
        "wls_flat": _flat(p_wls).tolist(),
        "nll_flat": _flat(p_nll).tolist(),
        "vecchia_flat": _flat(p_vec).tolist(),
        "mspe": {"cokriging": float(np.nanmean(diff**2)), "kriging": float(np.nanmean(diff_u**2))},
        "mape": {"cokriging": float(np.nanmean(np.abs(diff))),
                 "kriging": float(np.nanmean(np.abs(diff_u)))},
        "loocv_coverage_95": cover,
        "loocv_z_std": float(z.std()),
        "vecchia_rho_gap": abs(rho_vec - TRUTH[-1]),
        "dtype": str(dtype).replace("torch.", ""),
        "figures": figures,
    }


def main(device=None, **sizes):
    """The experiment on ``device`` (the card unless ``device="cpu"``) at the
    script's sizes (``SIZES``; any of them as keywords): the draw, ``run``,
    and the manifest ``torch_simulation_experiment``. Returns (random field,
    samples, statistics)."""
    from cokriging_tpu_torch.utils.config import resolve_device
    from cokriging_tpu_torch.utils.results import record_manifest

    unknown = set(sizes) - set(SIZES)
    if unknown:
        raise TypeError(f"unknown sizes {sorted(unknown)}; the sizes are {sorted(SIZES)}")
    s = {**SIZES, **sizes}
    dev = resolve_device(device)
    stages = Stages(dev)
    rf, samples = simulate(s["nx"], s["sample_size"], s["seed"], s["sample_seed"], device=dev)
    stages("simulate + sample")
    stats = run(rf, samples, dev, s["n_bins"], s["wls_maxiter"], s["nll_maxiter"],
                s["vecchia_m"], s["vecchia_maxiter"], stages)

    def rounded(v, k=4):
        return [round(float(x), k) for x in v]

    record_manifest("torch_simulation_experiment", {
        "sizes": s,
        "dtype": stats["dtype"],
        "figures": stats["figures"],
        "truth_flat": TRUTH,
        "wls_flat": rounded(stats["wls_flat"]),
        "nll_flat": rounded(stats["nll_flat"]),
        "vecchia_flat": rounded(stats["vecchia_flat"]),
        "vecchia_rho_gap": round(stats["vecchia_rho_gap"], 4),
        "mspe": {k: round(v, 4) for k, v in stats["mspe"].items()},
        "loocv_coverage_95": round(stats["loocv_coverage_95"], 3),
        "loocv_z_std": round(stats["loocv_z_std"], 3),
        "stage_s": {k: round(v, 3) for k, v in stages.seconds.items()},
        "wall_total_s": round(sum(stages.seconds.values()), 1),
    })
    return rf, samples, stats


if __name__ == "__main__":
    main()
