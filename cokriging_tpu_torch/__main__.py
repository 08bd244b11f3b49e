"""Command line: ``python -m cokriging_tpu_torch <command>``.

The staged-table workflow of ``python -m cokriging_tpu``, with the same
arguments, defaults, output files and printed summaries:

    fit        fit one month of staged tables (WLS, exact NLL or Vecchia) and
               save the parameters (.npz, readable by either package)
    predict    cokrige a fitted month onto the 0.5-degree land grid (local
               neighborhoods, or exact joint: dense or matrix-free CG)
    loocv      leave-one-out cross-validation diagnostics
               (MSPE/MAPE/coverage; local or joint predictor)

``fit --bootstrap N`` adds the parametric bootstrap of a WLS fit
(``<out>.bootstrap.csv``), ``fit --std-errors`` the standard errors from
the exact NLL's Hessian (``<out>.std_errors.csv``), ``predict --joint
--conditional-sims N`` the conditional realizations (``<out>.samples.npz``).
``--device`` (default ``cuda``) picks where the work runs; ``--device cpu``
runs on the host. ``sim`` and ``bench`` need modules the port does not have
yet and stop with an error that names the ROADMAP item that ports them.
"""

import argparse
import sys

_NOT_YET = {
    "sim": "the simulation experiment writes figures, which need the port's plot/ "
           "(ROADMAP.md Queue 1 item 13); its simulators are ported (sim/)",
    "bench": "the port's benchmark script is a benchmark PR's work (ROADMAP.md Queue 1, "
             "note for a benchmark PR)",
}


def _add_data_args(p, with_params=False):
    p.add_argument("--data", nargs="+", required=True, metavar="DATASET",
                   help="one staged table per process (e.g. XCO2 SIF)")
    if with_params:
        p.add_argument("--params", required=True)
    p.add_argument("--timestamp", required=True)
    p.add_argument("--timedeltas", nargs="+", type=int, default=None,
                   help="per-process month offsets (default: 0 -1 for two "
                        "processes, all zeros otherwise)")
    p.add_argument("--device", default="cuda",
                   help="device the work runs on (default cuda; cpu for the host)")


def _parser():
    parser = argparse.ArgumentParser(prog="cokriging_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    sub.add_parser("sim", help="run the simulation validation experiment (not ported yet)")
    sub.add_parser("bench", help="run the north-star benchmark (not ported yet)")

    p_fit = sub.add_parser("fit", help="fit one month of staged data by WLS")
    _add_data_args(p_fit)
    p_fit.add_argument("--max-dist", type=float, default=1.5e3,
                       help="variogram range cutoff, km (--method wls only)")
    p_fit.add_argument("--n-bins", type=int, default=15,
                       help="variogram bin count (--method wls only)")
    p_fit.add_argument("--method", choices=["wls", "nll", "vecchia"], default="wls",
                       help="estimator: composite variogram WLS (the reference's), "
                            "exact Gaussian NLL, or the Vecchia-approximation NLL "
                            "(large n)")
    p_fit.add_argument("--m-neighbors", type=int, default=30,
                       help="Vecchia conditioning-set size")
    p_fit.add_argument("--maxiter", type=int, default=200)
    p_fit.add_argument("--project-validity", action="store_true",
                       help="project the fitted optimum (any --method) onto the exact "
                            "spectral validity region (guarantees a PD joint covariance "
                            "for prediction; pairwise Gneiting bound)")
    p_fit.add_argument("--bootstrap", type=int, default=0, metavar="N",
                       help="(--method wls) parametric bootstrap of N replicates "
                            "(per-parameter SEs + percentile CIs -> <out>.bootstrap.csv)")
    p_fit.add_argument("--std-errors", action="store_true",
                       help="asymptotic standard errors from the exact-NLL Hessian "
                            "(not ported yet)")
    p_fit.add_argument("--out", default="params.npz")

    p_pred = sub.add_parser("predict", help="cokrige a fitted month")
    _add_data_args(p_pred, with_params=True)
    p_pred.add_argument("--process", type=int, default=1)
    p_pred.add_argument("--max-dist", type=float, default=1e3)
    p_pred.add_argument("--pred-grid", default=None,
                        help="staged table of prediction locations (lat/lon columns); "
                             "default: the 0.5-degree CONUS land grid")
    p_pred.add_argument("--joint", action="store_true",
                        help="exact joint cokriging (one global system, "
                             "src/joint_prediction.py) instead of the local-neighborhood "
                             "predictor")
    p_pred.add_argument("--solver", choices=["dense", "cg"], default="dense",
                        help="(--joint) dense Cholesky factorization, or the matrix-free "
                             "CG solver (predict/iterative.py) for observation counts past "
                             "one card's O(N^2) covariance memory")
    p_pred.add_argument("--conditional-sims", type=int, default=0, metavar="N",
                        help="(--joint) also draw N conditional-simulation realizations "
                             "from the full posterior -> <out>.samples.npz")
    p_pred.add_argument("--seed", type=int, default=0,
                        help="PRNG seed for --conditional-sims")
    p_pred.add_argument("--out", default="predictions.parquet")

    p_cv = sub.add_parser("loocv",
                          help="leave-one-out cross-validation diagnostics for a fitted month")
    _add_data_args(p_cv, with_params=True)
    p_cv.add_argument("--process", type=int, default=1)
    p_cv.add_argument("--predictor", choices=["local", "joint"], default="local",
                      help="local-neighborhood LOOCV (self-datum withheld by d > 0, "
                           "src/point_prediction.py:303-346) or exact joint LOOCV "
                           "(one-factorization precision identity, "
                           "src/joint_prediction.py:207-257)")
    p_cv.add_argument("--max-dist", type=float, default=1e3,
                      help="neighborhood radius, km (--predictor local)")
    p_cv.add_argument("--out", default="loocv.parquet")
    return parser


def _multifield(parser, args):
    """The MultiField of the staged tables: each table's data column named
    by its ``<name>_var`` column (else the first non-coordinate column),
    lon/lat as covariates, the 4 x 5-degree base grid as the main grid."""
    from cokriging_tpu_torch.data.grids import main_coords_array
    from cokriging_tpu_torch.fields.field import MultiField
    from cokriging_tpu_torch.utils.io import load_table

    dfs = [load_table(p) for p in args.data]
    if args.timedeltas is None:
        args.timedeltas = [0, -1] if len(dfs) == 2 else [0] * len(dfs)
    if len(args.timedeltas) != len(dfs):
        parser.error("--timedeltas must give one offset per --data table")
    names = []
    for df in dfs:
        var_cols = [c for c in df.columns if c.endswith("_var")]
        names.append(var_cols[0][: -len("_var")] if var_cols else
                     [c for c in df.columns if c not in ("time", "lat", "lon")][0])
    return MultiField.from_dataframes(dfs, names, [["lon", "lat"]] * len(dfs),
                                      timestamp=args.timestamp,
                                      timedeltas=list(args.timedeltas),
                                      main_coords=main_coords_array())


def _fit(args, mf):
    from cokriging_tpu_torch.utils.io import save_params

    if args.method == "wls":
        from cokriging_tpu_torch.estimate.empirical import VarioConfig, empirical_variograms
        from cokriging_tpu_torch.estimate.wls import fit_wls, moment_init

        est = empirical_variograms(mf, VarioConfig(max_dist=args.max_dist, n_bins=args.n_bins),
                                   device=args.device)
        params, result = fit_wls(est, init=moment_init(est), maxiter=args.maxiter,
                                 project_validity=args.project_validity, device=args.device)
        quality = f"cost {result.cost:.6g}"
    elif args.method == "nll":
        from cokriging_tpu_torch.estimate.nll import fit_nll

        params, info = fit_nll(mf, maxiter=args.maxiter, device=args.device)
        quality = f"nll {info['nll']:.6g}"
    else:
        from cokriging_tpu_torch.estimate.vecchia import fit_vecchia

        params, info = fit_vecchia(mf, m=args.m_neighbors, maxiter=args.maxiter,
                                   device=args.device)
        quality = f"vecchia nll {info['nll']:.6g} (m={info['m']})"
    if args.method != "wls" and args.project_validity:
        # fit_wls projects inside; the likelihood fits are projected here, so
        # the flag means the same for every --method
        from cokriging_tpu_torch.cov.spectral import project_to_valid

        params = project_to_valid(params)
    save_params(args.out, params, metadata={"timestamp": args.timestamp})
    print(params.to_dataframe().to_string(index=False))
    print(f"{quality} -> {args.out}")
    if args.bootstrap:
        from cokriging_tpu_torch.cov.matern import MultivariateMatern
        from cokriging_tpu_torch.estimate.bootstrap import parametric_bootstrap
        from cokriging_tpu_torch.estimate.empirical import VarioConfig

        boot = parametric_bootstrap(
            MultivariateMatern(params=params), mf,
            VarioConfig(max_dist=args.max_dist, n_bins=args.n_bins), n_rep=args.bootstrap,
            maxiter=args.maxiter, main=True, device=args.device,
        )
        bdf = boot.summary()
        bdf.to_csv(f"{args.out}.bootstrap.csv", index=False)
        print(bdf.to_string(index=False))
        print(f"bootstrap ({args.bootstrap} replicates) -> {args.out}.bootstrap.csv")
    if args.std_errors:
        from cokriging_tpu_torch.estimate.uncertainty import nll_std_errors

        sedf = nll_std_errors(params, mf, device=args.device)
        sedf.to_csv(f"{args.out}.std_errors.csv", index=False)
        print(sedf.to_string(index=False))
        print(f"NLL-Hessian standard errors -> {args.out}.std_errors.csv")


def _predict(args, mf):
    import numpy as np

    from cokriging_tpu_torch.cov.matern import MultivariateMatern
    from cokriging_tpu_torch.data.grids import prediction_coords
    from cokriging_tpu_torch.utils.io import load_params, load_table, save_table

    mod = MultivariateMatern(params=load_params(args.params))
    if args.pred_grid is not None:
        pgrid = load_table(args.pred_grid)[["lat", "lon"]]
    else:
        pgrid = prediction_coords()
    if args.joint:
        if args.solver == "cg":
            from cokriging_tpu_torch.predict.iterative import IterativeJointPredictor

            jp = IterativeJointPredictor(mod, mf, device=args.device)
        else:
            from cokriging_tpu_torch.predict.joint import JointPredictor

            jp = JointPredictor(mod, mf, device=args.device)
        if args.conditional_sims:
            out, samples = jp.sample(args.process, pgrid, n_samples=args.conditional_sims,
                                     seed=args.seed)
            np.savez_compressed(f"{args.out}.samples.npz", samples=samples)
            print(f"{args.conditional_sims} conditional realizations -> {args.out}.samples.npz")
        else:
            out = jp(args.process, pgrid, postprocess=False)
    else:
        from cokriging_tpu_torch.predict.local import LocalPredictor

        out = LocalPredictor(mod, mf, device=args.device)(
            args.process, pgrid, max_dist=args.max_dist, postprocess=False)
    out = out.to_dataframe()
    save_table(args.out, out)
    print(out[["pred", "pred_err"]].describe().to_string())
    print(f"-> {args.out}")


def _loocv(args, mf):
    import numpy as np

    from cokriging_tpu_torch.cov.matern import MultivariateMatern
    from cokriging_tpu_torch.utils.io import load_params, save_table

    mod = MultivariateMatern(params=load_params(args.params))
    if args.predictor == "local":
        from cokriging_tpu_torch.predict.local import LocalPredictor

        cv = LocalPredictor(mod, mf, device=args.device).cross_validation(
            args.process, max_dist=args.max_dist, postprocess=True)
    else:
        from cokriging_tpu_torch.predict.joint import JointPredictor

        cv = JointPredictor(mod, mf, device=args.device).cross_validation(
            args.process, postprocess=True)
    save_table(args.out, cv)
    resid = cv["residual"].to_numpy()
    finite = np.isfinite(resid)
    mspe = float(np.mean(resid[finite] ** 2))
    mape = float(np.mean(np.abs(resid[finite])))
    zscore = (cv["residual"] / cv["pred_err"].where(cv["pred_err"] > 0)).to_numpy()
    cover = float(np.mean(np.abs(zscore[np.isfinite(zscore)]) <= 1.96))
    print(cv[["data", "pred", "residual", "pred_err"]].describe().to_string())
    print(f"MSPE {mspe:.6g}  MAPE {mape:.6g}  "
          f"95% coverage {cover:.3f}  "
          f"({int(finite.sum())}/{len(cv)} locations)")
    print(f"-> {args.out}")


def main(argv=None):
    parser = _parser()
    args = parser.parse_args(argv)
    if args.cmd in ("sim", "bench"):
        parser.error(_NOT_YET[args.cmd])
    if args.cmd == "fit" and args.bootstrap and args.method != "wls":
        parser.error("--bootstrap requires --method wls")
    if args.cmd == "predict" and args.conditional_sims:
        if not args.joint:
            parser.error("--conditional-sims requires --joint")
        if args.solver == "cg":
            parser.error("--conditional-sims requires the dense solver (posterior covariance); "
                         "drop --solver cg")
    from cokriging_tpu_torch.utils.config import resolve_device

    resolve_device(args.device)  # raise now, before the tables load, without a card
    mf = _multifield(parser, args)
    {"fit": _fit, "predict": _predict, "loocv": _loocv}[args.cmd](args, mf)


if __name__ == "__main__":
    sys.exit(main())
