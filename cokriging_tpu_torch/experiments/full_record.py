"""The 71-month record in one batched fit, then cokriging maps of a few
months.

Counterpart of ``examples/full_record.py``: the reference record's span
(2014-09 .. 2020-07, ~71 monthly grids) synthesized at its shape by
``modelling_comparison.synthesize_conus_months`` (4 x 5-degree CONUS main
grid, bivariate-Matern residuals, rho = -0.6), then

1. per month, the fields (``MultiField.from_dataframes``, timedeltas
   [0, -1]; a month missing from one process is skipped) and their
   empirical (cross-)variograms (1500 km, 15 bins);
2. one batched WLS fit of all months (``fit_wls_batch``: the batched
   L-BFGS, each month from its own moment start, rho bounded at +-0.95,
   the Cauchy-Schwarz penalty at weight 1 and the parsimonious validity
   projection after it), sharded over the cards when there is more than
   one;
3. cokriging of SIF at the 0.5-degree land cells for ``n_pred_months``
   months spread over the record.

Gates: every month's cost finite, every predicted month > 90% finite.
Every stage runs on ``device`` (the card unless ``device="cpu"``) in the
run's dtype (float32 on the card, float64 on the CPU). The batched fit's
iterations are its rounds of ``estimate.nll.lockstep`` (one host read
each). ``JAX_MANIFEST`` holds the JAX package's own run
(``results/full_record.json``) for ``compare_manifest``.

Sizes: ``CARD_SIZES`` on the card (71 months, 3 predicted months, every
cell), ``CPU_SIZES`` on the CPU (the JAX script's CPU branch: 8 months, 1
predicted month, every 8th cell); ``FULL_RECORD_MONTHS`` overrides the
month count and keyword arguments of ``main`` override both. The manifest
``torch_full_record.json`` and, where matplotlib is installed, the figure
``torch_full_record_months.png`` go through ``utils.results``
(``COKRIGING_RESULTS_DIR`` and ``COKRIGING_NO_RECORD`` apply).

    python -m cokriging_tpu_torch.experiments.full_record [--device cuda|cpu]
"""

import argparse
import importlib.util

import numpy as np
import torch

from cokriging_tpu_torch.experiments import Stages, resolve_sizes

N_MONTHS = 71  # 2014-09 .. 2020-07, the reference record's span
RHO_BOUND = 0.95
PEGGED = 0.94  # |rho| above this counts as on the bound

CARD_SIZES = dict(months=N_MONTHS, n_pred_months=3, pred_stride=1)
CPU_SIZES = dict(months=8, n_pred_months=1, pred_stride=8)
ENV = dict(months="FULL_RECORD_MONTHS")

#: the JAX package's run on a TPU (results/full_record.json)
JAX_MANIFEST = {
    "months_fit": 71,
    "record_span": ["2019-02-01", "2024-12-01"],
    "rho_track": [
        -0.948, -0.576, -0.95, -0.345, -0.731, -0.85, -0.95, -0.496, -0.308, -0.51, -0.938,
        -0.74, -0.95, -0.808, -0.95, -0.95, -0.95, -0.656, -0.95, -0.95, -0.792, -0.95, 0.046,
        -0.625, -0.95, -0.84, -0.95, -0.581, -0.95, -0.95, -0.938, -0.95, -0.698, -0.95, -0.852,
        -0.95, -0.932, -0.385, -0.476, -0.877, -0.866, -0.94, -0.95, -0.896, -0.95, -0.933,
        -0.895, -0.95, -0.656, -0.943, -0.917, -0.95, -0.881, -0.95, -0.95, -0.336, -0.95,
        -0.778, -0.909, -0.589, -0.746, -0.712, -0.808, -0.864, -0.446, -0.95, -0.95, -0.858,
        -0.872, -0.748, -0.95,
    ],
    "n_converged": 49,
    "n_rho_bound": 29,
    "median_cost": 108.4,
    "pred_months": ["2019-02-01", "2022-01-01", "2024-12-01"],
    "pred_cells_per_month": 6256,
    "pred_finite_frac": {"2019-02-01": 1.0, "2022-01-01": 1.0, "2024-12-01": 1.0},
    "wall_s": {"synthesize": 20.2, "variograms_all_months": 126.5, "batched_fit": 82.8,
               "predict_months": 151.7},
    "wall_total_s": 381.1,
}


def sizes_for(device, **sizes) -> dict:
    """The run's sizes on ``device`` (``CARD_SIZES`` on the card,
    ``CPU_SIZES`` on the CPU), ``FULL_RECORD_MONTHS`` over them, then
    ``sizes``."""
    return resolve_sizes(device, CARD_SIZES, CPU_SIZES, sizes, ENV)


def month_fields(df_xco2, df_sif, dtype, stamps=None):
    """The record's months as fields and their variograms' inputs: for each
    stamp (by default every XCO2 month but the first, as SIF needs month
    k-1) the month's ``MultiField`` in ``dtype``; a month missing from one
    process is skipped. Returns (fields, stamps used)."""
    import pandas as pd

    from cokriging_tpu_torch.data.grids import main_coords_array
    from cokriging_tpu_torch.fields.field import MultiField

    main_c = main_coords_array()
    if stamps is None:
        stamps = sorted(df_xco2.time.unique())[1:]
    mfs, used = [], []
    for ts in stamps:
        ts = pd.Timestamp(ts)
        try:
            mf = MultiField.from_dataframes(
                [df_xco2, df_sif], ["xco2", "sif"], [["lon", "lat"], ["evi"]],
                timestamp=str(ts.date()), timedeltas=[0, -1], main_coords=main_c,
            ).astype(dtype)
        except (KeyError, ValueError):
            continue  # month missing from one process (record edges)
        mfs.append(mf)
        used.append(str(ts.date()))
    return mfs, used


def _figure(preds):
    """The predicted months side by side, where matplotlib is installed."""
    if importlib.util.find_spec("matplotlib") is None:
        print("figure not written: matplotlib is not installed", flush=True)
        return False
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from cokriging_tpu_torch.plot import plot_df
    from cokriging_tpu_torch.utils.results import save_figure

    fig, axes = plt.subplots(1, len(preds), figsize=(5.5 * len(preds), 3.6), squeeze=False)
    for ax, (ts, df) in zip(axes[0], preds.items()):
        plot_df(df.dropna(subset=["pred"]), "pred", ax=ax, title=f"SIF {ts}")
    fig.tight_layout()
    save_figure(fig, "torch_full_record_months")
    plt.close(fig)
    return True


def main(device=None, stages=None, **sizes):
    """The record on ``device`` (the card unless ``device="cpu"``) at the
    script's sizes for that device (``sizes_for``; ``months``,
    ``n_pred_months``, ``pred_stride`` as keywords). ``stages``: a
    ``Stages`` on that device, or None for a new one. Raises
    AssertionError where the script's gates fail. Returns the run's record:
    the manifest's keys (the rho track, convergence, costs, finite shares)
    plus the batched fit's iterations and seconds per iteration and the
    stage seconds, launches and peak memory (``wall_s``, ``launches``,
    ``peak_mib``)."""
    from cokriging_tpu_torch.cov.matern import MultivariateMatern
    from cokriging_tpu_torch.cov.params import ParamSpec
    from cokriging_tpu_torch.estimate import nll
    from cokriging_tpu_torch.estimate.empirical import VarioConfig, empirical_variograms
    from cokriging_tpu_torch.estimate.wls import fit_wls_batch, moment_init
    from cokriging_tpu_torch.experiments.modelling_comparison import (
        prediction_frame,
        synthesize_conus_months,
    )
    from cokriging_tpu_torch.parallel import make_mesh
    from cokriging_tpu_torch.predict.local import LocalPredictor
    from cokriging_tpu_torch.utils.config import compute_dtype, resolve_device
    from cokriging_tpu_torch.utils.results import record_manifest

    dev = resolve_device(device)
    s = sizes_for(dev, **sizes)
    dtype = compute_dtype(dev)
    stages = stages or Stages(dev)
    print(f"backend={dev.type} months={s['months']}", flush=True)

    # synthetic record at the real shape
    df_xco2, df_sif = synthesize_conus_months(seed=0, months=s["months"], device=dev)
    stages("synthesize")

    # per-month fields and empirical variograms
    mfs, used_stamps = month_fields(df_xco2, df_sif, dtype)
    stages("fields_all_months")
    cfg = VarioConfig(max_dist=1.5e3, n_bins=15, n_procs=2)
    ests = [empirical_variograms(mf, cfg, device=dev) for mf in mfs]
    stages("variograms_all_months")
    print(f"{len(ests)} monthly variogram sets in "
          f"{stages.seconds['fields_all_months'] + stages.seconds['variograms_all_months']:.1f}s",
          flush=True)

    # one batched fit over the whole record (sharded over the cards when
    # there is more than one): rho bounded inside the singular boundary,
    # the Cauchy-Schwarz penalty, each month from its own moment start and
    # the parsimonious projection after the fit, as the JAX script
    mesh = make_mesh() if dev.type == "cuda" and torch.cuda.device_count() > 1 else None
    spec = ParamSpec(n_procs=2, rho_bounds=(-RHO_BOUND, RHO_BOUND))
    rounds0 = nll.LOCKSTEP_ROUNDS
    params_list, costs, conv = fit_wls_batch(
        ests, init=moment_init(ests[0], spec=spec), maxiter=300, mesh=mesh,
        validity_weight=1.0, per_month_init=True, project_validity="parsimony", device=dev,
    )
    stages("batched_fit")
    rounds = nll.LOCKSTEP_ROUNDS - rounds0
    conv = np.asarray(conv)
    costs = np.asarray(costs, dtype=np.float64)
    fit_s = stages.seconds["batched_fit"]
    rhos = np.array([float(p.rho[0, 1]) for p in params_list])
    n_pegged = int((np.abs(rhos) > PEGGED).sum())
    print(f"batched WLS fit: {len(params_list)} months in one dispatch, {fit_s:.1f}s "
          f"({rounds} iterations, {fit_s / max(rounds, 1):.4f}s each); rho range "
          f"[{rhos.min():+.2f}, {rhos.max():+.2f}], median cost {np.median(costs):.1f}, "
          f"{conv.sum()}/{len(conv)} converged, {n_pegged} on the rho bound", flush=True)

    # multi-month cokriging maps
    pcoords, cov_pred = prediction_frame(s["pred_stride"])
    pick = np.linspace(0, len(mfs) - 1, s["n_pred_months"]).astype(int)
    stages.skip()
    preds = {}
    for k in pick:
        lp = LocalPredictor(MultivariateMatern(2, params_list[k].astype(dtype)), mfs[k],
                            covariates=cov_pred, device=dev)
        preds[used_stamps[k]] = lp(1, pcoords, max_dist=1e3)
    stages("predict_months")
    finite = {ts: float(np.isfinite(df["pred"].values).mean()) for ts, df in preds.items()}
    print(f"cokriged {len(pick)} months x {len(pcoords)} cells in "
          f"{stages.seconds['predict_months']:.1f}s; finite fractions {finite}", flush=True)

    wall = {"synthesize": stages.seconds["synthesize"],
            "variograms_all_months": (stages.seconds["fields_all_months"]
                                      + stages.seconds["variograms_all_months"]),
            "batched_fit": fit_s, "predict_months": stages.seconds["predict_months"]}
    record = {
        "sizes": s,
        "dtype": str(dtype).removeprefix("torch."),
        "months_fit": len(params_list),
        "record_span": [used_stamps[0], used_stamps[-1]],
        "months": used_stamps,
        "mesh_devices": mesh.size if mesh else 1,
        "rho_track": rhos.tolist(),
        "n_converged": int(conv.sum()),
        "n_rho_bound": n_pegged,
        "costs": costs.tolist(),
        "converged": conv.tolist(),
        "median_cost": float(np.median(costs)),
        "fit_iterations": rounds,
        "fit_s_per_iteration": fit_s / max(rounds, 1),
        "pred_months": list(preds.keys()),
        "pred_cells_per_month": int(len(pcoords)),
        "pred_finite_frac": finite,
        "wall_s": wall,
        "wall_total_s": sum(wall.values()),
        "stage_s": dict(stages.seconds),
        "launches": dict(stages.launches),
        "peak_mib": dict(stages.peak_mib),
    }
    record["figures"] = _figure(preds)
    record_manifest("torch_full_record", record)
    if not np.isfinite(costs).all():
        raise AssertionError(f"{int((~np.isfinite(costs)).sum())} months with a cost not finite")
    if not min(finite.values()) > 0.9:
        raise AssertionError(f"a predicted month is only {min(finite.values()):.2%} finite: {finite}")
    return record


def compare_manifest(record):
    """Print the run beside the JAX package's manifest, with the difference
    port - JAX: months fit, converged months, months on the rho bound, the
    median cost, the rho track (its largest |difference| and the months on
    the bound in one package only, where both fit the same months) and each
    predicted month's finite share. Returns the rows (name, port, JAX,
    difference)."""
    want = JAX_MANIFEST
    rows = [(key, record[key], want[key])
            for key in ("months_fit", "n_converged", "n_rho_bound", "median_cost")]
    if record["record_span"] == want["record_span"] and len(record["rho_track"]) == len(
            want["rho_track"]):
        port, jax_ = np.asarray(record["rho_track"]), np.asarray(want["rho_track"])
        gap = np.abs(port - jax_)
        k = int(np.argmax(gap))
        rows.append((f"rho max |diff| ({record['months'][k]})", port[k], jax_[k]))
        on_p, on_j = np.abs(port) > PEGGED, np.abs(jax_) > PEGGED
        rows.append(("rho on bound, port only", int((on_p & ~on_j).sum()), 0))
        rows.append(("rho on bound, JAX only", 0, int((on_j & ~on_p).sum())))
    else:
        print(f"rho track: the port fit {record['record_span']}, the JAX run "
              f"{want['record_span']}: not compared month by month")
    for ts, frac in record["pred_finite_frac"].items():
        if ts in want["pred_finite_frac"]:
            rows.append((f"finite {ts}", frac, want["pred_finite_frac"][ts]))
    rows = [(name, p, j, float(p) - float(j)) for name, p, j in rows]
    print(f"{'':>30} {'port':>12} {'JAX (TPU)':>12} {'port - JAX':>12}")
    for name, p, j, d in rows:
        print(f"{name:>30} {float(p):12.6g} {float(j):12.6g} {d:+12.4g}")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    main(ap.parse_args().device)
