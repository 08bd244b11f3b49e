"""Million-observation workflow: simulate -> Vecchia fit -> held-out cokriging.

Counterpart of ``examples/million_point_workflow.py``, with its stages, its
truth, its gates and its sizes:

1. simulate a bivariate Gaussian cofield with known parameters on a
   1024 x 1024 grid of [0, 100]^2 by circulant embedding (a 2048^2 torus,
   its lag-grid blocks through the Matern kernel) and sample 500,000
   semi-colocated observations per process (N = 1,000,000), without
   measurement error;
2. fit the 11-parameter bivariate Matern by maximum Vecchia likelihood
   (m = 20): a warm start on a subsample of 30,000 per process (maxiter
   100), then the full-N fit (maxiter 30), both through ``fit_vecchia``'s
   host L-BFGS-B loop, whose "auto" scaffold above 20,000 points is the
   coarse-to-fine ordering and kd-tree neighbours on the host;
3. require the fitted rho within 0.12 and both sigmas within 0.3 of the
   truth (0.25 and 0.5 below N = 100,000, where estimation noise rules);
4. cokrige process 1 at 16,384 held-out grid cells (``LocalPredictor`` with
   ``materialize_cov=False``: kd neighbourhoods within 0.8 on the host, the
   local systems gathered on the device) and require > 95% finite and a 95%
   interval coverage in (0.90, 0.995) ((0.80, 0.995) below N = 100,000).

The draw is the JAX script's realization: ``ReferenceSpectralField`` takes
the JAX spectral simulator's normals from its PRNG reproduced with numpy, in
float32 on the card (the JAX manifest was drawn on a TPU) and float64 on the
CPU; the locations come from numpy's generator, as in the JAX script. Every
stage after the draw runs on ``device`` in the script's dtype: float32 on
the card, float64 on the CPU. ``JAX_MANIFEST`` holds the JAX package's own
run (``results/million_point_workflow.json``) for ``compare_manifest``.

Sizes: ``CARD_SIZES`` on the card, ``CPU_SIZES`` on the CPU; the script's
environment knobs ``MPW_N`` (per process), ``MPW_GRID``, ``MPW_M``,
``MPW_HOLD`` and ``MPW_MAXITER`` (the full fit's) override them, and keyword
arguments of ``main`` override both. The manifest
``torch_million_point_workflow.json`` goes through ``utils.results``
(``COKRIGING_RESULTS_DIR`` and ``COKRIGING_NO_RECORD`` apply).

    python -m cokriging_tpu_torch.experiments.million_point_workflow [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

from cokriging_tpu_torch.experiments import Stages, resolve_sizes

# the reference simulation experiment's truth (cell 3) on a [0, 100]^2
# domain; nonzero nuggets, so the fit must separate the scales
TRUTH = [1.0, 1.0, 1.5, 1.5, 1.5, 5.0, 5.0, 5.0, 0.05, 0.05, -0.6]
BOUNDS = dict(sigma_bounds=(0.2, 3.0), nu_bounds=(0.4, 3.0), len_scale_bounds=(0.5, 25.0),
              nugget_bounds=(0.0, 0.5))
INIT = [1.0, 1.0, 1.0, 1.0, 1.0, 8.0, 8.0, 8.0, 0.1, 0.1, 0.0]
FIELD_SEED, SAMPLE_SEED, SUBSAMPLE_SEED, HOLD_SEED = 11, 7, 3, 5
N_SUB = 30_000  # per process: the warm start's subsample
AT_SCALE = 100_000  # N from which the tight gates hold

#: the script's sizes on an accelerator (its TPU run) and on the CPU
CARD_SIZES = dict(n_per=500_000, grid=1024, m=20, n_hold=16_384, maxiter_warm=100,
                  maxiter_full=30, max_dist=0.8)
CPU_SIZES = dict(n_per=1_200, grid=64, m=10, n_hold=300, maxiter_warm=30, maxiter_full=30,
                 max_dist=12.0)
ENV = dict(n_per="MPW_N", grid="MPW_GRID", m="MPW_M", n_hold="MPW_HOLD",
           maxiter_full="MPW_MAXITER")

#: the JAX package's run on a TPU (results/million_point_workflow.json)
JAX_MANIFEST = {
    "n_total": 1_000_000,
    "m": 20,
    "grid": [1024, 1024],
    "dtype": "float32",
    "fitted_flat": [1.0339, 1.1158, 1.4032, 1.3425, 1.3864, 5.5431, 6.1699, 5.864, 0.0499, 0.05,
                    -0.6665],
    "warm_fit": {"nll": 6843.628906, "success": True, "n_iter": 28, "n_obj_evals": 44,
                 "n": 60000},
    "full_fit": {"nll": -9072.5625, "success": True, "n_iter": 13, "n_obj_evals": 35,
                 "n": 1000000},
    "predict_cells": 16384,
    "predict_finite_frac": 1.0,
    "mspe": 0.052811,
    "coverage_95": 0.94696,
}


def sizes_for(device, **sizes) -> dict:
    """The run's sizes on ``device``: the script's (``CARD_SIZES`` on the
    card, ``CPU_SIZES`` on the CPU), its environment knobs over them, then
    ``sizes``."""
    return resolve_sizes(device, CARD_SIZES, CPU_SIZES, sizes, ENV)


def simulate(grid_n, n_per, dtype, device):
    """The truth cofield on the grid_n x grid_n grid of [0, 100]^2 (the JAX
    script's draw, its normals in ``dtype``) and its semi-colocated sample
    of ``n_per`` per process as a ``MultiField`` in ``dtype``: (random field,
    grid, multifield)."""
    from cokriging_tpu_torch.cov.matern import MultivariateMatern
    from cokriging_tpu_torch.cov.params import MaternParams, ParamSpec
    from cokriging_tpu_torch.experiments.reference_draws import ReferenceSpectralField
    from cokriging_tpu_torch.fields.field import Field, MultiField
    from cokriging_tpu_torch.sim import CartesianGrid

    spec = ParamSpec(2, **BOUNDS)
    truth = MaternParams.from_flat(torch.tensor(TRUTH, dtype=torch.float64), spec=spec)
    grid = CartesianGrid(xbounds=(0, 100), ybounds=(0, 100), xcount=grid_n, ycount=grid_n,
                         device=device)
    rf = ReferenceSpectralField(MultivariateMatern(params=truth), grid, seed=FIELD_SEED,
                                normals=dtype, device=device)
    samples = rf.sample(size=n_per, seed=SAMPLE_SEED)
    fields = [Field.from_arrays(s[["x", "y"]].values.astype(dtype), s[f"Z{k}"].values.astype(dtype),
                                name=f"Z{k}")
              for k, s in enumerate(samples)]
    return rf, grid, MultiField(fields=fields)


def subsample(mf, n_sub):
    """The warm start's subsample: ``n_sub`` observations of each process
    drawn without replacement (numpy's generator, seed 3, as the script)."""
    from cokriging_tpu_torch.fields.field import Field, MultiField

    rng = np.random.default_rng(SUBSAMPLE_SEED)
    fields = []
    for f in mf.fields:
        pick = rng.choice(f.size, size=min(f.size, n_sub), replace=False)
        fields.append(Field.from_arrays(f.coords.numpy()[pick], f.values.numpy()[pick], f.name))
    return MultiField(fields=fields)


def held_out_cells(rf, grid, n_per, n_hold, dtype):
    """(coordinates, process-1 truth) of ``n_hold`` grid cells that no
    process sampled (numpy's generator, seed 5, as the script)."""
    used = np.unique(np.concatenate(rf._split_samp_coords(n_per, SAMPLE_SEED)))
    free = np.setdiff1d(np.arange(grid.count), used)
    hold = np.sort(np.random.default_rng(HOLD_SEED).choice(
        free, size=min(n_hold, len(free)), replace=False))
    return grid.coords.values[hold].astype(dtype), rf.fields[1]["value"].values[hold]


def _fit_line(label, info, seconds):
    sc = info["scaffold"]
    return (f"{label} (N={info['n']}): nll={info['nll']:.1f} iters={info['n_iter']} "
            f"evals={info['n_obj_evals']} success={info['success']} in {seconds:.1f}s "
            f"(scaffold: order {sc['order_s']:.1f}s, neighbors {sc['neighbors_s']:.1f}s, "
            f"windows {sc['windows_s']:.1f}s, {sc['window_bytes'] / 2**20:.0f} MiB on the device)")


def main(device=None, stages=None, **sizes):
    """The workflow on ``device`` (the card unless ``device="cpu"``) at the
    script's sizes for that device (``sizes_for``; any of ``CARD_SIZES``'
    keys as keywords). ``stages``: a ``Stages`` on that device, or None for
    a new one. Raises AssertionError where the script's gates fail. Returns
    the run's record: the manifest's keys (the fitted flat, both fits'
    infos, MSPE, coverage, ...) plus the stage seconds, launches and peak
    memory (``stage_s``, ``launches``, ``peak_mib``)."""
    from cokriging_tpu_torch.cov.matern import MultivariateMatern
    from cokriging_tpu_torch.cov.params import MaternParams, ParamSpec
    from cokriging_tpu_torch.estimate.vecchia import fit_vecchia
    from cokriging_tpu_torch.predict.local import LocalPredictor
    from cokriging_tpu_torch.utils.config import resolve_device
    from cokriging_tpu_torch.utils.results import record_manifest

    dev = resolve_device(device)
    s = sizes_for(dev, **sizes)
    dtype = np.float32 if dev.type == "cuda" else np.float64
    stages = stages or Stages(dev)
    print(f"backend={dev.type} N={2 * s['n_per']} grid={s['grid']}x{s['grid']} m={s['m']}",
          flush=True)

    # 1. simulate the truth and sample N observations
    rf, grid, mf = simulate(s["grid"], s["n_per"], dtype, dev)
    stages("simulate")
    print(f"simulated {grid.count} cells/process in {stages.seconds['simulate']:.1f}s "
          f"(min_rel_eig {rf.min_rel_eig:.1e})", flush=True)

    # 2. Vecchia fit: warm start on a subsample, then all N
    spec = ParamSpec(2, **BOUNDS)
    init = MaternParams.from_flat(torch.tensor(INIT, dtype=getattr(torch, np.dtype(dtype).name)),
                                  spec=spec)
    p_warm, info_warm = fit_vecchia(subsample(mf, N_SUB), init=init, m=s["m"],
                                    maxiter=s["maxiter_warm"], main=False, device=dev)
    stages("fit_warm")
    print(_fit_line("warm-start fit", info_warm, stages.seconds["fit_warm"]), flush=True)
    params, info = fit_vecchia(mf, init=p_warm, m=s["m"], maxiter=s["maxiter_full"], main=False,
                               device=dev)
    stages("fit_full")
    s_per_eval = stages.seconds["fit_full"] / max(info["n_obj_evals"], 1)
    print(_fit_line("full fit", info, stages.seconds["fit_full"]) + f", {s_per_eval:.2f}s/eval",
          flush=True)

    # 3. parameter recovery against the truth
    flat_hat = params.to_flat().detach().cpu().numpy().astype(np.float64)
    delta = flat_hat - np.asarray(TRUTH)
    for nm, tv, hv in zip(spec.names(), TRUTH, flat_hat):
        print(f"  {nm:>12}: truth {tv:7.3f}  fitted {hv:7.3f}")
    at_scale = info["n"] >= AT_SCALE
    rho_tol, sig_tol = (0.12, 0.3) if at_scale else (0.25, 0.5)
    if not abs(delta[-1]) < rho_tol:
        raise AssertionError(f"rho off by {delta[-1]:+.3f}")
    if not np.all(np.abs(delta[:2]) < sig_tol):
        raise AssertionError(f"sigma off by {delta[:2]}")

    # 4. held-out cokriging of process 1 from the fitted model
    pc, z_true = held_out_cells(rf, grid, s["n_per"], s["n_hold"], dtype)
    lp = LocalPredictor(MultivariateMatern(params=params), mf, materialize_cov=False, device=dev)
    out = lp(1, pc, max_dist=s["max_dist"], postprocess=False)
    stages("predict")
    ok = np.isfinite(out.pred)
    resid = z_true - out.pred
    mspe = float(np.nanmean(resid**2))
    cover = float(np.mean(np.abs(resid[ok] / out.pred_err[ok]) < 1.96))
    print(f"held-out cokriging: {len(pc)} cells in {stages.seconds['predict']:.1f}s, "
          f"{int(ok.sum())} finite, MSPE {mspe:.4f}, 95% coverage {cover:.3f}, mean neighbourhood "
          f"{float(out.n_neighbors.mean()):.1f}", flush=True)
    if not ok.mean() > 0.95:
        raise AssertionError(f"only {ok.mean():.2%} finite predictions")
    lo_cov = 0.90 if at_scale else 0.80
    if not lo_cov < cover < 0.995:
        raise AssertionError(f"coverage {cover:.3f}")

    # 5. evidence
    trace = info.pop("nll_trace", [])
    info_warm.pop("nll_trace", None)
    record = {
        "n_total": int(info["n"]),
        "m": s["m"],
        "grid": [s["grid"], s["grid"]],
        "dtype": np.dtype(dtype).name,
        "sizes": s,
        "truth_flat": TRUTH,
        "fitted_flat": flat_hat.tolist(),
        "param_names": list(spec.names()),
        "recovery_max_abs_delta": float(np.max(np.abs(delta))),
        "warm_fit": info_warm,
        "full_fit": info,
        "s_per_eval_full": s_per_eval,
        "nll_trace_full": trace,
        "predict_cells": int(len(pc)),
        "predict_finite_frac": float(ok.mean()),
        "mean_neighbourhood": float(out.n_neighbors.mean()),
        "mspe": mspe,
        "coverage_95": cover,
        "stage_s": dict(stages.seconds),
        "launches": dict(stages.launches),
        "peak_mib": dict(stages.peak_mib),
        "wall_total_s": sum(stages.seconds.values()),
    }
    record_manifest("torch_million_point_workflow", record)
    return record


def compare_manifest(record):
    """Print the run beside the JAX package's manifest: the fitted flat
    vector, each fit's final NLL and evaluation count, the finite share,
    MSPE and coverage, each with the difference port - JAX. Returns the
    rows (name, port, JAX, difference)."""
    from cokriging_tpu_torch.cov.params import ParamSpec

    manifest = JAX_MANIFEST
    rows = [(f"fitted {nm}", p, j) for nm, p, j in zip(
        ParamSpec(2).names(), record["fitted_flat"], manifest["fitted_flat"])]
    for fit in ("warm_fit", "full_fit"):
        for key in ("nll", "n_obj_evals", "n_iter", "success"):
            rows.append((f"{fit} {key}", record[fit][key], manifest[fit][key]))
    for key in ("predict_finite_frac", "mspe", "coverage_95"):
        rows.append((key, record[key], manifest[key]))
    rows = [(name, p, j, float(p) - float(j)) for name, p, j in rows]
    print(f"{'':>22} {'port':>14} {'JAX (TPU)':>14} {'port - JAX':>12}")
    for name, p, j, d in rows:
        print(f"{name:>22} {float(p):14.6g} {float(j):14.6g} {d:+12.4g}")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    main(ap.parse_args().device)
