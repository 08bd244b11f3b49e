#!/usr/bin/env python3
"""Both packages' WLS fits of the trivariate demo's draw, on the CPU, and
how far each fit's end moves when its input moves in the last digits.

    JAX_PLATFORMS=cpu python3 tools/torch_trivariate_fits.py

The JAX package's own pipeline of ``examples/trivariate_demo.py`` (its
41 x 41 cofield of seed 11, the six variograms of the sample draws of
seeds 11, 12 and 13 pooled, ``moment_init``, ``fit_wls(method="scipy",
maxiter=400)``) beside the port's (``experiments/trivariate_demo.py``:
``simulate`` with the JAX simulator's draws, ``pooled_variograms``,
``fit``), both in float64 on the CPU. Then each package's fit again on the
other package's pooled estimate, and on its own with every bin mean
multiplied by 1 + 1e-15 u (u standard normal, ``PERTURBED`` seeds): the
spread of rho over those fits is how far a last-digit change of the input
moves the fit's end. Prints each fit's rho (01, 02, 12), WLS cost and
iterations, tests/test_trivariate.py's fit gates on the two packages' own
fits, the largest differences of the pooled bin means and counts between
the packages, the spreads, then one JSON line. Last, the bin counts of both
packages' six variograms on tests/test_trivariate.py's 31 x 31 grid (12
bins to 0.5; the counts do not depend on the values): where they differ,
pairs exactly on an edge fell one bin apart. The draw's fit misses the
test's rho bars in both packages (rho_12 of the wrong sign), which is why
the port holds those bars on the test's own recovery data instead. It takes
several minutes: the port's plain K_nu builds the 5,043^2 covariance on
this CPU.
"""

import copy
import json
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PERTURBED = (1, 2, 3)


def jax_estimate():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from cokriging_tpu.cov import MaternParams, MultivariateMatern
    from cokriging_tpu.cov.params import ParamSpec
    from cokriging_tpu.estimate import VarioConfig, empirical_variograms
    from cokriging_tpu.sim import CartesianGrid, MultivariateRandomField
    from cokriging_tpu_torch.experiments import trivariate_demo as T

    truth = MaternParams.from_flat(jnp.asarray(np.array(T.TRUTH)), spec=ParamSpec(n_procs=3, **T.BOUNDS))
    rf = MultivariateRandomField(MultivariateMatern(params=truth), CartesianGrid(xcount=41, ycount=41),
                                 seed=T.SEEDS[0])
    cfg = VarioConfig(max_dist=T.MAX_DIST, n_bins=T.N_BINS, geodesic=False)
    return T.pool([empirical_variograms(rf.to_fields(rf.sample(size=280, epsilon=(T.EPS,), seed=s)), cfg)
                   for s in T.SEEDS])


def jax_fit(est):
    from cokriging_tpu.cov.params import ParamSpec
    from cokriging_tpu.estimate.wls import fit_wls, moment_init
    from cokriging_tpu_torch.experiments import trivariate_demo as T

    params, result = fit_wls(est, init=moment_init(est, spec=ParamSpec(n_procs=3, **T.BOUNDS)),
                             method="scipy", maxiter=400)
    return params, result


def port_estimate():
    import torch

    from cokriging_tpu_torch.experiments import trivariate_demo as T

    _, rf, _ = T.simulate(41, torch.device("cpu"))
    return T.pooled_variograms(rf, 280, "cpu")


def port_fit(est):
    from cokriging_tpu_torch.experiments import trivariate_demo as T

    _, params, result = T.fit(est, 400, "cpu")
    return params, result


def _np(x):
    """A JAX array or a torch tensor as a float64 numpy array."""
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x, np.float64)


def with_bins(est, means, counts):
    """A copy of ``est`` with these bin means and counts."""
    out = copy.copy(est)
    out.bin_means, out.bin_counts = np.array(means, np.float64), np.array(counts)
    return out


def summary(params, result, seconds):
    return {"rho": _np(params.rho)[[0, 0, 1], [1, 2, 2]].tolist(), "sigma": _np(params.sigma).tolist(),
            "len_scale_diag": _np(params.len_scale)[[0, 1, 2], [0, 1, 2]].tolist(),
            "fitted_flat": _np(params.to_flat()).tolist(), "wls_cost": float(result.cost),
            "n_iter": int(getattr(result, "n_iter", -1) or -1), "seconds": seconds}


def lattice_ties():
    """Both packages' six variogram counts on tests/test_trivariate.py's
    31 x 31 grid (12 bins to 0.5, Euclidean), of one random value per cell
    and process: {"port - jax counts": (6, 12) nested list, "pairs moved":
    int}."""
    from cokriging_tpu.estimate import VarioConfig as JVarioConfig
    from cokriging_tpu.estimate import empirical_variograms as j_empirical_variograms
    from cokriging_tpu.fields.field import Field as JField
    from cokriging_tpu.fields.field import MultiField as JMultiField
    from cokriging_tpu_torch.estimate.empirical import VarioConfig, empirical_variograms
    from cokriging_tpu_torch.experiments import trivariate_demo as T
    from cokriging_tpu_torch.fields.field import Field, MultiField
    from cokriging_tpu_torch.sim import CartesianGrid

    grid = CartesianGrid(xcount=T.RECOVERY_GRID, ycount=T.RECOVERY_GRID)
    coords = np.column_stack([grid.coords["x"].values, grid.coords["y"].values])
    zs = np.random.default_rng(0).standard_normal((3, len(coords)))
    jfields = [JField.from_arrays(coords, z, f"Z{k}") for k, z in enumerate(zs)]
    for f in jfields:
        f.geodesic = False
    jc = np.asarray(j_empirical_variograms(JMultiField(fields=jfields), JVarioConfig(
        max_dist=T.RECOVERY_MAX_DIST, n_bins=T.N_BINS, geodesic=False)).bin_counts)
    pc = empirical_variograms(MultiField(fields=[Field.from_arrays(coords, z, f"Z{k}") for k, z in enumerate(zs)]),
                              VarioConfig(max_dist=T.RECOVERY_MAX_DIST, n_bins=T.N_BINS, geodesic=False),
                              device="cpu").bin_counts
    diff = np.asarray(pc, np.int64) - jc.astype(np.int64)
    return {"port - jax counts": diff.tolist(), "pairs moved": int(np.abs(diff).sum() // 2)}


def main():
    from cokriging_tpu_torch.experiments import trivariate_demo as T

    out, fits = {}, {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        est = {"jax": jax_estimate(), "port": port_estimate()}
        bins = {k: (np.asarray(e.bin_means, np.float64), np.asarray(e.bin_counts)) for k, e in est.items()}
        fitters = {"jax": jax_fit, "port": port_fit}
        runs = [(pkg, data, None) for pkg in fitters for data in ("jax", "port")]
        runs += [(pkg, pkg, seed) for pkg in fitters for seed in PERTURBED]
        for pkg, data, seed in runs:
            means, counts = bins[data]
            if seed is not None:
                means = means * (1.0 + 1e-15 * np.random.default_rng(seed).standard_normal(means.shape))
            t0 = time.perf_counter()
            params, result = fitters[pkg](with_bins(est[pkg], means, counts))
            name = f"{pkg} fit on {data}'s estimate" + ("" if seed is None else f", means x (1 + 1e-15 u), seed {seed}")
            fits[name] = summary(params, result, time.perf_counter() - t0)
            print(f"{name}: rho {np.round(fits[name]['rho'], 4).tolist()}, cost {fits[name]['wls_cost']!r}, "
                  f"{fits[name]['n_iter']} iterations, {fits[name]['seconds']:.1f} s", flush=True)
    for pkg in fitters:
        own = fits[f"{pkg} fit on {pkg}'s estimate"]
        out[f"{pkg}_test_bars"] = T.fit_gates(own)
        rhos = np.array([f["rho"] for k, f in fits.items() if k.startswith(f"{pkg} fit on {pkg}'s")])
        costs = [f["wls_cost"] for k, f in fits.items() if k.startswith(f"{pkg} fit on {pkg}'s")]
        out[f"{pkg}_rho_spread_last_digits"] = (rhos.max(0) - rhos.min(0)).tolist()
        out[f"{pkg}_cost_range_last_digits"] = [min(costs), max(costs)]
    (jm, jc), (pm, pc) = bins["jax"], bins["port"]
    out["bin_means_max_abs_diff"] = float(np.nanmax(np.abs(jm - pm)))
    out["bin_counts_equal"] = bool(np.array_equal(jc, pc))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out["lattice_ties"] = lattice_ties()
    out["fits"] = fits
    for k, v in out.items():
        if k != "fits":
            print(f"{k}: {v}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
