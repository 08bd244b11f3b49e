"""Entry points of the port (counterpart of ``__graft_entry__.py``).

``entry()`` returns the forward step of the flagship model, exact joint
bivariate Matern cokriging (prediction + uncertainty), with example
arguments sized like the simulation setup there (a 21 x 21 grid, 60
samples per process, prediction at every 5th cell).

``dryrun_multichip(n)`` runs one sharded estimation + prediction step on a
``parallel.make_mesh`` mesh of n shards: a batch of 2n WLS fits (one
sharded gradient step, then a short converged batched fit), the
row-sharded variogram pass, the term-sharded Vecchia NLL and its gradient,
sharded local prediction and matrix-free joint prediction with its row
tiles sharded. With fewer cards than n, the shards are virtual shards of
one device.

    python -m cokriging_tpu_torch.entry          # on the card
"""

import numpy as np
import torch

#: the sim-scaled parameters (__graft_entry__.py's ``_sim_setup``)
SIM_FLAT = [1.0, 1.0, 1.5, 1.5, 1.5, 0.2, 0.2, 0.2, 0.0, 0.0, -0.6]


def _sim_setup(nx=21, sample_size=60, seed=2, device=None):
    """(model, grid, MultiField): a simulated cofield on an nx x nx unit
    grid, drawn on ``device``, sampled semi-colocated with noise 0.1."""
    from cokriging_tpu_torch.cov.matern import MultivariateMatern
    from cokriging_tpu_torch.cov.params import MaternParams
    from cokriging_tpu_torch.sim import BivariateRandomField, CartesianGrid

    mod = MultivariateMatern(params=MaternParams.from_flat(
        torch.tensor(SIM_FLAT, dtype=torch.float64)))
    grid = CartesianGrid(xcount=nx, ycount=nx, device=device)
    rf = BivariateRandomField(mod, grid, seed=seed, device=device)
    samples = rf.sample(size=sample_size, epsilon=[0.1, 0.1], seed=seed + 1)
    return mod, grid, rf.to_fields(samples)


def entry(device=None):
    """(fn, example_args): ``fn(flat, c0, c1, v0, v1, pcoords) -> (pred,
    pred_err)`` of process 0 by exact joint cokriging
    (``predict.joint._joint_predict_core``), its example arguments float64
    on ``device`` (the card unless ``device="cpu"``)."""
    from cokriging_tpu_torch.cov.params import MaternParams
    from cokriging_tpu_torch.predict.joint import _joint_predict_core
    from cokriging_tpu_torch.utils.config import resolve_device

    dev = resolve_device(device)
    mod, grid, mf = _sim_setup(device=dev)
    coords = tuple(f.coords_main.to(dev) for f in mf.fields)
    values = tuple(f.values_main.to(dev) for f in mf.fields)
    pcoords = torch.as_tensor(grid.coords.values[::5], device=dev)
    spec = mod.params.spec

    def fn(flat, c0, c1, v0, v1, pcoords):
        params = MaternParams.from_flat(flat, spec=spec)
        with torch.no_grad():
            return _joint_predict_core(params, (c0, c1), (v0, v1), pcoords, 0, False)

    flat = mod.params.to_flat().to(dev)
    return fn, (flat, coords[0], coords[1], values[0], values[1], pcoords)


def _check(cond, what):
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, device=None, nx: int = 15, sample_size: int = 40,
                     seed: int = 2, cg_block: int = 8) -> None:
    """One sharded estimation + prediction step on an ``n_devices``-shard
    mesh (``__graft_entry__.py:100-215``), on ``device`` (the card unless
    ``device="cpu"``): the mesh's shards are the first n cards where the
    machine has that many, else n virtual shards of that one device. The
    sizes: an ``nx`` x ``nx`` grid with ``sample_size`` samples per
    process, local prediction at every 3rd cell and CG at every 9th in row
    tiles of ``cg_block``. Prints one OK line; raises on a failed check."""
    from cokriging_tpu_torch.cov.params import ParamSpec
    from cokriging_tpu_torch.estimate.empirical import VarioConfig, empirical_variograms
    from cokriging_tpu_torch.estimate.vecchia import VecchiaLikelihood
    from cokriging_tpu_torch.estimate.wls import fit_wls_batch_arrays
    from cokriging_tpu_torch.parallel import (
        make_mesh, sharded_local_predict, sharded_variogram_pair, sharded_vecchia_nll,
        sharded_wls_grad_step,
    )
    from cokriging_tpu_torch.predict.iterative import IterativeJointPredictor
    from cokriging_tpu_torch.predict.local import LocalPredictor
    from cokriging_tpu_torch.utils.config import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.device_count() >= n_devices:
        mesh = make_mesh(n_devices)
    else:
        mesh = make_mesh(n_devices, device=dev)
    _check(mesh.size == n_devices, f"a mesh of {mesh.size} shards, not {n_devices}")
    mod, grid, mf = _sim_setup(nx=nx, sample_size=sample_size, seed=seed, device=dev)

    # --- a batch of B "months" of WLS fits, the month axis sharded ---
    est = empirical_variograms(mf, VarioConfig(max_dist=1.0, n_bins=8, geodesic=False),
                               device=dev)
    b = 2 * n_devices
    # sim-scaled bounds (unit square, not km)
    spec = ParamSpec(n_procs=2, sigma_bounds=(0.1, 3.0), len_scale_bounds=(0.02, 1.0),
                     nugget_bounds=(0.0, 0.5))
    rng = np.random.default_rng(0)
    flat0 = mod.params.to_flat().cpu().numpy()
    flats = np.tile(flat0, (b, 1)) + rng.normal(scale=0.01, size=(b, flat0.size))
    lo, hi = spec.bounds()
    flats = np.clip(flats, lo, hi)
    centers = np.tile(est.bin_centers[None], (b, 1, 1))
    means = np.tile(est.bin_means[None], (b, 1, 1))
    counts = np.tile(est.bin_counts[None], (b, 1, 1))
    # one sharded gradient step (the cheap smoke of the sharded objective)
    new_flats, costs0 = sharded_wls_grad_step(flats, centers, np.nan_to_num(means, nan=1.0),
                                              counts, est.pairs, spec, lr=1e-4, mesh=mesh)
    _check(new_flats.shape == flats.shape and np.isfinite(costs0).all(),
           "the sharded WLS gradient step")
    # then a short converged batched fit, its members sharded in lockstep
    xs, costs, _ = fit_wls_batch_arrays(flats, centers, np.nan_to_num(means, nan=0.0), counts,
                                        est.pairs, spec, maxiter=25, mesh=mesh)
    _check(xs.shape == flats.shape and np.isfinite(costs).all(), "the sharded batched WLS fit")
    _check(float(np.mean(costs)) <= float(np.mean(costs0)),
           "the converged fits do not improve on their perturbed starts")

    # --- the row-sharded O(n^2) variogram pass, bins summed over shards ---
    f0 = mf.fields[0]
    _, _, sn = sharded_variogram_pair(f0.coords, f0.values, f0.coords, f0.values,
                                      VarioConfig(max_dist=2.0, n_bins=8, geodesic=False),
                                      marginal=True, mesh=mesh)
    _check(sn.sum() == f0.size * (f0.size - 1) // 2, "the sharded variogram's pair count")

    # --- the term-sharded Vecchia likelihood and its gradient, partial sums
    # added ---
    lik = VecchiaLikelihood([f.coords for f in mf.fields], [f.values for f in mf.fields], m=8,
                            geodesic=False, chunk=32, device=dev)
    flat_t = mod.params.to_flat().to(dev).requires_grad_(True)
    value = sharded_vecchia_nll(lik, flat_t, spec, mesh=mesh, chunk=32)
    (grad,) = torch.autograd.grad(value, flat_t)
    nll_sh = float(value.detach())
    with torch.no_grad():
        nll_1 = float(lik.nll(flat_t, spec))
    _check(np.isfinite(nll_sh) and abs(nll_sh - nll_1) < 1e-6 * max(1.0, abs(nll_1))
           and bool(torch.isfinite(grad).all()),
           f"the sharded Vecchia NLL {nll_sh} against {nll_1}, gradient {grad.tolist()}")

    # --- sharded local prediction: the location axis over the mesh ---
    pcoords = grid.coords.values[::3]
    pred, err = sharded_local_predict(LocalPredictor(mod, mf, device=dev), 0, pcoords,
                                      max_dist=0.6, mesh=mesh)
    _check(pred.shape == (len(pcoords),) and np.isfinite(pred).all() and np.isfinite(err).all(),
           "sharded local prediction")

    # --- matrix-free exact joint cokriging, row tiles sharded ---
    pc_it = grid.coords.values[::9]
    out = IterativeJointPredictor(mod, mf, block=cg_block, rhs_batch=16, tol=1e-8, maxiter=400,
                                  mesh=mesh, device=dev)(0, pc_it, postprocess=False)
    _check(np.isfinite(out.pred).all() and np.isfinite(out.pred_err).all(),
           "matrix-free sharded joint prediction")

    print(f"dryrun_multichip OK on {n_devices} devices: "
          f"{b} sharded converged WLS fits (mean cost {float(np.mean(costs)):.3f}), "
          f"row-sharded variogram ({int(sn.sum())} pairs), "
          f"term-sharded Vecchia NLL and gradient ({lik.n} terms, {nll_sh:.2f}), "
          f"{len(pcoords)} sharded local predictions, "
          f"{len(pc_it)} matrix-free sharded joint predictions.")


if __name__ == "__main__":
    fn, args = entry()
    print("entry OK:", [tuple(o.shape) for o in fn(*args)])
    dryrun_multichip(torch.cuda.device_count())
