"""Parametric bootstrap for the WLS variogram estimator, batched on the card.

Counterpart of ``cokriging_tpu/estimate/bootstrap.py``. The reference
reports WLS point estimates with no uncertainty (src/model.py:285-317). Here
the resampling loop is three batched steps:

1. **simulate**: one Cholesky of the joint covariance at the data
   coordinates, then all B replicate fields as one (n, B) product;
2. **re-estimate**: the replicate-batched bin pass
   (``kernels.cuda_ops.variogram_bin_batch``; on the card
   ``csrc/variogram.cu``'s batched form): each pair's distance and bin are
   found once for all replicates, and every replicate's cloud is added into
   its own histogram;
3. **refit**: ``estimate.wls.fit_wls_batch_arrays``, the batched L-BFGS over
   all replicates at once.

The replicate bins are NOT re-derived per replicate: the reference's bin
construction (src/fields.py:389-403) depends on the data only through
pairwise distances, which the bootstrap holds fixed, so every replicate
shares the observed bins by construction. The bins come from the standard
two-pass device estimate on replicate 0; the batched pass rebuilds its edges
from the bin centers, as the reference does, and refuses to go on if its
counts differ from the standard pass's.
"""

import dataclasses
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from cokriging_tpu_torch.cov.matern import block_covariance
from cokriging_tpu_torch.cov.params import MaternParams
from cokriging_tpu_torch.estimate.empirical import (
    VarioConfig,
    _h_of_d,
    empirical_variograms_device,
    point_features,
)
from cokriging_tpu_torch.estimate.nll import joint_distance_blocks
from cokriging_tpu_torch.estimate.wls import fit_wls_batch_arrays, moment_init
from cokriging_tpu_torch.kernels.cuda_ops import variogram_bin_batch
from cokriging_tpu_torch.utils.config import resolve_device


def _replicate_noise(seed: int, n: int, n_rep: int, dtype, device) -> torch.Tensor:
    """(n, n_rep) standard normals from a generator on ``device`` seeded
    with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn((n, n_rep), generator=gen, dtype=dtype, device=device)


def simulate_replicates(
    params: MaternParams,
    coords_list,
    n_rep: int,
    seed: int = 0,
    geodesic: bool = True,
    jitter: float = 1e-10,
    device=None,
):
    """Draw ``n_rep`` joint Gaussian replicates at fixed coordinates on
    ``device`` (the card unless ``device="cpu"``), in the coordinates'
    dtype.

    One factorization serves every replicate: z = L @ N(0, I_{n x B}). The
    nugget rides the covariance diagonal (exact-zero distances), so
    replicates mimic the observed process including its
    discontinuous-at-origin component.

    Returns a per-process list of (n_rep, n_i) tensors on ``device``.
    """
    dev = resolve_device(device)
    coords = [torch.as_tensor(c).to(dev) for c in coords_list]
    dtype = coords[0].dtype
    with torch.no_grad():
        cov = block_covariance(params.to(device=dev, dtype=dtype),
                               joint_distance_blocks(coords, geodesic=geodesic))
        cov.diagonal().add_(jitter)
        chol, info = torch.linalg.cholesky_ex(cov)
        del cov
        if bool(info != 0) or not bool(torch.isfinite(chol[-1, -1])):
            raise ValueError(
                "simulate_replicates: the generator's joint covariance is not"
                " positive definite (spectrally invalid parameters, e.g. a WLS"
                " optimum outside the Gneiting validity region). Project it"
                " first: cov.spectral.project_to_valid(params), or fit with"
                " fit_wls(..., project_validity=True)."
            )
        z = (chol @ _replicate_noise(seed, chol.shape[0], n_rep, dtype, dev)).T
    return list(torch.split(z, [c.shape[0] for c in coords], dim=1))


def batched_variograms(coords_list, values_rep, config: VarioConfig, device=None):
    """Binned (cross-)variograms for a batch of value replicates on fixed
    coordinates, sharing the observed bin structure, on ``device`` (the card
    unless ``device="cpu"``) in the coordinates' dtype.

    Args:
        coords_list: per-process (n_i, 2) coordinates.
        values_rep: per-process (B, n_i) replicate values.

    Returns:
        (pairs, centers (n_pairs, n_bins), means (B, n_pairs, n_bins),
        counts (n_pairs, n_bins)) as numpy arrays.
    """
    dev = resolve_device(device)
    p = len(coords_list)
    pairs = [(i, j) for i in range(p) for j in range(p) if i <= j]
    coords = [torch.as_tensor(c).to(dev) for c in coords_list]
    dtype = coords[0].dtype
    values = [torch.as_tensor(v).to(device=dev, dtype=dtype) for v in values_rep]

    # bins and counts from the standard device pass on one replicate (the
    # bin construction only reads distances, so any replicate works)
    pairs, centers, _, counts0 = empirical_variograms_device(
        coords, [v[0] for v in values], config, pairs=pairs, device=dev)

    # the edges of the standard pass rebuilt from its centers, as the
    # reference rebuilds them (bootstrap.py:201-207)
    width = centers[:, 1] - centers[:, 0]
    edges = np.concatenate(
        [centers - 0.5 * width[:, None], (centers[:, -1] + 0.5 * width)[:, None]], axis=1)
    edges[:, 0] = 0.0
    np_dtype = centers.dtype
    h_edges = [_h_of_d(e, config.geodesic).astype(np_dtype) for e in edges]
    h_max = float(_h_of_d(np_dtype.type(config.max_dist), config.geodesic))

    feats = [point_features(c, config.geodesic) for c in coords]
    # per-replicate centering by the mean (src/fields.py:378-381)
    centered = [v - v.sum(dim=1, keepdim=True) / v.shape[1] for v in values]
    sums, counts = variogram_bin_batch(
        [(feats[i], feats[j], centered[i], centered[j], i == j) for i, j in pairs],
        h_edges, config.geodesic, config.covariogram, h_max)
    counts = counts.cpu().numpy()
    if not np.array_equal(counts, counts0):
        raise AssertionError(
            "batched bin pass disagrees with the reference pass on pair"
            " counts: bin-edge reconstruction drifted"
        )
    sums = sums.cpu().numpy().transpose(1, 0, 2)  # (B, n_pairs, n_bins)
    means = np.where(counts[None] > 0, sums / np.maximum(counts[None], 1), np.nan)
    return pairs, centers, means.astype(np_dtype), counts


@dataclasses.dataclass
class BootstrapResult:
    """Sampling distribution of the WLS estimator under the fitted model."""

    params: MaternParams  # the estimate the bootstrap was run around
    flats: np.ndarray  # (n_rep, n_params) refitted parameter vectors
    costs: np.ndarray  # (n_rep,) final WLS costs

    def summary(self):
        """Per-parameter estimate, bootstrap SE, bias, and 95% percentile
        interval as a pandas frame; the full bootstrap covariance rides
        ``attrs``."""
        df = self.params.to_dataframe().copy()
        df["std_err"] = self.flats.std(axis=0, ddof=1)
        df["bias"] = self.flats.mean(axis=0) - self.params.to_flat().detach().cpu().numpy(
        ).astype(np.float64)
        df["q025"] = np.quantile(self.flats, 0.025, axis=0)
        df["q975"] = np.quantile(self.flats, 0.975, axis=0)
        df.attrs["covariance"] = np.cov(self.flats, rowvar=False)
        return df


def parametric_bootstrap(
    mod,
    mf,
    config: VarioConfig,
    n_rep: int = 200,
    seed: int = 0,
    maxiter: int = 300,
    init: Optional[MaternParams] = None,
    mesh=None,
    main: bool = False,
    project_validity: bool = True,
    per_replicate_init: bool = True,
    device=None,
) -> BootstrapResult:
    """Parametric bootstrap of the composite-WLS estimator on ``device``
    (the card unless ``device="cpu"``), in the dtype of the field
    coordinates.

    Simulates ``n_rep`` fields from the fitted model at the observed
    coordinates, re-estimates the empirical variograms (the
    replicate-batched bin pass), and refits every replicate with the batched
    L-BFGS.

    Args:
        mod: fitted MultivariateMatern (the bootstrap generator), or its
            MaternParams.
        mf: MultiField whose coordinates define the design.
        config: the VarioConfig used for the original fit.
        mesh: optional ``parallel.Mesh``: the refit's replicates are
            sharded over it (``fit_wls_batch_arrays``); the simulation and
            the re-estimate run on ``device``. The result equals the
            unsharded one bit for bit.
        main: use the main-grid coordinate subset instead of the full
            (augmented) coordinates.
        project_validity: project the generator onto the spectral validity
            region first (``cov.spectral.project_to_valid``): a WLS optimum
            can sit outside it, and an invalid generator has no PD
            covariance to simulate from.
        per_replicate_init: start each replicate's refit from the moment
            init of its own resampled variogram (host-computed) instead of
            the shared generator values; a per-replicate start deep in its
            own basin keeps replicates whose WLS surface is bistable from
            flipping basins on summation-order noise.

    Returns:
        BootstrapResult (``.summary()`` for SEs / percentile intervals).
    """
    from cokriging_tpu_torch.parallel.mesh import check_mesh

    check_mesh(mesh)
    dev = resolve_device(device)
    params = mod.params if hasattr(mod, "params") else mod
    if project_validity:
        from cokriging_tpu_torch.cov.spectral import project_to_valid

        params = project_to_valid(params)
    coords = [f.coords_main if main else f.coords for f in mf.fields]
    values_rep = simulate_replicates(params, coords, n_rep, seed=seed, geodesic=mf.geodesic,
                                     device=dev)
    pairs, centers, means, counts = batched_variograms(coords, values_rep, config, device=dev)

    if per_replicate_init and init is None:
        x0 = np.stack([
            moment_init(SimpleNamespace(pairs=list(pairs), bin_centers=centers,
                                        bin_means=means[b], bin_counts=counts, config=config),
                        spec=params.spec).to_flat().numpy()
            for b in range(n_rep)
        ])
    else:
        x_init = (init or params).to_flat().detach().cpu().numpy().astype(np.float64)
        x0 = np.tile(x_init[None], (n_rep, 1))
    flats, costs, _ = fit_wls_batch_arrays(
        x0, np.tile(centers[None], (n_rep, 1, 1)), np.nan_to_num(means, nan=0.0),
        np.tile(counts[None], (n_rep, 1, 1)), pairs, params.spec, maxiter=maxiter, mesh=mesh,
        device=dev,
    )
    return BootstrapResult(params=params, flats=flats, costs=costs)
