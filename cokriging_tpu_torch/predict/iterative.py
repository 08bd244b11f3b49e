"""Matrix-free exact joint cokriging (Jacobi-preconditioned CG).

Counterpart of ``cokriging_tpu/predict/iterative.py:52-458``.
``JointPredictor`` (``predict.joint``) factorizes the full (sum n_i)^2 joint
covariance; this module solves the same simple-kriging system without
holding it:

    W   = C^-1 K          (K = data-to-prediction cross-covariance)
    mu  = K^T (C^-1 z)
    var = diag(K*) - colsum(K * C^-1 K)

Covariance rows are assembled one (block, N) tile at a time, a distance
tile plus ``cov.matern.gathered_covariance`` (on the card through the
gathered-pairs kernel; the dense path's conventions: nugget on exact-zero
same-process distances, rho sigma_i sigma_j across), and folded at once into
``tile @ V`` against the batch of CG vectors. Peak memory is
O(block x N + N x rhs_batch); operations stay O(N^2) per CG iteration.

The conjugate-gradient solver is Jacobi-preconditioned and runs every
right-hand side of a chunk at once with per-column step sizes (a converged
column freezes: its step sizes are zero-guarded). The reference splits the
iterations into bounded dispatches for a TPU's dispatch ceiling; here it is
one loop.

LOOCV (``cross_validation``) solves C X = E for chunks of unit columns E at
the withheld rows with the same multi-right-hand-side CG; by the symmetry of
C^-1, column j of X is the precision row of datum j, which gives P_jj and
(C^-1 z)_j for the identity of ``predict.joint``,
pred_j = z_j - (C^-1 z)_j / P_jj and var_j = 1 / P_jj.

With ``mesh=`` (a ``parallel.Mesh``) the stacked system is padded to a
multiple of block x mesh.size (padded rows repeat the last datum and are
masked: zero right-hand sides, zero matvec rows, so CG keeps them at 0),
each shard runs ``_tiled_rows_matvec`` over its contiguous rows against the
replicated columns on its own device, and ``torch.cat`` on the home device
gathers the rows (the JAX package's tiled ``all_gather``); the CG iteration
stays one host loop.
"""

import warnings

import numpy as np
import torch

from cokriging_tpu_torch.cov.matern import gathered_covariance, pair_table
from cokriging_tpu_torch.kernels.distance import distance_matrix
from cokriging_tpu_torch.predict.local import LocalPrediction, coord_rows
from cokriging_tpu_torch.utils.config import resolve_device


def _tiled_rows_matvec(params, row_coords, row_procs, col_coords, col_procs, V,
                       geodesic, block, table=None):
    """y = C[rows, cols] @ V, assembling C one (block, n_cols) row tile at a
    time so the rows' covariance never materializes. ``table``: the
    parameters' ``pair_table`` for the coordinates' dtype and device, built
    here when None; with it the tiles read nothing back from the card."""
    if table is None:
        table = pair_table(params, row_coords.device, row_coords.dtype)
    out = torch.empty((row_coords.shape[0], V.shape[1]), dtype=V.dtype, device=V.device)
    for r0 in range(0, row_coords.shape[0], block):
        tile = gathered_covariance(
            params, distance_matrix(row_coords[r0:r0 + block], col_coords, geodesic),
            row_procs[r0:r0 + block], col_procs, table=table,
        )
        torch.matmul(tile.to(V.dtype), V, out=out[r0:r0 + block])
    return out


def _sharded_matvec(params, coords, procs, mask, geodesic, block, mesh):
    """V -> (C V) * mask for the padded stacked system, rows sharded over
    ``mesh``: shard k's rows (a multiple of ``block``) against all columns
    on ``mesh.devices[k]``, with its own replica of the parameters, their
    ``pair_table`` and the columns; the rows gathered on the home device."""
    from cokriging_tpu_torch.parallel.mesh import replicate, shard_batch

    rows = zip(*(shard_batch(mesh, t) for t in (coords, procs, mask)))
    shards = []
    for (c_loc, p_loc, m_loc), (prm, c_all, p_all) in zip(rows,
                                                          replicate(mesh, (params, coords, procs))):
        shards.append((prm, c_loc, p_loc, m_loc[:, None], c_all, p_all,
                       pair_table(prm, c_all.device, c_all.dtype)))

    def matvec(v):
        return torch.cat([
            (_tiled_rows_matvec(prm, c_loc, p_loc, c_all, p_all, v.to(c_all.device), geodesic,
                                block, tab) * m_loc).to(v.device)
            for prm, c_loc, p_loc, m_loc, c_all, p_all, tab in shards
        ])

    return matvec


def _pcg(params, coords, procs, B, tol, maxiter, geodesic, block, table, matvec=None):
    """X = C^-1 B by Jacobi-preconditioned CG over every column of B at
    once: (X, iterations, largest relative residual). ``table``, the
    parameters' ``pair_table``, serves every matvec; ``matvec`` replaces the
    one-device matvec (``_sharded_matvec``)."""

    if matvec is None:
        def matvec(v):
            return _tiled_rows_matvec(params, coords, procs, coords, procs, v, geodesic, block,
                                      table)

    diag = (params.sigma[procs] ** 2 + params.nugget[procs]).to(B.dtype)[:, None]
    bnorm = torch.clamp_min(torch.linalg.vector_norm(B, dim=0), torch.finfo(B.dtype).tiny)
    x = torch.zeros_like(B)
    r = B.clone()
    z = r / diag
    p = z
    rz = torch.sum(r * z, dim=0)

    def rel_residual():
        return float(torch.max(torch.linalg.vector_norm(r, dim=0) / bnorm))

    k = 0
    rel = rel_residual()
    while k < maxiter and rel > tol:
        ap = matvec(p)
        den = torch.sum(p * ap, dim=0)
        alpha = torch.where(den > 0, rz / torch.where(den > 0, den, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        z = r / diag
        rz_new = torch.sum(r * z, dim=0)
        beta = torch.where(rz > 0, rz_new / torch.where(rz > 0, rz, 1.0), 0.0)
        p = z + beta * p
        rz = rz_new
        k += 1
        rel = rel_residual()
    return x, k, rel


def _predict_chunk(params, coords, procs, a, pchunk, i, tol, maxiter, geodesic, block,
                   compute_err, table, mask=None, matvec=None):
    """(pred, pred_err, cg_iters, cg_resid) for one chunk of prediction
    locations. K follows src/joint_prediction.py:104-122: marginal rows
    carry the nugget at exact-zero distance, cross rows do not, both from
    ``gathered_covariance`` with the prediction side's process ids all i.
    ``mask`` zeroes the padded rows of a sharded system, whose ``matvec``
    the CG takes."""
    pprocs = torch.full((pchunk.shape[0],), i, dtype=procs.dtype, device=procs.device)
    K = gathered_covariance(params, distance_matrix(coords, pchunk, geodesic), procs,
                            pprocs, table=table).to(a.dtype)
    if mask is not None:
        K = K * mask[:, None]
    pred = K.T @ a[:, 0]
    if not compute_err:
        return pred, torch.full_like(pred, torch.nan), 0, 0.0
    X, iters, resid = _pcg(params, coords, procs, K, tol, maxiter, geodesic, block, table,
                           matvec)
    # diag(K*) = sigma_i^2 M(0) + nugget_i (src/joint_prediction.py:94-102)
    sill0 = params.sigma[i] ** 2 + params.nugget[i]
    var = sill0 - torch.sum(K * X, dim=0)
    return pred, torch.sqrt(torch.clamp_min(var, 0.0)), iters, resid


def _loocv_chunk(params, coords, procs, z, rows, tol, maxiter, geodesic, block, table,
                 matvec=None):
    """(pred, pred_err, cg_iters, cg_resid) of LOOCV at the data ``rows``
    (src/joint_prediction.py:207-257): X = C^-1 E for the unit columns E at
    ``rows`` in one multi-right-hand-side CG, then P_jj = X[rows_j, j] and
    (C^-1 z)_j = X[:, j] . z."""
    q = rows.shape[0]
    cols = torch.arange(q, device=z.device)
    e = torch.zeros((z.shape[0], q), dtype=z.dtype, device=z.device)
    e[rows, cols] = 1.0
    X, iters, resid = _pcg(params, coords, procs, e, tol, maxiter, geodesic, block, table,
                           matvec)
    pkk = X[rows, cols]
    pred = z[rows] - (X.T @ z) / pkk
    return pred, torch.sqrt(torch.clamp_min(1.0 / pkk, 0.0)), iters, resid


class IterativeJointPredictor:
    """Exact joint cokriging without materializing the joint covariance, on
    ``device`` (the card unless ``device="cpu"``), in the dtype of the field
    values.

    The same system and conventions as ``JointPredictor``, with results
    equal to solver tolerance; CG run to ``tol`` is the exact solve.

    Args:
        mod / mf / covariates: as JointPredictor.
        block: row-tile height of the matrix-free matvec; peak memory per
            matvec is O(block x N).
        rhs_batch: prediction points (or LOOCV data rows) solved together per
            CG run; the last chunk is solved at its own width.
        tol: relative-residual CG stopping tolerance.
        maxiter: CG iteration cap; a solve that ends above 10 tol warns.
        mesh: optional ``parallel.Mesh``: the matvec's row tiles are
            sharded over it (see the module docstring).
    """

    def __init__(self, mod, mf, covariates=None, *, block: int = 512, rhs_batch: int = 256,
                 tol: float = 1e-6, maxiter: int = 1000, mesh=None, device=None) -> None:
        if mod.n_procs != mf.n_procs:
            raise ValueError(
                "Number of theoretical processes different from empirical processes."
            )
        from cokriging_tpu_torch.parallel.mesh import check_mesh

        self.mesh = check_mesh(mesh)
        self.device = resolve_device(device)
        self.n_procs = mod.n_procs
        self.mod = mod
        self.mf = mf
        self.covariates = covariates
        self.block = int(block)
        self.rhs_batch = int(rhs_batch)
        self.tol = float(tol)
        self.maxiter = int(maxiter)
        self.last_diagnostics = None
        dtype = torch.as_tensor(mf.fields[0].values_main).dtype
        self.params = mod.params.to(device=self.device, dtype=dtype)

    def _stacked(self):
        """Per-process main-grid data stacked into (N, 2) coordinates,
        process ids and values on the device, and the CG's matvec: None
        (the one-device matvec), or under a mesh ``_sharded_matvec`` of the
        system padded to a multiple of block x mesh.size, whose padded
        rows repeat the last datum with value 0. Also the padded rows' mask
        (None without a mesh)."""
        fields = self.mf.fields
        coords = torch.cat([torch.as_tensor(f.coords_main) for f in fields]).to(self.device)
        procs = torch.cat([torch.full((f.coords_main.shape[0],), k, dtype=torch.int64)
                           for k, f in enumerate(fields)]).to(self.device)
        z = torch.cat([torch.as_tensor(f.values_main) for f in fields]).to(self.device)
        if self.mesh is None:
            return coords, procs, z, None, None
        n = coords.shape[0]
        pad = (-n) % (self.block * self.mesh.size)
        coords = torch.cat([coords, coords[-1:].expand(pad, -1)])
        procs = torch.cat([procs, procs[-1:].expand(pad)])
        z = torch.cat([z, z.new_zeros(pad)])
        mask = (torch.arange(n + pad, device=self.device) < n).to(z.dtype)
        matvec = _sharded_matvec(self.params, coords, procs, mask, self.mf.geodesic, self.block,
                                 self.mesh)
        return coords, procs, z, mask, matvec

    def _warn_unconverged(self, diags, what):
        self.last_diagnostics = diags
        worst = max(r for _, r in diags)
        if worst > 10.0 * self.tol:
            warnings.warn(
                f"{what} did not converge (relative residual "
                f"{worst:.2e} > tol {self.tol:.0e} after maxiter="
                f"{self.maxiter}); results are approximate."
            )

    def __call__(self, i: int, pcoords, postprocess: bool = True,
                 compute_err: bool = True):
        """Predict process i at the (n_pred, 2) ``pcoords`` (an array, a
        tensor or a frame of the two coordinate columns): with
        ``postprocess`` (the default) the reference's frame on the data
        scale, else a ``LocalPrediction`` in standardized units.
        ``compute_err=False`` skips
        the per-point variance solves (one 1-column CG in all) and returns
        NaN ``pred_err``."""
        params = self.params
        geo = self.mf.geodesic
        p_arr = coord_rows(pcoords)
        with torch.no_grad():
            coords, procs, z, mask, matvec = self._stacked()
            pc = torch.tensor(p_arr, dtype=coords.dtype, device=self.device)
            table = pair_table(params, self.device, coords.dtype)
            a, it0, res0 = _pcg(params, coords, procs, z[:, None], self.tol, self.maxiter,
                                geo, self.block, table, matvec)
            diags = [(it0, res0)]
            preds, errs = [], []
            for lo in range(0, pc.shape[0], self.rhs_batch):
                pred, err, it, res = _predict_chunk(
                    params, coords, procs, a, pc[lo:lo + self.rhs_batch], i, self.tol,
                    self.maxiter, geo, self.block, compute_err, table, mask, matvec,
                )
                diags.append((it, res))
                preds.append(pred)
                errs.append(err)
        self._warn_unconverged(diags, "iterative joint solve")
        n_data = int(z.shape[0]) if mask is None else int(mask.sum())
        out = LocalPrediction(
            p_arr, torch.cat(preds).cpu().numpy(), torch.cat(errs).cpu().numpy(),
            np.full(p_arr.shape[0], n_data), geo,
        )
        if postprocess:
            from cokriging_tpu_torch.predict.postprocess import postprocess_predictions

            return postprocess_predictions(out.to_dataframe(), self.mf.fields[i],
                                           self.covariates)
        return out

    def cross_validation(self, i: int, postprocess: bool = True):
        """Matrix-free LOOCV at every main-grid datum of process i, exact to
        the CG tolerance (``_loocv_chunk``; the dense ``JointPredictor``'s
        precision identity without C^-1): with ``postprocess`` (the default)
        the LOOCV frame (``predict.postprocess.loocv_frame``), else a
        ``LocalPrediction`` in standardized units. ``last_diagnostics`` holds
        (iterations, relative residual) per chunk; a chunk ending above 10
        tol warns."""
        params = self.params
        geo = self.mf.geodesic
        sizes = [int(f.coords_main.shape[0]) for f in self.mf.fields]
        offset = sum(sizes[:i])
        with torch.no_grad():
            coords, procs, z, _, matvec = self._stacked()
            table = pair_table(params, self.device, coords.dtype)
            preds, errs, diags = [], [], []
            for lo in range(0, sizes[i], self.rhs_batch):
                rows = torch.arange(offset + lo, offset + min(lo + self.rhs_batch, sizes[i]),
                                    device=self.device)
                pred, err, it, res = _loocv_chunk(params, coords, procs, z, rows, self.tol,
                                                  self.maxiter, geo, self.block, table, matvec)
                diags.append((it, res))
                preds.append(pred)
                errs.append(err)
        self._warn_unconverged(diags, "iterative LOOCV solves")
        pred, err = torch.cat(preds).cpu().numpy(), torch.cat(errs).cpu().numpy()
        field = self.mf.fields[i]
        if postprocess:
            from cokriging_tpu_torch.predict.postprocess import loocv_frame

            return loocv_frame(field, geo, pred, err, True)
        data_coords = np.asarray(field.coords_main)
        return LocalPrediction(data_coords, pred, err, np.full(sizes[i], sum(sizes) - 1), geo)
