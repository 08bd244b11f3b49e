"""Exact joint cokriging (one global simple-kriging system).

Counterpart of ``cokriging_tpu/predict/joint.py``, after the reference
joint Predictor (src/joint_prediction.py:13-257): the full (n1 + n2) x
(n1 + n2) data covariance is assembled from Matern blocks (on the card
through the Matern kernel), factorized once by Cholesky, and all prediction
weights come from triangular solves:

    W   = C^-1 K            (K = data-to-prediction cross-covariance)
    mu  = W^T z             (src/joint_prediction.py:68-77)
    Sig = K* - W^T K        (predictive covariance; err = sqrt(diag))

LOOCV: the reference deletes one row/column per datum and refactorizes the
whole system n times (src/joint_prediction.py:207-257). Withholding datum k
and predicting at its own location with the same model is algebraically the
bordered-system identity on the precision matrix P = C^-1:

    pred_k = z_k - (P z)_k / P_kk        var_k = 1 / P_kk

so the entire LOOCV sweep costs one factorization and one inverse. The
naive delete-row/col path is kept (``cross_validation(..., method='naive')``)
as a cross-check.

Predictions come back as ``predict.local.LocalPrediction`` in standardized
units. Conditional simulation (``sample``) and postprocessing to data scale
come with ``sim/`` and ``predict/postprocess.py``.
"""

import warnings

import numpy as np
import torch

from cokriging_tpu_torch.cov.matern import block_covariance, pair_table
from cokriging_tpu_torch.estimate.nll import joint_distance_blocks
from cokriging_tpu_torch.kernels.cuda_ops import matern_correlation_block
from cokriging_tpu_torch.kernels.distance import distance_matrix
from cokriging_tpu_torch.kernels.linalg import spd_inverse_from_chol
from cokriging_tpu_torch.predict.local import LocalPrediction
from cokriging_tpu_torch.utils.config import resolve_device


def _cov_block(params, i, j, d, table):
    """Covariance block between process i and process j at the 2-D
    distances ``d`` (nugget at exact zeros when i == j): on a CUDA tensor
    through the Matern kernel with the pair's row of ``table`` (the
    parameters' ``pair_table`` where it is of d's dtype), like the blocks of
    the joint covariance."""
    row = table.rows(i, j)[0] if d.is_cuda and d.dtype == table.value.dtype else None
    m = matern_correlation_block(params.nu[i, j], params.len_scale[i, j], d, table=row)
    if i == j:
        return m.mul_(params.sigma[i] ** 2).add_(torch.where(d == 0.0, params.nugget[i], 0.0))
    return m.mul_(params.rho[i, j] * params.sigma[i] * params.sigma[j])


def _joint_system(params, coords_tuple, pcoords, i, geodesic):
    """The three joint-cokriging covariance pieces for process i:

    - joint data covariance (src/joint_prediction.py:124-153),
    - data -> prediction cross-covariance stack (:104-122),
    - prediction-grid covariance with nugget (:94-102).
    """
    dists = joint_distance_blocks(list(coords_tuple), geodesic=geodesic)
    table = pair_table(params, dists[0][0].device, dists[0][0].dtype)
    joint_cov = block_covariance(params, dists, table=table)
    pred_cross = torch.cat(
        [
            _cov_block(params, i, j, distance_matrix(cj, pcoords, geodesic), table)
            for j, cj in enumerate(coords_tuple)
        ],
        dim=0,
    )
    pred_cov = _cov_block(params, i, i, distance_matrix(pcoords, pcoords, geodesic), table)
    return joint_cov, pred_cross, pred_cov


def _joint_predict_core(params, coords_tuple, values_tuple, pcoords, i, geodesic):
    """(pred, pred_err) at ``pcoords`` for process i; ``coords_tuple`` and
    ``values_tuple`` are the per-process tensors on the main grid."""
    joint_cov, pred_cross, pred_cov = _joint_system(
        params, coords_tuple, pcoords, i, geodesic
    )
    z = torch.cat(list(values_tuple))
    weights = _refined_posdef_solve(joint_cov, pred_cross)  # (ndata, npred)
    pred = weights.T @ z
    pred_var = pred_cov.diagonal() - torch.sum(weights * pred_cross, dim=0)
    pred_err = torch.sqrt(torch.clamp_min(pred_var, 0.0))
    return pred, pred_err


def _refined_posdef_solve(a, b, refine_iters: int = 2):
    """Solve a X = b for PD a via Cholesky, with mixed-precision iterative
    refinement when running in float32: factorize in the working dtype and
    apply ``refine_iters`` corrections from residuals formed in float64
    (standard Wilkinson refinement; a residual formed in the working
    precision would be rounding noise). A failed factorization gives NaN."""
    chol, info = torch.linalg.cholesky_ex(a)
    x = torch.cholesky_solve(b, chol)
    if refine_iters and a.dtype == torch.float32:
        a64 = a.double()
        b64 = b.double()
        for _ in range(refine_iters):
            r = (b64 - a64 @ x.double()).float()
            x = x + torch.cholesky_solve(r, chol)
    return torch.where(info == 0, x, torch.nan)


def _verify_core(params, coords_tuple, pcoords, i, geodesic):
    """True when the bordered [pred, data] system is not positive definite
    (trial Cholesky)."""
    joint_cov, k, pred_cov = _joint_system(params, coords_tuple, pcoords, i, geodesic)
    bordered = torch.cat(
        [torch.cat([pred_cov, k.T], dim=1), torch.cat([k, joint_cov], dim=1)], dim=0
    )
    chol, info = torch.linalg.cholesky_ex(bordered)
    return bool(info != 0) or not bool(torch.isfinite(chol.diagonal()).all())


def _loocv_core(params, coords_tuple, values_tuple, i, geodesic):
    """All-at-once LOOCV for process i via the precision-matrix identity."""
    dists = joint_distance_blocks(list(coords_tuple), geodesic=geodesic)
    joint_cov = block_covariance(params, dists)
    z = torch.cat(list(values_tuple))
    chol, info = torch.linalg.cholesky_ex(joint_cov)
    precision = spd_inverse_from_chol(chol)
    pz = precision @ z
    pkk = precision.diagonal()
    pred_all = torch.where(info == 0, z - pz / pkk, torch.nan)
    var_all = torch.where(info == 0, 1.0 / pkk, torch.nan)
    offset = sum(int(v.shape[0]) for v in values_tuple[:i])
    sl = slice(offset, offset + int(values_tuple[i].shape[0]))
    return pred_all[sl], torch.sqrt(torch.clamp_min(var_all[sl], 0.0))


class JointPredictor:
    """OO surface mirroring the reference joint Predictor
    (src/joint_prediction.py:13-257), on ``device`` (the card unless
    ``device="cpu"``), in the dtype of the field values."""

    def __init__(self, mod, mf, device=None) -> None:
        if mod.n_procs != mf.n_procs:
            raise ValueError(
                "Number of theoretical processes different from empirical processes."
            )
        self.device = resolve_device(device)
        self.n_procs = mod.n_procs
        self.mod = mod
        self.mf = mf
        dtype = torch.as_tensor(mf.fields[0].values_main).dtype
        self.params = mod.params.to(device=self.device, dtype=dtype)

    def _data(self):
        coords = tuple(torch.as_tensor(f.coords_main).to(self.device) for f in self.mf.fields)
        values = tuple(torch.as_tensor(f.values_main).to(self.device) for f in self.mf.fields)
        return coords, values

    def __call__(self, i: int, pcoords, postprocess: bool = False,
                 cv_ix=None) -> LocalPrediction:
        """Predict process i at the (n_pred, 2) ``pcoords``.

        ``cv_ix`` reproduces the reference's single-point withholding path
        (delete datum cv_ix of process i, predict at pcoords).
        """
        if postprocess:
            raise NotImplementedError(
                "postprocessing to data scale needs fields built from data frames"
            )
        coords, values = self._data()
        p_arr = np.atleast_2d(np.asarray(pcoords))
        pc = torch.as_tensor(p_arr, dtype=values[i].dtype, device=self.device)
        geo = self.mf.geodesic
        with torch.no_grad():
            if cv_ix is not None:
                keep = torch.ones(coords[i].shape[0], dtype=torch.bool, device=self.device)
                keep[cv_ix] = False
                coords = tuple(c[keep] if j == i else c for j, c in enumerate(coords))
                values = tuple(v[keep] if j == i else v for j, v in enumerate(values))
            else:
                self._verify_model(self.params, coords, pc, i, geo)
            pred, pred_err = _joint_predict_core(self.params, coords, values, pc, i, geo)
        n_data = sum(int(v.shape[0]) for v in values)
        return LocalPrediction(
            p_arr, pred.cpu().numpy(), pred_err.cpu().numpy(),
            np.full(p_arr.shape[0], n_data), geo,
        )

    def _verify_model(self, params, coords, pcoords, i, geodesic):
        """PD check of the bordered [pred, data] covariance by trial
        Cholesky (src/joint_prediction.py:260-274)."""
        if _verify_core(params, coords, pcoords, i, geodesic):
            warnings.warn(
                "Prediction joint covariance matrix is not positive definite;"
                " model technically invalid."
            )

    def cross_validation(self, i: int, postprocess: bool = False,
                         method: str = "fast") -> LocalPrediction:
        """LOOCV at every data location of process i
        (src/joint_prediction.py:207-257).

        method='fast' uses the one-factorization precision identity;
        method='naive' replays the reference's delete-and-refactorize loop
        (useful as a numerical cross-check).
        """
        if postprocess:
            raise NotImplementedError(
                "postprocessing to data scale needs fields built from data frames"
            )
        coords, values = self._data()
        geo = self.mf.geodesic
        data_coords = coords[i].cpu().numpy()
        n_i = data_coords.shape[0]
        if method == "fast":
            with torch.no_grad():
                pred, pred_err = _loocv_core(self.params, coords, values, i, geo)
            pred, pred_err = pred.cpu().numpy(), pred_err.cpu().numpy()
        else:
            outs = [self(i, data_coords[k], cv_ix=k) for k in range(n_i)]
            pred = np.array([o.pred[0] for o in outs])
            pred_err = np.array([o.pred_err[0] for o in outs])
        n_data = sum(int(v.shape[0]) for v in values)
        return LocalPrediction(data_coords, pred, pred_err, np.full(n_i, n_data - 1), geo)
