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
units, or with ``postprocess=True`` as the reference's frames on the data
scale (``predict.postprocess``). ``sample`` draws conditional simulations
from the full posterior (mean and covariance).
"""

import warnings

import numpy as np
import torch

from cokriging_tpu_torch.cov.matern import block_covariance, covariance_block, pair_table
from cokriging_tpu_torch.estimate.nll import joint_distance_blocks
from cokriging_tpu_torch.kernels.distance import distance_matrix
from cokriging_tpu_torch.kernels.linalg import spd_inverse_from_chol
from cokriging_tpu_torch.predict.local import LocalPrediction, coord_rows
from cokriging_tpu_torch.utils.config import resolve_device


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
            covariance_block(params, i, j, distance_matrix(cj, pcoords, geodesic), table)
            for j, cj in enumerate(coords_tuple)
        ],
        dim=0,
    )
    pred_cov = covariance_block(params, i, i, distance_matrix(pcoords, pcoords, geodesic), table)
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


def _posterior(params, coords_tuple, values_tuple, pcoords, i, geodesic):
    """The joint-cokriging posterior of process i at ``pcoords``: (pred,
    pred_err, the symmetrized posterior covariance K* - W^T K, and its root
    U sqrt(max(w, 0)) from ``eigh``, so root root^T is the covariance with
    its negative eigenvalues clipped to 0).

    The root comes from eigh rather than Cholesky: the posterior is only
    positive semi-definite (exactly singular where pcoords touch data
    locations and the nugget is zero), and clipping is the clean limit there,
    where a Cholesky would fail.
    """
    joint_cov, pred_cross, pred_cov = _joint_system(params, coords_tuple, pcoords, i, geodesic)
    z = torch.cat(list(values_tuple))
    weights = _refined_posdef_solve(joint_cov, pred_cross)
    pred = weights.T @ z
    post_cov = pred_cov - weights.T @ pred_cross
    post_cov = 0.5 * (post_cov + post_cov.T)
    pred_err = torch.sqrt(torch.clamp_min(post_cov.diagonal(), 0.0))
    w, u = torch.linalg.eigh(post_cov)
    return pred, pred_err, post_cov, u * torch.sqrt(torch.clamp_min(w, 0.0))[None, :]


def _posterior_noise(seed: int, n_pred: int, n_samples: int, dtype, device) -> torch.Tensor:
    """(n_pred, n_samples) standard normals from a generator on ``device``
    seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn((n_pred, n_samples), generator=gen, dtype=dtype, device=device)


def _conditional_sample_core(params, coords_tuple, values_tuple, pcoords, seed, i, geodesic,
                             n_samples):
    """Conditional (posterior) Gaussian simulation at ``pcoords``.

    The joint-cokriging predictive distribution is the full Gaussian
    posterior, mean W^T z and covariance K* - W^T K (the matrix whose
    diagonal the reference reads pred_err off, src/joint_prediction.py:74-78,
    discarding the off-diagonals). Its draws are field realizations that
    honor the data, the model and the spatial correlation of the prediction
    error: the geostatistical "conditional simulation" the reference never
    implemented. The nugget rides the prediction covariance as in
    prediction, so samples are of the observable process Z.

    Returns (pred, pred_err, samples (n_samples, npred)) in standardized
    units.
    """
    pred, pred_err, _, root = _posterior(params, coords_tuple, values_tuple, pcoords, i,
                                         geodesic)
    eps = _posterior_noise(seed, root.shape[0], n_samples, root.dtype, root.device)
    return pred, pred_err, (pred[:, None] + root @ eps).T


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
    ``device="cpu"``), in the dtype of the field values. ``covariates`` is
    the prediction grid's covariate frame for ``postprocess=True``."""

    def __init__(self, mod, mf, covariates=None, device=None) -> None:
        if mod.n_procs != mf.n_procs:
            raise ValueError(
                "Number of theoretical processes different from empirical processes."
            )
        self.device = resolve_device(device)
        self.n_procs = mod.n_procs
        self.mod = mod
        self.mf = mf
        self.covariates = covariates
        dtype = torch.as_tensor(mf.fields[0].values_main).dtype
        self.params = mod.params.to(device=self.device, dtype=dtype)

    def _data(self):
        coords = tuple(torch.as_tensor(f.coords_main).to(self.device) for f in self.mf.fields)
        values = tuple(torch.as_tensor(f.values_main).to(self.device) for f in self.mf.fields)
        return coords, values

    def __call__(self, i: int, pcoords, postprocess: bool = False,
                 cv_ix=None):
        """Predict process i at the (n_pred, 2) ``pcoords`` (an array, a
        tensor or a frame of the two coordinate columns): a
        ``LocalPrediction`` in standardized units, or with ``postprocess``
        the reference's frame on the data scale.

        ``cv_ix`` reproduces the reference's single-point withholding path
        (delete datum cv_ix of process i, predict at pcoords).
        """
        coords, values = self._data()
        p_arr = coord_rows(pcoords)
        pc = torch.tensor(p_arr, dtype=values[i].dtype, device=self.device)
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
        out = LocalPrediction(
            p_arr, pred.cpu().numpy(), pred_err.cpu().numpy(),
            np.full(p_arr.shape[0], n_data), geo,
        )
        if postprocess:
            from cokriging_tpu_torch.predict.postprocess import postprocess_predictions

            return postprocess_predictions(out.to_dataframe(), self.mf.fields[i],
                                           self.covariates)
        return out

    def _verify_model(self, params, coords, pcoords, i, geodesic):
        """PD check of the bordered [pred, data] covariance by trial
        Cholesky (src/joint_prediction.py:260-274)."""
        if _verify_core(params, coords, pcoords, i, geodesic):
            warnings.warn(
                "Prediction joint covariance matrix is not positive definite;"
                " model technically invalid."
            )

    def sample(self, i: int, pcoords, n_samples: int = 1, seed: int = 0,
               postprocess: bool = False):
        """Conditional simulation: ``n_samples`` realizations of process i
        at ``pcoords`` from the full joint-cokriging posterior (mean and
        covariance, not just the diagonal the reference reports), drawn on
        the predictor's device from a generator seeded with ``seed``.

        Returns ``(prediction, samples)``: what ``__call__`` returns (a
        ``LocalPrediction``, or with ``postprocess`` the frame on the data
        scale) and an ``(n_samples, n_rows)`` numpy array of realizations
        aligned with its rows, in the same units: with ``postprocess`` every
        realization gets the frame's affine back-transform, its additive
        surface read off the frame itself (pred' - scale_fact * pred), so
        the covariate merge and its dropped rows live in
        ``postprocess_predictions`` alone.
        """
        coords, values = self._data()
        p_arr = coord_rows(pcoords)
        pc = torch.tensor(p_arr, dtype=values[i].dtype, device=self.device)
        geo = self.mf.geodesic
        with torch.no_grad():
            self._verify_model(self.params, coords, pc, i, geo)
            pred, pred_err, samples = _conditional_sample_core(
                self.params, coords, values, pc, seed, i, geo, int(n_samples))
        samples = samples.cpu().numpy()
        n_data = sum(int(v.shape[0]) for v in values)
        out = LocalPrediction(p_arr, pred.cpu().numpy(), pred_err.cpu().numpy(),
                              np.full(p_arr.shape[0], n_data), geo)
        if not postprocess:
            return out, samples
        from cokriging_tpu_torch.predict.postprocess import postprocess_predictions

        df = out.to_dataframe()
        df["_row_ix"] = np.arange(len(df))
        frame = postprocess_predictions(df, self.mf.fields[i], self.covariates)
        keep = frame["_row_ix"].to_numpy().astype(int)
        trend = self.mf.fields[i].trend
        s = 1.0 if trend is None else trend.scale_fact
        additive = frame["pred"].to_numpy() - s * out.pred[keep].astype(np.float64)
        return frame.drop(columns="_row_ix"), samples[:, keep] * s + additive[None, :]

    def cross_validation(self, i: int, postprocess: bool = False,
                         method: str = "fast"):
        """LOOCV at every data location of process i
        (src/joint_prediction.py:207-257): a ``LocalPrediction`` in
        standardized units, or with ``postprocess`` the LOOCV frame
        (``predict.postprocess.loocv_frame``).

        method='fast' uses the one-factorization precision identity;
        method='naive' replays the reference's delete-and-refactorize loop
        (useful as a numerical cross-check).
        """
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
        if postprocess:
            from cokriging_tpu_torch.predict.postprocess import loocv_frame

            return loocv_frame(self.mf.fields[i], geo, pred, pred_err, True)
        n_data = sum(int(v.shape[0]) for v in values)
        return LocalPrediction(data_coords, pred, pred_err, np.full(n_i, n_data - 1), geo)
