"""The north-star benchmark on the port: ``python -m cokriging_tpu_torch bench``.

The workload of the JAX package's ``bench.py``: one 0.5-degree CONUS month of
synthetic observations, 2 x ``BENCH_N`` (default 12,500 per process):

1. empirical (cross-)semivariograms, one launch per pass over all three;
2. a 600-step Adam composite-WLS Matern fit from the moment initializer;
3. local cokriging with uncertainty at every 0.5-degree CONUS land cell
   within 1,000 km, from ~200 observations per field.

A warm-up run, then a timed run on fresh noise over the same coordinates;
then the second axis, the exact NLL's value + gradient per second at the
same n. Prints ONE JSON line with ``bench.py``'s keys (``metric``, ``value``,
``unit``, ``vs_baseline`` = 10 s / value, ``nll_evals_per_sec``) and its
rounding.

Dtypes follow the card's measurements: fit + predict in the port's measured
default (``utils.config.compute_dtype``: float32 on the card, float64 on the
host); the NLL axis in float64 everywhere, because in float32 the bench's
NLL point is not positive definite and every evaluation would be the
penalty. An evaluation that returns the penalty or a non-finite value or
gradient raises rather than giving a rate.

``BENCH_VERBOSE=1`` logs each stage to stderr. The module imports numpy
only; torch and the port's modules load inside the functions.
"""

import hashlib
import json
import os
import sys
import time

import numpy as np

VERBOSE = os.environ.get("BENCH_VERBOSE", "0") == "1"

N_PER_PROC = int(os.environ.get("BENCH_N", 12_500))  # paired obs ~ 25k
TARGET_SECONDS = 10.0
METRIC = "0.5-deg CONUS monthly cokriging fit+predict wall-clock (n~25k)"
MAXITER = 600
# The warm-up builds the kernels and runs every code path once; its Adam
# steps only warm up, so it takes this many of them (the timed run keeps
# MAXITER).
WARMUP_MAXITER = 10
MAX_DIST_KM = 1_000.0  # the local neighborhood radius
NLL_LEN_SCALE_KM = 700.0  # every length scale of the NLL point
NLL_JITTER = 1e-6
NLL_REPS = 3


def _log(msg):
    if VERBOSE:
        print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def _synthetic_month(rng, n):
    """CONUS-like observations: smooth spatial signal + noise."""
    lat = rng.uniform(24.0, 50.0, n)
    lon = rng.uniform(-124.0, -67.0, n)
    coords = np.column_stack([lat, lon])
    signal = (
        np.sin(np.deg2rad(lat) * 6.0)
        + 0.5 * np.cos(np.deg2rad(lon) * 4.0)
        + 0.3 * np.sin(np.deg2rad(lat * 2 + lon))
    )
    return coords, signal


def build_inputs(dtype, noise_seed=1, n=None):
    """(c1, v1, c2, v2) as numpy arrays of ``dtype``, ``n`` (default
    ``N_PER_PROC``) observations per process. The coordinates are fixed;
    the observation noise is drawn from ``noise_seed``, so the timed run
    gets fresh values at the warm-up's coordinates."""
    n = N_PER_PROC if n is None else n
    rng = np.random.default_rng(0)
    c1, s1 = _synthetic_month(rng, n)
    c2, s2 = _synthetic_month(rng, n)
    nrng = np.random.default_rng(noise_seed)
    v1 = s1 + nrng.normal(scale=0.4, size=n)
    v2 = -0.6 * s2 + nrng.normal(scale=0.4, size=n)
    v1 = (v1 - v1.mean()) / v1.std()
    v2 = (v2 - v2.mean()) / v2.std()
    return c1.astype(dtype), v1.astype(dtype), c2.astype(dtype), v2.astype(dtype)


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_pipeline(c1, v1, c2, v2, pred_coords, dtype, device, maxiter=MAXITER, nu_start=None):
    """One fit + predict of the month on ``device``: returns (params, fit
    result, raw ``LocalPrediction``, stage times, predictor). ``nu_start``
    replaces the initializer's smoothness (tests start off nu = 1.5)."""
    import torch

    from cokriging_tpu_torch.cov.matern import MultivariateMatern
    from cokriging_tpu_torch.estimate.empirical import (
        EmpiricalVariogram, VarioConfig, empirical_variograms_device,
    )
    from cokriging_tpu_torch.estimate.wls import fit_wls, moment_init
    from cokriging_tpu_torch.fields.field import Field, MultiField
    from cokriging_tpu_torch.predict.local import LocalPredictor

    times = {}
    _sync(device)
    t0 = time.perf_counter()
    _log("variograms (one launch per pass over the three)")
    cfg = VarioConfig(max_dist=3_000.0, n_bins=15, geodesic=True)
    pairs, centers, means, counts = empirical_variograms_device(
        [c1, c2], [v1, v2], cfg, device=device
    )
    est = EmpiricalVariogram(
        config=cfg, pairs=pairs, bin_centers=centers.astype(dtype),
        bin_means=means.astype(dtype), bin_counts=counts.astype(dtype),
    )
    _sync(device)
    t1 = time.perf_counter()
    _log(f"WLS fit ({maxiter} Adam steps)")
    init = moment_init(est)
    if nu_start is not None:
        flat = init.to_flat().clone()
        flat[2:5] = nu_start
        init = init.with_flat(flat)
    params, result = fit_wls(est, init=init, method="adam", maxiter=maxiter, device=device)
    _sync(device)
    t2 = time.perf_counter()
    _log("local predictor setup and prediction")
    sub = max(1, len(c1) // 200)  # ~200 obs/field on the "main" grid
    f1 = Field.from_arrays(c1[::sub], v1[::sub], "Z0")
    f1.geodesic = True
    f2 = Field.from_arrays(c2[::sub], v2[::sub], "Z1")
    f2.geodesic = True
    torch_dtype = getattr(torch, np.dtype(dtype).name)
    mod = MultivariateMatern(params=params.astype(torch_dtype))
    lp = LocalPredictor(mod, MultiField(fields=[f1, f2]), device=device)
    out = lp(0, pred_coords, max_dist=MAX_DIST_KM, postprocess=False)
    _sync(device)
    t3 = time.perf_counter()
    _log(f"pipeline done: {float(np.isfinite(out.pred).mean()):.4%} of "
         f"{len(out.pred)} predictions finite")
    times.update(variograms_s=t1 - t0, fit_s=t2 - t1, predict_s=t3 - t2, total_s=t3 - t0,
                 counts_per_pair=counts.sum(axis=1).tolist(),
                 counts_sha256=hashlib.sha256(np.ascontiguousarray(counts).tobytes()).hexdigest())
    return params, result, out, times, lp


def nll_evals_per_sec(c1, v1, c2, v2, device):
    """Warm exact-NLL value + gradient throughput at the month's n, float64,
    at bench.py's point (default parameters, every length scale
    ``NLL_LEN_SCALE_KM``, measurement variances 0, jitter ``NLL_JITTER``):
    one warm-up, then 1 / the least time of ``NLL_REPS`` calls at x0 (1 +
    0.01 (i + 1)). Returns (evals per second, record of the timed calls:
    points, values, gradients, seconds, the kernels' launch counts). Raises
    where an evaluation is the non-PD penalty or not finite."""
    import torch

    from cokriging_tpu_torch.cov.params import MaternParams
    from cokriging_tpu_torch.estimate.nll import (
        _penalty, joint_distance_blocks, nll_value_and_grad,
    )
    from cokriging_tpu_torch.kernels import cuda_ops as K

    _log("NLL evals/sec: distance blocks")
    coords = [torch.as_tensor(c, dtype=torch.float64, device=device) for c in (c1, c2)]
    dists = joint_distance_blocks(coords, geodesic=True)
    z = torch.as_tensor(np.concatenate([v1, v2]), dtype=torch.float64, device=device)
    mvar = torch.zeros_like(z)
    params = MaternParams.default(2)
    x0 = params.to_flat().numpy().astype(np.float64)
    x0[5:8] = NLL_LEN_SCALE_KM  # len_scales well inside the data span
    penalty = float(_penalty(z.shape[0], torch.float64, "cpu"))

    def evaluate(x):
        _sync(device)
        t0 = time.perf_counter()
        v, g = nll_value_and_grad(torch.as_tensor(x, device=device), dists, z, params.spec, mvar,
                                  NLL_JITTER)
        _sync(device)
        secs = time.perf_counter() - t0
        v, g = v.item(), g.cpu().numpy()
        if v == penalty or not (np.isfinite(v) and np.isfinite(g).all()):
            raise RuntimeError(
                f"the NLL at {x.tolist()} is {'the non-PD penalty' if v == penalty else v} "
                f"(gradient finite: {bool(np.isfinite(g).all())}): no rate to report"
            )
        return v, g, secs

    _log("NLL evals/sec: warm-up")
    evaluate(x0)
    _log("NLL evals/sec: timed evals")
    K.reset_launch_counts()
    xs = [x0 * (1.0 + 0.01 * (i + 1)) for i in range(NLL_REPS)]
    runs = [evaluate(x) for x in xs]
    launches = K.launch_counts()
    secs = [t for _, _, t in runs]
    record = dict(x=xs, values=[v for v, _, _ in runs], grads=[g for _, g, _ in runs],
                  seconds=secs, launches=launches)
    return 1.0 / min(secs), record


def main(device="cuda"):
    """Run the benchmark on ``device`` (the card unless the caller asks for
    the CPU) and print its JSON line. Returns the line and the timed run's
    results: params, fit result, predictions, predictor, stage times, the
    launch counts of the timed month (set to 0 just before it) and the NLL
    axis' record."""
    from cokriging_tpu_torch.data.grids import prediction_coords
    from cokriging_tpu_torch.kernels import cuda_ops as K
    from cokriging_tpu_torch.utils.config import compute_dtype, resolve_device

    dev = resolve_device(device)
    dtype = np.dtype(str(compute_dtype(dev)).replace("torch.", "")).type
    _log(f"start on {dev}: fit + predict in {np.dtype(dtype).name}, {N_PER_PROC} obs per process")
    c1, v1, c2, v2 = build_inputs(dtype, noise_seed=1)
    pred_coords = prediction_coords().astype(dtype)

    _log("warm-up")
    run_pipeline(c1, v1, c2, v2, pred_coords, dtype, dev, maxiter=WARMUP_MAXITER)

    # timed run on fresh value buffers at the same coordinates
    _, v1b, _, v2b = build_inputs(dtype, noise_seed=2)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    params, result, out, times, lp = run_pipeline(c1, v1b, c2, v2b, pred_coords, dtype, dev,
                                                  maxiter=MAXITER)
    elapsed = time.perf_counter() - t0
    launches = K.launch_counts()

    # second axis: exact-NLL value + gradient throughput at the same n, on
    # the timed run's month built in float64
    evals_ps, nll = nll_evals_per_sec(*build_inputs(np.float64, noise_seed=2), dev)

    line = {
        "metric": METRIC,
        "value": round(elapsed, 3),
        "unit": "s",
        "vs_baseline": round(TARGET_SECONDS / elapsed, 3),
        "nll_evals_per_sec": round(evals_ps, 4),
    }
    print(json.dumps(line))
    return dict(line=line, elapsed_s=elapsed, dtype=np.dtype(dtype).name, params=params,
                result=result, out=out, lp=lp, times=times, launches=launches,
                nll_evals_per_sec=evals_ps, nll=nll)
