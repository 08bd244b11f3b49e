#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``cokriging_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero without the final ok line:

(a) card and environment: ``nvidia-smi`` name and power limit, the device
    name, which of pandas/matplotlib/jax are installed, and that the port's
    main path imports none of them (nor optax, nor ``cokriging_tpu``);
(b) build: compile the CUDA sources under ``cokriging_tpu_torch/kernels/csrc``
    and print the build time and the ptxas register/spill lines;
(c) every kernel against its plain torch version on the card, in float32 and
    float64, at the main path's shapes: the variogram passes at 3 pairs x
    12,500 points x 15 bins (counts and h range exact, means rtol 1e-5 /
    1e-12) and the Matern kernel at the 256 x 256 joint blocks, a 4096^2
    symmetric block and nu in {0.5, 1.5, 2.7} (atol 5e-6 / 1e-12); then the
    whole path at 400 points per process on the card against the same code
    on the CPU (float64, fitted parameters rtol 1e-6, predictions atol 1e-6);
(d) the main path at the benchmark's size (bench.py's workload: 2 x 12,500
    synthetic CONUS observations, variograms, a 600-step Adam WLS fit from
    the moment initializer, local cokriging at every 0.5-degree land cell),
    float32 then float64: a warm-up run, then a timed run on fresh noise with
    the launch counts set to 0 just before it and read just after; every
    kernel must have run, the fit must lie in its bounds, and the
    predictions must follow the reference's semantics (> 99% finite when
    the fitted joint covariance is positive definite; in any case > 99%
    finite for the same month with rho = 0, see ``check_predictions``);
(e) kernel timing with CUDA events at the path's shapes beside the plain
    versions (and the Matern kernel at one 12,500^2 symmetric block), printed
    as one ``{"kernels": [...]}`` line with each kernel's bound.

The last line is ``{"ok": true, "device": {...}}``.
"""

import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
N_PER_PROC = 12_500
MAXITER = 600

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W):
# 3.35 TB/s of HBM3, 67 TFLOP/s float32 and 34 TFLOP/s float64 outside the
# tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}

# Operations per entry of the Matern kernel, counted from csrc/kv.cuh and
# csrc/matern.cu (each +, -, *, /, compare and transcendental counts one).
MATERN_OPS = {"prefactor": 14, "series_setup": 30, "series_trip": 18,
              "cf2_setup": 22, "cf2_trip": 28, "recurrence_step": 4}
SERIES_TRIPS = {"float32": 12, "float64": 40}
CF2_TRIPS = {"float32": 18, "float64": 80}
# Operations per pair of the variogram passes (csrc/variogram.cu): the
# geodesic h is 11, the h_max test 1, row < col 1; the min/max updates 3;
# a binned pair adds 2 per edge compare, 3 for the cloud and 2 to accumulate.
VARIO_PAIR_OPS = 13
VARIO_MINMAX_OPS = 3
VARIO_BIN_OPS_PER_EDGE = 2
VARIO_BIN_OPS = 5


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else "nvidia-smi failed"


# --- bench.py's synthetic CONUS month (bench.py:87-120) -------------------


def synthetic_month(rng, n):
    lat = rng.uniform(24.0, 50.0, n)
    lon = rng.uniform(-124.0, -67.0, n)
    coords = np.column_stack([lat, lon])
    signal = (
        np.sin(np.deg2rad(lat) * 6.0)
        + 0.5 * np.cos(np.deg2rad(lon) * 4.0)
        + 0.3 * np.sin(np.deg2rad(lat * 2 + lon))
    )
    return coords, signal


def build_inputs(n, dtype, noise_seed=1):
    rng = np.random.default_rng(0)
    c1, s1 = synthetic_month(rng, n)
    c2, s2 = synthetic_month(rng, n)
    nrng = np.random.default_rng(noise_seed)
    v1 = s1 + nrng.normal(scale=0.4, size=n)
    v2 = -0.6 * s2 + nrng.normal(scale=0.4, size=n)
    v1 = (v1 - v1.mean()) / v1.std()
    v2 = (v2 - v2.mean()) / v2.std()
    return c1.astype(dtype), v1.astype(dtype), c2.astype(dtype), v2.astype(dtype)


# --- the port's main path (bench.py run_pipeline) --------------------------


def run_pipeline(c1, v1, c2, v2, pred_coords, dtype, device, maxiter=MAXITER,
                 nu_start=None):
    import torch

    from cokriging_tpu_torch.cov.matern import MultivariateMatern
    from cokriging_tpu_torch.estimate.empirical import (
        EmpiricalVariogram, VarioConfig, empirical_variograms_device,
    )
    from cokriging_tpu_torch.estimate.wls import fit_wls, moment_init
    from cokriging_tpu_torch.fields.field import Field, MultiField
    from cokriging_tpu_torch.predict.local import LocalPredictor

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    times = {}
    sync()
    t0 = time.perf_counter()
    cfg = VarioConfig(max_dist=3_000.0, n_bins=15, geodesic=True)
    pairs, centers, means, counts = empirical_variograms_device(
        [c1, c2], [v1, v2], cfg, device=device
    )
    est = EmpiricalVariogram(
        config=cfg, pairs=pairs, bin_centers=centers.astype(dtype),
        bin_means=means.astype(dtype), bin_counts=counts.astype(dtype),
    )
    sync()
    t1 = time.perf_counter()
    init = moment_init(est)
    if nu_start is not None:
        flat = init.to_flat().clone()
        flat[2:5] = nu_start
        init = init.with_flat(flat)
    params, result = fit_wls(est, init=init, method="adam", maxiter=maxiter, device=device)
    sync()
    t2 = time.perf_counter()
    sub = max(1, len(c1) // 200)
    f1 = Field.from_arrays(c1[::sub], v1[::sub], "Z0")
    f1.geodesic = True
    f2 = Field.from_arrays(c2[::sub], v2[::sub], "Z1")
    f2.geodesic = True
    torch_dtype = getattr(torch, np.dtype(dtype).name)
    mod = MultivariateMatern(params=params.astype(torch_dtype))
    lp = LocalPredictor(mod, MultiField(fields=[f1, f2]), device=device)
    out = lp(0, pred_coords, max_dist=1_000.0)
    sync()
    t3 = time.perf_counter()
    times.update(variograms_s=t1 - t0, fit_s=t2 - t1, predict_s=t3 - t2, total_s=t3 - t0)
    return params, result, out, times, lp


# --- phase helpers ---------------------------------------------------------


def cuda_time_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def variogram_case(c1, v1, c2, v2, dtype, device):
    """The path's three pair passes: per pair its point features, centered
    values, h thresholds and (from the kernel's h range) h-edges."""
    import torch

    from cokriging_tpu_torch.estimate import empirical as E

    td = getattr(torch, np.dtype(dtype).name)
    feats, vals = [], []
    for c, v in ((c1, v1), (c2, v2)):
        ct = torch.as_tensor(c, device=device, dtype=td)
        vt = torch.as_tensor(v, device=device, dtype=td)
        feats.append(E.point_features(ct, True))
        vals.append((vt - vt.sum() / vt.shape[0]).contiguous())
    snap = 2e-2 if td == torch.float32 else 1e-6
    h_max = float(E._h_of_d(np.dtype(dtype).type(3000.0), True))
    h_snap = float(E._h_of_d(np.dtype(dtype).type(snap), True))
    return feats, vals, h_max, h_snap, snap


def phase_c_variogram(c1, v1, c2, v2, dtype, results):
    import torch

    from cokriging_tpu_torch.estimate import empirical as E
    from cokriging_tpu_torch.kernels import cuda_ops as K

    name = np.dtype(dtype).name
    feats, vals, h_max, h_snap, snap = variogram_case(c1, v1, c2, v2, dtype, "cuda")
    rtol = 1e-5 if name == "float32" else 1e-12
    err_mean = 0.0
    for i, j in ((0, 0), (0, 1), (1, 1)):
        marg = i == j
        mm_k = K.variogram_minmax(feats[i], feats[j], marg, True, h_max, h_snap)
        mm_p = K.variogram_minmax_plain(feats[i], feats[j], marg, True, h_max, h_snap)
        check(torch.equal(mm_k, mm_p), f"variogram_minmax {name} pair {(i, j)}: {mm_k} vs {mm_p}")
        hmin, hmax = mm_k.cpu().numpy()
        _, h_edges = E._device_bins(hmin, hmax, True, np.dtype(dtype).type(snap), 15, np.dtype(dtype))
        he = torch.as_tensor(h_edges, device="cuda")
        s_k, n_k = K.variogram_bin(feats[i], feats[j], vals[i], vals[j], he, marg, True, False, h_max)
        s_p, n_p = K.variogram_bin_plain(feats[i], feats[j], vals[i], vals[j], he, marg, True, False, h_max)
        check(torch.equal(n_k, n_p), f"variogram_bin {name} pair {(i, j)} counts differ")
        m_k = (s_k / n_k.clamp_min(1)).cpu().numpy()
        m_p = (s_p / n_p.clamp_min(1)).cpu().numpy()
        rel = float(np.max(np.abs(m_k - m_p) / np.maximum(np.abs(m_p), 1e-300)))
        check(rel <= rtol, f"variogram_bin {name} pair {(i, j)} means rel err {rel}")
        err_mean = max(err_mean, float(np.max(np.abs(m_k - m_p))))
    results[f"variogram_minmax_{name}"] = {"max_abs_err": 0.0}  # checked equal
    results[f"variogram_bin_{name}"] = {"max_abs_err": err_mean}
    log(f"(c) variogram {name}: minmax exact, counts exact, means max abs err {err_mean:.3e}")


def matern_blocks(c1, c2, dtype):
    """Distance blocks as the path and the checks use them: the joint 256^2
    blocks of the local predictor and a 4096^2 symmetric block."""
    import torch

    from cokriging_tpu_torch.kernels.distance import haversine_matrix

    td = getattr(torch, np.dtype(dtype).name)
    sub = max(1, N_PER_PROC // 200)
    a = np.concatenate([c1[::sub], np.repeat(c1[:1], 256 - len(c1[::sub]), 0)])
    b = np.concatenate([c2[::sub], np.repeat(c2[:1], 256 - len(c2[::sub]), 0)])
    A = torch.as_tensor(a, dtype=td, device="cuda")
    B = torch.as_tensor(b, dtype=td, device="cuda")
    joint = [(haversine_matrix(A, A), True), (haversine_matrix(A, B), False),
             (haversine_matrix(B, B), True)]
    big = torch.as_tensor(c1[:4096], dtype=td, device="cuda")
    return joint, haversine_matrix(big, big)


def phase_c_matern(c1, c2, dtype, results):
    import torch

    from cokriging_tpu_torch.kernels import cuda_ops as K

    name = np.dtype(dtype).name
    atol = 5e-6 if name == "float32" else 1e-12
    joint, big = matern_blocks(c1, c2, dtype)
    worst = 0.0
    cases = [(h, sym, 1.5, 500.0) for h, sym in joint]
    for nu, ls in ((0.5, 300.0), (1.5, 800.0), (2.7, 1500.0)):
        cases += [(big, True, nu, ls), (big, False, nu, ls), (joint[1][0], False, nu, ls)]
    for h, sym, nu, ls in cases:
        x = math.sqrt(2 * nu) * h / ls
        check(bool((x < 2).any()) and bool((x >= 2).any()), "case must span x = 2")
        got = K.matern_correlation_block(nu, ls, h, symmetric=sym)
        ref = K.matern_correlation_block_plain(nu, ls, h, symmetric=sym)
        err = float((got - ref).abs().max())
        check(err <= atol, f"matern {name} nu={nu} sym={sym} {tuple(h.shape)}: err {err}")
        check(bool(torch.isfinite(got).all()), "matern output not finite")
        worst = max(worst, err)
    results[f"matern_correlation_{name}"] = {"max_abs_err": worst}
    log(f"(c) matern {name}: {len(cases)} blocks, max abs err {worst:.3e} (bar {atol})")


def phase_c_small_path():
    """The whole path at 400 points per process on the card against the
    same code on the CPU, float64, from nu = 1.4 (off the half-integer
    orders, where the reference's dK/dnu jumps)."""
    from cokriging_tpu_torch.data.grids import prediction_coords

    c1, v1, c2, v2 = build_inputs(400, np.float64)
    pc = prediction_coords()[::10]
    p_gpu, _, o_gpu, _, _ = run_pipeline(c1, v1, c2, v2, pc, np.float64, "cuda", maxiter=50, nu_start=1.4)
    p_cpu, _, o_cpu, _, _ = run_pipeline(c1, v1, c2, v2, pc, np.float64, "cpu", maxiter=50, nu_start=1.4)
    xg = p_gpu.to_flat().cpu().numpy()
    xc = p_cpu.to_flat().numpy()
    rel = float(np.max(np.abs(xg - xc) / np.abs(xc)))
    check(rel <= 1e-6, f"small path: params rel err {rel}")
    ok = np.isfinite(o_cpu.pred)
    check(np.array_equal(ok, np.isfinite(o_gpu.pred)), "small path: NaN lanes differ")
    err = float(max(np.max(np.abs(o_gpu.pred[ok] - o_cpu.pred[ok])),
                    np.max(np.abs(o_gpu.pred_err[ok] - o_cpu.pred_err[ok]))))
    check(err <= 1e-6, f"small path: prediction abs err {err}")
    log(f"(c) small path card vs CPU f64: params rel err {rel:.3e}, predictions abs err {err:.3e}")


def check_predictions(lp, out, pc, name):
    """Predictions of the bench month against the reference's semantics.

    A local system is a principal submatrix of the joint data covariance, so
    when the fitted model's joint covariance is positive definite at the
    data, more than 99% of the cells must get finite predictions. When it is
    not (the reference's WLS fit of the bench month is not: the JAX package
    returns the same parameters and NaN at the same cells), NaN marks the
    cells whose local system failed, as in the reference
    (src/point_prediction.py:218-222); the same month and predictor with
    rho = 0, a valid model by construction, must then be > 99% finite.
    """
    import dataclasses

    import torch

    from cokriging_tpu_torch.cov.matern import MultivariateMatern
    from cokriging_tpu_torch.predict.local import LocalPredictor

    finite = float(np.isfinite(out.pred).mean())
    offsets = np.cumsum([0] + [c.shape[0] for c in lp._coords])[:-1]
    idx = torch.cat([torch.arange(n, device=lp.device) + int(o)
                     for n, o in zip(lp._n_valid, offsets)])
    joint_pd = int(torch.linalg.cholesky_ex(lp.joint_cov[idx][:, idx])[1]) == 0
    if joint_pd:
        check(finite > 0.99, f"(d) {name}: PD model but only {finite:.2%} finite predictions")
    p0 = dataclasses.replace(lp.params, rho=torch.eye(2, dtype=lp.params.rho.dtype,
                                                      device=lp.device))
    out0 = LocalPredictor(MultivariateMatern(params=p0), lp.mf, device=lp.device)(
        0, pc.astype(out.pred.dtype), max_dist=1_000.0)
    finite0 = float(np.isfinite(out0.pred).mean())
    log(f"(d) {name}: fitted joint covariance PD at the data: {joint_pd}; "
        f"finite predictions {finite:.4%}; with rho = 0: {finite0:.4%}")
    check(finite0 > 0.99, f"(d) {name}: only {finite0:.2%} finite predictions with rho = 0")


def cf2_trips(mu, x, dtype):
    """Trips each CF2 entry runs before it converges (csrc/kv.cuh)."""
    import torch

    eps = torch.finfo(dtype).eps
    a1 = 0.25 - mu * mu + 0.0 * x
    b = 2.0 * (1.0 + x)
    d = 1.0 / b
    delh = d
    q1, q2 = torch.zeros_like(x), torch.ones_like(x)
    q, c, a = a1, a1, -a1
    s = 1.0 + q * delh
    trips = torch.zeros_like(x, dtype=torch.int32)
    done = torch.zeros_like(x, dtype=torch.bool)
    for i in range(2, CF2_TRIPS[str(dtype).replace("torch.", "")] + 2):
        trips += (~done).int()
        a = a - 2.0 * (i - 1.0)
        c_n = -a * c / i
        qnew = (q1 - b * q2) / a
        q = q + c_n * qnew
        b = b + 2.0
        d = 1.0 / (b + a * d)
        delh = (b * d - 1.0) * delh
        dels = q * delh
        s = s + dels
        done = done | ((torch.abs(dels / s) < eps) & (a1 != 0.0))
        scale = torch.clamp_min(torch.abs(qnew), 1e-30)
        q1, q2, c = q2 / scale, qnew / scale, c_n * scale
    return trips


def matern_bound(h, nu, ls, symmetric):
    """Least time for one Matern block: max(bytes / HBM rate, operations /
    peak rate) over the entries this block's data needs."""
    import torch

    name = str(h.dtype).replace("torch.", "")
    mask = h > 0
    if symmetric:
        mask &= torch.ones_like(mask).tril()
    n_entries = h.shape[0] * (h.shape[0] + 1) // 2 if symmetric else h.numel()
    pos = h[mask]
    x = math.sqrt(2 * nu) * pos / ls
    nl = math.floor(abs(nu) + 0.5)
    mu = abs(nu) - nl
    o = MATERN_OPS
    series = int((x < 2).sum())
    cf2_x = x[x >= 2]
    trips = int(cf2_trips(torch.full_like(cf2_x, mu), cf2_x, h.dtype).sum()) if cf2_x.numel() else 0
    ops = (pos.numel() * (o["prefactor"] + nl * o["recurrence_step"])
           + series * (o["series_setup"] + SERIES_TRIPS[name] * o["series_trip"])
           + cf2_x.numel() * o["cf2_setup"] + trips * o["cf2_trip"])
    nbytes = (n_entries + h.numel()) * h.element_size()
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[name] * 1e3
    return (t_bytes, "bytes") if t_bytes > t_ops else (t_ops, "operations")


def vario_bound(n_pairs, n_valid, n_bins, dtype_name, minmax):
    if minmax:
        ops = n_pairs * VARIO_PAIR_OPS + n_valid * VARIO_MINMAX_OPS
    else:
        ops = n_pairs * VARIO_PAIR_OPS + n_valid * (
            VARIO_BIN_OPS + VARIO_BIN_OPS_PER_EDGE * (n_bins + 1))
    return ops / PEAK_OPS_PER_S[dtype_name] * 1e3, "operations"


def phase_e(c1, v1, c2, v2, dtype, launches, results):
    import torch

    from cokriging_tpu_torch.estimate import empirical as E
    from cokriging_tpu_torch.kernels import cuda_ops as K

    name = np.dtype(dtype).name
    feats, vals, h_max, h_snap, snap = variogram_case(c1, v1, c2, v2, dtype, "cuda")
    pairs = ((0, 0), (0, 1), (1, 1))
    edges, n_pairs, n_valid = {}, 0, 0
    for i, j in pairs:
        hmin, hmax = K.variogram_minmax(feats[i], feats[j], i == j, True, h_max, h_snap).cpu().numpy()
        edges[(i, j)] = torch.as_tensor(
            E._device_bins(hmin, hmax, True, np.dtype(dtype).type(snap), 15, np.dtype(dtype))[1],
            device="cuda")
        n = feats[i].shape[0]
        n_pairs += n * (n - 1) // 2 if i == j else n * feats[j].shape[0]
        n_valid += int(K.variogram_bin(feats[i], feats[j], vals[i], vals[j], edges[(i, j)],
                                       i == j, True, False, h_max)[1].sum())

    def mm(fn):
        return lambda: [fn(feats[i], feats[j], i == j, True, h_max, h_snap) for i, j in pairs]

    def bn(fn):
        return lambda: [fn(feats[i], feats[j], vals[i], vals[j], edges[(i, j)], i == j, True,
                           False, h_max) for i, j in pairs]

    rows = []
    for kname, kern, plain, src_line, minmax in (
        ("variogram_minmax", mm(K.variogram_minmax), mm(K.variogram_minmax_plain), 143, True),
        ("variogram_bin", bn(K.variogram_bin), bn(K.variogram_bin_plain), 143, False),
    ):
        ms = cuda_time_ms(kern, 20)
        plain_ms = cuda_time_ms(plain, 3)
        bound_ms, bound_by = vario_bound(n_pairs, n_valid, 15, name, minmax)
        rows.append(dict(
            name=f"{kname}_{name}", route="cuda",
            source="cokriging_tpu_torch/kernels/csrc/variogram.cu",
            replaces=f"cokriging_tpu/kernels/pallas_ops.py:{src_line}",
            launches=launches[kname], ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            shape="3 pairs x 12500 points x 15 bins",
        ))

    joint, _ = matern_blocks(c1, c2, dtype)
    nu, ls = 1.5, 800.0

    def jm(fn):
        return lambda: [fn(nu, ls, h, symmetric=s) for h, s in joint]

    bounds = [matern_bound(h, nu, ls, s) for h, s in joint]
    rows.append(dict(
        name=f"matern_correlation_{name}", route="cuda",
        source="cokriging_tpu_torch/kernels/csrc/matern.cu",
        replaces="cokriging_tpu/kernels/pallas_ops.py:782",
        launches=launches["matern_correlation"],
        ms=cuda_time_ms(jm(K.matern_correlation_block), 50),
        plain_ms=cuda_time_ms(jm(K.matern_correlation_block_plain), 5),
        bound_ms=sum(b[0] for b in bounds), bound_by=bounds[0][1],
        library_ms=None, shape="joint blocks 256^2 sym + 256^2 + 256^2 sym",
    ))
    for r in rows:
        r.update(max_abs_err=results[r["name"]]["max_abs_err"])
        r["max_err"] = r["max_abs_err"]
    # next slice's shape: one 12,500^2 symmetric block
    big_c = torch.as_tensor(c1, dtype=getattr(torch, name), device="cuda")
    from cokriging_tpu_torch.kernels.distance import haversine_matrix

    hb = haversine_matrix(big_c, big_c)
    big = dict(
        shape="12500^2 symmetric", dtype=name,
        ms=cuda_time_ms(lambda: K.matern_correlation_block(nu, ls, hb, symmetric=True), 3),
        plain_ms=cuda_time_ms(lambda: K.matern_correlation_block_plain(nu, ls, hb), 1),
    )
    big["bound_ms"], big["bound_by"] = matern_bound(hb, nu, ls, True)
    del hb
    torch.cuda.empty_cache()
    return rows, big


def main():
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on the card only", file=sys.stderr)
        return 1
    if not (HERE / "cokriging_tpu_torch").is_dir():
        print("cokriging_tpu_torch/ is missing beside chip_smoke.py", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        # (a) card and environment
        smi = nvidia_smi_line()
        log(f"(a) nvidia-smi: {smi}")
        log(f"(a) torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
        log(f"(a) device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
        found = {m: importlib.util.find_spec(m) is not None for m in ("pandas", "matplotlib", "jax")}
        log(f"(a) installed: {found}")
        import cokriging_tpu_torch.estimate.empirical  # noqa: F401
        import cokriging_tpu_torch.estimate.wls  # noqa: F401
        import cokriging_tpu_torch.predict.local  # noqa: F401
        from cokriging_tpu_torch.data.grids import prediction_coords
        from cokriging_tpu_torch.kernels import _build
        from cokriging_tpu_torch.kernels import cuda_ops as K

        loaded = [m for m in ("jax", "cokriging_tpu", "pandas", "matplotlib", "optax")
                  if m in sys.modules]
        check(not loaded, f"the port's main path imported {loaded}")

        # (b) build
        info = _build.build()
        log(f"(b) build: {info['seconds']:.1f} s into {info['dir']}")
        for line in info["ptxas"]:
            log(f"(b) ptxas: {line}")

        # (c) kernels against their plain versions, then a small whole path
        kres = {}
        for dtype in (np.float32, np.float64):
            c1, v1, c2, v2 = build_inputs(N_PER_PROC, dtype)
            phase_c_variogram(c1, v1, c2, v2, dtype, kres)
            phase_c_matern(c1, c2, dtype, kres)
        phase_c_small_path()

        # (d) the main path at bench size, float32 then float64
        pc = prediction_coords()
        rows, bigs = [], []
        for dtype in (np.float32, np.float64):
            name = np.dtype(dtype).name
            c1, v1, c2, v2 = build_inputs(N_PER_PROC, dtype, noise_seed=1)
            run_pipeline(c1, v1, c2, v2, pc.astype(dtype), dtype, "cuda")
            _, v1b, _, v2b = build_inputs(N_PER_PROC, dtype, noise_seed=2)
            K.reset_launch_counts()
            params, result, out, times, lp = run_pipeline(c1, v1b, c2, v2b, pc.astype(dtype), dtype, "cuda")
            launches = K.launch_counts()
            finite = float(np.isfinite(out.pred).mean())
            x = params.to_flat().cpu().numpy().astype(np.float64)
            lo, hi = params.spec.bounds()
            tol = 1e-6 * (hi - lo)
            log(f"(d) {name}: stages {json.dumps(times)}")
            log(f"(d) {name}: launches {launches}, finite predictions {finite:.4%} of {len(out.pred)}, "
                f"fit cost {result.cost:.6g}, params {np.array2string(x, precision=5)}")
            check(all(v > 0 for v in launches.values()), f"(d) {name}: a kernel never ran: {launches}")
            check_predictions(lp, out, pc, name)
            check(bool(np.all((x >= lo - tol) & (x <= hi + tol))), f"(d) {name}: params out of bounds")
            # (e) kernel timing at the path's shapes
            r, big = phase_e(c1, v1b, c2, v2b, dtype, launches, kres)
            rows += r
            bigs.append(big)
        for big in bigs:
            log(f"(e) matern 12,500^2 symmetric {big['dtype']}: {big['ms']:.3f} ms, "
                f"plain {big['plain_ms']:.3f} ms, bound {big['bound_ms']:.4f} ms ({big['bound_by']})")
    except SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
