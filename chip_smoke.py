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
    float64, at the main path's shapes: the variogram passes in one launch
    each over the month's 3 variograms x 12,500 points x 15 bins and one at
    40 bins (counts and h ranges exact, means rtol 1e-5 / 1e-12; bit-equal to
    the one-variogram launches and run to run) and their stress cases
    (``phase_c_variogram_stress``: the 36 variograms of processes of 1, 127,
    128, 129, 255, 256, 257 and 513 points, geodesic and Euclidean,
    semivariogram and covariogram, 15 and 40 bins with edges on pairs and 14
    edges of one value after 0), the
    Matern kernel at the 256 x 256
    joint blocks, a 4096^2 symmetric block and nu in {0.5, 1.5, 2.7} (atol
    5e-6 / 1e-12), and the Matern block-gradient kernel at a ragged 300 x 517
    block and a 4096^2 symmetric block with an asymmetric cotangent, nu in
    {0.3, 0.5, 1.5, 2.7} (each of its four sums within 1e-5 / 1e-12 of the
    sum of |terms|; symmetric == full), and the gathered-pairs kernels at
    ragged flat lengths with 1, 3 and 6 pairs, nu in {0.3, 0.5, 1.5, 2.7,
    1.2, 0.8} and exact zeros (forward atol 5e-6 / 1e-12; each per-pair
    gradient sum within 1e-5 / 1e-12 of its sum of |terms|, bit-equal on a
    second launch), and the partition stress cases of the four sorting
    kernels (``phase_c_partition``: one branch only, a shuffled 50/50 mix,
    ten pairs, lengths around the tile, nu in {0.5, 1.5, 2.5} and 1.5 -+
    ulp; the pairs forward bit-equal under a permutation and without its
    early CF2 exit, its gradient bit-equal again; the block forward at n in
    {1, 63, 65, 650} and 650 x 411, its symmetric output exactly symmetric
    and bit-equal to the full one's lower triangle, both bit-equal under a
    joint permutation of rows and columns and without the early CF2 exit;
    the block gradient bit-equal again and symmetric == full).
    Then the whole paths at 400 points per process on the
    card against the same code on the CPU in float64: fit + local prediction
    (fitted parameters rtol 1e-6, predictions atol 1e-6), the exact NLL
    (value rtol 1e-10, gradient rtol 1e-7 / atol 1e-10, analytic against
    plain-AD branch), the joint predictor (atol 1e-8), the Vecchia value and
    gradient (m = 10; rtol 1e-10 / 1e-7), direct-assembly against
    materialized local prediction and kd against the device search (1e-10)
    and CG against the joint predictor (tol 1e-10, rtol 1e-6);
(d) the main path at the benchmark's size (bench.py's workload: 2 x 12,500
    synthetic CONUS observations, variograms, a 600-step Adam WLS fit from
    the moment initializer, local cokriging at every 0.5-degree land cell),
    float32 then float64: a warm-up run (10 Adam steps), then a timed run on
    fresh noise with
    the launch counts set to 0 just before it and read just after; every
    kernel must have run, the fit must lie in its bounds, and the
    predictions must follow the reference's semantics (> 99% finite when
    the fitted joint covariance is positive definite; in any case > 99%
    finite for the same month with rho = 0, see ``check_predictions``; the
    finite share with the fit projected onto the validity region is logged);
(e) kernel timing with CUDA events at the path's shapes beside the plain
    versions (and the Matern kernel at one 12,500^2 symmetric block, held
    against its plain version there too; the variogram passes alone at 2 x
    60,000 points), printed as one ``{"kernels": [...]}`` line with each
    kernel's bound, one row per kernel and path;
(f) the exact-likelihood path at the same size (bench.py's second axis:
    2 x 12,500 observations, default parameters with all length scales 700
    km, measurement variances 0, jitter 1e-6), float32 then float64: a
    warm-up and three timed NLL value+gradient evaluations with the launch
    counts set to 0 just before and read just after (3 Matern and 3
    block-gradient launches per evaluation), the penalty semantics where
    that point is not positive definite, a point with nuggets 0.1 where it
    is (finite value, nonzero gradient, a central-difference directional
    check in float64), the stage times, ``block_covariance`` forward and
    backward under ``torch.cuda.set_sync_debug_mode("error")``
    (``block_covariance_sync_free``), both kernels of the evaluation
    against their plain versions at its own three 12,500^2 blocks (symmetric,
    full, symmetric) and cotangent (the bars of phase (c)), timed there for
    this path's rows of the kernels line, the Matern forward timed and held
    there once more at nu = 1.37, where no CF2 lane leaves early (its own
    row), then a maximum-likelihood fit on the
    stride-5 subsample and joint prediction at every land cell with the
    fitted parameters; the joint predictor on all 2 x 12,500 observations in
    float64 runs once, its finite share printed. Phase (f) runs before the
    kernels line is printed, so its rows carry its counts;
(g) the large-n path at the size of the JAX package's example
    (examples/large_n_workflow.py: 2 x 60,000 synthetic CONUS observations),
    float32 then float64: a Vecchia fit (m = 20, maxiter 80, chunk 4096,
    coarse order and kd neighbors) inside its bounds, below its start and
    with rho < 0; the Vecchia value + gradient at the fit (the least of three
    after a warm-up; the launch counts of one equal the number of chunks);
    both pairs kernels against their plain versions at the path's own
    launches (the whole window set; the gradient at one chunk's own
    cotangent and at a random one); the parsimonious validity projection;
    direct-assembly local prediction of process 1 at 63 x 63 cells within
    120 km (> 95% finite) and CG joint prediction on the first 2 x 12,500
    observations at 256 cells (block 512, tol 1e-3, maxiter 40; all finite),
    the pairs kernel held against its plain version at one batch and one row
    tile of each; the row tile's forward bit-equal under a permutation of its
    entries, and one pairs call and one CG matvec over all 49 row tiles run
    under ``torch.cuda.set_sync_debug_mode("error")`` (``cg_sync_free``). Its
    rows of the kernels line follow.

(h) the table-to-map workflow at the size of bench.py's month, float32 then
    float64: long-format frames of three months of the synthetic CONUS month
    (2 x 12,500 rows per month, fresh noise each month, a linear time trend,
    lat/lon covariates) -> ``MultiField.from_dataframes`` (timedeltas 0, -1;
    every row main) -> ``empirical_variograms(mf)`` (1500 km, 15 bins; one
    launch per pass) -> the CLI's WLS fit with ``project_validity=True``
    (bounds, Cauchy-Schwarz) -> ``LocalPredictor(..., postprocess=True)`` at
    the 6,256 land cells from (d)'s ~202 main data per field (1000 km; > 99%
    finite) -> local LOOCV at all 12,500 data of process 0 (130 km: as many
    data per neighborhood as (d)'s; > 99% finite) -> dense and CG LOOCV on
    the first 2 x 2,500 rows with nuggets 0.1 (tol 1e-10, maxiter 500, chunks
    of 1024; float64 rtol 1e-6 / atol 1e-8, the float32 gap logged). Every
    stage runs with the launch counts set to 0 before it and read after it
    (variogram passes 1 + 1, the Matern forward in prediction and in the
    three LOOCVs, the pairs forward in CG); each postprocessed column is held
    against a float64 numpy back-transform with the field's TrendStats, and
    each LOOCV residual equals data - pred. Its rows of the kernels line: the
    variogram passes at its shapes, the Matern forward at the LOOCV's three
    12,500^2 blocks, the pairs forward at one CG row tile. Last, the CLI
    (``python -m cokriging_tpu_torch fit / predict / loocv --device cuda``
    in subprocesses) on tests/test_cli.py's staged tables against the same
    commands with ``--device cpu``, float64: parameters rtol 1e-6, columns
    atol 1e-6.

(i) simulation and the parametric bootstrap, float64: the dense cofield at the
    simulation experiment's size (``examples/simulation_experiment.py``: a
    51 x 51 grid, seed 42; its 5,202^2 covariance against the plain version,
    atol 1e-12, |L L^T - C|_F / |C|_F < 1e-12, the semi-colocated sample's
    indices equal to numpy's draw), the spectral cofield at the million-point
    workflow's (``examples/million_point_workflow.py:73-87``: 1024 x 1024 on
    [0, 100]^2, seed 11, a 2048^2 torus; its lag-grid blocks against the
    plain version, min_rel_eig >= -clip_tol, the embedded covariance equal to
    the model's blocks to 1e-10 of the sill; ``sample_ensemble(16)``, then
    2 x 12,500 observations), on them the WLS fit (maxiter 60) projected onto
    the validity region and the parametric bootstrap as ``examples/uncertainty_demo.py:77``
    runs it (200 replicates; variograms to 30 in 15 bins; maxiter cut from
    200 to 100) with
    stage times: the batched bin pass's counts equal to the reference
    pass's, its sums to 200 single-replicate launches of the existing pass
    (rtol 1e-12 / 1e-5) and to its plain version on 8 replicates and on
    all 200, the first 2 replicates refit alone equal to their batched
    refits (rtol 1e-8), every refit finite and in its box, each parameter's
    95% interval logged beside the truth; the batched pass and refit once more
    in float32 on the first 50 replicates cast (2 refit alone, rtol 1e-5); conditional simulation from the first 2 x 2,500
    observations at the 32 x 32 sub-grid, 100 draws, in float32 and float64
    (pred and pred_err equal to ``__call__``'s, sample means within 5
    standard errors, root root^T equal to the posterior covariance); and
    ``fit --maxiter 30 --bootstrap 16`` / ``predict --joint
    --conditional-sims 10 --device cuda`` on tests/test_cli.py's staged
    tables. Each stage runs
    with the launch counts set to 0 before it and read after it (the Matern
    forward in every simulation, both variogram passes and the batched form
    in the bootstrap). Its rows of the kernels line: the batched pass in both
    dtypes (with the 200 single launches' time as ``yardstick_ms``) and the
    Matern forward at the 5,202^2 covariance, the 2048^2 lag grid and the
    replicates' 12,500^2 blocks.

(j) parameter uncertainty: (f)'s maximum-likelihood fit (bench.py's month,
    every 5th observation, 2 x 2,500, float64), its observed information on
    the card (``torch.autograd.functional.hessian`` of the plain-AD NLL: 11
    rows of double backward through the block kernels, whose backward is the
    second-order pair of ``csrc/matern_hess.cu``), timed, with the launch
    counts set to 0 just before and read just after (every kernel of the
    path must run), symmetric to round-off before symmetrization (1e-10 of
    max|H|) and equal to ``observed_information``, with exactly one build of
    the second-order rows (``recurrence_table(..., order=2)`` for the three
    process pairs, counted beside the launches), exactly 3 launches of the
    tangent's partials (one per block) and 33 of its combine (one per row and
    block), and the Hessian's peak device memory; the second-order kernels
    held against their plain versions at the Hessian's own blocks (the
    Hessian sums at the first of its three 2,500^2 blocks, each within 1e-14
    of its sum of |terms| in float64 and 1e-6 in float32, ``J_HESS_BAR``,
    and bit-equal at each block to a launch that builds its row itself; the
    tangent's partials at each block, each field within 1e-12 / 1e-5 of its
    largest entry; the combine at each block's first row of nonzero weights
    within the same bars of the plain tangent over the plain partials) and
    timed there (the Hessian sums alone with the path's rows, as launches
    that build their rows, and the one row build alone; the Hessian's whole
    tangent work, 3 partials and 33 combines, as the path launched it); at
    the fit with its nuggets raised to 0.1, each
    column against a central (or, beside the positive-definite wall,
    one-sided) difference of the card's exact gradient (1e-4 of the
    column's largest entry), and the float32 information against the
    float64 one (1e-3 of max|H|); ``examples/uncertainty_demo.py``'s ML half
    at its own size (41 x 41 grid, seed 42, 2 x 120 samples, seed 43: the
    information at its truth, card against the CPU within 1e-9 of max|H|,
    the CPU's computed in a worker process beside the rest of the phase,
    and ``nll_std_errors``); ``optim_lag_nd`` over lags 0..359 (tau
    30) and ``get_stats`` at ``examples/crosscov_eda.py``'s size (36 x 72 x
    1,825 daily cells, ~70% missing) on the card against the CPU on every
    8th cell (lags equal, 1e-10), and ``regional_stats`` by hemisphere and
    latitude band on ``examples/xcov_eda.py``'s 5-degree monthly frame, card
    against CPU. Its rows of the kernels line: both kernels in both dtypes.
    Phase (i)'s CLI fit also runs ``--std-errors``, its table held against
    ``nll_std_errors`` in this process (1e-6).

(k) the sharded paths (``cokriging_tpu_torch.parallel``) on
    ``make_mesh(4, device="cuda")``, four virtual shards of the one card, each
    against the same call with no mesh, with the launch counts set to 0
    before each stage and read after it (every kernel of a stage launched
    once per shard): ``sharded_variogram_pair`` on bench.py's month,
    marginal and cross (3000 km, 15 bins; float32 and float64; centers and
    counts equal, means rtol 1e-5 / 1e-12; one launch per pass per shard);
    ``sharded_local_predict`` at (d)'s land cells less one, materialized and
    direct, and with ``cv=True`` at all 12,500 data of process 0 within 130
    km (rtol 1e-5 / 1e-10 of the largest value); ``sharded_vecchia_nll``'s
    value and gradient at (g)'s 2 x 60,000 windows (float64 rtol 1e-12 /
    1e-9, float32 logged; each chunk launched once) and ``fit_vecchia(mesh=)``
    for 10 iterations in float64 (rtol 1e-8); ``IterativeJointPredictor(
    mesh=)`` on 2 x 2,500 of the month with nuggets 0.1 (tol 1e-10, float64,
    rtol 1e-8) and on (g)'s 2 x 12,500 at 256 cells (40 iterations, float32:
    the iterations equal, the gap logged); the parametric bootstrap on (i)'s
    spectral sample (8 replicates, maxiter 30, float64) with its refit
    sharded and stepped in lockstep, bit-equal, both walls logged. The
    one-card mesh ``make_mesh()`` runs each path once more, bit-equal to no
    mesh (the CG on 2 x 2,560 rows, a multiple of its 512-row tile, at tol
    1e-4; the bootstrap at 4 replicates, maxiter 20). Its rows of the kernels line:
    both variogram passes over one shard's sides, marginal and cross, in
    both dtypes. Phase (c) also holds the Hessian sums of
    ``csrc/matern_hess.cu`` against their plain versions at nu = 1.5 -+ one
    ulp and in blocks of entries at x = 2 exactly (``phase_c_hess_edges``).

(l) the last modules: the serving export (``utils/export.py``) of (d)'s
    month (its ~202 data per field, process 0, 1000 km, the 6,256 land cells)
    under (k)'s model ``K_PARAMS``: ``LocalPredictor(materialize_cov=False)``
    exported on the card at the live predictor's batch size, saved to bytes
    and loaded, serving every cell batch by batch (the last batch padded) in
    float32 and float64, bit-equal to the live predictor on the same batches,
    the pairs kernel launched once per served batch through the registered op
    ``cokriging_tpu_torch::matern_corr_pairs``; fresh runtime inputs (the
    flat vector x 1.1, process 0's values x 0.5) bit-equal to the live
    predictor on them; the f64 artifact within 1e-9 of the largest value of
    the CPU predictor at 256 cells; the export, load, served and live walls;
    the op's host cost per call against the bare launch; then
    ``python -m cokriging_tpu_torch sim --device cuda`` at the experiment's
    sizes (exit 0 with its Vecchia assertion, only ``torch_*`` files, the
    JAX manifest's statistics keys; its statistics logged beside the JAX
    manifest's); ``entry("cuda")``'s joint-cokriging step against the same
    step on the CPU (f64, 1e-10 of the largest value) and
    ``dryrun_multichip(4, device="cuda")`` on four virtual shards of the
    card. Its rows of the kernels line: the pairs forward at one served
    batch, both dtypes.

Cuts of depth against the time limit: (d)'s float64 Adam fit runs 200 of
bench.py's 600 steps (its per-step time is logged); (f) holds the
block-gradient kernel against its plain version at the 12,500^2 cross block
only (it times the kernel at all three); (i) refits 4 replicates alone (2 per
dtype, in 4 worker processes), not 16; (j) holds the Hessian sums against
their plain version at the first of the three blocks only (the kernel's time
at all three is logged); (k)'s bootstrap runs 8 replicates, not 16.

``python3 chip_smoke.py abcg`` runs only the phases named (a and b always)
and prints no result line; ``python3 chip_smoke.py k`` runs (a), (b) and (k), ``python3
chip_smoke.py l`` (a), (b) and (l). The kernels line's rows of the kernels
redesigned last (the variogram passes, the block forward and the pairs
gradient) carry their ptxas registers, static shared memory and spills from
this run's build; a log line beside each gives the
time recorded for the kernel before the redesign, which is not part of the
kernels line.

The last line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import hashlib
import importlib.util
import json
import math
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
N_PER_PROC = 12_500
MAXITER = 600
# the float64 Adam fit of (d) is cut to this many steps (its per-step time is
# reported; float32 keeps bench.py's 600)
MAXITER_F64 = 200
WARMUP_MAXITER = 10  # the warm-up run of phase (d): its steps only warm up

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
# The same for the block-gradient kernel (csrc/matern_grad.cu, the Dual<T>
# operators of csrc/kv.cuh: a dual add is 2 operations, a dual product or
# quotient 4, a dual-by-scalar product 2): the entry's own arithmetic, the
# dual series and CF2, the dual recurrence step and the step to K_{nu+-1}.
MATERN_GRAD_OPS = {"prefactor": 45 + 5, "series_setup": 78, "series_trip": 36,
                   "cf2_setup": 39, "cf2_trip": 61, "recurrence_step": 9}
# Operations of the pairs kernels' per-entry select (csrc/matern_pairs.cu
# pair_of: two compares, a conversion and an equality test), on top of the
# Matern entry's own.
PAIR_SELECT_OPS = 4
# Operations per pair of the variogram passes (csrc/variogram.cu): the
# geodesic h is 11, the h_max test 1, row < col 1; the min/max updates 3;
# a binned pair adds 3 for the cloud and 2 to accumulate, and for its bin
# 4 for the lookup cell (shift, subtract, two clamps) and 2 per exact compare
# (k_cmp of them, csrc/vario.cuh::bin_count); a linear scan over the edges
# took 2 per edge compare over all n_bins + 1 edges, the count the bound is
# also given under.
VARIO_PAIR_OPS = 13
VARIO_MINMAX_OPS = 3
VARIO_BIN_OPS_PER_EDGE = 2
VARIO_BIN_OPS = 5
VARIO_LOOKUP_OPS = 4
VARIO_COMPARE_OPS = 2

# The rows of the kernels redesigned last: the kernel's entry in the ptxas
# report, and its time recorded before the redesign (chip_smoke on one NVIDIA
# H100 80GB HBM3 at 700 W: the unsorted Matern kernels without tables; the
# variogram passes of one launch per variogram with a scan over the edges),
# which is logged beside this run's and kept out of the kernels line.
REDESIGNED = {
    "variogram_minmax_float32": ("variogram.cu", "minmax_kernelIfLb1E", 0.440),
    "variogram_minmax_float64": ("variogram.cu", "minmax_kernelIdLb1E", 0.611),
    "variogram_bin_float32": ("variogram.cu", "bin_kernelIfLb1ELb0ELi1E", 1.601),
    "variogram_bin_float64": ("variogram.cu", "bin_kernelIdLb1ELb0ELi1E", 1.711),
    "matern_correlation_float32": ("matern.cu", "matern_kernelIf", 0.709),
    "matern_correlation_float64": ("matern.cu", "matern_kernelId", 0.655),
    "matern_correlation_float32_nll": ("matern.cu", "matern_kernelIf", 31.92),
    "matern_correlation_float64_nll": ("matern.cu", "matern_kernelId", 241.64),
    "matern_correlation_float32_nll_nu1.37": ("matern.cu", "matern_kernelIf", None),
    "matern_correlation_float64_nll_nu1.37": ("matern.cu", "matern_kernelId", None),
    "matern_corr_pairs_grad_float32_vecchia": ("matern_pairs.cu", "pairs_grad_kernelIf", 2.857),
    "matern_corr_pairs_grad_float64_vecchia": ("matern_pairs.cu", "pairs_grad_kernelId", 12.276),
    # the batched bin pass (its walk kernel; 50 replicates in float32, 200 in
    # float64, as (i) runs them; recorded before: one kernel over every pair
    # and replicate) and the Hessian sums, whose earlier row timed three
    # launches that each built their row (47.35 / 56.36 ms at the three
    # blocks): no time of the first block alone was recorded
    "variogram_bin_batch_float32_i": ("variogram.cu", "batch_walk_kernelIfLb0ELi16E", 26.17),
    "variogram_bin_batch_float64_i": ("variogram.cu", "batch_walk_kernelIdLb0ELi16E", 58.61),
    "matern_block_hess_float32": ("matern_hess.cu", "HessStepIfE", None),
    "matern_block_hess_float64": ("matern_hess.cu", "HessStepIdE", None),
    # the block tangent's partials (recorded before: the fused tangent's three
    # launches, one per block, that the partials' three replace) and its
    # combine (new: no earlier kernel did only this)
    "matern_block_partials_float32": ("matern_hess.cu", "partials_kernelIf", 0.63),
    "matern_block_partials_float64": ("matern_hess.cu", "partials_kernelId", 2.93),
    "matern_block_tangent_float32": ("matern_hess.cu", "tangent_combine_kernelIf", None),
    "matern_block_tangent_float64": ("matern_hess.cu", "tangent_combine_kernelId", None),
}
# the same record for one 12,500^2 symmetric block, and for the Vecchia window
# set in one gradient launch (that one built its table in the call)
RECORDED_BIG_MS = {"float32": 8.22, "float64": 60.46}
RECORDED_ONE_LAUNCH_MS = {"float32": 3.238, "float64": 11.243}
# a non-half-integer order, where every CF2 lane of the block forward runs to
# convergence (at the NLL's nu = 1.5 they leave after their setup)
NU_GENERAL = 1.37


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
    times.update(variograms_s=t1 - t0, fit_s=t2 - t1, predict_s=t3 - t2, total_s=t3 - t0,
                 counts_per_pair=counts.sum(axis=1).tolist(),
                 counts_sha256=hashlib.sha256(np.ascontiguousarray(counts).tobytes()).hexdigest())
    return params, result, out, times, lp


# --- phase helpers ---------------------------------------------------------


def cuda_time_ms(fn, reps, warm=True, head_start_ms=0.0):
    """Mean CUDA-event time of ``fn`` over ``reps`` calls. ``head_start_ms``:
    the card first sleeps that long, so the host queues every call before
    the card reaches them and the time is the card's alone (for wrappers
    whose host work per call is close to their kernels' time)."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if head_start_ms:
        torch.cuda._sleep(int(head_start_ms * 2e6))  # cycles at <= 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def keep(store, key, fn):
    """``fn`` as a thunk that also leaves its result in ``store[key]``, so a
    timed call's output can be compared afterwards."""
    def run():
        store[key] = fn()
    return run


def variogram_case(c1, v1, c2, v2, dtype, device, max_dist=3000.0):
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
    h_max = float(E._h_of_d(np.dtype(dtype).type(max_dist), True))
    h_snap = float(E._h_of_d(np.dtype(dtype).type(snap), True))
    return feats, vals, h_max, h_snap, snap


MONTH_PAIRS = ((0, 0), (0, 1), (1, 1))
# processes of the variogram stress cases: around the kernel's 256-point tiles
VARIO_STRESS_N = (1, 127, 128, 129, 255, 256, 257, 513)


def vario_sides(feats, vals, pairs):
    """The pass-1 and pass-2 sides of the variograms ``pairs`` (the
    arguments of ``variogram_minmax_pairs`` and ``variogram_bin_pairs``)."""
    return ([(feats[i], feats[j], i == j) for i, j in pairs],
            [(feats[i], feats[j], vals[i], vals[j], i == j) for i, j in pairs])


def check_bins(name, got, want, rtol):
    """Counts equal, sums within rtol of the plain version's: the sums' max
    relative error."""
    import torch

    check(torch.equal(got[1], want[1]), f"{name}: counts differ from the plain version")
    rel = float(((got[0] - want[0]).abs() / want[0].abs().clamp_min(1e-300)).max())
    check(rel <= rtol, f"{name}: sums rel err {rel} (bar {rtol})")
    return rel


def check_bin_sums(name, got, want, scale, rtol):
    """Counts equal, sums within rtol of the plain version's relative to
    ``scale``, each bin's sum of |terms| (the measure a sum's rounding is
    bounded by; it is the sum itself where the terms are >= 0): the largest
    such error, and the largest relative to the sums themselves."""
    import torch

    check(torch.equal(got[1], want[1]), f"{name}: counts differ from the plain version")
    diff = (got[0] - want[0]).abs()
    err = float((diff / scale.clamp_min(1e-300)).max())
    check(err <= rtol, f"{name}: sums err {err} of the sum of |terms| (bar {rtol})")
    return err, float((diff / want[0].abs().clamp_min(1e-300)).max())


def check_same(name, a, b):
    import torch

    check(all(torch.equal(x, y) for x, y in zip(a, b)), f"{name}: not bit-equal")


def phase_c_variogram(c1, v1, c2, v2, dtype, results):
    """The month's three variograms in one launch per pass: h ranges equal
    to the plain version's and the one-variogram launches', counts equal to
    the plain version's, means within rtol; sums and counts bit-equal to the
    one-variogram launches' and to a second call's; one cross variogram at
    40 bins (two windows, two launches)."""
    import torch

    from cokriging_tpu_torch.estimate import empirical as E
    from cokriging_tpu_torch.kernels import cuda_ops as K

    name = np.dtype(dtype).name
    np_dt = np.dtype(dtype)
    feats, vals, h_max, h_snap, snap = variogram_case(c1, v1, c2, v2, dtype, "cuda")
    rtol = 1e-5 if name == "float32" else 1e-12
    mm_sides, sides = vario_sides(feats, vals, MONTH_PAIRS)
    mm_k = K.variogram_minmax_pairs(mm_sides, True, h_max, h_snap)
    check(torch.equal(mm_k, K.variogram_minmax_pairs_plain(mm_sides, True, h_max, h_snap)),
          f"variogram_minmax {name}: {mm_k} differs from the plain version")
    check(torch.equal(mm_k, torch.stack([K.variogram_minmax(*sd, True, h_max, h_snap)
                                         for sd in mm_sides])),
          f"variogram_minmax {name}: one launch differs from the one-variogram launches")
    edges = [E._device_bins(lo, hi, True, np_dt.type(snap), 15, np_dt)[1]
             for lo, hi in mm_k.cpu().numpy()]
    got = K.variogram_bin_pairs(sides, edges, True, False, h_max)
    plain = K.variogram_bin_pairs_plain(sides, edges, True, False, h_max)
    check_bins(f"variogram_bin {name}", got, plain, rtol)
    m_k = (got[0] / got[1].clamp_min(1)).cpu().numpy()
    m_p = (plain[0] / plain[1].clamp_min(1)).cpu().numpy()
    rel = float(np.max(np.abs(m_k - m_p) / np.maximum(np.abs(m_p), 1e-300)))
    check(rel <= rtol, f"variogram_bin {name}: means rel err {rel}")
    err_mean = float(np.max(np.abs(m_k - m_p)))
    one = [K.variogram_bin(*sd[:4], e, sd[4], True, False, h_max) for sd, e in zip(sides, edges)]
    check_same(f"variogram_bin {name}: one launch against the one-variogram launches", got,
               (torch.stack([a for a, _ in one]), torch.stack([b for _, b in one])))
    check_same(f"variogram_bin {name}: run to run", got,
               K.variogram_bin_pairs(sides, edges, True, False, h_max))
    # more bins than the kernel's histogram holds: two windows, two launches
    _, h40 = E._device_bins(*mm_k[1].cpu().numpy(), True, np_dt.type(snap), 40, np_dt)
    before = K.launch_counts()["variogram_bin"]
    got40 = K.variogram_bin_pairs(sides[1:2], [h40], True, False, h_max)
    check(K.launch_counts()["variogram_bin"] == before + 2, "40 bins must take two pair passes")
    rel40 = check_bins(f"variogram_bin {name} 40 bins", got40,
                       K.variogram_bin_pairs_plain(sides[1:2], [h40], True, False, h_max), rtol)
    results[f"variogram_minmax_{name}"] = {"max_abs_err": 0.0}  # checked equal
    results[f"variogram_bin_{name}"] = {"max_abs_err": err_mean}
    log(f"(c) variogram {name}: one launch per pass over 3 variograms: minmax exact, counts "
        f"exact, means max abs err {err_mean:.3e}, bit-equal to the one-variogram launches and "
        f"run to run; 40 bins: counts exact, sums rel err {rel40:.3e}")


def on_edge_bins(fa, fb, marginal, geodesic, h_max, n_bins, np_dt):
    """n_bins + 1 h-edges drawn from the variogram's own valid h values (as
    the kernel forms them: h_block is the same arithmetic), the first pulled
    to 0, so that pairs lie exactly on edges; fixed edges for a variogram
    without pairs."""
    import torch

    from cokriging_tpu_torch.kernels import cuda_ops as K

    h = K.h_block(fa, fb, geodesic)
    valid = h <= h_max
    if marginal:
        valid &= torch.ones_like(valid).triu(1)
    hv = torch.unique(h[valid]).cpu().numpy()
    if hv.size < n_bins + 1:
        return np.linspace(0.0, h_max, n_bins + 1).astype(np_dt)
    edges = hv[np.linspace(0, hv.size - 1, n_bins + 1).round().astype(int)]
    edges[0] = 0.0
    return edges.astype(np_dt)


def phase_c_variogram_stress(dtype, results):
    """All 36 variograms of processes of VARIO_STRESS_N points (duplicated
    points give h = 0), geodesic and Euclidean, semivariogram and
    covariogram, at 15 and 40 bins with edges on pairs and at 14 edges of
    one value after 0, in one call per pass (two launches: 32 variograms
    per launch): h ranges equal to the plain version's, counts equal, sums
    within rtol 1e-5 / 1e-12 of each bin's sum of |terms| (the plain
    version adds with atomics, so its last bits vary run to run, and a
    covariogram bin's products can cancel far below that sum) and bit-equal
    run to run."""
    import torch

    from cokriging_tpu_torch.estimate import empirical as E
    from cokriging_tpu_torch.kernels import cuda_ops as K

    name = np.dtype(dtype).name
    np_dt = np.dtype(dtype)
    td = getattr(torch, name)
    rtol = 1e-5 if name == "float32" else 1e-12
    rng = np.random.default_rng(23)
    pairs = [(i, j) for i in range(len(VARIO_STRESS_N)) for j in range(i, len(VARIO_STRESS_N))]
    worst, worst_rel, n_cases = 0.0, 0.0, 0
    for geodesic in (True, False):
        pts = [np.column_stack([rng.uniform(24, 50, n), rng.uniform(-124, -67, n)])
               for n in VARIO_STRESS_N]
        for k in range(2, len(pts)):
            pts[k][:3] = pts[k - 1][:3]
        scale = 1.0 if geodesic else 0.1
        feats = [E.point_features(torch.as_tensor(p * scale, dtype=td, device="cuda"), geodesic)
                 for p in pts]
        vals = [torch.as_tensor(rng.normal(size=len(p)), dtype=td, device="cuda") for p in pts]
        h_max = float(E._h_of_d(np_dt.type(2000.0 if geodesic else 3.0), geodesic))
        h_snap = float(E._h_of_d(np_dt.type(1e-6), geodesic))
        mm_sides, sides = vario_sides(feats, vals, pairs)
        before = K.launch_counts()["variogram_minmax"]
        mm = K.variogram_minmax_pairs(mm_sides, geodesic, h_max, h_snap)
        check(K.launch_counts()["variogram_minmax"] == before + 2,
              "36 variograms take two minmax launches")
        check(torch.equal(mm, K.variogram_minmax_pairs_plain(mm_sides, geodesic, h_max, h_snap)),
              f"variogram stress {name} geodesic={geodesic}: h ranges differ")
        for n_bins in (15, 40, "same"):
            if n_bins == "same":  # 14 edges of one value after 0: the many-compare lookup
                n_bins = 14
                edges = [np.r_[0.0, np.full(n_bins, 0.25 * h_max)].astype(np_dt) for _ in pairs]
            else:
                edges = [on_edge_bins(feats[i], feats[j], i == j, geodesic, h_max, n_bins, np_dt)
                         for i, j in pairs]
            for covariogram in (False, True):
                what = (f"variogram stress {name} geodesic={geodesic} covariogram={covariogram} "
                        f"{n_bins} bins, edges {edges[1][1:3]}")
                got = K.variogram_bin_pairs(sides, edges, geodesic, covariogram, h_max)
                want = K.variogram_bin_pairs_plain(sides, edges, geodesic, covariogram, h_max)
                # a covariogram's products cancel: its rounding is bounded
                # relative to the sum of |a b|, the covariogram of |a|, |b|
                scale = K.variogram_bin_pairs_plain(
                    [(fa, fb, va.abs(), vb.abs(), m) for fa, fb, va, vb, m in sides], edges,
                    geodesic, True, h_max)[0] if covariogram else want[0]
                err, rel = check_bin_sums(what, got, want, scale, rtol)
                worst, worst_rel = max(worst, err), max(worst_rel, rel)
                check_same(f"{what}: run to run", got,
                           K.variogram_bin_pairs(sides, edges, geodesic, covariogram, h_max))
                check(int(got[1].sum()) > 0, f"{what}: no pairs binned")
                n_cases += 1
    log(f"(c) variogram stress {name}: {n_cases} calls of {len(pairs)} variograms (n in "
        f"{VARIO_STRESS_N}, edges on pairs): counts exact, sums err <= {worst:.3e} of the sum of "
        f"|terms| ({worst_rel:.3e} of the sums), bit-equal run to run")


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


def tie_distances(nu, ls, td):
    """Distances h within 64 ulp of 2 ls / sqrt(2 nu) whose x = sqrt(2 nu) (h
    / ls), formed in dtype ``td`` as the kernels and the plain model form it,
    is 2 exactly (a CPU tensor), or None where no distance gives x == 2."""
    import torch

    nu_t, ls_t = torch.tensor(nu, dtype=td), torch.tensor(ls, dtype=td)
    up = torch.tensor(math.inf, dtype=td)
    h = torch.tensor(2.0 * ls / math.sqrt(2.0 * nu), dtype=td)
    for _ in range(64):
        h = torch.nextafter(h, -up)
    found = []
    for _ in range(128):
        if float(torch.sqrt(2.0 * nu_t) * (h / ls_t)) == 2.0:
            found.append(h.clone())
        h = torch.nextafter(h, up)
    return torch.stack(found) if found else None


def phase_c_hess_edges(dtype, results):
    """The Hessian sums of ``csrc/matern_hess.cu`` against their plain
    versions where the reference's x-derivatives part from the true mixed
    partials: at nu = 1.5 -+ one ulp of the dtype (CF2 lanes that stop after
    their first trip; 48 x 64 entries at x from 2 to 40) and in blocks of
    entries at x = 2 exactly (the branch clamps' tie) at those orders and at
    nu = 1.2; each of the five sums within ``J_HESS_BAR`` of its sum of
    |terms| (1e-14 / 1e-6)."""
    import torch

    from cokriging_tpu_torch.kernels import cuda_ops as K

    name = np.dtype(dtype).name
    td = getattr(torch, name)
    ls = 700.0
    bar = J_HESS_BAR[name][0]
    gen = torch.Generator(device="cuda").manual_seed(11)
    worst, cases = 0.0, []
    for nu in ulp_nus(name)[3:] + [1.2]:
        blocks = []
        if nu != 1.2:
            x = np.geomspace(2.0, 40.0, 48 * 64)
            blocks.append(("x in [2, 40]", torch.as_tensor(x * ls / math.sqrt(2.0 * nu),
                                                           dtype=td).reshape(48, 64)))
        tie = tie_distances(nu, ls, td)
        if tie is not None:
            h = tie.repeat(-(-256 // tie.numel()))[:256].reshape(16, 16).cuda()
            # as the kernel and the plain model form it: a true division by a
            # tensor (a Python divisor becomes a product with its reciprocal)
            x_card = (torch.sqrt(2.0 * torch.tensor(nu, dtype=td, device="cuda"))
                      * (h / torch.tensor(ls, dtype=td, device="cuda")))
            check(bool((x_card == 2.0).all()), f"(c) hess edges {name} nu={nu}: x != 2 on the card")
            blocks.append(("x = 2", h))
        for what, h in blocks:
            h = h.cuda()
            ct = torch.randn(h.shape, dtype=td, device="cuda", generator=gen)
            got = K.matern_block_hess(nu, ls, h, ct)
            ref, mag = K.matern_block_hess_plain(nu, ls, h, ct, magnitude=True)
            rel = (got - ref).abs() / mag.clamp_min(1e-300)
            check(bool(torch.isfinite(got).all()) and bool((rel <= bar).all()),
                  f"(c) hess edges {name} nu={nu} {what}: {got.tolist()} vs plain {ref.tolist()}, "
                  f"|terms| {mag.tolist()}, bar {bar}")
            worst = max(worst, float(rel.max()))
            cases.append(f"{nu!r} {what}")
    results[f"matern_block_hess_{name}_edges"] = {"max_err": worst}
    log(f"(c) hess edges {name}: {len(cases)} blocks ({cases}), worst |kernel - plain| / "
        f"sum|terms| {worst:.3e} (bar {bar})")


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


def phase_c_block_grad(c1, c2, dtype, results):
    """``matern_block_grad`` against its plain version: every one of the four
    sums within tol * (the same sum over absolute values)."""
    import torch

    from cokriging_tpu_torch.kernels import cuda_ops as K
    from cokriging_tpu_torch.kernels.distance import haversine_matrix

    name = np.dtype(dtype).name
    td = getattr(torch, name)
    tol = 1e-5 if name == "float32" else 1e-12
    a = torch.as_tensor(c1[:300], dtype=td, device="cuda")
    b = torch.as_tensor(np.concatenate([c1[:7], c2[:510]]), dtype=td, device="cuda")
    ragged = haversine_matrix(a, b)  # 300 x 517 with 7 exact zeros
    check(int((ragged == 0).sum()) == 7, "ragged block must hold exact zeros")
    _, big = matern_blocks(c1, c2, dtype)
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst_abs = worst_rel = 0.0
    n_cases = 0
    for nu, ls in ((0.3, 300.0), (0.5, 300.0), (1.5, 800.0), (2.7, 1500.0)):
        for h, sym in ((ragged, False), (big, True)):
            x = math.sqrt(2 * nu) * h / ls
            check(bool((x < 2).any()) and bool((x >= 2).any()), "case must span x = 2")
            ct = torch.randn(h.shape, dtype=td, device="cuda", generator=gen)  # asymmetric
            got = K.matern_block_grad(1.7, 0.05, nu, ls, h, ct, symmetric=sym)
            ref = K.matern_block_grad_plain(1.7, 0.05, nu, ls, h, ct, symmetric=sym)
            mag = K.matern_block_grad_plain(1.7, 0.05, nu, ls, h, ct, symmetric=sym, absolute=True)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"block grad {name} nu={nu}: not finite")
            pairs = [("plain", ref)]
            if sym:
                pairs.append(("full", K.matern_block_grad(1.7, 0.05, nu, ls, h, ct)))
                check(torch.equal(got, K.matern_block_grad(1.7, 0.05, nu, ls, h, ct, symmetric=True)),
                      f"block grad {name} nu={nu}: sums differ from run to run")
            for what, other in pairs:
                rel = float(((got - other).abs() / mag).max())
                check(rel <= tol, f"block grad {name} nu={nu} sym={sym} {tuple(h.shape)} vs {what}: "
                      f"{got.tolist()} vs {other.tolist()}, |terms| {mag.tolist()}")
                worst_rel = max(worst_rel, rel)
                worst_abs = max(worst_abs, float((got - other).abs().max()))
            n_cases += 1
    results[f"matern_block_grad_{name}"] = {"max_abs_err": worst_abs, "max_err": worst_rel}
    log(f"(c) block grad {name}: {n_cases} blocks, worst |kernel - plain| / sum|terms| "
        f"{worst_rel:.3e} (bar {tol}), worst abs {worst_abs:.3e}")


def phase_c_small_nll():
    """The exact-likelihood path at 2 x 400 points on the card against the
    same code on the CPU, float64: NLL value and gradient (analytic branch
    both sides), analytic against plain-AD branch on the card, and the joint
    predictor."""
    import torch

    from cokriging_tpu_torch.cov.matern import MultivariateMatern
    from cokriging_tpu_torch.cov.params import MaternParams
    from cokriging_tpu_torch.data.grids import prediction_coords
    from cokriging_tpu_torch.estimate.nll import joint_distance_blocks, neg_log_likelihood
    from cokriging_tpu_torch.fields.field import Field, MultiField
    from cokriging_tpu_torch.kernels import cuda_ops as K
    from cokriging_tpu_torch.predict.joint import JointPredictor

    c1, v1, c2, v2 = build_inputs(400, np.float64)
    flat = np.array([1.0, 1.0, 1.4, 1.3, 1.2, 500.0, 450.0, 550.0, 0.05, 0.04, -0.3])
    spec = MaternParams.default(2).spec

    def value_and_grad(device, analytic):
        coords = [torch.as_tensor(c, device=device) for c in (c1, c2)]
        dists = joint_distance_blocks(coords, geodesic=True)
        z = torch.as_tensor(np.concatenate([v1, v2]), device=device)
        x = torch.tensor(flat, device=device, requires_grad=True)
        v = neg_log_likelihood(x, dists, z, spec, None, 1e-8, analytic_grad=analytic)
        (g,) = torch.autograd.grad(v, x)
        return v.item(), g.cpu().numpy()

    K.reset_launch_counts()
    v_gpu, g_gpu = value_and_grad("cuda", True)
    counts = K.launch_counts()
    check(counts["matern_correlation"] == 3 and counts["matern_block_grad"] == 3,
          f"small NLL: launches {counts}")
    v_ad, g_ad = value_and_grad("cuda", False)
    v_cpu, g_cpu = value_and_grad("cpu", True)
    check(abs(v_gpu - v_cpu) <= 1e-10 * abs(v_cpu), f"small NLL: value {v_gpu} vs CPU {v_cpu}")
    check(np.allclose(g_gpu, g_cpu, rtol=1e-7, atol=1e-10), f"small NLL: gradient {g_gpu} vs CPU {g_cpu}")
    check(abs(v_gpu - v_ad) <= 1e-10 * abs(v_ad) and np.allclose(g_gpu, g_ad, rtol=1e-7, atol=1e-10),
          f"small NLL: analytic {g_gpu} vs plain AD {g_ad} on the card")
    log(f"(c) small NLL card vs CPU f64: value {v_gpu:.12g}, rel err {abs(v_gpu - v_cpu) / abs(v_cpu):.3e}; "
        f"gradient max rel err {float(np.max(np.abs(g_gpu - g_cpu) / np.abs(g_cpu))):.3e}; "
        f"analytic vs plain AD on the card {float(np.max(np.abs(g_gpu - g_ad) / np.abs(g_ad))):.3e}")

    fields = [Field.from_arrays(c1, v1, "Z0"), Field.from_arrays(c2, v2, "Z1")]
    for f in fields:
        f.geodesic = True
    mod = MultivariateMatern(params=MaternParams.from_flat(torch.as_tensor(flat)))
    pc = prediction_coords()[::10]
    out = {dev: JointPredictor(mod, MultiField(fields=fields), device=dev)(0, pc)
           for dev in ("cuda", "cpu")}
    err = float(max(np.max(np.abs(out["cuda"].pred - out["cpu"].pred)),
                    np.max(np.abs(out["cuda"].pred_err - out["cpu"].pred_err))))
    check(np.isfinite(out["cpu"].pred).all() and err <= 1e-8, f"small joint prediction: abs err {err}")
    log(f"(c) small joint prediction card vs CPU f64: {len(pc)} cells, abs err {err:.3e}")


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
    # the same fit projected onto the validity region (fit_wls's
    # project_validity=True), logged beside
    from cokriging_tpu_torch.cov.spectral import project_to_valid

    outp = LocalPredictor(MultivariateMatern(params=project_to_valid(lp.params)), lp.mf,
                          device=lp.device)(0, pc.astype(out.pred.dtype), max_dist=1_000.0)
    finitep = float(np.isfinite(outp.pred).mean())
    log(f"(d) {name}: fitted joint covariance PD at the data: {joint_pd}; "
        f"finite predictions {finite:.4%}; with rho = 0: {finite0:.4%}; with the fit projected "
        f"onto the validity region: {finitep:.4%}")
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


def entry_ops(x, nu, dtype, grad=False, ops=None):
    """Operations of the Matern kernel (``grad``: of the block-gradient
    kernel) over entries at x = sqrt(2 nu) h / ls > 0 of one nu, CF2 counted
    per trip the result needs: up to convergence, none past the setup for a
    forward at half-integer nu (a1 = 0: every trip adds exactly 0), all of
    them for a gradient there (the tangent needs them)."""
    import torch

    name = str(dtype).replace("torch.", "")
    o = ops or (MATERN_GRAD_OPS if grad else MATERN_OPS)
    nl = math.floor(abs(nu) + 0.5)
    mu = abs(nu) - nl
    steps = max(nl - 1, 0) if grad else nl  # the gradient stops one order short
    cf2_x = x[x >= 2]
    n_series = x.numel() - cf2_x.numel()
    degenerate = float(torch.tensor(0.25, dtype=dtype) - torch.tensor(mu, dtype=dtype) ** 2) == 0.0
    trips = 0
    if cf2_x.numel() and (grad or not degenerate):
        trips = int(cf2_trips(torch.full_like(cf2_x, mu), cf2_x, dtype).sum())
    return (x.numel() * (o["prefactor"] + steps * o["recurrence_step"])
            + n_series * (o["series_setup"] + SERIES_TRIPS[name] * o["series_trip"])
            + cf2_x.numel() * o["cf2_setup"] + trips * o["cf2_trip"])


def matern_bound(h, nu, ls, symmetric, grad=False, ops=None, n_out=4, n_fields=1):
    """Least times for one Matern block (``grad``: for its block gradient,
    or with ``ops`` one of the gradient-like second-order kernels: the
    Hessian sums, ``n_out`` = 5 doubles out, or the tangent's partials,
    ``n_out`` = 0 and ``n_fields`` = 3 whole n x m fields written): (bytes /
    HBM rate, operations / peak rate) in ms over the entries this block's
    data needs, counted in row chunks; ``bound_of`` combines them."""
    import torch

    name = str(h.dtype).replace("torch.", "")
    n, m = h.shape
    n_ops = 0
    rows = max(1, (1 << 24) // m)
    for r0 in range(0, n, rows):
        hc = h[r0:r0 + rows]
        mask = hc > 0
        if symmetric:
            ri = torch.arange(r0, r0 + hc.shape[0], device=h.device)[:, None]
            mask &= torch.arange(m, device=h.device)[None, :] <= ri
        n_ops += entry_ops(math.sqrt(2 * nu) * hc[mask] / ls, nu, h.dtype, grad, ops)
    n_entries = n * (n + 1) // 2 if symmetric else h.numel()
    # forward and the tangent's partials: h read where evaluated, the block
    # (n_fields of them) written; gradient and Hessian sums: h read where
    # evaluated, the cotangent read whole, n_out doubles written
    nbytes = ((n_entries + n_fields * h.numel()) * h.element_size()
              + (8 * n_out if grad else 0))
    return nbytes / PEAK_BYTES_PER_S * 1e3, n_ops / PEAK_OPS_PER_S[name] * 1e3


def pairs_bound(chunks, nus, lss, grad=False):
    """(bytes / HBM rate, operations / peak rate) in ms of the pairs kernel
    (``grad``: of its gradient kernel) over the path's launches, ``chunks`` =
    [(h, idx), ...]: every entry at its own pair's (nu, ls), plus the
    select; bytes h + index + out (gradient: h + index + ct, and the sums)."""
    from cokriging_tpu_torch.kernels import cuda_ops as K

    ops = n = nbytes = 0
    for h, idx in chunks:
        hf = h.reshape(-1).abs()
        k = K.pair_index(idx.reshape(-1), len(nus))
        for p, (nu, ls) in enumerate(zip(nus, lss)):
            for s in range(0, hf.numel(), 1 << 24):
                hp = hf[s:s + (1 << 24)][(k[s:s + (1 << 24)] == p) & (hf[s:s + (1 << 24)] > 0)]
                ops += entry_ops(math.sqrt(2 * nu) * hp / ls, nu, h.dtype, grad)
        n += hf.numel()
        nbytes += 3 * hf.numel() * h.element_size() + (16 * len(nus) if grad else 0)
    ops += n * PAIR_SELECT_OPS
    name = str(chunks[0][0].dtype).replace("torch.", "")
    return nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[name] * 1e3


def ptxas_of(lines, src, kernel):
    """"R registers, S bytes smem static; B bytes stack, spills" of the entry of
    ``src``'s ptxas report whose name holds ``kernel``, from the build's
    report lines (``_build.build()["ptxas"]``)."""
    section = entry = None
    found = {}
    for line in lines:
        if line.startswith("== "):
            section = line[3:].strip()
        elif "Compiling entry function" in line:
            entry = line if section == src and kernel in line else None
        elif entry is not None and "spill" in line:
            found["spill"] = line.strip()
        elif entry is not None and "registers" in line:
            found["registers"] = line.split("Used", 1)[-1].split(",")[0].strip()
            smem = [p.strip() for p in line.split(",") if "smem" in p]
            found["smem"] = smem[0] if smem else "0 bytes smem"
            break
    return (f"{found.get('registers', 'not found')}, {found.get('smem', 'smem not found')} static; "
            f"{found.get('spill', 'spills not found')}")


def bound_of(blocks):
    """``(bound_ms, bound_by)`` of the blocks launched together: the larger of
    their summed byte times and their summed operation times."""
    t_bytes = sum(b[0] for b in blocks)
    t_ops = sum(b[1] for b in blocks)
    return (t_bytes, "bytes") if t_bytes > t_ops else (t_ops, "operations")


def vario_bound(n_pairs, n_valid, k_cmp, n_bins, dtype_name, minmax):
    """(bound ms, "operations", the bound under the edge scan's count) of
    one pass: ``n_pairs`` pairs, ``n_valid`` [k] binned pairs of variogram
    k, ``k_cmp`` [k] its exact compares per pair (csrc/vario.cuh)."""
    rate = PEAK_OPS_PER_S[dtype_name] / 1e3
    base = n_pairs * VARIO_PAIR_OPS
    if minmax:
        ops = base + sum(n_valid) * VARIO_MINMAX_OPS
        return ops / rate, "operations", ops / rate
    old = base + sum(n_valid) * (VARIO_BIN_OPS + VARIO_BIN_OPS_PER_EDGE * (n_bins + 1))
    ops = base + sum(v * (VARIO_BIN_OPS + VARIO_LOOKUP_OPS + VARIO_COMPARE_OPS * k)
                     for v, k in zip(n_valid, k_cmp))
    return ops / rate, "operations", old / rate


def vario_rows(c1, v1, c2, v2, dtype, launches, shape, reps, plain_reps, max_dist=3000.0,
               suffix=""):
    """The two passes over the three variograms of one month of points
    (c1, c2) within ``max_dist`` km: one call each, timed with CUDA events
    beside the plain versions, with bounds from this run's pairs and counts;
    counts checked equal to the plain version's. Rows of the kernels line
    (named with ``suffix``)."""
    import torch

    from cokriging_tpu_torch.estimate import empirical as E
    from cokriging_tpu_torch.kernels import cuda_ops as K

    name = np.dtype(dtype).name
    np_dt = np.dtype(dtype)
    feats, vals, h_max, h_snap, snap = variogram_case(c1, v1, c2, v2, dtype, "cuda", max_dist)
    mm_sides, sides = vario_sides(feats, vals, MONTH_PAIRS)
    hr = K.variogram_minmax_pairs(mm_sides, True, h_max, h_snap).cpu().numpy()
    edges = [E._device_bins(lo, hi, True, np_dt.type(snap), 15, np_dt)[1] for lo, hi in hr]
    n_pairs = sum(f[0].shape[0] * (f[0].shape[0] - 1) // 2 if f[2] else
                  f[0].shape[0] * f[1].shape[0] for f in mm_sides)
    k_cmp = [K._bin_record(e, True, True, np_dt)[1] for e in edges]
    n_valid = [int(v) for v in K.variogram_bin_pairs(sides, edges, True, False, h_max)[1].sum(1)]
    rows, kept = [], {}
    for kname, kern, plain, minmax in (
        ("variogram_minmax", lambda: K.variogram_minmax_pairs(mm_sides, True, h_max, h_snap),
         lambda: K.variogram_minmax_pairs_plain(mm_sides, True, h_max, h_snap), True),
        ("variogram_bin", lambda: K.variogram_bin_pairs(sides, edges, True, False, h_max),
         lambda: K.variogram_bin_pairs_plain(sides, edges, True, False, h_max), False),
    ):
        ms = cuda_time_ms(keep(kept, "kernel", kern), reps, head_start_ms=50.0)
        plain_ms = cuda_time_ms(keep(kept, "plain", plain), plain_reps)
        got, want = (kept["kernel"], kept["plain"]) if minmax else (kept["kernel"][1],
                                                                    kept["plain"][1])
        check(torch.equal(got, want), f"{kname} {name} {shape}: differs from the plain version")
        # h ranges and counts equal; the bin sums' largest difference
        err = 0.0 if minmax else float((kept["kernel"][0] - kept["plain"][0]).abs().max())
        bound_ms, bound_by, old_bound = vario_bound(n_pairs, n_valid, k_cmp, 15, name, minmax)
        rows.append(dict(
            name=f"{kname}_{name}{suffix}", route="cuda",
            source="cokriging_tpu_torch/kernels/csrc/variogram.cu",
            replaces="cokriging_tpu/kernels/pallas_ops.py:143",
            launches=launches[kname], ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            bound_ms_edge_scan=old_bound, shape=shape, pairs=n_pairs, binned=sum(n_valid),
            k_cmp=k_cmp, max_abs_err=err,
        ))
    return rows


def phase_e(c1, v1, c2, v2, dtype, launches, results):
    import torch

    from cokriging_tpu_torch.kernels import cuda_ops as K

    name = np.dtype(dtype).name
    td = getattr(torch, name)
    rows = vario_rows(c1, v1, c2, v2, dtype, launches, "3 pairs x 12500 points x 15 bins", 20, 3)

    joint, _ = matern_blocks(c1, c2, dtype)
    nu, ls = 1.5, 800.0
    # the value row, built once on the card, as the path's block_covariance
    # builds its pair_table once per call
    row = K.recurrence_table(torch.full((1,), nu, dtype=td, device="cuda"),
                             torch.full((1,), ls, dtype=td, device="cuda"), td)[0]

    def jm(fn, **kw):
        return lambda: [fn(nu, ls, h, symmetric=s, **kw) for h, s in joint]

    bound_ms, bound_by = bound_of([matern_bound(h, nu, ls, s) for h, s in joint])
    rows.append(dict(
        name=f"matern_correlation_{name}", route="cuda",
        source="cokriging_tpu_torch/kernels/csrc/matern.cu",
        replaces="cokriging_tpu/kernels/pallas_ops.py:782",
        launches=launches["matern_correlation"],
        ms=cuda_time_ms(jm(K.matern_correlation_block, table=row), 50),
        plain_ms=cuda_time_ms(jm(K.matern_correlation_block_plain), 5),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        path="(d) fit + local prediction", shape="joint blocks 256^2 sym + 256^2 + 256^2 sym",
    ))
    for r in rows:
        r.update(max_abs_err=results[r["name"]]["max_abs_err"])
        r["max_err"] = r["max_abs_err"]
    # the likelihood path's shape: one 12,500^2 symmetric block
    big_c = torch.as_tensor(c1, dtype=getattr(torch, name), device="cuda")
    from cokriging_tpu_torch.kernels.distance import haversine_matrix

    hb = haversine_matrix(big_c, big_c)
    kept = {}
    big = dict(
        shape="12500^2 symmetric", dtype=name,
        ms=cuda_time_ms(keep(kept, "kernel", lambda: K.matern_correlation_block(
            nu, ls, hb, symmetric=True, table=row)), 3),
        plain_ms=cuda_time_ms(keep(kept, "plain", lambda: K.matern_correlation_block_plain(nu, ls, hb)), 1),
    )
    big["max_abs_err"] = float((kept["kernel"] - kept["plain"]).abs().max())
    atol = 5e-6 if name == "float32" else 1e-12
    check(big["max_abs_err"] <= atol and bool(torch.isfinite(kept["kernel"]).all()),
          f"(e) matern {name} 12,500^2 symmetric: err {big['max_abs_err']} (bar {atol})")
    big["bound_ms"], big["bound_by"] = bound_of([matern_bound(hb, nu, ls, True)])
    del hb, kept
    torch.cuda.empty_cache()
    return rows, big


def block_covariance_sync_free(flat, dists, spec, name):
    """``block_covariance`` forward and backward at the NLL's three blocks,
    the parameters on the card and its ``pair_table`` built inside, under
    ``torch.cuda.set_sync_debug_mode("error")``: 3 + 3 launches, a finite
    gradient, and the same covariance and gradient bit for bit as outside
    that mode."""
    import torch

    from cokriging_tpu_torch.cov.matern import block_covariance
    from cokriging_tpu_torch.cov.params import MaternParams
    from cokriging_tpu_torch.kernels import cuda_ops as K

    flat = flat.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        params = MaternParams.from_flat(flat, spec=spec)

    def run():
        with torch.enable_grad():
            cov = block_covariance(params, dists, h_grad=False)
            (g,) = torch.autograd.grad(cov.diagonal().sum() + cov[0].sum(), flat, retain_graph=True)
        return cov.detach(), g

    want = run()
    before = K.launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = run()
    except RuntimeError as e:
        raise SmokeFailure(f"(f) {name}: block_covariance synchronized: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)
    after = K.launch_counts()
    grew = {k: after[k] - before[k] for k in ("matern_correlation", "matern_block_grad")}
    check(grew == {"matern_correlation": 3, "matern_block_grad": 3}, f"(f) {name}: launches {grew}")
    check(bool(torch.isfinite(got[1]).all()) and torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"(f) {name}: block_covariance under sync debug mode differs or is not finite")
    log(f"(f) {name}: block_covariance forward + backward at the three 12,500^2 blocks ran under "
        f"set_sync_debug_mode('error') ({grew}), bit-equal to the same outside it")


def phase_f(dtype, pc, results):
    """The exact-likelihood path at bench size in one dtype; returns its
    rows of the kernels line (the Matern forward and the block gradient at
    this path's blocks)."""
    import warnings

    import torch

    from cokriging_tpu_torch.cov.matern import MultivariateMatern, block_covariance, pair_table
    from cokriging_tpu_torch.cov.params import MaternParams
    from cokriging_tpu_torch.estimate.nll import (
        fit_nll_device, joint_distance_blocks, neg_log_likelihood, nll_value_and_grad,
    )
    from cokriging_tpu_torch.fields.field import Field, MultiField
    from cokriging_tpu_torch.kernels import cuda_ops as K
    from cokriging_tpu_torch.predict.joint import JointPredictor

    name = np.dtype(dtype).name
    td = getattr(torch, name)
    c1, v1, c2, v2 = build_inputs(N_PER_PROC, dtype, noise_seed=1)
    coords = [torch.as_tensor(c, device="cuda") for c in (c1, c2)]
    z = torch.as_tensor(np.concatenate([v1, v2]), device="cuda")
    n = z.shape[0]
    dists = joint_distance_blocks(coords, geodesic=True)
    spec = MaternParams.default(2).spec
    x0 = MaternParams.default(2).to_flat().numpy().astype(dtype)
    x0[5:8] = 700.0  # length scales well inside the data span
    mvar = torch.zeros_like(z)
    jitter = 1e-6
    def penalty_of(n_obs):  # as the NLL rounds it to its dtype
        return float(np.dtype(dtype).type(1e6 * (1.0 + 0.5 * n_obs)))

    penalty = penalty_of(n)

    def evaluate(x):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v, g = nll_value_and_grad(torch.as_tensor(x, device="cuda"), dists, z, spec, mvar, jitter)
        torch.cuda.synchronize()
        return v.item(), g.cpu().numpy().astype(np.float64), time.perf_counter() - t0

    # bench.py:187-220: a warm-up, then three timed evaluations at fresh points
    evaluate(x0)
    K.reset_launch_counts()
    runs = [evaluate(x0 * (1.0 + 0.01 * (i + 1))) for i in range(3)]
    launches = K.launch_counts()
    check(launches["matern_correlation"] == 9 and launches["matern_block_grad"] == 9,
          f"(f) {name}: expected 3 + 3 launches per evaluation, got {launches}")
    at_penalty = [v == penalty for v, _, _ in runs]
    secs = [t for _, _, t in runs]
    log(f"(f) {name}: bench point (nugget 0, l = 700 km, jitter {jitter}): values "
        f"{[v for v, _, _ in runs]}, at the non-PD penalty: {at_penalty}; "
        f"seconds {secs}, evals/s {1.0 / min(secs)}; launches {launches}")
    for (v, g, _), pen in zip(runs, at_penalty):
        if pen:
            check(not g.any(), f"(f) {name}: penalty point with a nonzero gradient {g}")
        else:
            check(np.isfinite(v) and np.isfinite(g).all() and g.any(),
                  f"(f) {name}: value {v}, gradient {g}")

    # a point where the factorization succeeds: the same with nuggets 0.1
    xg = x0.copy()
    xg[8:10] = 0.1
    evaluate(xg)
    vg, gg, tg = evaluate(xg * (1.0 + np.array([0.0] * 5 + [0.01] * 3 + [0.0] * 3, dtype)))
    check(np.isfinite(vg) and vg != penalty and np.isfinite(gg).all() and gg.any(),
          f"(f) {name}: genuine point value {vg}, gradient {gg}")
    log(f"(f) {name}: genuine point (nuggets 0.1, l = 707 km): value {vg}, gradient "
        f"{np.array2string(gg, precision=6)}, seconds {tg}, evals/s {1.0 / tg}")
    if name == "float64":
        xq = xg * (1.0 + np.array([0.0] * 5 + [0.01] * 3 + [0.0] * 3))
        scale = np.array([1, 1, 1, 1, 1, 100, 100, 100, 0.05, 0.05, 0.3])
        d = np.where(gg >= 0, 1.0, -1.0) * scale  # no cancellation in g . d
        eps = 1e-4
        with torch.no_grad():
            vp, vm = (neg_log_likelihood(torch.as_tensor(xq + sgn * eps * d, device="cuda"), dists, z,
                                         spec, mvar, jitter).item() for sgn in (1.0, -1.0))
        fd, gd = (vp - vm) / (2 * eps), float(gg @ d)
        log(f"(f) {name}: directional check: central difference {fd}, g.d {gd}, "
            f"rel err {abs(fd - gd) / abs(gd):.3e}")
        check(abs(fd - gd) <= 1e-4 * abs(gd), f"(f) {name}: directional check {fd} vs {gd}")

    # stage times of one evaluation at the genuine point (host clock, each
    # stage ends in a synchronize), on the NLL's own calls
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    params = MaternParams.from_flat(torch.as_tensor(xg, device="cuda"), spec=spec)
    stages = {}
    with torch.no_grad():
        cov, stages["assembly_s"] = timed(lambda: block_covariance(params, dists, h_grad=False))
        cov.diagonal().add_(jitter)
        (chol, info), stages["cholesky_s"] = timed(lambda: torch.linalg.cholesky_ex(cov))
        check(int(info) == 0, f"(f) {name}: genuine point did not factorize")
        del cov

        def solves():
            alpha = torch.linalg.solve_triangular(chol, z[:, None], upper=False)
            beta = torch.linalg.solve_triangular(chol.T, alpha, upper=True)[:, 0]
            return torch.cholesky_inverse(chol).addr_(beta, beta, alpha=-1.0).mul_(0.5)

        g_cov, stages["solves_inverse_s"] = timed(solves)
        del chol
        block_covariance_sync_free(torch.as_tensor(xg, device="cuda"), dists, spec, name)
        h = N_PER_PROC
        # the evaluation's three blocks with their own (nu, l): (1,1), (1,2),
        # (2,2), and their rows of the pair table the evaluation builds
        table = pair_table(params, "cuda", td, grad=True)
        blocks = [(dists[0][0], g_cov[:h, :h], True, float(xg[2]), float(xg[5]), table.rows(0, 0)),
                  (dists[0][1], g_cov[:h, h:], False, float(xg[3]), float(xg[6]), table.rows(0, 1)),
                  (dists[1][1], g_cov[h:, h:], True, float(xg[4]), float(xg[7]), table.rows(1, 1))]

        def grads(fn, checked=None, **kw):
            chosen = blocks if checked is None else blocks[checked:checked + 1]
            return lambda: [fn(1.0, 0.1, nu, ls, hb, ct, symmetric=sym, **kw)
                            for hb, ct, sym, nu, ls, _ in chosen]

        def grads_k():
            return [K.matern_block_grad(1.0, 0.1, nu, ls, hb, ct, symmetric=sym, table=rows[1])
                    for hb, ct, sym, nu, ls, rows in blocks]

        _, stages["block_grad_s"] = timed(grads_k)
        log(f"(f) {name}: stages of one evaluation {json.dumps(stages)} "
            f"(sum {sum(stages.values())}, whole evaluation {tg})")
        # (e) the block-gradient kernel's row at these three 12,500^2 blocks
        # with the evaluation's own cotangent, each block's four sums held
        # against the plain version at the bar of phase (c)
        # the plain version at the cross block only (the 12,500^2 full one): at
        # all three it took ~72 s of the script's time limit
        kept = {}
        ms = cuda_time_ms(keep(kept, "kernel", grads_k), 2)
        kept["kernel"] = kept["kernel"][1:2]
        plain_ms = cuda_time_ms(keep(kept, "plain", grads(K.matern_block_grad_plain, checked=1)),
                                1, warm=False)
        mags = grads(K.matern_block_grad_plain, absolute=True, checked=1)()
        tol = 1e-5 if name == "float32" else 1e-12
        grad_res = dict(results[f"matern_block_grad_{name}"])
        full_rel = 0.0
        for k, (got, ref, mag) in enumerate(zip(kept["kernel"], kept["plain"], mags)):
            diff = (got - ref).abs()
            check(bool(torch.isfinite(got).all()) and bool((diff <= tol * mag).all()),
                  f"(f) block grad {name} 12,500^2 block {k}: {got.tolist()} vs plain {ref.tolist()}, "
                  f"|terms| {mag.tolist()}")
            full_rel = max(full_rel, float((diff / mag.clamp_min(1e-300)).max()))
            grad_res["max_abs_err"] = max(grad_res["max_abs_err"], float(diff.max()))
        grad_res["max_err"] = max(grad_res["max_err"], full_rel)
        log(f"(f) {name}: block gradient at the 12,500^2 cross block: |kernel - plain| / "
            f"sum|terms| {full_rel:.3e} (bar {tol}); plain {plain_ms:.1f} ms there")
        grad_bound = bound_of([matern_bound(hb, nu, ls, sym, grad=True) for hb, _, sym, nu, ls, _ in blocks])
        # the Matern forward at the same three blocks, one at a time
        atol = 5e-6 if name == "float32" else 1e-12
        fwd = dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0)
        for k, (hb, _, sym, nu, ls, rows) in enumerate(blocks):
            fwd["ms"] += cuda_time_ms(keep(kept, "kernel", lambda: K.matern_correlation_block(
                nu, ls, hb, symmetric=sym, table=rows[0])), 3)
            fwd["plain_ms"] += cuda_time_ms(
                keep(kept, "plain", lambda: K.matern_correlation_block_plain(nu, ls, hb, symmetric=sym)), 1)
            err = float((kept["kernel"] - kept["plain"]).abs().max())
            check(err <= atol and bool(torch.isfinite(kept["kernel"]).all()),
                  f"(f) matern {name} 12,500^2 block {k}: err {err} (bar {atol})")
            fwd["max_abs_err"] = max(fwd["max_abs_err"], err)
        kept.clear()
        log(f"(f) {name}: Matern forward at the three 12,500^2 blocks: max abs err {fwd['max_abs_err']:.3e} "
            f"(bar {atol})")
        fwd_bound = bound_of([matern_bound(hb, nu, ls, sym) for hb, _, sym, nu, ls, _ in blocks])
        # the same blocks at NU_GENERAL, each with its own length scale and
        # the value row a pair table would hold there
        gen = dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0)
        for k, (hb, _, sym, _, ls, _) in enumerate(blocks):
            row = K.recurrence_table(torch.full((1,), NU_GENERAL, dtype=td, device="cuda"),
                                     torch.full((1,), ls, dtype=td, device="cuda"), td)[0]
            gen["ms"] += cuda_time_ms(keep(kept, "kernel", lambda: K.matern_correlation_block(
                NU_GENERAL, ls, hb, symmetric=sym, table=row)), 3)
            gen["plain_ms"] += cuda_time_ms(keep(kept, "plain", lambda: K.matern_correlation_block_plain(
                NU_GENERAL, ls, hb, symmetric=sym)), 1, warm=False)
            err = float((kept["kernel"] - kept["plain"]).abs().max())
            check(err <= atol and bool(torch.isfinite(kept["kernel"]).all()),
                  f"(f) matern {name} 12,500^2 block {k} at nu {NU_GENERAL}: err {err} (bar {atol})")
            gen["max_abs_err"] = max(gen["max_abs_err"], err)
        kept.clear()
        log(f"(f) {name}: Matern forward at the three 12,500^2 blocks at nu {NU_GENERAL}: {gen['ms']:.3f} ms, "
            f"plain {gen['plain_ms']:.3f} ms, max abs err {gen['max_abs_err']:.3e} (bar {atol})")
        gen_bound = bound_of([matern_bound(hb, NU_GENERAL, ls, sym) for hb, _, sym, _, ls, _ in blocks])
    shape = "NLL blocks 12500^2 sym + 12500^2 + 12500^2 sym"
    rows = [
        dict(name=f"matern_correlation_{name}_nll", route="cuda",
             source="cokriging_tpu_torch/kernels/csrc/matern.cu",
             replaces="cokriging_tpu/kernels/pallas_ops.py:782",
             launches=launches["matern_correlation"], launches_per_eval=3,
             bound_ms=fwd_bound[0], bound_by=fwd_bound[1], library_ms=None,
             path="(f) exact likelihood", shape=shape, max_err=fwd["max_abs_err"], **fwd),
        dict(name=f"matern_correlation_{name}_nll_nu{NU_GENERAL}", route="cuda",
             source="cokriging_tpu_torch/kernels/csrc/matern.cu",
             replaces="cokriging_tpu/kernels/pallas_ops.py:782",
             launches=launches["matern_correlation"], launches_per_eval=3,
             bound_ms=gen_bound[0], bound_by=gen_bound[1], library_ms=None,
             path=f"(f) exact likelihood, its blocks timed at nu = {NU_GENERAL}", shape=shape,
             max_err=gen["max_abs_err"], **gen),
        dict(name=f"matern_block_grad_{name}", route="cuda",
             source="cokriging_tpu_torch/kernels/csrc/matern_grad.cu",
             replaces="cokriging_tpu/kernels/pallas_ops.py:485",
             launches=launches["matern_block_grad"], launches_per_eval=3, ms=ms, plain_ms=plain_ms,
             plain_of="the 12,500^2 cross block only",
             bound_ms=grad_bound[0], bound_by=grad_bound[1], library_ms=None,
             path="(f) exact likelihood", shape=shape, **grad_res),
    ]
    del g_cov, blocks, dists, mags
    torch.cuda.empty_cache()

    # maximum-likelihood fit on the stride-5 subsample, then joint prediction
    fields = [Field.from_arrays(c[::5], v[::5], f"Z{k}") for k, (c, v) in enumerate(((c1, v1), (c2, v2)))]
    for f in fields:
        f.geodesic = True
    mf = MultiField(fields=fields)
    init = MaternParams.default(2, dtype=td)
    sub = joint_distance_blocks([torch.as_tensor(f.coords_main, device="cuda") for f in fields], True)
    z_sub = torch.cat([f.values_main for f in fields]).to("cuda")
    with torch.no_grad():
        start = neg_log_likelihood(init.to_flat().to("cuda"), sub, z_sub, spec, None, jitter).item()
    del sub
    K.reset_launch_counts()
    (params, info), fit_s = timed(lambda: fit_nll_device(mf, init=init, jitter=jitter, maxiter=60,
                                                        method="lbfgs"))
    x = params.to_flat().cpu().numpy().astype(np.float64)
    lo, hi = spec.bounds()
    log(f"(f) {name}: ML fit (L-BFGS, 2 x {fields[0].size} points, maxiter 60, jitter {jitter}): "
        f"start {start}, fitted {info}, seconds {fit_s}, params {np.array2string(x, precision=5)}")
    check(bool(np.all((x >= lo - 1e-6 * (hi - lo)) & (x <= hi + 1e-6 * (hi - lo)))),
          f"(f) {name}: ML fit out of bounds")
    if start == penalty_of(z_sub.shape[0]):
        # the default start is itself non-PD in this dtype: the gradient is
        # zero there, so the fitter must stop at once and say so
        log(f"(f) {name}: the default start is at the non-PD penalty; the fit stays there")
        check(not info["success"] and info["n_obj_evals"] == 1, f"(f) {name}: {info}")
    else:
        check(info["nll"] < start, f"(f) {name}: ML fit did not improve: {info['nll']} vs {start}")
    jp = JointPredictor(MultivariateMatern(params=params), mf)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out, pred_s = timed(lambda: jp(0, pc.astype(dtype)))
    valid = not any("not positive definite" in str(w.message) for w in caught)
    finite = float(np.isfinite(out.pred).mean())
    log(f"(f) {name}: joint prediction at {len(pc)} cells from 2 x {fields[0].size} points: "
        f"model valid {valid}, finite {finite:.4%}, seconds {pred_s}, launches {K.launch_counts()}")
    if valid:
        check(finite > 0.99 and bool(np.all(out.pred_err[np.isfinite(out.pred_err)] >= 0)),
              f"(f) {name}: valid model but {finite:.2%} finite predictions")
    if name == "float64":
        full = [Field.from_arrays(c, v, f"Z{k}") for k, (c, v) in enumerate(((c1, v1), (c2, v2)))]
        for f in full:
            f.geodesic = True
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out, pred_s = timed(lambda: JointPredictor(MultivariateMatern(params=params),
                                                       MultiField(fields=full))(0, pc))
        log(f"(f) {name}: joint prediction from all 2 x {N_PER_PROC} points (not gated): finite "
            f"{float(np.isfinite(out.pred).mean()):.4%}, seconds {pred_s}, "
            f"warnings {[str(w.message)[:60] for w in caught]}")
    torch.cuda.empty_cache()
    return rows


# --- the large-n path (examples/large_n_workflow.py) ------------------------


N_LARGE = 60_000  # per process
N_CG = 12_500  # per process: the first observations, the bench month's n
VECCHIA_M, VECCHIA_CHUNK, VECCHIA_MAXITER = 20, 4096, 80
LARGE_INIT = [1.0, 1.0, 1.5, 1.5, 1.5, 500.0, 500.0, 500.0, 0.05, 0.05, 0.0]


def large_n_month(dtype, n=N_LARGE):
    """The JAX package's large-n example data (examples/large_n_workflow.py:
    59-69, seed 0): a CONUS-like bivariate field, a shared smooth signal plus
    noise, the second process on the first's coordinates in reverse order."""
    rng = np.random.default_rng(0)
    lat = rng.uniform(24.0, 50.0, n).astype(dtype)
    lon = rng.uniform(-124.0, -67.0, n).astype(dtype)
    base = np.sin(np.deg2rad(lat) * 6.0) + 0.5 * np.cos(np.deg2rad(lon) * 4.0)
    c1 = np.column_stack([lat, lon])
    c2 = np.ascontiguousarray(np.column_stack([lat, lon])[::-1])
    z1 = base + 0.3 * rng.normal(size=n)
    z2 = -0.6 * base[::-1] + 0.3 * rng.normal(size=n)
    z1 = ((z1 - z1.mean()) / z1.std()).astype(dtype)
    z2 = ((z2 - z2.mean()) / z2.std()).astype(dtype)
    return c1, z1, c2, z2


def geo_fields(pairs):
    from cokriging_tpu_torch.fields.field import Field, MultiField

    fields = []
    for c, z, name in pairs:
        f = Field.from_arrays(c, z, name)
        f.geodesic = True
        fields.append(f)
    return MultiField(fields=fields)


@contextlib.contextmanager
def captured(name, limit=None, module=None):
    """The arguments of the calls of ``cuda_ops.<name>`` (or ``module``'s
    ``name``) made inside the block (the first ``limit`` of them), as the
    path hands them over: the positional ones, then the keyword ones' values
    in order (the pairs forward's prebuilt ``table``)."""
    from cokriging_tpu_torch.kernels import cuda_ops as K

    K = module or K
    store, orig = [], getattr(K, name)

    def spy(*args, **kwargs):
        if limit is None or len(store) < limit:
            store.append(args + tuple(kwargs.values()))
        return orig(*args, **kwargs)

    setattr(K, name, spy)
    try:
        yield store
    finally:
        setattr(K, name, orig)


def pairs_forward_check(calls, atol, what):
    """Kernel against plain version over the path's own forward launches
    (``calls``: their argument tuples, the path's table included where it
    passed one): (max abs error, kernel ms, plain ms)."""
    import torch

    from cokriging_tpu_torch.kernels import cuda_ops as K

    kept = {}
    ms = cuda_time_ms(keep(kept, "kernel", lambda: [K.matern_corr_pairs(*a) for a in calls]), 3)
    plain_ms = cuda_time_ms(keep(kept, "plain", lambda: [K.matern_corr_pairs_plain(*a[:4]) for a in calls]),
                            1, warm=False)
    err = max(float((k - p).abs().max()) for k, p in zip(kept["kernel"], kept["plain"]))
    finite = all(bool(torch.isfinite(k).all()) for k in kept["kernel"])
    check(finite and err <= atol, f"pairs forward at {what}: err {err} (bar {atol}), finite {finite}")
    tables = sum(len(a) > 4 and a[4] is not None for a in calls)
    log(f"pairs forward at {what}: {tables} of {len(calls)} launches were handed the path's table")
    return err, ms, plain_ms


def pairs_grad_check(calls, tol, what, timed_reps=0):
    """Gradient kernel against plain version over ``calls`` (argument tuples
    with their cotangents, then the path's table where it passed one): every
    per-pair sum within tol * sum |terms|, the
    same sums on a second launch. Returns (max rel, max abs, kernel ms, plain
    ms); the times only when ``timed_reps``."""
    import torch

    from cokriging_tpu_torch.kernels import cuda_ops as K

    kept = {}
    run_k = keep(kept, "kernel", lambda: [K.matern_corr_pairs_grad(*a) for a in calls])
    run_p = keep(kept, "plain", lambda: [K.matern_corr_pairs_grad_plain(*a[:5]) for a in calls])
    ms = plain_ms = None
    if timed_reps:
        ms = cuda_time_ms(run_k, timed_reps)
        plain_ms = cuda_time_ms(run_p, 1, warm=False)
    else:
        run_k()
        run_p()
    again = [K.matern_corr_pairs_grad(*a) for a in calls]
    rel = err = 0.0
    for a, got, ref, rep in zip(calls, kept["kernel"], kept["plain"], again):
        mag = K.matern_corr_pairs_grad_plain(*a[:5], absolute=True)
        diff = (got - ref).abs()
        check(bool(torch.isfinite(got).all()) and bool((diff <= tol * mag).all()),
              f"pairs gradient at {what}: {got.tolist()} vs plain {ref.tolist()}, |terms| {mag.tolist()}")
        check(torch.equal(got, rep), f"pairs gradient at {what}: sums differ from run to run")
        rel = max(rel, float((diff / mag.clamp_min(1e-300)).max()))
        err = max(err, float(diff.max()))
    return rel, err, ms, plain_ms


def phase_c_pairs(dtype, results):
    """The gathered-pairs kernels against their plain versions: ragged flat
    lengths, 1, 3 and 6 pairs with nu in {0.3, 0.5, 1.5, 2.7, 1.2, 0.8}, each
    pair spanning x = 2, exact zeros in h."""
    import torch

    name = np.dtype(dtype).name
    td = getattr(torch, name)
    atol, tol = (5e-6, 1e-5) if name == "float32" else (1e-12, 1e-12)
    rng = np.random.default_rng(6)
    nus = [0.3, 0.5, 1.5, 2.7, 1.2, 0.8]
    lss = [300.0, 300.0, 800.0, 1500.0, 450.0, 600.0]
    err_f = rel_g = err_g = 0.0
    for n_pairs, n in ((1, 1_000_003), (3, 777_777), (6, 2_000_001)):
        h = np.abs(rng.normal(size=n)) * 1500.0
        h[::61] = 0.0
        idx = rng.integers(0, n_pairs, size=n)
        for p in range(n_pairs):
            x = math.sqrt(2 * nus[p]) * h[idx == p] / lss[p]
            check(bool((x < 2).any()) and bool((x >= 2).any()), "case must span x = 2")
        t = [torch.as_tensor(a, dtype=td, device="cuda") for a in (idx, h, rng.normal(size=n))]
        args = (torch.tensor(nus[:n_pairs], dtype=td), torch.tensor(lss[:n_pairs], dtype=td), t[0], t[1])
        e, _, _ = pairs_forward_check([args], atol, f"{name} {n_pairs} pairs x {n}")
        r, ea, _, _ = pairs_grad_check([args + (t[2],)], tol, f"{name} {n_pairs} pairs x {n}")
        err_f, rel_g, err_g = max(err_f, e), max(rel_g, r), max(err_g, ea)
    results[f"matern_corr_pairs_{name}"] = {"max_abs_err": err_f}
    results[f"matern_corr_pairs_grad_{name}"] = {"max_abs_err": err_g, "max_err": rel_g}
    log(f"(c) pairs {name}: 3 cases (1, 3, 6 pairs; 0.8-2 M entries), forward max abs err {err_f:.3e} "
        f"(bar {atol}); gradient worst |kernel - plain| / sum|terms| {rel_g:.3e} (bar {tol}), "
        f"bit-equal on a second launch")


def ulp_nus(name):
    """Half-integer orders (degenerate CF2 lanes, which the forward lets
    leave CF2 early) and 1.5 -+ one ulp of the dtype (the reference's
    truncated CF2 tangent, ROADMAP Queue 3)."""
    ft = np.float32 if name == "float32" else np.float64
    return [0.5, 1.5, 2.5, float(np.nextafter(ft(1.5), ft(0))), float(np.nextafter(ft(1.5), ft(2)))]


def phase_c_partition(dtype, results):
    """Stress cases of the four partitioned kernels against their plain
    versions. The pairs forward and gradient: one branch only (x < 2;
    x >= 2), a shuffled 50/50 mix over ten pairs, ten pairs unshuffled,
    lengths around their 2,048-entry tile; nu holds 0.5, 1.5, 2.5 and 1.5 -+
    ulp; each forward output also bit-equal under a random permutation of
    its entries (permuted back) and with the degenerate lanes' CF2 trips run
    in full, each gradient sum within tol * sum |terms| and bit-equal on a
    second launch. The block forward: symmetric blocks of n in {1, 63, 65,
    650} (and a ragged 650 x 411 one) all series, all CF2 or mixed at the
    same nu, full and symmetric: the symmetric output exactly symmetric and
    equal bit for bit to the full one's lower triangle, both bit-equal when
    rows and columns of h are permuted together and without the early CF2
    exit. The block gradient: the 650^2 and 650 x 411 blocks: each sum
    within tol * sum |terms|, bit-equal on a second launch, symmetric ==
    full."""
    import torch

    from cokriging_tpu_torch.kernels import cuda_ops as K

    name = np.dtype(dtype).name
    td = getattr(torch, name)
    atol, tol = (5e-6, 1e-5) if name == "float32" else (1e-12, 1e-12)
    rng = np.random.default_rng(8)
    nus = [0.3, 1.2] + ulp_nus(name) + [0.8, 2.2, 3.1]
    lss = [300.0, 450.0, 800.0, 1500.0, 600.0, 350.0, 900.0, 1200.0, 700.0, 500.0]
    x_lo = rng.uniform(1e-3, 1.99, 400_000)
    x_hi = rng.uniform(2.0, 40.0, 400_000)
    err_f = rel_g = err_g = 0.0
    n_cases = 0
    for what, x, n_pairs in (("series only", x_lo, 7), ("CF2 only", x_hi, 7),
                             ("50/50 shuffled", rng.permutation(np.concatenate([x_lo, x_hi])), 10),
                             ("ten pairs in runs", np.concatenate([x_lo, x_hi]), 10),
                             ("1 entry", x_hi[:1], 1), ("2,047", x_lo[:2047], 3),
                             ("2,049", x_hi[:2049], 3), ("100,001 mixed", np.concatenate(
                                 [x_lo[:50_000], x_hi[:50_001]]), 10)):
        idx = rng.integers(0, n_pairs, size=x.shape[0])
        nu, ls = np.array(nus[:n_pairs]), np.array(lss[:n_pairs])
        h = x * ls[idx] / np.sqrt(2.0 * nu[idx])
        h[::97] = 0.0
        nu_t, ls_t = (torch.tensor(v, dtype=td, device="cuda") for v in (nu, ls))
        idx_t, h_t = (torch.as_tensor(v, dtype=td, device="cuda") for v in (idx, h))
        got = K.matern_corr_pairs(nu_t, ls_t, idx_t, h_t)
        ref = K.matern_corr_pairs_plain(nu_t, ls_t, idx_t, h_t)
        err = float((got - ref).abs().max())
        check(bool(torch.isfinite(got).all()) and err <= atol,
              f"(c) pairs forward {name} {what}: err {err} (bar {atol})")
        perm = torch.randperm(h_t.numel(), device="cuda")
        back = torch.empty_like(got)
        back[perm] = K.matern_corr_pairs(nu_t, ls_t, idx_t[perm], h_t[perm])
        check(torch.equal(back, got), f"(c) pairs forward {name} {what}: not bit-equal under permutation")
        full = K.matern_corr_pairs(nu_t, ls_t, idx_t, h_t, early_exit=False)
        check(torch.equal(full, got), f"(c) pairs forward {name} {what}: the degenerate lanes' early "
              f"CF2 exit changed a bit")
        ct = torch.as_tensor(rng.normal(size=x.shape[0]), dtype=td, device="cuda")
        r, e, _, _ = pairs_grad_check([(nu_t, ls_t, idx_t, h_t, ct)], tol, f"(c) {name} {what}")
        err_f, rel_g, err_g = max(err_f, err), max(rel_g, r), max(err_g, e)
        n_cases += 1
    results[f"matern_corr_pairs_{name}"]["max_abs_err"] = max(
        results[f"matern_corr_pairs_{name}"]["max_abs_err"], err_f)
    g_res = results[f"matern_corr_pairs_grad_{name}"]
    g_res["max_abs_err"], g_res["max_err"] = max(g_res["max_abs_err"], err_g), max(g_res["max_err"], rel_g)
    worst = err_m = 0.0
    n_blocks = 0
    ls = 800.0
    for nu in ulp_nus(name):
        for what, lo, hi in (("series only", 1e-3, 1.99), ("CF2 only", 2.0, 40.0),
                             ("mixed", 1e-3, 40.0)):
            for n in (1, 63, 65, 650):
                x = rng.uniform(lo, hi, size=(n, n))
                x = np.tril(x, -1) + np.tril(x, -1).T
                h = torch.as_tensor(x * ls / np.sqrt(2.0 * nu), dtype=td, device="cuda")
                err_m = max(err_m, matern_stress_block(h, nu, ls, atol, f"{name} nu={nu} {what} {n}"))
                n_blocks += 1
            ct = torch.as_tensor(rng.normal(size=(n, n)), dtype=td, device="cuda")
            for hh, cc, sym in ((h, ct, True), (h[:, :411], ct[:, :411].contiguous(), False)):
                got = K.matern_block_grad(1.3, 0.02, nu, ls, hh, cc, symmetric=sym)
                ref = K.matern_block_grad_plain(1.3, 0.02, nu, ls, hh, cc, symmetric=sym)
                mag = K.matern_block_grad_plain(1.3, 0.02, nu, ls, hh, cc, symmetric=sym, absolute=True)
                rel = float(((got - ref).abs() / mag.clamp_min(1e-300)).max())
                check(bool(torch.isfinite(got).all()) and bool(((got - ref).abs() <= tol * mag).all()),
                      f"(c) block grad {name} nu={nu} {what} sym={sym}: {got.tolist()} vs plain "
                      f"{ref.tolist()}, |terms| {mag.tolist()}")
                check(torch.equal(got, K.matern_block_grad(1.3, 0.02, nu, ls, hh, cc, symmetric=sym)),
                      f"(c) block grad {name} nu={nu} {what}: sums differ from run to run")
                if sym:
                    full = K.matern_block_grad(1.3, 0.02, nu, ls, hh, cc)
                    check(bool(((got - full).abs() <= tol * mag).all()),
                          f"(c) block grad {name} nu={nu} {what}: symmetric {got.tolist()} vs full "
                          f"{full.tolist()}")
                worst = max(worst, rel)
    grad_res = results[f"matern_block_grad_{name}"]
    grad_res["max_err"] = max(grad_res["max_err"], worst)
    m_res = results[f"matern_correlation_{name}"]
    m_res["max_abs_err"] = max(m_res["max_abs_err"], err_m)
    log(f"(c) partition stress {name} at nu {ulp_nus(name)}: pairs forward {n_cases} cases, max abs err "
        f"{err_f:.3e} (bar {atol}), bit-equal under permutation and without the early CF2 exit; pairs "
        f"gradient the same cases, worst |kernel - plain| / sum|terms| {rel_g:.3e} (bar {tol}), bit-equal "
        f"again; block forward {n_blocks} blocks full and symmetric (and 650 x 411), max abs err "
        f"{err_m:.3e} (bar {atol}), symmetric exactly symmetric and bit-equal to full, bit-equal under "
        f"a joint permutation and without the early CF2 exit; block grad 30 blocks, worst |kernel - "
        f"plain| / sum|terms| {worst:.3e} (bar {tol}), bit-equal again, symmetric == full")


def matern_stress_block(h, nu, ls, atol, what):
    """One block of the block forward's stress cases (square symmetric h,
    zero diagonal): full and symmetric outputs within atol of the plain
    version, the symmetric one exactly symmetric and bit-equal to the full
    one's lower triangle, both bit-equal when the rows and columns of h are
    permuted together and with the early CF2 exit off; at n = 650 also the
    ragged 650 x 411 block. Returns the largest error."""
    import torch

    from cokriging_tpu_torch.kernels import cuda_ops as K

    n = h.shape[0]
    full = K.matern_correlation_block(nu, ls, h)
    sym = K.matern_correlation_block(nu, ls, h, symmetric=True)
    err = float((full - K.matern_correlation_block_plain(nu, ls, h)).abs().max())
    check(bool(torch.isfinite(full).all()) and err <= atol, f"(c) matern {what}: err {err} (bar {atol})")
    low = torch.tril(torch.ones(n, n, dtype=torch.bool, device="cuda"))
    check(torch.equal(sym, sym.T) and torch.equal(sym[low], full[low]),
          f"(c) matern {what}: symmetric output not symmetric or not the full one's lower triangle")
    perm = torch.randperm(n, device="cuda")
    for s, out in ((False, full), (True, sym)):
        moved = K.matern_correlation_block(nu, ls, h[perm][:, perm].contiguous(), symmetric=s)
        check(torch.equal(moved, out[perm][:, perm]), f"(c) matern {what} sym={s}: not bit-equal under a "
              f"joint permutation of rows and columns")
        check(torch.equal(K.matern_correlation_block(nu, ls, h, symmetric=s, early_exit=False), out),
              f"(c) matern {what} sym={s}: the degenerate lanes' early CF2 exit changed a bit")
    if n == 650:
        rag = h[:, :411].contiguous()
        got = K.matern_correlation_block(nu, ls, rag)
        check(torch.equal(got, full[:, :411]), f"(c) matern {what}: the ragged 650 x 411 block differs")
    return err


def phase_c_small_large_n():
    """The large-n path's pieces at 2 x 400 points on the card against the
    same code on the CPU, float64: the Vecchia value and gradient (m = 10),
    direct-assembly against materialized local prediction and kd against the
    device search, CG against the dense joint predictor."""
    import warnings

    import torch

    from cokriging_tpu_torch.cov.matern import MultivariateMatern
    from cokriging_tpu_torch.cov.params import MaternParams
    from cokriging_tpu_torch.data.grids import prediction_coords
    from cokriging_tpu_torch.estimate.vecchia import VecchiaLikelihood, vecchia_nll_value_and_grad
    from cokriging_tpu_torch.kernels import cuda_ops as K
    from cokriging_tpu_torch.kernels.distance import haversine_matrix
    from cokriging_tpu_torch.predict.iterative import IterativeJointPredictor
    from cokriging_tpu_torch.predict.joint import JointPredictor
    from cokriging_tpu_torch.predict.local import LocalPredictor

    c1, v1, c2, v2 = build_inputs(400, np.float64)
    flat = [1.0, 1.0, 1.4, 1.3, 1.2, 500.0, 450.0, 550.0, 0.05, 0.04, -0.3]
    spec = MaternParams.default(2).spec
    res = {}
    for dev in ("cuda", "cpu"):
        K.reset_launch_counts()
        lik = VecchiaLikelihood([c1, c2], [v1, v2], m=10, geodesic=True, chunk=256, device=dev)
        v, g = vecchia_nll_value_and_grad(torch.tensor(flat, device=dev), lik._win, spec, True, 256)
        res[dev] = (lik.perm, v.item(), g.cpu().numpy(), K.launch_counts())
    (perm_g, v_g, g_g, n_g), (perm_c, v_c, g_c, _) = res["cuda"], res["cpu"]
    check(np.array_equal(perm_g, perm_c), "small Vecchia: the maxmin orders differ")
    check(n_g["matern_corr_pairs"] == 4 and n_g["matern_corr_pairs_grad"] == 4,
          f"small Vecchia: launches {n_g}")
    check(abs(v_g - v_c) <= 1e-10 * abs(v_c) and np.allclose(g_g, g_c, rtol=1e-7, atol=1e-10),
          f"small Vecchia: value {v_g} vs {v_c}, gradient {g_g} vs {g_c}")
    log(f"(c) small Vecchia card vs CPU f64 (2 x 400, m = 10, 4 chunks): value rel err "
        f"{abs(v_g - v_c) / abs(v_c):.3e}, gradient max rel err "
        f"{float(np.max(np.abs(g_g - g_c) / np.abs(g_c))):.3e}")

    mf = geo_fields(((c1, v1, "Z0"), (c2, v2, "Z1")))
    mod = MultivariateMatern(params=MaternParams.from_flat(torch.tensor(flat)))
    pc = prediction_coords()[::10]
    # the CPU's plain K_nu is slow: there, every 20th of the cells with data
    # within 500 km
    near = haversine_matrix(torch.as_tensor(pc), torch.as_tensor(np.concatenate([c1, c2])))
    few = pc[(near <= 500.0).any(dim=1).numpy()][::20]
    kinds = {"mat": {}, "dir": dict(materialize_cov=False),
             "kd": dict(materialize_cov=False, neighbor_method="kd")}
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for kind, kw in kinds.items():
            out["cuda", kind] = LocalPredictor(mod, mf, **kw)(0, pc)
        for dev in ("cuda", "cpu"):
            for kind in ("dir", "kd"):
                out[dev, kind, "few"] = LocalPredictor(mod, mf, device=dev, **kinds[kind])(
                    0, few, max_dist=500.0)
    worst = 0.0
    for a, b in ((("cuda", "mat"), ("cuda", "dir")), (("cuda", "dir"), ("cuda", "kd")),
                 (("cpu", "dir", "few"), ("cuda", "dir", "few")),
                 (("cpu", "kd", "few"), ("cuda", "kd", "few"))):
        x, y = out[a], out[b]
        ok = np.isfinite(x.pred)
        check(np.array_equal(ok, np.isfinite(y.pred)) and ok.mean() > 0.9,
              f"small local {a} vs {b}: NaN lanes differ or too many")
        check(np.allclose(y.pred[ok], x.pred[ok], rtol=1e-10, atol=1e-12)
              and np.allclose(y.pred_err[ok], x.pred_err[ok], rtol=1e-8, atol=1e-7),
              f"small local {a} vs {b}")
        worst = max(worst, float(np.max(np.abs(y.pred[ok] - x.pred[ok]))))
    log(f"(c) small local prediction f64: direct vs materialized and kd vs device search on the "
        f"card ({len(pc)} cells, 1000 km), card vs CPU ({len(few)} cells, 500 km), pred max abs "
        f"err {worst:.3e}")

    cells = pc[:64]
    ijp = IterativeJointPredictor(mod, mf, block=128, rhs_batch=64, tol=1e-10, maxiter=1000)
    got = ijp(0, cells)
    want = JointPredictor(mod, mf)(0, cells)
    check(np.allclose(got.pred, want.pred, rtol=1e-6, atol=1e-8)
          and np.allclose(got.pred_err, want.pred_err, rtol=1e-6, atol=1e-8),
          "small CG vs dense joint prediction")
    log(f"(c) small CG vs dense joint f64 ({len(cells)} cells, tol 1e-10): CG iterations "
        f"{[k for k, _ in ijp.last_diagnostics]}, pred max abs err "
        f"{float(np.max(np.abs(got.pred - want.pred))):.3e}")


def cg_sync_free(ijp, call, name):
    """The CG row tile's forward on a random permutation of its entries,
    permuted back, bit-equal to the tile's own output; then one
    ``matern_corr_pairs`` call (its table built on the card) and one CG
    matvec over all row tiles (the pair table built beforehand, as the
    predictor does once per solve) under
    ``torch.cuda.set_sync_debug_mode("error")``: neither may synchronize."""
    import torch

    from cokriging_tpu_torch.cov.matern import pair_table
    from cokriging_tpu_torch.kernels import cuda_ops as K
    from cokriging_tpu_torch.predict.iterative import _tiled_rows_matvec

    nu, ls, idx, h = call[:4]
    got = K.matern_corr_pairs(*call)
    perm = torch.randperm(h.numel(), device="cuda")
    back = torch.empty_like(got.reshape(-1))
    back[perm] = K.matern_corr_pairs(nu, ls, idx.reshape(-1)[perm], h.reshape(-1)[perm])
    check(torch.equal(back.reshape(got.shape), got),
          f"(g) {name}: the CG row tile's forward is not bit-equal under a permutation")
    coords, procs, *_ = ijp._stacked()
    table = pair_table(ijp.params, coords.device, coords.dtype)
    v = torch.randn(coords.shape[0], 1, dtype=ijp.params.sigma.dtype, device="cuda")
    before = K.launch_counts()["matern_corr_pairs"]
    torch.cuda.synchronize()
    with torch.no_grad():
        torch.cuda.set_sync_debug_mode("error")
        try:
            one = K.matern_corr_pairs(nu, ls, idx, h)
            y = _tiled_rows_matvec(ijp.params, coords, procs, coords, procs, v, True, ijp.block, table)
        except RuntimeError as e:
            raise SmokeFailure(f"(g) {name}: a pairs call or CG matvec synchronized: {e}") from e
        finally:
            torch.cuda.set_sync_debug_mode(0)
    tiles = K.launch_counts()["matern_corr_pairs"] - before - 1
    check(torch.equal(one, got) and bool(torch.isfinite(y).all()),
          f"(g) {name}: the sync-free pairs call or matvec is wrong")
    log(f"(g) {name}: CG row tile bit-equal under a permutation; one pairs call and one matvec over "
        f"{tiles} row tiles ran under set_sync_debug_mode('error')")


def phase_g(dtype, results):
    """The large-n path at the JAX example's size in one dtype; returns its
    rows of the kernels line."""
    import warnings

    import torch

    from cokriging_tpu_torch.cov.matern import MultivariateMatern
    from cokriging_tpu_torch.cov.params import MaternParams, ParamSpec
    from cokriging_tpu_torch.cov.spectral import params_rho_max, project_to_valid
    from cokriging_tpu_torch.estimate.vecchia import (
        VecchiaLikelihood, fit_vecchia, vecchia_nll_value_and_grad,
    )
    from cokriging_tpu_torch.kernels import cuda_ops as K
    from cokriging_tpu_torch.predict.iterative import IterativeJointPredictor
    from cokriging_tpu_torch.predict.local import LocalPredictor

    name = np.dtype(dtype).name
    td = getattr(torch, name)
    atol, tol = (5e-6, 1e-5) if name == "float32" else (1e-12, 1e-12)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    c1, z1, c2, z2 = large_n_month(dtype)
    mf = geo_fields(((c1, z1, "XCO2"), (c2, z2, "SIF")))
    spec = ParamSpec(n_procs=2)
    init = MaternParams.default(2, spec).with_flat(torch.tensor(LARGE_INIT, dtype=torch.float64))

    # the fit, as the example runs it ("auto": coarse order, kd-tree neighbors)
    (params, info), fit_s = timed(lambda: fit_vecchia(
        mf, init=init, m=VECCHIA_M, maxiter=VECCHIA_MAXITER, main=False, chunk=VECCHIA_CHUNK))
    x = params.to_flat().cpu().numpy().astype(np.float64)
    lo, hi = spec.bounds()
    start = info["nll_trace"][0]
    log(f"(g) {name}: Vecchia fit (2 x {N_LARGE}, m = {VECCHIA_M}, maxiter {VECCHIA_MAXITER}): "
        f"seconds {fit_s}, evaluations {info['n_obj_evals']}, iterations {info['n_iter']}, "
        f"success {info['success']}, nll {start} -> {info['nll']}, params "
        f"{np.array2string(x, precision=5)}")
    check(params.sigma.dtype == td, f"(g) {name}: fitted params in {params.sigma.dtype}")
    check(bool(np.all((x >= lo - 1e-6 * (hi - lo)) & (x <= hi + 1e-6 * (hi - lo)))),
          f"(g) {name}: Vecchia fit out of bounds")
    check(info["nll"] < start, f"(g) {name}: the fit did not improve on its start")
    check(float(params.rho[0, 1]) < 0.0, f"(g) {name}: fitted rho {float(params.rho[0, 1])} >= 0")

    # Vecchia value + gradient at the fitted point: the least of three after
    # a warm-up, the launch counts of the first timed one
    lik, scaffold_s = timed(lambda: VecchiaLikelihood(
        [c1, c2], [z1, z2], m=VECCHIA_M, geodesic=True, chunk=VECCHIA_CHUNK))
    n_chunks = math.ceil(lik.n / VECCHIA_CHUNK)
    xf = params.to_flat().detach()

    def evaluate():
        return vecchia_nll_value_and_grad(xf, lik._win, spec, True, VECCHIA_CHUNK)

    with captured("matern_corr_pairs") as fwd_calls, captured("matern_corr_pairs_grad", 1) as grad_calls:
        evaluate()
    K.reset_launch_counts()
    (v, g), s0 = timed(evaluate)
    launches = K.launch_counts()
    secs = [s0] + [timed(evaluate)[1] for _ in range(2)]
    log(f"(g) {name}: scaffold ({lik.ordering} order, {lik.neighbor_method} neighbors) {scaffold_s} s; "
        f"value + gradient at the fit: value {v.item()}, seconds {secs}, evals/s {1.0 / min(secs)}; "
        f"launches {launches}, chunks {n_chunks}")
    check(launches["matern_corr_pairs"] == n_chunks and launches["matern_corr_pairs_grad"] == n_chunks,
          f"(g) {name}: expected {n_chunks} pairs launches each, got {launches}")
    check(np.isfinite(v.item()) and bool(torch.isfinite(g).all()), f"(g) {name}: value {v}, gradient {g}")

    # both pairs kernels against their plain versions at the path's shapes
    nus_t, lss_t = fwd_calls[0][0], fwd_calls[0][1]
    nus, lss = nus_t.tolist(), lss_t.tolist()
    chunks = [(a[3], a[2]) for a in fwd_calls]
    n_entries = sum(h.numel() for h, _ in chunks)
    check(n_entries == lik.n * (VECCHIA_M + 1) * (VECCHIA_M + 2) // 2, "(g) window set size")
    f_err, f_ms, f_plain = pairs_forward_check(fwd_calls, atol, f"the {name} window set")
    r_real, e_real, _, _ = pairs_grad_check(grad_calls, tol, f"one {name} chunk, its cotangent")
    gen = torch.Generator(device="cuda").manual_seed(7)
    grad_table = grad_calls[0][5:]  # the path's gradient table, where it passed one
    rand_calls = [a[:4] + (torch.randn(a[3].shape, dtype=td, device="cuda", generator=gen),)
                  + grad_table for a in fwd_calls]
    r_rand, e_rand, g_ms, g_plain = pairs_grad_check(rand_calls, tol, f"the {name} window set", 2)
    log(f"(g) {name}: pairs at the window set ({len(fwd_calls)} launches, {n_entries} entries, "
        f"pairs nu {np.round(nus, 4).tolist()}, ls {np.round(lss, 2).tolist()}): forward max abs err "
        f"{f_err:.3e} (bar {atol}), {f_ms:.3f} ms, plain {f_plain:.1f} ms; gradient |kernel - plain| / "
        f"sum|terms| {r_real:.3e} at one chunk's own cotangent, {r_rand:.3e} at a random one (bar {tol}), "
        f"{g_ms:.3f} ms, plain {g_plain:.1f} ms")
    # the same work in one launch each, with the path's tables: the wrappers'
    # host work once instead of per chunk
    h_all, i_all = (torch.cat([a[k].reshape(-1) for a in fwd_calls]) for k in (3, 2))
    c_all = torch.cat([a[4].reshape(-1) for a in rand_calls])
    f_tab = fwd_calls[0][4] if len(fwd_calls[0]) > 4 else None
    g_tab = grad_table[0] if grad_table else None
    one_f = cuda_time_ms(lambda: K.matern_corr_pairs(nus_t, lss_t, i_all, h_all, table=f_tab), 3)
    one_g = cuda_time_ms(lambda: K.matern_corr_pairs_grad(nus_t, lss_t, i_all, h_all, c_all,
                                                          table=g_tab), 3)
    log(f"(g) {name}: the window set in one launch each, with the path's tables: forward {one_f:.3f} ms, "
        f"gradient {one_g:.3f} ms")
    del h_all, i_all, c_all
    shape = f"{n_chunks} launches, {lik.n} windows x {n_entries // lik.n} entries"
    fb, gb = bound_of([pairs_bound(chunks, nus, lss)]), bound_of([pairs_bound(chunks, nus, lss, True)])
    rows = [
        dict(name=f"matern_corr_pairs_{name}_vecchia", route="cuda",
             source="cokriging_tpu_torch/kernels/csrc/matern_pairs.cu",
             replaces="cokriging_tpu/kernels/pallas_ops.py:631", launches=launches["matern_corr_pairs"],
             ms=f_ms, plain_ms=f_plain, bound_ms=fb[0], bound_by=fb[1], library_ms=None,
             max_abs_err=f_err, max_err=f_err, path="(g) Vecchia value + gradient", shape=shape,
             one_launch_ms=one_f),
        dict(name=f"matern_corr_pairs_grad_{name}_vecchia", route="cuda",
             source="cokriging_tpu_torch/kernels/csrc/matern_pairs.cu",
             replaces="cokriging_tpu/kernels/pallas_ops.py:767",
             launches=launches["matern_corr_pairs_grad"], ms=g_ms, plain_ms=g_plain, bound_ms=gb[0],
             bound_by=gb[1], library_ms=None, max_abs_err=max(e_real, e_rand),
             max_err=max(r_real, r_rand), path="(g) Vecchia value + gradient", shape=shape,
             one_launch_ms=one_g),
    ]
    del fwd_calls, grad_calls, rand_calls, chunks, lik
    torch.cuda.empty_cache()

    # the validity projection, then direct local prediction of process 1
    proj = project_to_valid(params, parsimony=True).astype(td)
    log(f"(g) {name}: projected rho {float(params.rho[0, 1])} -> {float(proj.rho[0, 1])} "
        f"(bound {float(params_rho_max(proj, 0, 1))}), params "
        f"{np.array2string(proj.to_flat().cpu().numpy().astype(np.float64), precision=5)}")
    mod = MultivariateMatern(params=proj)
    glat = np.linspace(25.0, 49.0, 63)
    glon = np.linspace(-123.0, -68.0, 63)
    gg = np.stack(np.meshgrid(glat, glon), -1).reshape(-1, 2).astype(dtype)
    lp = LocalPredictor(mod, mf, materialize_cov=False)
    K.reset_launch_counts()
    with captured("matern_corr_pairs", 1) as local_calls, warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out, local_s = timed(lambda: lp(1, gg, max_dist=120.0))
    local_launches = K.launch_counts()["matern_corr_pairs"]
    finite = float(np.isfinite(out.pred).mean())
    log(f"(g) {name}: direct local prediction, {len(gg)} cells, 120 km: seconds {local_s}, finite "
        f"{finite:.4%}, mean neighborhood {float(out.n_neighbors.mean())}, launches {local_launches}, "
        f"warnings {[str(w.message)[:70] for w in caught]}")
    check(finite > 0.95, f"(g) {name}: only {finite:.2%} finite direct local predictions")
    check(local_launches > 0, f"(g) {name}: direct local prediction launched no pairs kernel")
    l_err, l_ms, l_plain = pairs_forward_check(local_calls, atol, f"one {name} direct-local batch")
    lb = bound_of([pairs_bound([(local_calls[0][3], local_calls[0][2])], local_calls[0][0].tolist(),
                               local_calls[0][1].tolist())])
    rows.append(dict(
        name=f"matern_corr_pairs_{name}_local", route="cuda",
        source="cokriging_tpu_torch/kernels/csrc/matern_pairs.cu",
        replaces="cokriging_tpu/kernels/pallas_ops.py:631", launches=local_launches, ms=l_ms,
        plain_ms=l_plain, bound_ms=lb[0], bound_by=lb[1], library_ms=None, max_abs_err=l_err,
        max_err=l_err, path="(g) direct local prediction",
        shape=f"one batch {tuple(local_calls[0][3].shape)}"))
    log(f"(g) {name}: pairs at one direct-local batch {tuple(local_calls[0][3].shape)}: max abs err "
        f"{l_err:.3e}, {l_ms:.3f} ms, plain {l_plain:.1f} ms")
    del local_calls, lp
    torch.cuda.empty_cache()

    # matrix-free joint prediction on the first 2 x 12,500 observations
    sub = geo_fields(((c1[:N_CG], z1[:N_CG], "XCO2"), (c2[:N_CG], z2[:N_CG], "SIF")))
    ijp = IterativeJointPredictor(mod, sub, block=512, rhs_batch=256, tol=1e-3, maxiter=40)
    K.reset_launch_counts()
    with captured("matern_corr_pairs", 1) as cg_calls, warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        jout, cg_s = timed(lambda: ijp(1, gg[:256]))
    cg_launches = K.launch_counts()["matern_corr_pairs"]
    log(f"(g) {name}: CG joint prediction, 2 x {N_CG} points, 256 cells: seconds {cg_s}, "
        f"(iterations, relative residual) per solve {ijp.last_diagnostics}, launches {cg_launches}, "
        f"finite {float(np.isfinite(jout.pred).mean()):.4%}, warnings {[str(w.message)[:70] for w in caught]}")
    check(bool(np.isfinite(jout.pred).all()), f"(g) {name}: CG predictions not all finite")
    c_err, c_ms, c_plain = pairs_forward_check(cg_calls, atol, f"one {name} CG row tile")
    cg_sync_free(ijp, cg_calls[0], name)
    cb = bound_of([pairs_bound([(cg_calls[0][3], cg_calls[0][2])], cg_calls[0][0].tolist(),
                               cg_calls[0][1].tolist())])
    rows.append(dict(
        name=f"matern_corr_pairs_{name}_cg", route="cuda",
        source="cokriging_tpu_torch/kernels/csrc/matern_pairs.cu",
        replaces="cokriging_tpu/kernels/pallas_ops.py:631", launches=cg_launches, ms=c_ms,
        plain_ms=c_plain, bound_ms=cb[0], bound_by=cb[1], library_ms=None, max_abs_err=c_err,
        max_err=c_err, path="(g) CG joint prediction", shape=f"one row tile {tuple(cg_calls[0][3].shape)}"))
    log(f"(g) {name}: pairs at one CG row tile {tuple(cg_calls[0][3].shape)}: max abs err {c_err:.3e}, "
        f"{c_ms:.3f} ms, plain {c_plain:.1f} ms")
    del cg_calls, ijp
    torch.cuda.empty_cache()
    return rows


# --- phase (h): the table-to-map workflow ---------------------------------

H_TIMES = ("2019-01-01", "2019-02-01", "2019-03-01")
H_TIMESTAMP = "2019-02-01"
H_TREND = 0.25  # the linear time trend added per month
H_MAX_DIST = 1500.0  # variogram range cutoff, km (the CLI's default)
H_FIT_MAXITER = 200  # the CLI's default
# LOOCV at all 12,500 data of a field: the radius whose neighborhoods hold as
# many data (~45 per process) as (d)'s 1000 km does on its ~202-point
# prediction fields; at 1000 km every one of the 12,500 systems would hold
# ~5,400 data
H_LOOCV_KM = 130.0
H_SMALL = 2_500  # per process: the joint and CG LOOCV's rows
CLI_TIMES = ("2018-04-01", "2018-05-01", "2018-06-01")


def month_frames(n=N_PER_PROC, seed=11):
    """Three months of bench.py's synthetic CONUS month as two long-format
    frames [time, lat, lon, <name>, <name>_var]: the month's locations (seed
    0), fresh noise each month (``seed``), a linear time trend."""
    import pandas as pd

    rng = np.random.default_rng(0)
    c1, s1 = synthetic_month(rng, n)
    c2, s2 = synthetic_month(rng, n)
    nrng = np.random.default_rng(seed)
    frames = []
    for name, c, s, scale in (("xco2", c1, s1, 1.0), ("sif", c2, s2, -0.6)):
        frames.append(pd.concat([
            pd.DataFrame({"time": pd.Timestamp(t), "lat": c[:, 0], "lon": c[:, 1],
                          name: scale * s + nrng.normal(scale=0.4, size=n) + H_TREND * k,
                          f"{name}_var": 0.01})
            for k, t in enumerate(H_TIMES)], ignore_index=True))
    return frames, c1, c2


def head_field(f, n):
    """The first ``n`` rows of a field whose rows are all main."""
    import dataclasses

    mv = f.measurement_var
    return dataclasses.replace(
        f, coords=f.coords[:n], values=f.values[:n], coords_main=f.coords_main[:n],
        values_main=f.values_main[:n], measurement_var=None if mv is None else mv[:n],
        spatial_trend=f.spatial_trend[:n], spatial_trend_main=f.spatial_trend_main[:n])


def check_back_transform(frame, raw_pred, raw_err, trend, surface, what, rtol):
    """A postprocessed frame against its standardized values back-transformed
    in float64 numpy with the field's TrendStats (``surface``: the OLS trend
    at the frame's rows)."""
    pred = raw_pred.astype(np.float64) * trend.scale_fact + trend.spatial_mean + surface \
        + trend.temporal_trend
    err = raw_err.astype(np.float64) * trend.scale_fact
    ok = np.isfinite(pred)
    check(np.array_equal(ok, np.isfinite(frame["pred"].to_numpy())), f"(h) {what}: NaN lanes moved")
    gap = float(np.max(np.abs(frame["pred"].to_numpy()[ok] - pred[ok]) / np.abs(pred[ok]).clip(1.0)))
    gap_e = float(np.max(np.abs(frame["pred_err"].to_numpy()[ok] - err[ok])))
    check(gap <= rtol and gap_e <= rtol * trend.scale_fact,
          f"(h) {what}: back-transform off by {gap:.3e} / {gap_e:.3e} (bar {rtol})")
    return gap


def phase_h(dtype, results):
    """The table-to-map workflow at the size of bench.py's month in one
    dtype; returns its rows of the kernels line."""
    import warnings

    import torch

    from cokriging_tpu_torch.cov.matern import MultivariateMatern
    from cokriging_tpu_torch.cov.spectral import params_rho_max
    from cokriging_tpu_torch.data.grids import prediction_coords
    from cokriging_tpu_torch.estimate.empirical import VarioConfig, empirical_variograms
    from cokriging_tpu_torch.estimate.wls import cauchy_schwarz_check, fit_wls, moment_init
    from cokriging_tpu_torch.fields.field import MultiField
    from cokriging_tpu_torch.kernels import cuda_ops as K
    from cokriging_tpu_torch.predict import IterativeJointPredictor, JointPredictor, LocalPredictor

    name = np.dtype(dtype).name
    td = getattr(torch, name)
    atol = 5e-6 if name == "float32" else 1e-12
    back_rtol = 1e-6 if name == "float32" else 1e-12
    stages, launches = {}, {}

    def stage(key, fn, kernels=()):
        """``fn`` with the launch counts set to 0 just before and read just
        after, timed on the host clock around a synchronize; every kernel
        named must have run."""
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
        torch.cuda.synchronize()
        stages[key] = time.perf_counter() - t0
        launches[key] = {k: v for k, v in K.launch_counts().items() if v}
        for w in caught:
            log(f"(h) {name} {key}: warning: {str(w.message)[:110]}")
        for k in kernels:
            check(launches[key].get(k, 0) > 0, f"(h) {name} {key}: no {k} launch: {launches[key]}")
        return out

    # 1-2. the frames and the fields: all 12,500 rows of each field main
    (frames, c1, c2), frames_s = timed_host(lambda: month_frames(N_PER_PROC))
    args = (frames, ["xco2", "sif"], [["lon", "lat"]] * 2, H_TIMESTAMP, [0, -1])
    mf64, fields_s = timed_host(lambda: MultiField.from_dataframes(*args, main_coords=None))
    mf = mf64.astype(td)
    log(f"(h) {name}: frames 2 x 3 months x {N_PER_PROC} rows in {frames_s:.3f} s, fields "
        f"(trend removal, OLS, standardization) in {fields_s:.3f} s: timestamps "
        f"{[f.timestamp for f in mf.fields]}, main rows {[f.coords_main.shape[0] for f in mf.fields]}, "
        f"temporal trends {[round(f.trend.temporal_trend, 6) for f in mf.fields]}")
    check([f.timestamp for f in mf.fields] == ["2019-02-01", "2019-01-01"], "(h) timedeltas")

    # 3. variograms: one launch per pass
    est = stage("variograms", lambda: empirical_variograms(
        mf, VarioConfig(max_dist=H_MAX_DIST, n_bins=15)), ("variogram_minmax", "variogram_bin"))
    check(launches["variograms"].get("variogram_minmax") == 1
          and launches["variograms"].get("variogram_bin") == 1,
          f"(h) {name}: variogram launches {launches['variograms']}, not 1 + 1")
    check(est.timestamp == H_TIMESTAMP and est.timedeltas == [0, -1], "(h) estimate metadata")

    # 4. the fit, as the CLI runs it: scipy L-BFGS-B from the moment
    # initializer, projected onto the validity region
    params, result = stage("fit", lambda: fit_wls(
        est, init=moment_init(est), maxiter=H_FIT_MAXITER, project_validity=True))
    x = params.to_flat().cpu().numpy().astype(np.float64)
    lo, hi = params.spec.bounds()
    tol = 1e-6 * (hi - lo)
    cs_ok = cauchy_schwarz_check(params)
    rho, bound = abs(float(params.rho[0, 1])), 0.99 * float(params_rho_max(params, 0, 1))
    results[f"h_cs_{name}"] = cs_ok
    log(f"(h) {name}: fit cost {result.cost:.6g}, iterations {result.n_iter}, success "
        f"{result.success}, params {np.array2string(x, precision=5)}, |rho| {rho:.6g} within the "
        f"projection's bound {bound:.6g}, Cauchy-Schwarz {cs_ok}")
    check(params.sigma.dtype == td, f"(h) {name}: fitted params in {params.sigma.dtype}")
    check(bool(np.all((x >= lo - tol) & (x <= hi + tol))), f"(h) {name}: params out of bounds")
    check(rho <= bound * (1 + 1e-6), f"(h) {name}: |rho| {rho} above the projection's bound {bound}")
    check(float(params.nu[0, 1]) >= 0.5 * float(params.nu[0, 0] + params.nu[1, 1]) * (1 - 1e-6),
          f"(h) {name}: cross smoothness below the Gneiting floor after the projection")
    if not cs_ok:
        # this month's fit sits on the box (nu 0.2 / 3.5 / 0.2, ls_22 100 km),
        # where the spectral bound of cov.spectral.rho_max admits a rho that
        # fails Cauchy-Schwarz: the JAX package returns the same projected
        # parameters and the same verdict (tests/test_torch_wls_validity.py)
        log(f"(h) {name}: the projected fit fails the Cauchy-Schwarz check, as the JAX package's "
            f"does on this month")
    mod = MultivariateMatern(params=params)

    # 5. prediction at the land cells on the data scale, from the fields on
    # (d)'s prediction grid of ~202 data each (every 62nd observation)
    sub = max(1, N_PER_PROC // 200)
    main = np.concatenate([c1[::sub], c2[::sub]])
    mf_pred = MultiField.from_dataframes(*args, main_coords=main).astype(td)
    pc = prediction_coords().astype(dtype)

    def predict():
        lp = LocalPredictor(mod, mf_pred)
        return lp, lp(0, pc, postprocess=True)

    lp, frame = stage("predict", predict, ("matern_correlation",))
    raw = lp(0, pc)
    trend = mf_pred.fields[0].trend
    finite = float(np.isfinite(frame["pred"].to_numpy()).mean())
    gap = check_back_transform(frame, raw.pred, raw.pred_err, trend,
                               trend.predict_ols(pc[:, ::-1].astype(np.float64)), "predict",
                               back_rtol)
    results[f"h_finite_predict_{name}"] = finite
    log(f"(h) {name}: predict at {len(pc)} cells from {[f.coords_main.shape[0] for f in mf_pred.fields]} "
        f"main data, 1000 km: finite {finite:.4%}, back-transform max rel gap {gap:.3e}, pred range "
        f"[{np.nanmin(frame['pred']):.4f}, {np.nanmax(frame['pred']):.4f}]")
    check(finite > 0.99, f"(h) {name}: only {finite:.2%} finite predictions after the projection")

    # 6. local LOOCV at all 12,500 data of process 0
    def local_cv():
        lp_cv = LocalPredictor(mod, mf)
        return lp_cv, lp_cv.cross_validation(0, max_dist=H_LOOCV_KM, postprocess=True)

    with captured("matern_correlation_block") as m_calls:
        lp_cv, cv = stage("local_loocv", local_cv, ("matern_correlation",))
    cv_raw = lp_cv.cross_validation(0, max_dist=H_LOOCV_KM)
    f0 = mf.fields[0]
    finite_cv = float(np.isfinite(cv["pred"].to_numpy()).mean())
    check(np.array_equal(cv["residual"].to_numpy(), (cv["data"] - cv["pred"]).to_numpy(),
                         equal_nan=True),
          f"(h) {name}: local LOOCV residual is not data - pred")
    gap_cv = check_back_transform(cv, cv_raw.pred, cv_raw.pred_err, f0.trend,
                                  f0.spatial_trend_main, "local LOOCV", back_rtol)
    feb = frames[0][frames[0]["time"] == H_TIMESTAMP]["xco2"].to_numpy()
    data_gap = float(np.max(np.abs(cv["data"].to_numpy() - feb)))
    check(data_gap <= (1e-5 if name == "float32" else 1e-12) * float(np.abs(feb).max()),
          f"(h) {name}: the LOOCV data column is not the frame's data ({data_gap:.3e})")
    results[f"h_finite_loocv_{name}"] = finite_cv
    log(f"(h) {name}: local LOOCV at {len(cv)} data, {H_LOOCV_KM:g} km: finite {finite_cv:.4%}, "
        f"mean neighborhood {float(cv_raw.n_neighbors.mean()):.1f}, MSPE "
        f"{float(np.nanmean(cv['residual'] ** 2)):.6g}, back-transform gap {gap_cv:.3e}, data "
        f"column vs the frame {data_gap:.3e}")
    check(finite_cv > 0.99, f"(h) {name}: only {finite_cv:.2%} finite LOOCV predictions")
    del lp_cv, cv_raw
    torch.cuda.empty_cache()

    # 7. joint and CG LOOCV where the dense one fits and CG converges
    small = MultiField(fields=[head_field(f, H_SMALL) for f in mf.fields], timestamp=mf.timestamp,
                       timedeltas=mf.timedeltas)
    mod_n = MultivariateMatern(params=params.replace(nugget=torch.full_like(params.nugget, 0.1)))
    dense = stage("joint_loocv", lambda: JointPredictor(mod_n, small).cross_validation(
        0, postprocess=True), ("matern_correlation",))
    ijp = IterativeJointPredictor(mod_n, small, block=512, rhs_batch=1024, tol=1e-10, maxiter=500)
    with captured("matern_corr_pairs", 1) as cg_calls:
        it = stage("cg_loocv", lambda: ijp.cross_validation(0, postprocess=True),
                   ("matern_corr_pairs",))
    gaps = {c: float(np.max(np.abs(it[c].to_numpy() - dense[c].to_numpy())
                            / (0.01 + np.abs(dense[c].to_numpy()))))
            for c in ("pred", "pred_err")}
    abs_gap = {c: float(np.max(np.abs(it[c].to_numpy() - dense[c].to_numpy())))
               for c in ("pred", "pred_err")}
    log(f"(h) {name}: joint vs CG LOOCV at 2 x {H_SMALL} (nugget 0.1, tol 1e-10, maxiter 500, "
        f"chunks of 1024): CG (iterations, residual) {ijp.last_diagnostics}; max abs gap {abs_gap}, "
        f"relative to |dense| + 0.01 {gaps}")
    results[f"h_cg_gap_{name}"] = abs_gap
    check(np.array_equal(it["residual"].to_numpy(), (it["data"] - it["pred"]).to_numpy(),
                         equal_nan=True),
          f"(h) {name}: CG LOOCV residual is not data - pred")
    if name == "float64":
        for c in ("pred", "pred_err"):
            check(np.allclose(it[c], dense[c], rtol=1e-6, atol=1e-8),
                  f"(h) float64: CG LOOCV {c} off the dense LOOCV by {abs_gap[c]:.3e}")

    # the path's kernels against their plain versions at its own shapes
    rows = vario_rows(*[np.ascontiguousarray(a.numpy()) for a in (
        mf.fields[0].coords, mf.fields[0].values, mf.fields[1].coords, mf.fields[1].values)],
        dtype, launches["variograms"], f"(h) 3 pairs x {N_PER_PROC} points x 15 bins, 1500 km",
        20, 3, max_dist=H_MAX_DIST, suffix="_h")
    for r in rows:
        r.update(launches=launches["variograms"][r["name"].rsplit("_", 2)[0]],
                 path="(h) variograms of the fields")
    # block by block: the plain version's temporaries of three 12,500^2
    # blocks at once do not fit beside the kept outputs in float64
    rows.append(matern_row(
        f"matern_correlation_{name}_h", launches["local_loocv"].get("matern_correlation", 0),
        "(h) local LOOCV joint covariance",
        f"{N_PER_PROC}^2 sym + {N_PER_PROC}^2 + {N_PER_PROC}^2 sym at the fitted nu, ls",
        matern_calls_check(m_calls, atol, f"(h) {name}: Matern blocks of the LOOCV covariance")))
    del m_calls, lp
    torch.cuda.empty_cache()
    c_err, c_ms, c_plain = pairs_forward_check(cg_calls, atol, f"one {name} (h) CG LOOCV row tile")
    cb = bound_of([pairs_bound([(cg_calls[0][3], cg_calls[0][2])], cg_calls[0][0].tolist(),
                               cg_calls[0][1].tolist())])
    rows.append(dict(
        name=f"matern_corr_pairs_{name}_h_cg", route="cuda",
        source="cokriging_tpu_torch/kernels/csrc/matern_pairs.cu",
        replaces="cokriging_tpu/kernels/pallas_ops.py:631",
        launches=launches["cg_loocv"].get("matern_corr_pairs", 0), ms=c_ms, plain_ms=c_plain,
        bound_ms=cb[0], bound_by=cb[1], library_ms=None, max_abs_err=c_err, max_err=c_err,
        path="(h) CG LOOCV", shape=f"one row tile {tuple(cg_calls[0][3].shape)}"))
    del cg_calls, ijp
    torch.cuda.empty_cache()
    log(f"(h) {name}: stages (s) {json.dumps(stages)}")
    log(f"(h) {name}: launches per stage {json.dumps(launches)}")
    return rows


def timed_host(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def cli_table(name, rng, own_seed):
    """tests/test_cli.py's staged table: [time, lat, lon, <name>, <name>_var]
    on the 4 x 5-degree base grid, three months, smooth partially correlated
    signals."""
    import pandas as pd

    from cokriging_tpu_torch.data.grids import main_coords_array

    mc = main_coords_array()
    srng = np.random.default_rng(own_seed)
    base = (np.sin(np.deg2rad(mc[:, 0]) * 5) + 0.5 * np.cos(np.deg2rad(mc[:, 1]) * (3 + own_seed % 3))
            + 0.6 * srng.normal(size=len(mc)))
    return pd.concat([
        pd.DataFrame({"time": pd.Timestamp(t), "lat": mc[:, 0], "lon": mc[:, 1],
                      name: base + 0.15 * rng.normal(size=len(mc)) + 0.05 * k, f"{name}_var": 0.01})
        for k, t in enumerate(CLI_TIMES)], ignore_index=True)


def phase_h_cli():
    """``python -m cokriging_tpu_torch fit / predict / loocv --device cuda``
    on tests/test_cli.py's staged tables, held against the same commands with
    ``--device cpu`` (in this process), float64: parameters rtol 1e-6,
    predictions and LOOCV columns atol 1e-6."""
    import os
    import tempfile

    from cokriging_tpu_torch.__main__ import main as cli_main
    from cokriging_tpu_torch.utils.io import load_params, load_table, save_table

    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(6)
        paths = []
        for k, nm in enumerate(("xco2", "sif")):
            paths.append(os.path.join(tmp, f"{nm}.parquet"))
            save_table(paths[-1], cli_table(nm, rng, 600 + k))
        common = ["--data", *paths, "--timestamp", CLI_TIMES[1], "--timedeltas", "0", "0"]
        out, secs = {}, {}
        for dev in ("cuda", "cpu"):
            p = os.path.join(tmp, f"params_{dev}.npz")
            for cmd, extra in (("fit", ["--max-dist", "3000", "--n-bins", "8", "--maxiter", "60",
                                        "--project-validity", "--out", p]),
                               ("predict", ["--params", p, "--out",
                                            os.path.join(tmp, f"pred_{dev}.parquet")]),
                               ("loocv", ["--params", p, "--out",
                                          os.path.join(tmp, f"cv_{dev}.parquet")])):
                argv = [cmd, *common, *extra, "--device", dev]
                t0 = time.perf_counter()
                if dev == "cuda":
                    run = subprocess.run([sys.executable, "-m", "cokriging_tpu_torch", *argv],
                                         cwd=HERE, capture_output=True, text=True, timeout=300,
                                         env={**os.environ, "PYTHONPATH": str(HERE)})
                    check(run.returncode == 0, f"(h) CLI {cmd} --device cuda: exit "
                          f"{run.returncode}: {run.stderr[-2000:]}")
                    out[dev, cmd, "stdout"] = run.stdout
                else:
                    import contextlib as _c
                    import io as _io

                    buf = _io.StringIO()
                    with _c.redirect_stdout(buf):
                        cli_main(argv)
                    out[dev, cmd, "stdout"] = buf.getvalue()
                secs[dev, cmd] = time.perf_counter() - t0
            out[dev, "params"] = load_params(p).to_flat().numpy()
            out[dev, "pred"] = load_table(os.path.join(tmp, f"pred_{dev}.parquet"))
            out[dev, "cv"] = load_table(os.path.join(tmp, f"cv_{dev}.parquet"))
    pg, pc = out["cuda", "params"], out["cpu", "params"]
    check(np.allclose(pg, pc, rtol=1e-6, atol=0), f"(h) CLI params cuda {pg} vs cpu {pc}")
    worst = {}
    for key, cols in (("pred", ("pred", "pred_err")), ("cv", ("data", "pred", "residual", "pred_err"))):
        g, c = out["cuda", key], out["cpu", key]
        check(list(g.columns) == list(c.columns) and len(g) == len(c), f"(h) CLI {key} frames differ")
        for col in cols:
            a, b = g[col].to_numpy(), c[col].to_numpy()
            check(np.array_equal(np.isfinite(a), np.isfinite(b)), f"(h) CLI {key} {col}: NaN lanes")
            ok = np.isfinite(a)
            worst[f"{key}.{col}"] = float(np.max(np.abs(a[ok] - b[ok]))) if ok.any() else 0.0
            check(worst[f"{key}.{col}"] <= 1e-6, f"(h) CLI {key} {col}: cuda vs cpu {worst[key + '.' + col]}")
    log(f"(h) CLI fit / predict / loocv, --device cuda (subprocesses) vs --device cpu: params max rel "
        f"err {float(np.max(np.abs(pg - pc) / np.abs(pc))):.3e}, columns max abs err {worst}, "
        f"predictions {len(out['cuda', 'pred'])} cells, finite "
        f"{float(np.isfinite(out['cuda', 'pred']['pred']).mean()):.4%}; seconds "
        f"{ {f'{d} {c}': round(v, 3) for (d, c), v in secs.items()} }")
    log(f"(h) CLI loocv --device cuda printed: {out['cuda', 'loocv', 'stdout'].strip().splitlines()[-2]}")


# --- phase (i): simulation and the parametric bootstrap -----------------------

# examples/simulation_experiment.py:28 (the dense simulator's truth) and
# examples/million_point_workflow.py:73-81 (the spectral one's, on [0, 100]^2)
I_DENSE_TRUTH = [1.0, 1.0, 1.5, 1.5, 1.5, 0.2, 0.2, 0.2, 0.0, 0.0, -0.6]
I_DENSE_GRID = 51
I_SPEC_TRUTH = [1.0, 1.0, 1.5, 1.5, 1.5, 5.0, 5.0, 5.0, 0.05, 0.05, -0.6]
I_SPEC_BOUNDS = dict(sigma_bounds=(0.2, 3.0), nu_bounds=(0.4, 3.0), len_scale_bounds=(0.5, 25.0),
                     nugget_bounds=(0.0, 0.5))
I_SPEC_GRID = 1024
I_ENSEMBLE = 16
# the bootstrap (examples/uncertainty_demo.py:77: 200 replicates, maxiter
# 200; cut to maxiter 100 for the script's time limit) at bench.py's n on
# the spectral field's sample; the variograms to 30 (six length scales of
# the truth's 5) in 15 bins
I_N = N_PER_PROC
I_REP = 200
I_MAXITER = 100
I_MAX_DIST = 30.0
I_CHECK_REP = 8  # replicates held against the plain batched pass
# replicates refit alone against their batched refits, per dtype: each such
# refit is a host-bound run of ~200 iterations (~20 s f64 on the card alone),
# so they run side by side in worker processes
I_SINGLE_REP = 2
I_REFIT_WORKERS = 4
# the float32 repeat of the batched pass and refit: the first 50 replicates
I_REP_F32 = 50
I_FIT_MAXITER = 60  # the WLS fit before the bootstrap (tests/test_cli.py's)
I_COND_N = 2_500  # per process: the conditional simulation's data
I_COND_STEP = 32  # every 32nd grid line: a 32 x 32 sub-grid
I_COND_SAMPLES = 100


def i_stage(name, stages, launches, key, fn, kernels=()):
    """``fn`` with the launch counts set to 0 just before and read just
    after, timed on the host clock around a synchronize; every kernel named
    must have run."""
    import warnings

    import torch

    from cokriging_tpu_torch.kernels import cuda_ops as K

    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn()
    torch.cuda.synchronize()
    stages[key] = time.perf_counter() - t0
    launches[key] = {k: v for k, v in K.launch_counts().items() if v}
    for w in caught:
        log(f"(i) {name} {key}: warning: {str(w.message)[:110]}")
    for k in kernels:
        check(launches[key].get(k, 0) > 0, f"(i) {name} {key}: no {k} launch: {launches[key]}")
    return out


def matern_calls_check(calls, atol, what, reps=2):
    """The Matern kernel against its plain version at a path's own launches
    (``calls``: the argument tuples ``captured`` kept), one at a time, every
    output finite; ``what`` names them in a failure. Returns (max abs error,
    kernel ms, plain ms, bound ms, bound by)."""
    import torch

    from cokriging_tpu_torch.kernels import cuda_ops as K

    def sym_of(a):  # block_covariance passes symmetric= and table=, covariance_block table=
        return a[3] if len(a) > 4 else False

    ms = plain_ms = err = 0.0
    for a in calls:
        kept = {}
        sym, table = sym_of(a), (a[-1] if len(a) > 3 else None)
        ms += cuda_time_ms(keep(kept, "kernel", lambda: K.matern_correlation_block(
            *a[:3], symmetric=sym, table=table)), reps)
        plain_ms += cuda_time_ms(keep(kept, "plain", lambda: K.matern_correlation_block_plain(
            *a[:3], symmetric=sym)), 1, warm=False)
        err = max(err, float((kept["kernel"] - kept["plain"]).abs().max()))
        check(bool(torch.isfinite(kept["kernel"]).all()), f"{what}: not finite")
        del kept
        torch.cuda.empty_cache()
    check(err <= atol, f"{what}: err {err} (bar {atol})")
    b = bound_of([matern_bound(a[2], float(a[0]), float(a[1]), sym_of(a)) for a in calls])
    return err, ms, plain_ms, b[0], b[1]


def matern_row(name, launches, what, shape, check_out):
    err, ms, plain_ms, bound_ms, bound_by = check_out
    return dict(name=name, route="cuda", source="cokriging_tpu_torch/kernels/csrc/matern.cu",
                replaces="cokriging_tpu/kernels/pallas_ops.py:782", launches=launches, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                max_abs_err=err, max_err=err, path=what, shape=shape)


def phase_i_dense(stages, launches, rows):
    """1. The dense cofield at the simulation experiment's size, float64."""
    import torch

    from cokriging_tpu_torch.cov.matern import MultivariateMatern
    from cokriging_tpu_torch.cov.params import MaternParams
    from cokriging_tpu_torch.kernels import cuda_ops as K
    from cokriging_tpu_torch.sim import BivariateRandomField, CartesianGrid

    mod = MultivariateMatern(params=MaternParams.from_flat(torch.tensor(I_DENSE_TRUTH)))
    grid = CartesianGrid(xcount=I_DENSE_GRID, ycount=I_DENSE_GRID, device="cuda")
    with captured("matern_correlation_block") as calls:
        rf = i_stage("dense", stages, launches, "dense_cofield",
                     lambda: BivariateRandomField(mod, grid, seed=42), ("matern_correlation",))
    n2 = 2 * grid.count
    check(rf.cmat.shape == (n2, n2) and rf.cmat.dtype == torch.float64, "(i) dense covariance shape")
    resid = float(torch.linalg.matrix_norm(rf.chol_lower @ rf.chol_lower.T - rf.cmat)
                  / torch.linalg.matrix_norm(rf.cmat))
    check(resid < 1e-12, f"(i) dense: |L L^T - C|_F / |C|_F = {resid}")
    # the covariance against its plain assembly, block by block
    p = mod.params.to(device="cuda")
    d = grid.dist
    plain = {}
    for i, j in ((0, 0), (0, 1), (1, 1)):
        m = K.matern_correlation_block_plain(p.nu[i, j], p.len_scale[i, j], d)
        if i == j:
            plain[i, j] = p.sigma[i] ** 2 * m + torch.where(d == 0.0, p.nugget[i], 0.0)
        else:
            plain[i, j] = p.rho[i, j] * p.sigma[i] * p.sigma[j] * m
    n = grid.count
    cov_err = max(float((rf.cmat[i * n:(i + 1) * n, j * n:(j + 1) * n] - plain[i, j]).abs().max())
                  for i, j in plain)
    del plain
    check(cov_err <= 1e-12, f"(i) dense covariance against the plain version: {cov_err}")
    samples = rf.sample(size=100, epsilon=[0.1, 0.1], seed=7)
    # the semi-colocated indices: numpy's draw, index for index
    rng = np.random.default_rng(7)
    rows_np = rng.choice(grid.count, size=150, replace=False)
    want = [np.concatenate([rows_np[:50], rows_np[50:100]]),
            np.concatenate([rows_np[:50], rows_np[100:150]])]
    for k, s in enumerate(samples):
        check(np.array_equal(s[["x", "y"]].values, grid.coords.values[want[k]]),
              f"(i) dense sample {k}: indices differ from numpy's draw")
    log(f"(i) dense cofield {I_DENSE_GRID} x {I_DENSE_GRID}, seed 42, float64: covariance "
        f"{n2}^2, max abs err against the plain version {cov_err:.3e}, |L L^T - C|_F/|C|_F "
        f"{resid:.3e}; sample(100, eps 0.1, seed 7) indices equal numpy's; field sd "
        f"{[round(float(f['value'].std()), 4) for f in rf.fields]}")
    rows.append(matern_row("matern_correlation_float64_i_dense",
                           launches["dense_cofield"].get("matern_correlation", 0),
                           "(i) dense cofield covariance",
                           f"{n} ^2 sym + {n}^2 + {n}^2 sym (the {n2}^2 covariance)",
                           matern_calls_check(calls, 1e-12, "(i) Matern at the dense covariance")))
    del rf, calls
    torch.cuda.empty_cache()


def phase_i_spectral(stages, launches, rows):
    """2. The spectral cofield at the million-point workflow's size, and its
    sample of bench.py's n; returns (model, spec, samples)."""
    import torch

    from cokriging_tpu_torch.cov.matern import MultivariateMatern, covariance_block
    from cokriging_tpu_torch.cov.params import MaternParams, ParamSpec
    from cokriging_tpu_torch.sim import CartesianGrid, SpectralRandomField

    spec = ParamSpec(2, **I_SPEC_BOUNDS)
    mod = MultivariateMatern(params=MaternParams.from_flat(torch.tensor(I_SPEC_TRUTH), spec=spec))
    grid = CartesianGrid(xbounds=(0, 100), ybounds=(0, 100), xcount=I_SPEC_GRID,
                         ycount=I_SPEC_GRID, device="cuda")
    with captured("matern_correlation_block") as calls:
        rf = i_stage("spectral", stages, launches, "spectral_build",
                     lambda: SpectralRandomField(mod, grid, seed=11), ("matern_correlation",))
    clip_tol = 1e-6
    check(rf.min_rel_eig >= -clip_tol, f"(i) spectral: min_rel_eig {rf.min_rel_eig}")
    p = mod.params.to(device="cuda")
    h = calls[-1][2]  # the final torus's lag grid
    emb_err = 0.0
    for i, j in ((0, 0), (0, 1), (1, 1)):
        block = covariance_block(p, i, j, h)
        emb_err = max(emb_err, float((rf.embedded_covariance(i, j) - block).abs().max()))
        del block
    sill = max(float(p.sigma[i] ** 2 + p.nugget[i]) for i in range(2))
    check(emb_err <= 1e-10 * sill, f"(i) spectral: embedded covariance off the model by {emb_err}")
    ens = i_stage("spectral", stages, launches, "sample_ensemble",
                  lambda: rf.sample_ensemble(I_ENSEMBLE, seed=5))
    check(tuple(ens.shape) == (I_ENSEMBLE, 2, I_SPEC_GRID, I_SPEC_GRID)
          and bool(torch.isfinite(ens).all()), "(i) spectral ensemble shape / finite")
    var = [float(ens[:, k].var()) for k in range(2)]
    del ens
    samples = i_stage("spectral", stages, launches, "sample",
                      lambda: rf.sample(size=I_N, seed=7))
    log(f"(i) spectral cofield {I_SPEC_GRID} x {I_SPEC_GRID} on [0, 100]^2, seed 11: torus "
        f"{rf._mx} x {rf._my}, min_rel_eig {rf.min_rel_eig:.3e} (clip_tol {clip_tol}), embedded "
        f"covariance against the model's lag-grid blocks {emb_err:.3e} (sill {sill}); ensemble of "
        f"{I_ENSEMBLE} variances {[round(v, 4) for v in var]}; sample 2 x {I_N}")
    rows.append(matern_row("matern_correlation_float64_i_spectral",
                           launches["spectral_build"].get("matern_correlation", 0),
                           "(i) spectral cofield lag-grid blocks",
                           f"3 x {rf._mx} x {rf._my} full", matern_calls_check(
                               calls, 1e-12, "(i) Matern at the spectral lag grid", reps=3)))
    del rf, calls
    torch.cuda.empty_cache()
    return mod, spec, samples


def vario_batch_bound(n_pairs, n_valid, k_cmp, n_rep, dtype_name):
    """(bound ms, "operations") of the batched bin pass: h, the row < col
    and h_max tests once per pair, the lookup and its compares once per
    binned pair, the cloud and the add per binned pair and replicate."""
    ops = n_pairs * VARIO_PAIR_OPS + sum(
        v * (VARIO_LOOKUP_OPS + VARIO_COMPARE_OPS * k + VARIO_BIN_OPS * n_rep)
        for v, k in zip(n_valid, k_cmp))
    return ops / (PEAK_OPS_PER_S[dtype_name] / 1e3), "operations"


def batch_pass_rows(coords, values, cfg, calls, launches, dtype, n_rep):
    """The bootstrap's batched bin launch (``calls``: its arguments, kept by
    ``captured``) against B single-replicate launches of the existing pass
    (the yardstick), its plain version on ``I_CHECK_REP`` replicates and on
    all ``n_rep`` (the launch's own output), and its timing; returns the
    kernels line's row."""
    import torch

    from cokriging_tpu_torch.kernels import cuda_ops as K

    name = np.dtype(dtype).name
    rtol = 1e-5 if name == "float32" else 1e-12
    sides, edges, geodesic, cov, h_max = calls[0]
    kept = {}
    ms = cuda_time_ms(keep(kept, "kernel", lambda: K.variogram_bin_batch(
        sides, edges, geodesic, cov, h_max)), 3)
    sums, counts = kept["kernel"]
    singles = [[(fa, fb, va[b].contiguous(), vb[b].contiguous(), m) for fa, fb, va, vb, m in sides]
               for b in range(n_rep)]
    yard = {}
    yard_ms = cuda_time_ms(keep(yard, "out", lambda: [K.variogram_bin_pairs(
        s, edges, geodesic, cov, h_max) for s in singles]), 1)
    rel = 0.0
    for b, (s1, n1) in enumerate(yard["out"]):
        check(torch.equal(n1, counts), f"(i) {name} batched counts differ from replicate {b}'s pass")
        rel = max(rel, float(((sums[:, b] - s1).abs() / s1.abs().clamp_min(1e-300)).max()))
    check(rel <= rtol, f"(i) {name} batched sums against {n_rep} single launches: {rel} (bar {rtol})")

    def against_plain(got, plain, what):
        check(torch.equal(got[1], plain[1]), f"(i) {name} batched counts differ from the plain "
              f"version {what}")
        rel_p = float(((got[0] - plain[0]).abs() / plain[0].abs().clamp_min(1e-300)).max())
        check(rel_p <= rtol, f"(i) {name} batched sums against the plain version {what}: {rel_p} "
              f"(bar {rtol})")
        return rel_p, float((got[0] - plain[0]).abs().max())

    few = [(fa, fb, va[:I_CHECK_REP].contiguous(), vb[:I_CHECK_REP].contiguous(), m)
           for fa, fb, va, vb, m in sides]
    rel8, _ = against_plain(K.variogram_bin_batch(few, edges, geodesic, cov, h_max),
                            K.variogram_bin_batch_plain(few, edges, geodesic, cov, h_max),
                            f"on {I_CHECK_REP} replicates")
    # the path's own shape: all n_rep replicates, its launch's output
    plain_ms = cuda_time_ms(keep(kept, "plain", lambda: K.variogram_bin_batch_plain(
        sides, edges, geodesic, cov, h_max)), 1, warm=False)
    rel_all, err = against_plain(kept["kernel"], kept["plain"], f"on all {n_rep} replicates")
    np_dt = np.dtype(dtype)
    k_cmp = [K._bin_record(e, True, True, np_dt)[1] for e in edges]
    n_pairs = sum(fa.shape[0] * (fa.shape[0] - 1) // 2 if m else fa.shape[0] * fb.shape[0]
                  for fa, fb, _, _, m in sides)
    n_valid = [int(c) for c in counts.sum(1)]
    bound_ms, bound_by = vario_batch_bound(n_pairs, n_valid, k_cmp, n_rep, name)
    log(f"(i) {name} batched bin pass, {n_rep} replicates x 3 variograms x {sides[0][0].shape[0]} "
        f"points x {len(edges[0]) - 1} bins: {ms:.3f} ms [the {n_rep} single-replicate launches of "
        f"the existing pass: {yard_ms:.3f} ms], plain {plain_ms:.1f} ms, bound {bound_ms:.4f} ms; "
        f"sums against the single launches max rel {rel:.3e}, against the plain version on "
        f"{I_CHECK_REP} replicates {rel8:.3e} and on all {n_rep} {rel_all:.3e} (max abs {err:.3e}); "
        f"counts exact; {n_pairs} pairs, {sum(n_valid)} binned")
    return dict(name=f"variogram_bin_batch_{name}_i", route="cuda",
                source="cokriging_tpu_torch/kernels/csrc/variogram.cu",
                replaces="cokriging_tpu/kernels/pallas_ops.py:143",
                launches=launches.get("variogram_bin_batch", 0), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None, max_abs_err=err,
                max_err=err, yardstick_ms=yard_ms, path="(i) parametric bootstrap re-estimate",
                shape=f"{n_rep} replicates x 3 pairs x {sides[0][0].shape[0]} points x "
                      f"{len(edges[0]) - 1} bins")


def refit_jobs(name, x0, arrays, pairs, spec, flats, costs, rtol):
    """Every batched refit finite and in its box; returns the jobs of the
    first ``I_SINGLE_REP`` replicates' refits alone (``refit_alone``), each
    with the batched refit it must equal."""
    lo, hi = spec.bounds()
    check(np.isfinite(flats).all() and np.isfinite(costs).all(), f"(i) {name} refits not finite")
    check(bool(np.all((flats >= lo) & (flats <= hi))), f"(i) {name} refits outside the box")
    c, m, n = (np.asarray(a) for a in arrays)
    return [dict(name=name, b=b, pairs=tuple(pairs), spec=spec, rtol=rtol, flat=flats[b],
                 cost=costs[b], args=(np.asarray(x0)[b], c[b], m[b], n[b]))
            for b in range(I_SINGLE_REP)]


def refit_alone(job):
    """One replicate refit alone, the single-instance fitter in the
    replicate's dtype on the card (run in a worker process): (x, cost)."""
    import torch

    from cokriging_tpu_torch.estimate.wls import make_device_wls_fitter

    c = job["args"][1]
    fit = make_device_wls_fitter(job["pairs"], job["spec"], I_MAXITER)
    x1, v1, _, _ = fit(*(torch.as_tensor(a, device="cuda", dtype=torch.as_tensor(c).dtype)
                         for a in job["args"]))
    return x1.cpu().numpy(), float(v1)


def refits_alone(jobs, stages):
    """The jobs' refits alone in ``I_REFIT_WORKERS`` worker processes on the
    card (each refit is host-bound: the card runs them side by side), each
    against its batched refit; returns the worst relative gap per dtype."""
    import multiprocessing

    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(I_REFIT_WORKERS) as pool:
        out = pool.map_async(refit_alone, jobs, chunksize=1).get(timeout=900)
    stages["refits_alone"] = time.perf_counter() - t0
    worst = {}
    for job, (x1, v1) in zip(jobs, out, strict=True):
        rel = float(np.max(np.abs(x1 - job["flat"]) / np.abs(job["flat"]).clip(1e-300)))
        worst[job["name"]] = max(worst.get(job["name"], 0.0), rel)
        check(rel <= job["rtol"] and abs(v1 - job["cost"]) <= job["rtol"] * abs(job["cost"]),
              f"(i) {job['name']} replicate {job['b']}: batched refit off its fit alone by {rel} "
              f"(bar {job['rtol']})")
    return worst


def phase_i_bootstrap(mod, spec, samples, stages, launches, rows):
    """3. The WLS fit and the parametric bootstrap at 2 x ``I_N``, float64,
    then the batched pass and refit once more in float32."""
    import torch

    from cokriging_tpu_torch.cov.matern import MultivariateMatern
    from cokriging_tpu_torch.estimate import bootstrap as TB
    from cokriging_tpu_torch.estimate.empirical import VarioConfig, empirical_variograms
    from cokriging_tpu_torch.estimate.wls import fit_wls, fit_wls_batch_arrays, moment_init
    from cokriging_tpu_torch.fields.field import Field, MultiField

    mf = MultiField(fields=[Field.from_arrays(s[["x", "y"]].values, s[f"Z{k}"].values, f"Z{k}")
                            for k, s in enumerate(samples)])
    cfg = VarioConfig(max_dist=I_MAX_DIST, n_bins=15, geodesic=False)
    est = i_stage("bootstrap", stages, launches, "variograms",
                  lambda: empirical_variograms(mf, cfg), ("variogram_minmax", "variogram_bin"))
    params, result = i_stage("bootstrap", stages, launches, "wls_fit", lambda: fit_wls(
        est, init=moment_init(est, spec=spec), maxiter=I_FIT_MAXITER, project_validity=True))
    x_fit = params.to_flat().cpu().numpy()
    log(f"(i) WLS fit on the spectral sample (scipy, projected): cost {result.cost:.6g}, "
        f"iterations {result.n_iter}, params {np.array2string(x_fit, precision=4)}")
    kept = {}

    def spy(name):
        orig = getattr(TB, name)

        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*a, **k)
            torch.cuda.synchronize()
            stages[f"bootstrap_{name}"] = time.perf_counter() - t0
            kept[name] = (a, out)
            return out
        return run

    orig = {k: getattr(TB, k) for k in ("simulate_replicates", "batched_variograms",
                                        "fit_wls_batch_arrays")}
    for k in orig:
        setattr(TB, k, spy(k))
    try:
        with captured("matern_correlation_block") as m_calls, \
                captured("variogram_bin_batch", module=TB) as b_calls:
            boot = i_stage("bootstrap", stages, launches, "parametric_bootstrap",
                           lambda: TB.parametric_bootstrap(MultivariateMatern(params=params), mf, cfg,
                                                           n_rep=I_REP, seed=3, maxiter=I_MAXITER),
                           ("matern_correlation", "variogram_minmax", "variogram_bin",
                            "variogram_bin_batch"))
    finally:
        for k, f in orig.items():
            setattr(TB, k, f)
    lb = launches["parametric_bootstrap"]
    # the batched pass's counts equal the reference pass's (batched_variograms
    # raises otherwise); here once more against the reference pass itself
    (coords, values_rep, _), (pairs, centers, means, counts) = kept["batched_variograms"]
    x0 = kept["fit_wls_batch_arrays"][0][0]
    arrays = kept["fit_wls_batch_arrays"][0][1:4]
    flats, costs = boot.flats, boot.costs
    rows.append(batch_pass_rows(coords, values_rep, cfg, b_calls, lb, np.float64, I_REP))
    jobs = refit_jobs("float64", x0, arrays, pairs, spec, flats, costs, 1e-8)
    summary = boot.summary()
    truth = np.asarray(I_SPEC_TRUTH)
    cover = (summary["q025"].to_numpy() <= truth) & (truth <= summary["q975"].to_numpy())
    log(f"(i) bootstrap float64: {I_REP} replicates, maxiter {I_MAXITER}: stages "
        f"{ {k: round(v, 3) for k, v in stages.items() if k.startswith('bootstrap_')} }, launches "
        f"{lb}; 95% intervals "
        f"{[(n, round(a, 4), round(b, 4)) for n, a, b in zip(summary['name'], summary['q025'], summary['q975'])]}"
        f", cover the truth on {int(cover.sum())}/11 {cover.astype(int).tolist()}")
    rows.append(matern_row("matern_correlation_float64_i_replicates",
                           lb.get("matern_correlation", 0), "(i) simulate_replicates covariance",
                           f"{I_N}^2 sym + {I_N}^2 + {I_N}^2 sym", matern_calls_check(
                               m_calls, 1e-12, "(i) Matern at the replicate covariance", reps=1)))
    del m_calls
    torch.cuda.empty_cache()

    # the batched pass and refit once more in float32 on the first
    # I_REP_F32 replicates cast
    c32 = [torch.as_tensor(c).to(torch.float32) for c in coords]
    v32 = [v[:I_REP_F32].to(torch.float32) for v in values_rep]
    with captured("variogram_bin_batch", module=TB) as b32:
        pairs32, centers32, means32, counts32 = i_stage(
            "bootstrap", stages, launches, "batched_variograms_f32",
            lambda: TB.batched_variograms(c32, v32, cfg), ("variogram_bin_batch",))
    rows.append(batch_pass_rows(c32, v32, cfg, b32, launches["batched_variograms_f32"],
                                np.float32, I_REP_F32))
    a32 = (np.tile(centers32[None], (I_REP_F32, 1, 1)), np.nan_to_num(means32, nan=0.0),
           np.tile(counts32[None], (I_REP_F32, 1, 1)).astype(np.float32))
    x0_32 = np.asarray(x0)[:I_REP_F32]
    flats32, costs32, _ = i_stage("bootstrap", stages, launches, "refit_f32",
                                  lambda: fit_wls_batch_arrays(x0_32, *a32, pairs32, spec,
                                                               maxiter=I_MAXITER))
    jobs += refit_jobs("float32", x0_32, a32, pairs32, spec, flats32, costs32, 1e-5)
    log(f"(i) bootstrap float32 (the first {I_REP_F32} replicates cast): batched pass "
        f"{stages['batched_variograms_f32']:.3f} s, refit {stages['refit_f32']:.3f} s; flats "
        f"against float64 max abs {float(np.max(np.abs(flats32 - flats[:I_REP_F32]))):.3e}")
    worst = refits_alone(jobs, stages)
    log(f"(i) {I_SINGLE_REP} replicates per dtype refit alone ({I_REFIT_WORKERS} worker "
        f"processes, {stages['refits_alone']:.1f} s), max rel gap to their batched refits "
        f"{ {k: f'{v:.3e}' for k, v in worst.items()} }")
    return params, mf


def phase_i_conditional(mod, mf, stages, launches, rows):
    """4. Conditional simulation from the first 2 x ``I_COND_N`` observations
    at the 32 x 32 sub-grid, float32 and float64."""
    import torch

    from cokriging_tpu_torch.fields.field import Field, MultiField
    from cokriging_tpu_torch.predict import JointPredictor
    from cokriging_tpu_torch.predict import joint as TJ

    small = MultiField(fields=[Field.from_arrays(f.coords[:I_COND_N], f.values[:I_COND_N], f.name)
                               for f in mf.fields])
    g = np.linspace(0.0, 100.0, I_SPEC_GRID)[::I_COND_STEP]
    cells = np.array([(x, y) for x in g for y in g])
    taken = {tuple(r) for f in small.fields for r in f.coords.numpy().round(9)}
    cells = cells[[tuple(r) not in taken for r in cells.round(9)]]
    for dtype, rtol, root_tol in ((torch.float32, 1e-4, 1e-4), (torch.float64, 1e-8, 1e-10)):
        name = str(dtype).replace("torch.", "")
        jp = JointPredictor(mod, small.astype(dtype))
        out, draws = i_stage("conditional", stages, launches, f"sample_{name}",
                             lambda: jp.sample(0, cells, n_samples=I_COND_SAMPLES, seed=8),
                             ("matern_correlation",))
        base = jp(0, cells)
        check(draws.shape == (I_COND_SAMPLES, len(cells)) and np.isfinite(draws).all(),
              f"(i) conditional {name}: draws shape / finite")
        gap = max(float(np.max(np.abs(out.pred - base.pred) / np.abs(base.pred).clip(1e-3))),
                  float(np.max(np.abs(out.pred_err - base.pred_err) / base.pred_err)))
        check(gap <= rtol, f"(i) conditional {name}: pred / pred_err off __call__'s by {gap}")
        z = np.abs(draws.mean(axis=0) - out.pred) / (out.pred_err / np.sqrt(I_COND_SAMPLES))
        check(np.all(z < 5.0), f"(i) conditional {name}: sample means {z.max():.2f} SE off pred")
        coords = tuple(f.coords_main.to(device="cuda", dtype=dtype) for f in small.fields)
        values = tuple(f.values_main.to(device="cuda", dtype=dtype) for f in small.fields)
        with torch.no_grad():
            _, _, post, root = TJ._posterior(jp.params, coords, values,
                                             torch.as_tensor(cells, device="cuda", dtype=dtype),
                                             0, False)
            root_err = float((root @ root.T - post).abs().max() / post.abs().max())
        check(root_err <= root_tol, f"(i) conditional {name}: root root^T off the posterior by {root_err}")
        log(f"(i) conditional simulation {name}: {len(cells)} cells from 2 x {I_COND_N} data, "
            f"{I_COND_SAMPLES} draws in {stages[f'sample_{name}']:.3f} s, launches "
            f"{launches[f'sample_{name}']}; pred/pred_err against __call__ {gap:.3e}, means max "
            f"{z.max():.2f} SE, root root^T against the posterior {root_err:.3e}")
        del jp, post, root
        torch.cuda.empty_cache()


def _cli_multifield(paths, common):
    """The CLI's MultiField of its staged tables, as ``fit`` builds it."""
    from cokriging_tpu_torch.__main__ import _multifield, _parser

    parser = _parser()
    return _multifield(parser, parser.parse_args(["fit", *common, "--device", "cuda"]))


def phase_i_cli(stages):
    """5. ``fit --bootstrap 16`` and ``predict --joint --conditional-sims
    10`` with ``--device cuda`` on tests/test_cli.py's staged tables (their
    projected fit is positive definite), the prediction held against the
    same command on the CPU in this process."""
    import io
    import os
    import tempfile

    import pandas as pd

    from cokriging_tpu_torch.__main__ import main as cli_main
    from cokriging_tpu_torch.data.grids import main_coords_array
    from cokriging_tpu_torch.estimate.uncertainty import nll_std_errors
    from cokriging_tpu_torch.utils.io import load_params, load_table, save_table

    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(6)
        paths = []
        for k, nm in enumerate(("xco2", "sif")):
            paths.append(os.path.join(tmp, f"{nm}.parquet"))
            save_table(paths[-1], cli_table(nm, rng, 600 + k))
        mc = main_coords_array()
        grid = os.path.join(tmp, "grid.parquet")
        save_table(grid, pd.DataFrame({"lat": mc[::3, 0] + 0.5, "lon": mc[::3, 1] + 0.5}))
        common = ["--data", *paths, "--timestamp", CLI_TIMES[1], "--timedeltas", "0", "0"]
        params = os.path.join(tmp, "params.npz")
        out = {}
        for cmd, argv in (
            ("fit", ["fit", *common, "--max-dist", "3000", "--n-bins", "8", "--maxiter", "30",
                     "--project-validity", "--bootstrap", "16", "--std-errors", "--out", params]),
            ("predict", ["predict", *common, "--params", params, "--pred-grid", grid, "--joint",
                         "--conditional-sims", "10", "--seed", "3",
                         "--out", os.path.join(tmp, "pred_cuda.parquet")]),
        ):
            t0 = time.perf_counter()
            run = subprocess.run([sys.executable, "-m", "cokriging_tpu_torch", *argv,
                                  "--device", "cuda"], cwd=HERE, capture_output=True, text=True,
                                 timeout=300, env={**os.environ, "PYTHONPATH": str(HERE)})
            stages[f"cli_{cmd}"] = time.perf_counter() - t0
            check(run.returncode == 0, f"(i) CLI {cmd} --device cuda: exit {run.returncode}: "
                  f"{run.stderr[-2000:]}")
            out[cmd] = run.stdout
        boot = pd.read_csv(f"{params}.bootstrap.csv")
        check(list(boot.columns) == ["name", "value", "bounds", "std_err", "bias", "q025", "q975"]
              and boot.shape == (11, 7) and np.isfinite(boot["std_err"]).all(),
              f"(i) CLI bootstrap table: {boot.columns.tolist()} {boot.shape}")
        # --std-errors: its table against nll_std_errors here, on the card, at
        # the fitted parameters file
        sedf = pd.read_csv(f"{params}.std_errors.csv")
        cli_mf = _cli_multifield(paths, common)
        with contextlib.redirect_stderr(io.StringIO()):
            ref = nll_std_errors(load_params(params), cli_mf)
        se_gap = float(np.max(np.abs(sedf["std_err"].to_numpy() - ref["std_err"].to_numpy())
                              / np.maximum(np.abs(ref["std_err"].to_numpy()), 1e-300)))
        check(list(sedf.columns) == list(ref.columns) and sedf.shape == (11, 5)
              and list(sedf["at_bound"]) == list(ref["at_bound"]) and se_gap <= 1e-6,
              f"(i) CLI std errors against nll_std_errors: {sedf.columns.tolist()} {se_gap}")
        pred = load_table(os.path.join(tmp, "pred_cuda.parquet"))
        with np.load(os.path.join(tmp, "pred_cuda.parquet.samples.npz")) as f:
            keys, sims = list(f.keys()), f["samples"]
        check(keys == ["samples"] and sims.shape == (10, len(pred)) and np.isfinite(sims).all(),
              f"(i) CLI samples: {keys} {sims.shape}")
        with contextlib.redirect_stdout(io.StringIO()):
            cli_main(["predict", *common, "--params", params, "--pred-grid", grid, "--joint",
                      "--out", os.path.join(tmp, "pred_cpu.parquet"), "--device", "cpu"])
        cpu = load_table(os.path.join(tmp, "pred_cpu.parquet"))
        gap = float(np.max(np.abs(pred[["pred", "pred_err"]].to_numpy()
                                  - cpu[["pred", "pred_err"]].to_numpy())))
        check(gap <= 1e-6, f"(i) CLI conditional-sims prediction against the CPU: {gap}")
    log(f"(i) CLI fit --bootstrap 16 / predict --joint --conditional-sims 10 --device cuda: "
        f"{stages['cli_fit']:.1f} / {stages['cli_predict']:.1f} s per process; bootstrap table "
        f"{boot.shape}, std_err {np.round(boot['std_err'].to_numpy(), 4).tolist()}; samples "
        f"{sims.shape}; prediction against the CPU {gap:.3e}; std errors against "
        f"nll_std_errors {se_gap:.3e}; printed "
        f"{out['fit'].strip().splitlines()[-1]!r}")


def phase_i():
    """Simulation and the parametric bootstrap; returns its rows of the
    kernels line."""
    import torch

    stages, launches, rows = {}, {}, []
    t0 = time.perf_counter()
    phase_i_dense(stages, launches, rows)
    mod, spec, samples = phase_i_spectral(stages, launches, rows)
    SHARED["i_spectral"] = (mod, samples)
    params, mf = phase_i_bootstrap(mod, spec, samples, stages, launches, rows)
    phase_i_conditional(mod, mf, stages, launches, rows)
    torch.cuda.empty_cache()
    phase_i_cli(stages)
    log(f"(i) stages (s) {json.dumps({k: round(v, 4) for k, v in stages.items()})}")
    log(f"(i) launches per stage {json.dumps(launches)}")
    log(f"(i) seconds {time.perf_counter() - t0:.1f}")
    return rows


# --- phase (j): parameter uncertainty -----------------------------------------

# Operations per entry of the second-order kernels (csrc/matern_hess.cu over
# csrc/kv.cuh's Dual2<T>: an add 3, a product 10, a product with a scalar 3,
# a reciprocal 8, an exponential 6): the Hessian kernel's second-order
# series and CF2 trips, recurrence step and matern_second_tab's own
# arithmetic; the tangent's partials kernel runs the block gradient's dual
# pass without its cotangent weighting (matern_grad.cu's GradStep: three
# products, three adds, two finiteness tests, -8) and stores the partials
# unweighted; the combine weights them: a compare, three products, two
# finiteness tests, two adds.
MATERN_HESS_OPS = {"prefactor": 90, "series_setup": 140, "series_trip": 59,
                   "cf2_setup": 70, "cf2_trip": 110, "recurrence_step": 19}
MATERN_PARTIALS_OPS = dict(MATERN_GRAD_OPS, prefactor=MATERN_GRAD_OPS["prefactor"] - 8)
COMBINE_OPS = 8
J_STRIDE = 5  # (f)'s maximum-likelihood subsample of bench.py's month: 2 x 2,500
J_JITTER = 1e-6
J_FD_STEP = 1e-5  # central-difference step, of each parameter's box width
# bars, from the CPU rehearsal of this phase (PERF.md section 6): each Hessian
# column against the central difference of the exact gradient, relative to
# the column's largest entry; the Hessian before symmetrization symmetric to
# round-off, relative to max|H|; float32 against float64, relative to
# max|H|; the demo's card against the CPU
J_FD_BAR = 1e-4
J_SYM_BAR = {"float64": 1e-10, "float32": 1e-4}
J_F32_BAR = 1e-3
# the Hessian sums against their plain versions, each within its bar of its
# sum of |terms| (first-order sums, then d2M/dnu2, d2M/dnu dls, d2M/dls2):
# read on an H100 at (j)'s blocks, float64 <= 1.4e-17 and float32 <= 7.5e-9,
# where a kernel that left one sum out reads >= 7.9e-7 / 7.5e-5
J_HESS_BAR = {"float64": [1e-14] * 5, "float32": [1e-6] * 5}
J_DEMO_BAR = 1e-9
J_DEMO_THREADS = 2  # the demo's CPU Hessian runs beside the card's work
# examples/uncertainty_demo.py:56-68: the truth, the bounds, the 41 x 41 grid
J_DEMO_TRUTH = [1.0, 1.0, 1.5, 1.5, 1.5, 0.2, 0.2, 0.2, 0.05, 0.05, -0.6]
J_DEMO_BOUNDS = dict(sigma_bounds=(0.1, 3.0), len_scale_bounds=(0.02, 1.0),
                     nugget_bounds=(0.0, 0.5))
# examples/crosscov_eda.py's optimal-lag search (lags 0..359 days, tau 30),
# the CPU reference on every 8th cell
J_EDA_LAGS = (0, 360)
J_EDA_TAU = 30
J_EDA_STRIDE = 8


def j_problem():
    """(f)'s maximum-likelihood problem in float64: bench.py's month (noise
    seed 1), every 5th observation of each process, fitted on the card by
    ``fit_nll_device`` from the default start (L-BFGS, maxiter 60, jitter
    1e-6) as phase (f) fits it; returns (the MultiField, the fitted
    parameters, the fit's info)."""
    import torch

    from cokriging_tpu_torch.cov.params import MaternParams
    from cokriging_tpu_torch.estimate.nll import fit_nll_device
    from cokriging_tpu_torch.fields.field import Field, MultiField

    c1, v1, c2, v2 = build_inputs(N_PER_PROC, np.float64, noise_seed=1)
    fields = [Field.from_arrays(c[::J_STRIDE], v[::J_STRIDE], f"Z{k}")
              for k, (c, v) in enumerate(((c1, v1), (c2, v2)))]
    for f in fields:
        f.geodesic = True
    mf = MultiField(fields=fields)
    params, info = fit_nll_device(mf, init=MaternParams.default(2, dtype=torch.float64),
                                  jitter=J_JITTER, maxiter=60, method="lbfgs")
    return mf, params, info


def j_hessian(mf, params, dtype_name, rows, stages, launches):
    """The observed information of ``params`` on ``mf`` in one dtype on the
    card: the raw Hessian (before symmetrization, its launch counts and the
    arguments of its second-order launches captured), then
    ``observed_information`` itself (equal to the raw one symmetrized);
    both new kernels held against their plain versions at the Hessian's own
    blocks, timed there for this path's rows of the kernels line. Returns
    the information."""
    import torch

    from cokriging_tpu_torch.estimate.nll import _fit_inputs, neg_log_likelihood
    from cokriging_tpu_torch.estimate.uncertainty import observed_information
    from cokriging_tpu_torch.kernels import cuda_ops as K

    td = getattr(torch, dtype_name)
    mf = mf.astype(td)
    params = params.astype(td)
    spec = params.spec
    _, dists, z, _ = _fit_inputs(mf, params, False, True, "cuda")
    flat = params.to_flat().detach().to("cuda")

    def fn(f):
        return neg_log_likelihood(f, dists, z, spec, None, J_JITTER, analytic_grad=False)

    with torch.no_grad():
        value = float(fn(flat).detach())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2**20
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with captured("matern_block_hess") as hess_calls, \
            captured("matern_block_partials") as part_calls, \
            captured("matern_block_tangent") as all_tan_calls:
        raw = torch.autograd.functional.hessian(fn, flat)
    torch.cuda.synchronize()
    stages[f"hessian_{dtype_name}_s"] = time.perf_counter() - t0
    stages[f"hessian_{dtype_name}_peak_mb"] = torch.cuda.max_memory_allocated() / 2**20
    stages[f"hessian_{dtype_name}_base_mb"] = base_mb
    counts = {k: v for k, v in K.launch_counts().items() if v}
    launches[f"hessian_{dtype_name}"] = counts
    for k in ("matern_correlation", "matern_block_grad", "matern_block_partials",
              "matern_block_tangent", "matern_block_hess"):
        check(counts.get(k, 0) > 0, f"(j) {dtype_name}: no {k} launch in the Hessian: {counts}")
    # the tangent's partials once per block (3), one combine per row and block
    check(counts.get("matern_block_partials") == 3 and counts.get("matern_block_tangent") == 33,
          f"(j) {dtype_name}: {counts.get('matern_block_partials')} tangent-partials and "
          f"{counts.get('matern_block_tangent')} combine launches in one Hessian, not 3 and 33")
    # the second-order rows of all three process pairs, built once per Hessian
    # (the first block's double backward) and shared by the three blocks
    check(counts.get("recurrence_table_order2", 0) == 1,
          f"(j) {dtype_name}: {counts.get('recurrence_table_order2', 0)} second-order row "
          f"builds in one Hessian, not 1")
    raw = raw.detach().double().cpu().numpy()
    scale = float(np.abs(raw).max())
    asym = float(np.abs(raw - raw.T).max()) / scale
    log(f"(j) {dtype_name}: NLL {value} at the fit; raw Hessian in {stages[f'hessian_{dtype_name}_s']:.3f} s, "
        f"peak memory {stages[f'hessian_{dtype_name}_peak_mb']:.1f} MiB ({base_mb:.1f} before), "
        f"launches {counts}, max|H| {scale:.6g}, asymmetry {asym:.3e} (bar {J_SYM_BAR[dtype_name]})")
    check(np.isfinite(raw).all() and asym <= J_SYM_BAR[dtype_name],
          f"(j) {dtype_name}: Hessian not finite or not symmetric: {asym}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    info = observed_information(params, mf, jitter=J_JITTER)
    stages[f"observed_information_{dtype_name}_s"] = time.perf_counter() - t0
    gap = float(np.abs(info - 0.5 * (raw + raw.T)).max()) / scale
    check(gap <= 1e-12, f"(j) {dtype_name}: observed_information off the raw Hessian: {gap}")
    # per block (by its partials) the first combine of nonzero weights
    tan_calls, seen = [], set()
    for a in all_tan_calls:
        if a[2].data_ptr() not in seen and bool((a[1] != 0).any()):
            seen.add(a[2].data_ptr())
            tan_calls.append(a)
    rows += j_kernel_rows(dtype_name, hess_calls, part_calls, tan_calls, all_tan_calls, counts,
                          stages)
    return info


def combine_bound(h):
    """(bytes / HBM rate, operations / peak rate) in ms of one combine of
    the tangent's partials over the block of h's shape: three fields read
    and the tangent written whole, the five weight doubles read."""
    name = str(h.dtype).replace("torch.", "")
    return ((4 * h.numel() * h.element_size() + 40) / PEAK_BYTES_PER_S * 1e3,
            COMBINE_OPS * h.numel() / PEAK_OPS_PER_S[name] * 1e3)


def j_kernel_rows(dtype_name, hess_calls, part_calls, tan_calls, all_tan_calls, counts, stages):
    """The second-order kernels against their plain versions at the
    Hessian's own launches (the Hessian sums at the first of its three
    blocks, timed at all three; the tangent's partials at each of the three
    blocks; the combine at each block's first launch with nonzero weights,
    against the plain tangent over the block's plain partials, so one
    autograd pass serves both checks), each timed there; their rows of the
    kernels line (the Hessian sums' at the first block, where the plain
    version ran). The Hessian's tangent work as the path launched it, its 3
    partials and 33 combines, is timed once more as one
    (``per_hessian_ms``), with the bound of that work beside it.
    The Hessian sums are timed alone, with the second-order row the path
    handed them (``ms``, ``ms_all_blocks``), and as a launch that builds its
    row first (``ms_with_row_build_all_blocks``, how this row was timed
    before the rows were built once per Hessian); the one build of all three
    pairs' rows is timed alone (``row_build_ms``)."""
    import torch

    from cokriging_tpu_torch.kernels import cuda_ops as K

    def detached(calls):
        return [[t.detach() if torch.is_tensor(t) else t for t in a] for a in calls]

    hess_calls, part_calls = detached(hess_calls), detached(part_calls)
    tan_calls, all_tan_calls = detached(tan_calls), detached(all_tan_calls)
    f32 = dtype_name == "float32"
    hess = dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0, max_err=0.0, ms_all_blocks=0.0,
                ms_with_row_build_all_blocks=0.0)
    bar = torch.tensor(J_HESS_BAR[dtype_name], dtype=torch.float64, device="cuda")
    blocks = []
    check(len(hess_calls) == 3, f"(j) {dtype_name}: {len(hess_calls)} Hessian-sum launches")
    check(all(len(a) == 6 and torch.is_tensor(a[5]) for a in hess_calls),
          f"(j) {dtype_name}: a Hessian-sum launch of the path built its own row")
    td = hess_calls[0][2].dtype
    nu_pairs = torch.stack([torch.as_tensor(a[0], dtype=td, device="cuda") for a in hess_calls])
    ls_pairs = torch.stack([torch.as_tensor(a[1], dtype=td, device="cuda") for a in hess_calls])
    hess["row_build_ms"] = cuda_time_ms(lambda: K.recurrence_table(nu_pairs, ls_pairs, td,
                                                                   order=2), 3)
    for k, (nu, ls, h, ct, sym, row) in enumerate(hess_calls):
        kept = {}
        ms = cuda_time_ms(keep(kept, "kernel", lambda: K.matern_block_hess(
            nu, ls, h, ct, symmetric=sym, table=row)), 3)
        hess["ms_all_blocks"] += ms
        hess["ms_with_row_build_all_blocks"] += cuda_time_ms(keep(
            kept, "built", lambda: K.matern_block_hess(nu, ls, h, ct, symmetric=sym)), 3)
        check(torch.equal(kept["kernel"], kept["built"]),
              f"(j) Hessian sums {dtype_name} block {k}: the path's row and a row built in the "
              f"launch give other sums: {kept['kernel'].tolist()} / {kept['built'].tolist()}")
        if k:  # the plain sums only at the first block (a cut against the time limit)
            check(bool(torch.isfinite(kept["kernel"]).all()),
                  f"(j) Hessian sums {dtype_name} block {k}: {kept['kernel'].tolist()}")
            continue
        hess["ms"] = ms
        # the plain sums and their sums of |terms| from one timed pass
        hess["plain_ms"] += cuda_time_ms(keep(kept, "plain", lambda: K.matern_block_hess_plain(
            nu, ls, h, ct, symmetric=sym, magnitude=True)), 1, warm=False)
        kept["plain"], mag = kept["plain"]
        diff = (kept["kernel"] - kept["plain"]).abs()
        rel = diff / mag.clamp_min(1e-300)
        hess["max_abs_err"] = max(hess["max_abs_err"], float(diff.max()))
        hess["max_err"] = max(hess["max_err"], float(rel.max()))
        # what a kernel that left one sum out (returned 0 for it) would read
        dropped = (kept["plain"].abs() / mag.clamp_min(1e-300)).tolist()
        name = f"{k} ({'symmetric' if sym else 'full'} {h.shape[0]} x {h.shape[1]})"
        blocks.append(dict(block=name, err=rel.tolist(), dropped_sum_reads=dropped))
        log(f"(j) {dtype_name} Hessian sums at block {name}: |kernel - plain| / sum|terms| "
            f"{np.array2string(rel.cpu().numpy(), precision=2)} (bars {J_HESS_BAR[dtype_name]}); "
            f"a kernel leaving one sum out reads {np.array2string(np.array(dropped), precision=2)}")
        check(bool(torch.isfinite(kept["kernel"]).all()) and bool((rel <= bar).all()),
              f"(j) Hessian sums {dtype_name} block {k}: {kept['kernel'].tolist()} vs plain "
              f"{kept['plain'].tolist()}, |terms| {mag.tolist()}, bars {J_HESS_BAR[dtype_name]}")
        del kept
        torch.cuda.empty_cache()
    tan_bar = 1e-5 if f32 else 1e-12
    part = dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0, max_err=0.0)
    plain_parts = {}
    check(len(part_calls) == 3, f"(j) {dtype_name}: {len(part_calls)} tangent-partials launches")
    # the first row builds each block's partials just before its combine, so
    # the first three combines read the three launches' buffers in order
    block_of = {a[2].data_ptr(): k for k, a in enumerate(all_tan_calls[:3])}
    check(len(block_of) == 3 and {a[2].data_ptr() for a in all_tan_calls} == set(block_of),
          f"(j) {dtype_name}: the combines do not read the three blocks' partials")
    for k, (nu, ls, h, sym, table) in enumerate(part_calls):
        kept = {}
        part["ms"] += cuda_time_ms(keep(kept, "kernel", lambda: K.matern_block_partials(
            nu, ls, h, sym, table)), 3)
        part["plain_ms"] += cuda_time_ms(keep(kept, "plain", lambda: K.matern_block_partials_plain(
            nu, ls, h, symmetric=sym)), 1, warm=False)
        err = [float((kept["kernel"][f] - kept["plain"][f]).abs().max()) for f in range(3)]
        rel = [e / float(kept["plain"][f].abs().max()) for f, e in enumerate(err)]
        part["max_abs_err"] = max(part["max_abs_err"], max(err))
        part["max_err"] = max(part["max_err"], max(rel))
        check(bool(torch.isfinite(kept["kernel"]).all()) and max(rel) <= tan_bar,
              f"(j) tangent partials {dtype_name} block {k}: err / max|entry| per field {rel}")
        plain_parts[k] = kept["plain"]
        del kept
    tan = dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0, max_err=0.0)
    for a in tan_calls:
        scale, w, parts = a
        k = block_of[parts.data_ptr()]
        kept = {}
        # a head start: the host's time per call is close to the kernel's
        tan["ms"] += cuda_time_ms(keep(kept, "kernel", lambda: K.matern_block_tangent(*a)), 3,
                                  head_start_ms=2.0)
        tan["plain_ms"] += cuda_time_ms(keep(kept, "plain", lambda: K.matern_block_tangent_plain(
            scale, w, plain_parts[k])), 1, warm=False)
        err = float((kept["kernel"] - kept["plain"]).abs().max())
        size = float(kept["plain"].abs().max())
        check(bool(torch.isfinite(kept["kernel"]).all()) and err <= tan_bar * size,
              f"(j) tangent {dtype_name} block {k}: err {err} of {size}")
        tan["max_abs_err"] = max(tan["max_abs_err"], err)
        tan["max_err"] = max(tan["max_err"], err / size)
        del kept
    del plain_parts
    torch.cuda.empty_cache()
    # the Hessian's tangent work as the path launched it: 3 partials, 33 combines
    tan["per_hessian_ms"] = cuda_time_ms(lambda: (
        [K.matern_block_partials(*a) for a in part_calls],
        [K.matern_block_tangent(*a) for a in all_tan_calls]), 3)
    tan["all_combines_ms"] = cuda_time_ms(
        lambda: [K.matern_block_tangent(*a) for a in all_tan_calls], 3, head_start_ms=10.0)
    tan["hessian_peak_mb"] = stages[f"hessian_{dtype_name}_peak_mb"]
    pb = bound_of([matern_bound(a[2], float(a[0]), float(a[1]), a[3], grad=True,
                                ops=MATERN_PARTIALS_OPS, n_out=0, n_fields=3) for a in part_calls])
    cb = bound_of([combine_bound(a[2][0]) for a in tan_calls])
    tan["per_hessian_bound_ms"] = (pb[0]
                                   + bound_of([combine_bound(a[2][0]) for a in all_tan_calls])[0])
    stages[f"tangent_per_hessian_{dtype_name}_ms"] = tan["per_hessian_ms"]
    hb = bound_of([matern_bound(a[2], float(a[0]), float(a[1]), a[4], grad=True,
                                ops=MATERN_HESS_OPS, n_out=5) for a in hess_calls[:1]])
    hb_all = bound_of([matern_bound(a[2], float(a[0]), float(a[1]), a[4], grad=True,
                                    ops=MATERN_HESS_OPS, n_out=5) for a in hess_calls])
    hess["bound_ms_all_blocks"] = hb_all[0]
    shape = "Hessian blocks 2500^2 sym + 2500^2 + 2500^2 sym"
    log(f"(j) {dtype_name}: Hessian sums alone at the first block {hess['ms']:.3f} ms (at the "
        f"three {hess['ms_all_blocks']:.3f} ms; each launch building its row "
        f"{hess['ms_with_row_build_all_blocks']:.3f} ms; the one second-order row build of the "
        f"three pairs alone {hess['row_build_ms']:.3f} ms), plain {hess['plain_ms']:.1f} ms, worst "
        f"|kernel - plain| / sum|terms| {hess['max_err']:.3e}; "
        f"tangent partials at 3 blocks {part['ms']:.3f} ms (bound {pb[0]:.3f}), plain "
        f"{part['plain_ms']:.1f} ms, worst err / max|entry| {part['max_err']:.3e}; combine at "
        f"{len(tan_calls)} blocks {tan['ms']:.3f} ms (bound {cb[0]:.3f}), plain "
        f"{tan['plain_ms']:.1f} ms, worst err / max|entry| {tan['max_err']:.3e}; the Hessian's "
        f"tangent work (3 partials + {len(all_tan_calls)} combines) {tan['per_hessian_ms']:.3f} ms "
        f"(the combines {tan['all_combines_ms']:.3f}; bound {tan['per_hessian_bound_ms']:.3f})")
    replaces = "cokriging_tpu/estimate/uncertainty.py:75-79 (jax.hessian; no Pallas kernel)"
    return [
        dict(name=f"matern_block_hess_{dtype_name}", route="cuda",
             source="cokriging_tpu_torch/kernels/csrc/matern_hess.cu", replaces=replaces,
             launches=counts.get("matern_block_hess", 0),
             row_builds=counts.get("recurrence_table_order2", 0), bound_ms=hb[0], bound_by=hb[1],
             library_ms=None, path="(j) observed information",
             shape="the first Hessian block, 2500^2 sym (ms_all_blocks: all three)",
             bars=J_HESS_BAR[dtype_name], blocks=blocks, **hess),
        dict(name=f"matern_block_partials_{dtype_name}", route="cuda",
             source="cokriging_tpu_torch/kernels/csrc/matern_hess.cu", replaces=replaces,
             launches=counts.get("matern_block_partials", 0), bound_ms=pb[0], bound_by=pb[1],
             library_ms=None, path="(j) observed information",
             shape=f"{shape}, one launch per block", bar=tan_bar, **part),
        dict(name=f"matern_block_tangent_{dtype_name}", route="cuda",
             source="cokriging_tpu_torch/kernels/csrc/matern_hess.cu", replaces=replaces,
             launches=counts.get("matern_block_tangent", 0), launches_timed=len(tan_calls),
             bound_ms=cb[0], bound_by=cb[1], library_ms=None, path="(j) observed information",
             shape=f"{shape}, each block's first combine of nonzero weights", bar=tan_bar,
             **tan),
    ]


def j_finite_difference(mf, params, info):
    """Each column of the float64 information against a difference of the
    card's exact gradient (``nll_value_and_grad``: the analytic backward
    through the block-gradient kernel), steps h of J_FD_STEP of each
    parameter's box width: central, or one-sided of second order
    (-3 g(x) + 4 g(x + h) - g(x + 2h)) / 2h into the box where the central
    stencil would leave the positive-definite region (a fit ends on its wall,
    ROADMAP Queue 3) or the box; every stencil point must factorize."""
    import torch

    from cokriging_tpu_torch.estimate.nll import _fit_inputs, _penalty, nll_value_and_grad

    _, dists, z, _ = _fit_inputs(mf, params, False, True, "cuda")
    spec = params.spec
    flat = params.to_flat().detach().to("cuda", torch.float64)
    penalty = float(_penalty(z.shape[0], torch.float64, "cpu"))
    lo, hi = (np.asarray(b, np.float64) for b in spec.bounds())
    step = J_FD_STEP * (hi - lo)

    def grad_at(k, t):
        e = torch.zeros(11, dtype=torch.float64, device="cuda")
        e[k] = float(t)
        v, g = nll_value_and_grad(flat + e, dists, z, spec, None, J_JITTER)
        return float(v) != penalty, g.cpu().numpy()

    x = flat.cpu().numpy()
    fd = np.zeros((11, 11))
    one_sided = []
    for k in range(11):
        h = step[k]
        ok_p, gp = grad_at(k, h)
        ok_m, gm = grad_at(k, -h)
        if ok_p and ok_m and x[k] - h >= lo[k] and x[k] + h <= hi[k]:
            fd[:, k] = (gp - gm) / (2.0 * h)
            continue
        d = 1.0 if (ok_p and x[k] + 2 * h <= hi[k]) else -1.0
        ok0, g0 = grad_at(k, 0.0)
        ok1, g1 = grad_at(k, d * h)
        ok2, g2 = grad_at(k, 2 * d * h)
        check(ok0 and ok1 and ok2, f"(j) no factorizing stencil for parameter {k}")
        fd[:, k] = d * (-3.0 * g0 + 4.0 * g1 - g2) / (2.0 * h)
        one_sided.append(k)
    col = np.abs(info - fd).max(axis=0) / np.maximum(np.abs(info).max(axis=0), 1e-300)
    log(f"(j) float64: Hessian columns against a difference of the exact gradient (step "
        f"{J_FD_STEP} of each box width; one-sided for {one_sided}): worst {col.max():.3e} "
        f"(bar {J_FD_BAR}) per column {np.array2string(col, precision=2)}")
    check(bool((col <= J_FD_BAR).all()), f"(j) Hessian off the difference of the gradient: {col}")


def j_demo_truth(device):
    """The demo's truth as MaternParams (float64) on ``device``."""
    import torch

    from cokriging_tpu_torch.cov.params import MaternParams, ParamSpec

    return MaternParams.from_flat(torch.tensor(J_DEMO_TRUTH, dtype=torch.float64, device=device),
                                  spec=ParamSpec(n_procs=2, **J_DEMO_BOUNDS))


def j_demo_cpu_information(mf):
    """The port's information of the demo at its truth on the CPU (run in a
    worker process, beside the rest of phase (j)): (information, seconds)."""
    import torch

    from cokriging_tpu_torch.estimate.uncertainty import observed_information

    torch.set_num_threads(J_DEMO_THREADS)
    t0 = time.perf_counter()
    info = observed_information(j_demo_truth("cpu"), mf, device="cpu")
    return info, time.perf_counter() - t0


def j_demo_start(stages):
    """examples/uncertainty_demo.py's maximum-likelihood half at its own
    size: its truth on a 41 x 41 grid, seed 42, 2 x 120 samples with epsilon
    0.05 (seed 43), simulated on the card; the port's CPU information of that
    sample starts in a worker process (the reference the card is held to,
    ~35 s on the host). Returns (the MultiField, the pool, its pending
    result)."""
    import dataclasses
    import multiprocessing

    import torch

    from cokriging_tpu_torch.cov.matern import MultivariateMatern
    from cokriging_tpu_torch.sim import BivariateRandomField, CartesianGrid

    t0 = time.perf_counter()
    rf = BivariateRandomField(MultivariateMatern(params=j_demo_truth("cuda")),
                              CartesianGrid(xcount=41, ycount=41), seed=42)
    mf = rf.to_fields(rf.sample(size=120, epsilon=[0.05, 0.05], seed=43))
    torch.cuda.synchronize()
    stages["demo_sim_s"] = time.perf_counter() - t0
    on_cpu = dataclasses.replace(mf, fields=[dataclasses.replace(f, **{
        k: getattr(f, k).cpu() for k in ("coords", "values", "coords_main", "values_main",
                                          "measurement_var") if getattr(f, k) is not None})
        for f in mf.fields])
    pool = multiprocessing.get_context("spawn").Pool(1)
    return mf, pool, pool.apply_async(j_demo_cpu_information, (on_cpu,))


def j_demo(stages, mf, pending):
    """The demo's information at the truth on the card against the port's
    on the CPU (float64, J_DEMO_BAR of max|H|), and ``nll_std_errors`` on the
    card's information."""
    import torch

    from cokriging_tpu_torch.estimate.uncertainty import nll_std_errors, observed_information

    truth = j_demo_truth("cuda")
    t1 = time.perf_counter()
    info_card = observed_information(truth, mf)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    info_cpu, cpu_s = pending.get(timeout=600)
    t3 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        df = nll_std_errors(truth, mf, information=info_card)
    stages.update(demo_hessian_card_s=t2 - t1, demo_hessian_cpu_s=cpu_s,
                  demo_cpu_wait_s=t3 - t2)
    gap = float(np.abs(info_card - info_cpu).max()) / float(np.abs(info_cpu).max())
    log(f"(j) demo (2 x {mf.fields[0].size}, at the truth): Hessian card {t2 - t1:.3f} s, CPU "
        f"{cpu_s:.3f} s in its worker process (waited {t3 - t2:.3f} s for it), card against CPU "
        f"{gap:.3e} of max|H| (bar {J_DEMO_BAR}); eigenvalues "
        f"{np.array2string(np.linalg.eigvalsh(info_card), precision=3)}; std_err "
        f"{np.round(df['std_err'].to_numpy(), 4).tolist()}; warnings "
        f"{[str(w.message)[:50] for w in caught]}")
    check(gap <= J_DEMO_BAR, f"(j) demo Hessian card against CPU: {gap}")
    check(np.isfinite(df["std_err"].to_numpy()).all(), "(j) demo standard errors not finite")


def j_eda(stages, launches):
    """The space-time statistics at examples/crosscov_eda.py's size (its
    ``synthesize_daily(seed=0)``: a global 5-degree daily cube over five
    years, 36 x 72 x 1,825, ~70% missing): ``optim_lag_nd`` over lags 0..359
    with tau 30 and ``get_stats`` on the card, held against the port on the
    CPU on every 8th cell (lags equal, xcor to 1e-10); then ``regional_stats``
    on examples/xcov_eda.py's 5-degree monthly frame, card against CPU."""
    import torch

    from cokriging_tpu_torch.stats import (
        get_stats, hemisphere_labels, lat_band_labels, optim_lag_nd, regional_monthly,
        regional_stats,
    )

    examples = {}
    for name in ("crosscov_eda", "xcov_eda"):
        spec = importlib.util.spec_from_file_location(f"_{name}", HERE / "examples" / f"{name}.py")
        examples[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(examples[name])
    check(not [m for m in ("jax", "cokriging_tpu") if m in sys.modules],
          "(j) loading the examples' data makers imported JAX")
    t0 = time.perf_counter()
    sif, xco2, _, _, _ = examples["crosscov_eda"].synthesize_daily(seed=0)
    shape = (36, 72, sif.shape[-1])
    sif, xco2 = sif.reshape(shape), xco2.reshape(shape)
    stages["eda_synthesize_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best = optim_lag_nd(xco2, sif, lag_bnds=J_EDA_LAGS, tau=J_EDA_TAU)
    stats = get_stats({"sif": sif, "xco2": xco2})
    torch.cuda.synchronize()
    stages["eda_card_s"] = time.perf_counter() - t0
    sub = (slice(None), slice(None, None, J_EDA_STRIDE))
    t0 = time.perf_counter()
    ref = optim_lag_nd(xco2[sub], sif[sub], lag_bnds=J_EDA_LAGS, tau=J_EDA_TAU, device="cpu")
    ref_stats = get_stats({"sif": sif[sub], "xco2": xco2[sub]}, device="cpu")
    stages["eda_cpu_every_8th_s"] = time.perf_counter() - t0
    lag_eq = bool(np.array_equal(best["optim_lag"][sub], ref["optim_lag"]))
    xc_gap = float(np.nanmax(np.abs(best["xcor"][sub] - ref["xcor"])))
    st_gap = max(float(np.nanmax(np.abs(stats[k][sub] - ref_stats[k]) / np.maximum(
        np.abs(ref_stats[k]), 1e-300))) for k in ref_stats)
    finite = float(np.isfinite(best["xcor"]).mean())
    lags, n_lag = np.unique(best["optim_lag"][np.isfinite(best["xcor"])], return_counts=True)
    log(f"(j) EDA cube {shape}: optimal lags + get_stats on the card {stages['eda_card_s']:.3f} s "
        f"(CPU on every {J_EDA_STRIDE}th cell {stages['eda_cpu_every_8th_s']:.3f} s); lags equal "
        f"{lag_eq}, xcor gap {xc_gap:.3e}, stats rel gap {st_gap:.3e}; cells with a lag "
        f"{finite:.3%}, the commonest lags {lags[np.argsort(-n_lag)][:3].tolist()} (the raw cubes: "
        f"the seasonal cycle, which the example removes first, dominates their correlation)")
    check(lag_eq and xc_gap <= 1e-10 and st_gap <= 1e-10,
          f"(j) EDA card against CPU: lags equal {lag_eq}, xcor {xc_gap}, stats {st_gap}")
    df = examples["xcov_eda"].synthesize_global_monthly()
    t0 = time.perf_counter()
    tables = {}
    for grouper, labels in (("hemisphere", hemisphere_labels(df)),
                            ("lat_band", lat_band_labels(df, width=30.0))):
        monthly = regional_monthly(df, labels)
        tables[grouper] = (regional_stats(monthly, grouper, lags=(0, 1, 2, 3)),
                           regional_stats(monthly, grouper, lags=(0, 1, 2, 3), device="cpu"))
    stages["regional_stats_s"] = time.perf_counter() - t0
    for grouper, (card, cpu) in tables.items():
        num = card.select_dtypes("number").to_numpy(np.float64)
        gap = float(np.nanmax(np.abs(num - cpu.select_dtypes("number").to_numpy(np.float64))
                              / np.maximum(np.abs(num), 1e-300)))
        check(gap <= 1e-10 and card.shape == cpu.shape, f"(j) regional_stats {grouper}: {gap}")
        log(f"(j) regional_stats by {grouper} ({len(df)} rows): {card.shape}, card against CPU {gap:.3e}")


def phase_j():
    """Parameter uncertainty: the observed information of (f)'s ML fit in
    float64 and float32, the demo's, the space-time statistics; returns its
    rows of the kernels line."""
    import torch

    from cokriging_tpu_torch.estimate.uncertainty import observed_information

    stages, launches, rows = {}, {}, []
    t0 = time.perf_counter()
    demo_mf, pool, pending = j_demo_start(stages)
    try:
        t1 = time.perf_counter()
        mf, params, fit = j_problem()
        stages["ml_fit_s"] = time.perf_counter() - t1
        log(f"(j) (f)'s ML fit (2 x {mf.fields[0].size}, float64): {fit}, params "
            f"{np.array2string(params.to_flat().cpu().numpy(), precision=5)}")
        j_hessian(mf, params, "float64", rows, stages, launches)
        # the difference check and float32 against float64 at the fit with its
        # nuggets raised to 0.1 ((f)'s convention): an ML fit of the free model
        # may end on the wall of the positive-definite region (ROADMAP Queue 3),
        # where no difference of the gradient is defined and a float32 factor
        # carries the conditioning's error
        lifted = params.to_flat().detach().clone()
        lifted[8:10] = torch.clamp_min(lifted[8:10], 0.1)
        lifted = params.with_flat(lifted)
        info64b = observed_information(lifted, mf, jitter=J_JITTER)
        j_finite_difference(mf, lifted, info64b)
        info32 = j_hessian(mf, lifted, "float32", rows, stages, launches)
        gap = float(np.abs(info32 - info64b).max()) / float(np.abs(info64b).max())
        log(f"(j) float32 information against float64 at nuggets >= 0.1: {gap:.3e} of max|H| "
            f"(bar {J_F32_BAR})")
        check(gap <= J_F32_BAR, f"(j) float32 information off float64's: {gap}")
        torch.cuda.empty_cache()
        j_demo(stages, demo_mf, pending)
        j_eda(stages, launches)
    finally:
        pool.terminate()
        pool.join()
    log(f"(j) stages (s) {json.dumps({k: round(v, 4) for k, v in stages.items()})}")
    log(f"(j) launches {json.dumps(launches)}")
    log(f"(j) seconds {time.perf_counter() - t0:.1f}")
    return rows


# --- phase (k): the sharded paths on the card ---------------------------------

K_SHARDS = 4  # virtual shards of the one card
# a well-conditioned month model (nuggets 0.1) for the sharded prediction paths
K_PARAMS = [1.0, 1.0, 1.5, 1.5, 1.5, 700.0, 700.0, 700.0, 0.1, 0.1, -0.5]
K_LOCAL_KM = 1000.0  # (d)'s prediction radius
K_VECCHIA_ITERS = 10
K_CG_SMALL = 2_500  # (h)'s joint and CG LOOCV rows per process
K_CG_TILED = 2_560  # per process: 5,120 rows, a multiple of the 512-row tile
K_CG_CELLS = 256
K_BOOT_REP, K_BOOT_MAXITER = 8, 30
K_BOOT_ONE_CARD = (4, 20)  # replicates, maxiter of the one-card mesh's bootstrap
SHARED = {}  # (i)'s spectral model and sample, which (k) reuses


def k_stage(stages, launches, key, fn, kernels=None, exact=False):
    """``fn`` with the launch counts set to 0 just before and read just
    after, timed on the host clock around a synchronize; ``kernels`` maps
    each kernel of the stage to the launches it must reach (one per shard),
    or equal with ``exact``."""
    import warnings

    import torch

    from cokriging_tpu_torch.kernels import cuda_ops as K

    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn()
    torch.cuda.synchronize()
    stages[key] = time.perf_counter() - t0
    launches[key] = {k: v for k, v in K.launch_counts().items() if v}
    for w in caught[:2]:
        log(f"(k) {key}: warning: {str(w.message)[:110]}")
    for k, n in (kernels or {}).items():
        got = launches[key].get(k, 0)
        check(got == n if exact else got >= n,
              f"(k) {key}: {k} launched {got} times, {'not' if exact else 'fewer than'} {n}: "
              f"{launches[key]}")
    return out


def k_same(what, pairs, rtol=None, norm=False):
    """Each (got, want) pair of arrays bit-equal (``rtol`` None) or within
    ``rtol`` of ``want`` elementwise (``norm``: of max |want|), NaN where
    ``want`` is NaN; returns the worst relative gap."""
    worst = 0.0
    for got, want in pairs:
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        check(got.shape == want.shape, f"(k) {what}: shape {got.shape}, not {want.shape}")
        same_nan = np.array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        scale = np.abs(want[ok]).max() if norm and ok.any() else np.abs(want[ok])
        gap = float((np.abs(got[ok] - want[ok]) / np.maximum(scale, 1e-300)).max()) if ok.any() else 0.0
        if rtol is None:
            check(same_nan and np.array_equal(got, want, equal_nan=True),
                  f"(k) {what}: not bit-equal to the call with no mesh (relative gap {gap:.3e})")
        else:
            check(same_nan and gap <= rtol, f"(k) {what}: relative gap {gap:.3e} (bar {rtol})")
        worst = max(worst, gap)
    return worst


def k_vario_rows(mm_args, bin_args, name, kind, counts, shards):
    """Both variogram passes over shard 0's sides of a sharded variogram (the
    arguments the sharded call handed its first launch of each pass), timed
    beside their plain versions (h range and counts equal, the sums' largest
    difference), with bounds from those sides' pairs: rows of the kernels
    line."""
    import torch

    from cokriging_tpu_torch.kernels import cuda_ops as K

    np_dt = np.dtype(name)
    sides, edges = bin_args[0], bin_args[1]
    n_pairs = sum(a.shape[0] * (a.shape[0] - 1) // 2 if marg else a.shape[0] * b.shape[0]
                  for a, b, marg in mm_args[0])
    k_cmp = [K._bin_record(np.asarray(e), True, True, np_dt)[1] for e in edges]
    n_valid = [int(v) for v in K.variogram_bin_pairs(*bin_args)[1].sum(1)]
    rows = []
    for kname, kern, plain, minmax in (
        ("variogram_minmax", lambda: K.variogram_minmax_pairs(*mm_args),
         lambda: K.variogram_minmax_pairs_plain(*mm_args), True),
        ("variogram_bin", lambda: K.variogram_bin_pairs(*bin_args),
         lambda: K.variogram_bin_pairs_plain(*bin_args), False),
    ):
        kept = {}
        ms = cuda_time_ms(keep(kept, "kernel", kern), 20, head_start_ms=50.0)
        plain_ms = cuda_time_ms(keep(kept, "plain", plain), 2)
        got, want = (kept["kernel"], kept["plain"]) if minmax else (kept["kernel"][1],
                                                                    kept["plain"][1])
        check(torch.equal(got, want), f"(k) {kname} {name} {kind} shard: differs from the plain version")
        err = 0.0 if minmax else float((kept["kernel"][0] - kept["plain"][0]).abs().max())
        bound_ms, bound_by, _ = vario_bound(n_pairs, n_valid, k_cmp, 15, name, minmax)
        rows.append(dict(
            name=f"{kname}_{name}_k_{kind}_shard", route="cuda",
            source="cokriging_tpu_torch/kernels/csrc/variogram.cu",
            replaces="cokriging_tpu/kernels/pallas_ops.py:143", launches=counts.get(kname, 0),
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            max_abs_err=err, max_err=err,
            path=f"(k) sharded_variogram_pair, {kind}, one launch per pass per shard of {shards}",
            shape=f"shard 0's {len(sides)} side(s): {n_pairs} pairs x 15 bins", pairs=n_pairs,
            binned=sum(n_valid), k_cmp=k_cmp))
    return rows


def k_variograms(mesh, one_card, stages, launches):
    """sharded_variogram_pair on bench.py's month, marginal and cross (3000
    km, 15 bins), against the one-variogram call: centers and counts equal,
    means rtol 1e-5 / 1e-12; one launch per pass per shard; bit-equal on the
    one-card mesh."""
    from cokriging_tpu_torch.estimate.empirical import VarioConfig, empirical_variogram_pair
    from cokriging_tpu_torch.parallel import sharded_variogram_pair

    cfg = VarioConfig(max_dist=3000.0, n_bins=15)
    passes = {"variogram_minmax": 1, "variogram_bin": 1}
    per_shard = {k: mesh.size for k in passes}
    rows = []
    for dtype in (np.float32, np.float64):
        name = np.dtype(dtype).name
        rtol = 1e-5 if name == "float32" else 1e-12
        c1, v1, c2, v2 = build_inputs(N_PER_PROC, dtype)
        for kind, b, w, marg in (("marginal", c1, v1, True), ("cross", c2, v2, False)):
            key = f"variogram_{kind}_{name}"
            one = k_stage(stages, launches, key, lambda: empirical_variogram_pair(
                c1, v1, b, w, cfg, marg), passes, exact=True)
            with captured("variogram_minmax_pairs", 1) as mm, captured("variogram_bin_pairs", 1) as bp:
                got = k_stage(stages, launches, key + "_mesh", lambda: sharded_variogram_pair(
                    c1, v1, b, w, cfg, marg, mesh=mesh), per_shard, exact=True)
            k_same(f"{key} centers, counts", [(got[0], one[0]), (got[2], one[2])])
            gap = k_same(f"{key} means", [(got[1], one[1])], rtol)
            k_same(f"{key} one-card mesh", zip(sharded_variogram_pair(
                c1, v1, b, w, cfg, marg, mesh=one_card), one))
            rows += k_vario_rows(mm[0], bp[0], name, kind, launches[key + "_mesh"], mesh.size)
            log(f"(k) {key}: {int(one[2].sum())} pairs binned; {mesh.size} shards "
                f"{stages[key + '_mesh']:.4f} s, one call {stages[key]:.4f} s; means rel gap "
                f"{gap:.3e} (bar {rtol}); launches {launches[key + '_mesh']}")
    return rows


def k_local(mesh, one_card, stages, launches):
    """sharded_local_predict at (d)'s land cells less one (not a multiple of
    the shards), materialized and direct, and with ``cv=True`` at all 12,500
    data of process 0 within 130 km, against the predictor's own calls
    (rtol 1e-5 / 1e-10) and bit-equal on the one-card mesh."""
    import torch

    from cokriging_tpu_torch.cov.matern import MultivariateMatern
    from cokriging_tpu_torch.cov.params import MaternParams
    from cokriging_tpu_torch.data.grids import prediction_coords
    from cokriging_tpu_torch.parallel import sharded_local_predict
    from cokriging_tpu_torch.predict.local import LocalPredictor

    pc_all = prediction_coords()[:-1]
    check(len(pc_all) % mesh.size != 0, "(k) the land cells must not split evenly over the shards")
    for dtype in (np.float32, np.float64):
        name = np.dtype(dtype).name
        rtol = 1e-5 if name == "float32" else 1e-10
        td = getattr(torch, name)
        c1, v1, c2, v2 = build_inputs(N_PER_PROC, dtype)
        sub = max(1, N_PER_PROC // 200)
        mf_d = geo_fields(((c1[::sub], v1[::sub], "Z0"), (c2[::sub], v2[::sub], "Z1")))
        mod = MultivariateMatern(params=MaternParams.from_flat(torch.tensor(K_PARAMS, dtype=td)))
        pc = pc_all.astype(dtype)
        for kind, kw, kern in (("materialized", {}, "matern_correlation"),
                               ("direct", dict(materialize_cov=False, neighbor_method="device"),
                                "matern_corr_pairs")):
            key = f"local_{kind}_{name}"
            # the materialized path's kernel builds the joint covariance the
            # shards gather from; the direct path's runs in every shard
            need = {kern: 1 if kind == "materialized" else mesh.size}
            holder = {}

            def predictor():
                holder["lp"] = LocalPredictor(mod, mf_d, **kw)
                return holder["lp"]

            one = k_stage(stages, launches, key, lambda: predictor()(0, pc, max_dist=K_LOCAL_KM),
                          {kern: 1})
            lp = holder["lp"]
            got = k_stage(stages, launches, key + "_mesh", lambda: sharded_local_predict(
                predictor(), 0, pc, K_LOCAL_KM, mesh=mesh), need)
            gap = k_same(key, [(got[0], one.pred), (got[1], one.pred_err)], rtol, norm=True)
            k_same(f"{key} one-card mesh", zip(sharded_local_predict(
                lp, 0, pc, K_LOCAL_KM, mesh=one_card), (one.pred, one.pred_err)))
            log(f"(k) {key}: {len(pc)} cells, finite {float(np.isfinite(one.pred).mean()):.4%}; "
                f"{mesh.size} shards {stages[key + '_mesh']:.4f} s, one call {stages[key]:.4f} s; "
                f"rel gap {gap:.3e} (bar {rtol}); launches {launches[key + '_mesh']}")
        mf_full = geo_fields(((c1, v1, "Z0"), (c2, v2, "Z1")))
        key = f"local_loocv_{name}"
        lp = k_stage(stages, launches, key + "_covariance", lambda: LocalPredictor(mod, mf_full),
                     {"matern_correlation": 1})
        one = k_stage(stages, launches, key, lambda: lp.cross_validation(0, max_dist=H_LOOCV_KM))
        got = k_stage(stages, launches, key + "_mesh", lambda: sharded_local_predict(
            lp, 0, c1, H_LOOCV_KM, mesh=mesh, cv=True))
        gap = k_same(key, [(got[0], one.pred), (got[1], one.pred_err)], rtol, norm=True)
        k_same(f"{key} one-card mesh", zip(sharded_local_predict(
            lp, 0, c1, H_LOOCV_KM, mesh=one_card, cv=True), (one.pred, one.pred_err)))
        log(f"(k) {key}: LOOCV at {len(c1)} data, {H_LOOCV_KM:g} km, finite "
            f"{float(np.isfinite(one.pred).mean()):.4%}; {mesh.size} shards "
            f"{stages[key + '_mesh']:.4f} s, one call {stages[key]:.4f} s; rel gap {gap:.3e} "
            f"(bar {rtol})")
        del lp, one, got
        torch.cuda.empty_cache()


def k_vecchia(mesh, one_card, stages, launches):
    """sharded_vecchia_nll's value and gradient at (g)'s 2 x 60,000 windows
    (m = 20, chunk 4096) against the unsharded evaluation (float64 rtol 1e-12
    / 1e-9 of max |gradient|; float32 logged), every chunk launched once and
    every shard launching; bit-equal on the one-card mesh; then
    ``fit_vecchia(mesh=)`` for 10 iterations in float64 against the
    unsharded fit (rtol 1e-8)."""
    import torch

    from cokriging_tpu_torch.cov.params import MaternParams, ParamSpec
    from cokriging_tpu_torch.estimate.vecchia import (
        VecchiaLikelihood, fit_vecchia, vecchia_nll_value_and_grad,
    )
    from cokriging_tpu_torch.parallel import sharded_vecchia_nll

    spec = ParamSpec(n_procs=2)
    xf = torch.tensor(LARGE_INIT, dtype=torch.float64, device="cuda")
    for dtype in (np.float64, np.float32):
        name = np.dtype(dtype).name
        c1, z1, c2, z2 = large_n_month(dtype)
        lik = k_stage(stages, launches, f"vecchia_scaffold_{name}", lambda: VecchiaLikelihood(
            [c1, c2], [z1, z2], m=VECCHIA_M, geodesic=True, chunk=VECCHIA_CHUNK))
        n_chunks = math.ceil(lik.n / VECCHIA_CHUNK)
        every = {"matern_corr_pairs": n_chunks, "matern_corr_pairs_grad": n_chunks}

        def sharded(on):
            x = xf.clone().requires_grad_(True)
            v = sharded_vecchia_nll(lik, x, spec, mesh=on, chunk=VECCHIA_CHUNK)
            return (v.detach(), *torch.autograd.grad(v, x))

        key = f"vecchia_{name}"
        v1, g1 = k_stage(stages, launches, key, lambda: vecchia_nll_value_and_grad(
            xf, lik._win, spec, True, VECCHIA_CHUNK), every, exact=True)
        with captured("matern_corr_pairs") as calls:
            v4, g4 = k_stage(stages, launches, key + "_mesh", lambda: sharded(mesh), every,
                             exact=True)
        shard_devs = {a[3].device for a in calls}
        check(len(calls) == n_chunks and shard_devs == set(mesh.devices),
              f"(k) {key}: {len(calls)} launches on {shard_devs}")
        pairs = [(v4.cpu().numpy(), v1.cpu().numpy()), (g4.cpu().numpy(), g1.cpu().numpy())]
        if name == "float64":
            gap_v = k_same(f"{key} value", pairs[:1], 1e-12)
            gap_g = k_same(f"{key} gradient", pairs[1:], 1e-9, norm=True)
        else:
            gap_v = k_same(f"{key} value", pairs[:1], math.inf)
            gap_g = k_same(f"{key} gradient", pairs[1:], math.inf, norm=True)
        k_same(f"{key} one-card mesh", [(a.cpu().numpy(), b.cpu().numpy())
                                        for a, b in zip(sharded(one_card), (v1, g1))])
        log(f"(k) {key}: {lik.n} windows in {n_chunks} chunks over {mesh.size} shards: value "
            f"{float(v1)}, rel gap {gap_v:.3e}, gradient gap / max|g| {gap_g:.3e}"
            f"{' (bars 1e-12, 1e-9)' if name == 'float64' else ' (logged)'}; {mesh.size} shards "
            f"{stages[key + '_mesh']:.4f} s, one device {stages[key]:.4f} s; scaffold "
            f"{stages['vecchia_scaffold_' + name]:.2f} s; launches {launches[key + '_mesh']}")
        del lik, calls
        torch.cuda.empty_cache()
    c1, z1, c2, z2 = large_n_month(np.float64)
    mf = geo_fields(((c1, z1, "XCO2"), (c2, z2, "SIF")))
    init = MaternParams.default(2, spec).with_flat(xf.cpu())
    kw = dict(init=init, m=VECCHIA_M, maxiter=K_VECCHIA_ITERS, main=False, chunk=VECCHIA_CHUNK)
    p1, i1 = k_stage(stages, launches, "vecchia_fit_float64", lambda: fit_vecchia(mf, **kw))
    p4, i4 = k_stage(stages, launches, "vecchia_fit_float64_mesh", lambda: fit_vecchia(
        mf, mesh=mesh, **kw), {"matern_corr_pairs": mesh.size, "matern_corr_pairs_grad": mesh.size})
    gap = k_same("vecchia_fit_float64", [(p4.to_flat().cpu().numpy(), p1.to_flat().cpu().numpy())],
                 1e-8)
    log(f"(k) vecchia_fit_float64: {K_VECCHIA_ITERS} iterations, {i1['n_obj_evals']} / "
        f"{i4['n_obj_evals']} evaluations, nll {i1['nll']} / {i4['nll']}; params rel gap {gap:.3e} "
        f"(bar 1e-8); {mesh.size} shards {stages['vecchia_fit_float64_mesh']:.2f} s, one device "
        f"{stages['vecchia_fit_float64']:.2f} s (each with its scaffold)")


def k_cg(mesh, one_card, stages, launches):
    """IterativeJointPredictor(mesh=) on 2 x 2,500 of bench.py's month with
    nuggets 0.1 at 256 cells (tol 1e-10, float64; rtol 1e-8), on 2 x 2,560
    (tol 1e-4) bit-equal on the one-card mesh, then (g)'s 2 x 12,500 at 256 cells (40
    iterations, float32): the iterations equal, the gap logged."""
    import torch

    from cokriging_tpu_torch.cov.matern import MultivariateMatern
    from cokriging_tpu_torch.cov.params import MaternParams
    from cokriging_tpu_torch.data.grids import prediction_coords
    from cokriging_tpu_torch.predict.iterative import IterativeJointPredictor

    pc = prediction_coords()[:K_CG_CELLS]
    c1, v1, c2, v2 = build_inputs(N_PER_PROC, np.float64)
    mod = MultivariateMatern(params=MaternParams.from_flat(torch.tensor(K_PARAMS, dtype=torch.float64)))
    pairs = {"matern_corr_pairs": mesh.size}

    def cg(n, on, **kw):
        mf = geo_fields(((c1[:n], v1[:n], "Z0"), (c2[:n], v2[:n], "Z1")))
        p = IterativeJointPredictor(mod, mf, block=512, rhs_batch=K_CG_CELLS, mesh=on, **kw)
        out = p(0, pc)
        return out, p.last_diagnostics

    kw = dict(tol=1e-10, maxiter=1000)
    one, d1 = k_stage(stages, launches, "cg_float64", lambda: cg(K_CG_SMALL, None, **kw), {
        "matern_corr_pairs": 1})
    got, d4 = k_stage(stages, launches, "cg_float64_mesh", lambda: cg(K_CG_SMALL, mesh, **kw), pairs)
    gap = k_same("cg_float64", [(got.pred, one.pred), (got.pred_err, one.pred_err)], 1e-8, norm=True)
    # the one-card mesh's check at a looser tolerance: bit-equality holds at any
    a, _ = cg(K_CG_TILED, None, tol=1e-4, maxiter=1000)
    b, _ = cg(K_CG_TILED, one_card, tol=1e-4, maxiter=1000)
    k_same("cg_float64 one-card mesh", [(b.pred, a.pred), (b.pred_err, a.pred_err)])
    log(f"(k) cg_float64: 2 x {K_CG_SMALL}, {K_CG_CELLS} cells, tol 1e-10: (iterations, residual) "
        f"{d1} / sharded {d4}; rel gap {gap:.3e} (bar 1e-8); {mesh.size} shards "
        f"{stages['cg_float64_mesh']:.3f} s, one device {stages['cg_float64']:.3f} s; launches "
        f"{launches['cg_float64_mesh']}")
    # (g)'s system in float32
    g1, z1, g2, z2 = large_n_month(np.float32)
    mf = geo_fields(((g1[:N_CG], z1[:N_CG], "XCO2"), (g2[:N_CG], z2[:N_CG], "SIF")))
    mod32 = MultivariateMatern(params=MaternParams.from_flat(torch.tensor(LARGE_INIT,
                                                                          dtype=torch.float32)))
    cells = pc.astype(np.float32)

    def big(on):
        p = IterativeJointPredictor(mod32, mf, block=512, rhs_batch=K_CG_CELLS, tol=1e-3, maxiter=40,
                                    mesh=on)
        return p(1, cells), p.last_diagnostics

    one, d1 = k_stage(stages, launches, "cg_float32", lambda: big(None), {"matern_corr_pairs": 1})
    got, d4 = k_stage(stages, launches, "cg_float32_mesh", lambda: big(mesh), pairs)
    check([d[0] for d in d4] == [d[0] for d in d1], f"(k) cg_float32: iterations {d4} vs {d1}")
    gap = k_same("cg_float32", [(got.pred, one.pred), (got.pred_err, one.pred_err)], math.inf,
                 norm=True)
    log(f"(k) cg_float32: 2 x {N_CG}, {K_CG_CELLS} cells, 40 iterations: (iterations, residual) "
        f"{d1} / sharded {d4}; gap / max {gap:.3e} (logged); {mesh.size} shards "
        f"{stages['cg_float32_mesh']:.3f} s, one device {stages['cg_float32']:.3f} s")


def k_bootstrap(mesh, one_card, stages, launches):
    """The parametric bootstrap on (i)'s 2 x 12,500 spectral sample (8
    replicates, maxiter 30, float64) with its refit sharded: bit-equal to
    the unsharded bootstrap, walls logged; on the one-card mesh (4
    replicates, maxiter 20) bit-equal too."""
    from cokriging_tpu_torch.estimate import bootstrap as TB
    from cokriging_tpu_torch.estimate.empirical import VarioConfig
    from cokriging_tpu_torch.fields.field import Field, MultiField

    if "i_spectral" not in SHARED:
        SHARED["i_spectral"] = phase_i_spectral({}, {}, [])[::2]
    mod, samples = SHARED["i_spectral"]
    mf = MultiField(fields=[Field.from_arrays(s[["x", "y"]].values, s[f"Z{k}"].values, f"Z{k}")
                            for k, s in enumerate(samples)])
    cfg = VarioConfig(max_dist=I_MAX_DIST, n_bins=15, geodesic=False)
    passes = {"variogram_minmax": 1, "variogram_bin_batch": 1}

    def boot(on, n_rep=K_BOOT_REP, maxiter=K_BOOT_MAXITER):
        return TB.parametric_bootstrap(mod, mf, cfg, n_rep=n_rep, seed=3, maxiter=maxiter, mesh=on)

    one = k_stage(stages, launches, "bootstrap", lambda: boot(None), passes)
    got = k_stage(stages, launches, "bootstrap_mesh", lambda: boot(mesh), passes)
    k_same("bootstrap", [(got.flats, one.flats), (got.costs, one.costs)])
    k_same("bootstrap one-card mesh", [(a, b) for x, y in ((boot(one_card, *K_BOOT_ONE_CARD),
                                                            boot(None, *K_BOOT_ONE_CARD)),)
                                       for a, b in ((x.flats, y.flats), (x.costs, y.costs))])
    log(f"(k) bootstrap: {K_BOOT_REP} replicates, maxiter {K_BOOT_MAXITER}, 2 x {I_N}: bit-equal; "
        f"{mesh.size} shards in lockstep {stages['bootstrap_mesh']:.2f} s, unsharded "
        f"{stages['bootstrap']:.2f} s; finite {bool(np.isfinite(one.flats).all())}")


def phase_k():
    """The sharded paths on the card; returns its rows of the kernels line."""
    import torch

    from cokriging_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    mesh = make_mesh(K_SHARDS, device="cuda")
    one_card = make_mesh()
    check(one_card.size == torch.cuda.device_count(), "(k) make_mesh() is not every card")
    stages, launches = {}, {}
    rows = k_variograms(mesh, one_card, stages, launches)
    for part in (k_local, k_vecchia, k_cg, k_bootstrap):
        part(mesh, one_card, stages, launches)
        log(f"(k) {part.__name__} done, {time.perf_counter() - t0:.1f} s into (k)")
        torch.cuda.empty_cache()
    log(f"(k) stages (s) {json.dumps({k: round(v, 4) for k, v in stages.items()})}")
    log(f"(k) launches per stage {json.dumps(launches)}")
    log(f"(k) seconds {time.perf_counter() - t0:.1f}")
    return rows


# --- phase (l): the serving export, the simulation experiment, the entry ------

L_CPU_CELLS = 256  # cells at which the card's f64 artifact is held against the CPU
L_FRESH = (1.1, 0.5)  # fresh runtime inputs: the flat vector x 1.1, process 0's values x 0.5
L_DISPATCH_CALLS = 2000  # calls per timing of the pairs op's dispatch against its launch
L_CG_LAUNCHES = 3921  # (g)'s CG launches per prediction (PERF.md section 6)
# the JAX simulation manifest's statistics keys, which the port's manifest carries
L_SIM_KEYS = ("truth_flat", "wls_flat", "nll_flat", "vecchia_flat", "mspe", "loocv_coverage_95",
              "loocv_z_std", "stage_s")


def l_month(dtype, scale0=1.0):
    """(d)'s month as (d)'s predictor takes it (every 62nd of the 2 x 12,500
    observations, ~202 per field), process 0's values times ``scale0``."""
    c1, v1, c2, v2 = build_inputs(N_PER_PROC, dtype)
    sub = max(1, N_PER_PROC // 200)
    return geo_fields(((c1[::sub], v1[::sub] * dtype(scale0), "Z0"), (c2[::sub], v2[::sub], "Z1")))


def l_predictor(dtype, scale=(1.0, 1.0), device=None):
    """The direct-assembly local predictor of (d)'s month under (k)'s model
    (the flat vector times ``scale[0]``, process 0's values times
    ``scale[1]``)."""
    import torch

    from cokriging_tpu_torch.cov.matern import MultivariateMatern
    from cokriging_tpu_torch.cov.params import MaternParams
    from cokriging_tpu_torch.predict.local import LocalPredictor

    td = getattr(torch, np.dtype(dtype).name)
    flat = torch.tensor(K_PARAMS, dtype=td) * scale[0]
    return LocalPredictor(MultivariateMatern(params=MaternParams.from_flat(flat)),
                          l_month(dtype, scale[1]), materialize_cov=False,
                          neighbor_method="device", device=device)


def l_same(what, got, want):
    """Bit-equal (NaN where NaN) outputs; the largest gap otherwise, for the
    failure message."""
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        same = g.shape == w.shape and np.array_equal(g, w, equal_nan=g.dtype.kind == "f")
        gap = float(np.nanmax(np.abs(g.astype(np.float64) - w))) if g.shape == w.shape else None
        check(same, f"(l) {what}: output {k} not bit-equal to the live predictor (largest gap {gap})")


def l_dispatch(stages):
    """Host microseconds per call of the pairs forward through the
    registered op against its bare ctypes launch (the wrapper before the op
    existed), one entry, in turns bare / op / op / bare."""
    import torch

    from cokriging_tpu_torch.kernels import cuda_ops as K

    nu = torch.tensor([1.5], dtype=torch.float32, device="cuda")
    ls = torch.tensor([500.0], dtype=torch.float32, device="cuda")
    h = torch.full((1,), 100.0, dtype=torch.float32, device="cuda")
    idx = torch.zeros_like(h)
    table = K.recurrence_table(nu, ls, torch.float32)
    runs = {"bare": lambda: K._pairs_forward_launch(nu, ls, idx, h, table, True),
            "op": lambda: K.matern_corr_pairs(nu, ls, idx, h, table=table)}
    us = {"bare": [], "op": []}
    for kind in ("bare", "op", "op", "bare"):
        runs[kind]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(L_DISPATCH_CALLS):
            runs[kind]()
        torch.cuda.synchronize()
        us[kind].append(1e6 * (time.perf_counter() - t0) / L_DISPATCH_CALLS)
    extra = min(us["op"]) - min(us["bare"])
    stages["dispatch_us"] = us
    log(f"(l) pairs forward, host us per call (one entry, {L_DISPATCH_CALLS} calls, bare / op / op / "
        f"bare): {us['bare'][0]:.2f} / {us['op'][0]:.2f} / {us['op'][1]:.2f} / {us['bare'][1]:.2f}; "
        f"the op adds {extra:.2f} us per launch, {extra * L_CG_LAUNCHES / 1e6:.4f} s over (g)'s "
        f"{L_CG_LAUNCHES} CG launches")


def l_cpu_cells(n):
    """The cells at which the card's f64 artifact is held against the CPU."""
    return np.linspace(0, n - 1, L_CPU_CELLS).astype(int)


def l_export_job(dtype_name):
    """(worker process) One dtype's artifact of (d)'s month exported on the
    card at the live predictor's batch size: (bytes, export seconds, batch,
    widths)."""
    import torch

    from cokriging_tpu_torch.data.grids import prediction_coords
    from cokriging_tpu_torch.utils.export import export_program, make_local_prediction_fn

    dtype = np.dtype(dtype_name).type
    lp = l_predictor(dtype)
    pc = prediction_coords().astype(dtype)
    module, (flat, _, *values) = make_local_prediction_fn(lp, 0, pc, max_dist=K_LOCAL_KM)
    batch = lp._batch_size(module.k_each, len(pc))
    first = np.concatenate([pc, np.repeat(pc[-1:], max(0, batch - len(pc)), axis=0)])[:batch]
    t0 = time.perf_counter()
    blob = export_program(module, (flat, torch.as_tensor(first, device="cuda"), *values),
                          platforms=["cuda"])
    return blob, time.perf_counter() - t0, batch, module.k_each


def l_cpu_job(_):
    """(worker process) The float64 live predictor on the CPU at
    ``l_cpu_cells``: (pred, pred_err, n_neighbors, seconds)."""
    import torch

    from cokriging_tpu_torch.data.grids import prediction_coords

    torch.set_num_threads(2)
    pc = prediction_coords()
    t0 = time.perf_counter()
    out = l_predictor(np.float64, device="cpu")(0, pc[l_cpu_cells(len(pc))], max_dist=K_LOCAL_KM)
    return out.pred, out.pred_err, out.n_neighbors, time.perf_counter() - t0


def l_served(stages, rows, exported, cpu_out):
    """1. The served artifact of (d)'s month: ``LocalPredictor(
    materialize_cov=False)`` on the card, ``exported`` at the live
    predictor's batch size (bytes from ``l_export_job``), loaded, serving all
    land cells batch by batch (the last batch padded) in both dtypes, each
    bit-equal to the live predictor on the same batches, the pairs kernel
    launched once per served batch; fresh runtime inputs against the live
    predictor on them; the f64 artifact against the CPU predictor
    (``cpu_out``) at ``L_CPU_CELLS`` cells (1e-9 of the largest value). Rows
    of the kernels line: the pairs forward at one served batch's launch."""
    import torch

    from cokriging_tpu_torch.data.grids import prediction_coords
    from cokriging_tpu_torch.kernels import cuda_ops as K
    from cokriging_tpu_torch.utils.export import load_program, make_local_prediction_fn

    pc_all = prediction_coords()
    for dtype in (np.float32, np.float64):
        name = np.dtype(dtype).name
        atol = 5e-6 if name == "float32" else 1e-12
        blob, stages[f"export_{name}"], batch, k_each = exported[name]
        lp = l_predictor(dtype)
        pc = pc_all.astype(dtype)
        n = len(pc)
        _, (flat, _, *values) = make_local_prediction_fn(lp, 0, pc[:1], max_dist=K_LOCAL_KM)
        n_pad = -(-n // batch) * batch
        check(lp._batch_size(k_each, n_pad) == batch, "(l) padding changed the batch size")
        pc_pad = np.concatenate([pc, np.repeat(pc[-1:], n_pad - n, axis=0)])
        pcs = torch.as_tensor(pc_pad, device="cuda")
        check(tuple(k_each) == tuple(lp._neighborhood_widths(pcs, K_LOCAL_KM)),
              f"(l) {name}: the exported widths are not the live predictor's")
        t0 = time.perf_counter()
        fn = load_program(blob)
        stages[f"load_{name}"] = time.perf_counter() - t0

        def serve(flat, values):
            outs = [fn(flat, pcs[s:s + batch], *values) for s in range(0, n_pad, batch)]
            return [torch.cat([o[k] for o in outs]).cpu().numpy() for k in range(3)]

        t0 = time.perf_counter()
        serve(flat, values)  # the loaded program's first call
        stages[f"first_served_{name}"] = time.perf_counter() - t0
        K.reset_launch_counts()
        t0 = time.perf_counter()
        got = serve(flat, values)
        stages[f"served_{name}"] = time.perf_counter() - t0
        served = K.launch_counts()["matern_corr_pairs"]
        check(served == n_pad // batch, f"(l) {name}: {served} pairs launches in "
              f"{n_pad // batch} served batches")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        live = lp(0, pc, max_dist=K_LOCAL_KM)
        stages[f"live_{name}"] = time.perf_counter() - t0
        with captured("matern_corr_pairs", 1) as calls:
            live_pad = lp(0, pc_pad, max_dist=K_LOCAL_KM)
        l_same(f"{name} served", got, (live_pad.pred, live_pad.pred_err, live_pad.n_neighbors))
        tail = max(float(np.nanmax(np.abs(g[:n].astype(np.float64) - w)))
                   for g, w in zip(got[:2], (live.pred, live.pred_err)))
        finite = float(np.isfinite(got[0][:n]).mean())
        check(finite > 0.99, f"(l) {name}: only {finite:.2%} finite served predictions")
        # fresh runtime inputs through the same artifact
        f_flat, f_scale = L_FRESH
        fresh = serve(flat * f_flat, (values[0] * f_scale, *values[1:]))
        live_fresh = l_predictor(dtype, L_FRESH)(0, pc_pad, max_dist=K_LOCAL_KM)
        l_same(f"{name} served on fresh inputs", fresh,
               (live_fresh.pred, live_fresh.pred_err, live_fresh.n_neighbors))
        check(not np.allclose(fresh[0][:n], got[0][:n], equal_nan=True),
              f"(l) {name}: fresh inputs did not change the served predictions")
        log(f"(l) {name}: served {n} cells in {n_pad // batch} batches of {batch} (widths "
            f"{tuple(k_each)}), bit-equal to the live predictor, fresh inputs too; finite "
            f"{finite:.4%}; export {stages[f'export_{name}']:.2f} s (a worker process), load "
            f"{stages[f'load_{name}']:.2f} s, artifact {len(blob)} bytes; served "
            f"{stages[f'served_{name}']:.4f} s, live {stages[f'live_{name}']:.4f} s; pairs launches "
            f"{served}; largest gap to the unpadded live call {tail:.3e}")
        if name == "float64":
            idx = l_cpu_cells(n)
            stages["cpu_live_float64"] = cpu_out[3]
            for k, w in enumerate(cpu_out[:2]):
                g = got[k][idx]
                check(np.array_equal(np.isfinite(g), np.isfinite(w)), "(l) f64 vs CPU: NaN lanes")
                gap = float(np.nanmax(np.abs(g - w))) / float(np.nanmax(np.abs(w)))
                check(gap <= 1e-9, f"(l) the card's f64 artifact vs the CPU predictor, output {k}: "
                      f"{gap:.3e} of the largest value (bar 1e-9)")
                log(f"(l) f64 artifact on the card vs the CPU predictor at {L_CPU_CELLS} cells, "
                    f"output {k}: {gap:.3e} of the largest value")
            check(np.array_equal(got[2][idx], cpu_out[2]), "(l) f64 vs CPU: neighborhood sizes")
        err, ms, plain_ms = pairs_forward_check(calls, atol, f"one {name} served batch")
        a = calls[0]
        bound = bound_of([pairs_bound([(a[3], a[2])], a[0].tolist(), a[1].tolist())])
        rows.append(dict(
            name=f"matern_corr_pairs_{name}_served", route="cuda",
            source="cokriging_tpu_torch/kernels/csrc/matern_pairs.cu",
            replaces="cokriging_tpu/kernels/pallas_ops.py:631", launches=served, ms=ms,
            plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1], library_ms=None,
            max_abs_err=err, max_err=err,
            path="(l) the served local-prediction artifact (torch.export), through the "
                 "registered op cokriging_tpu_torch::matern_corr_pairs",
            shape=f"one served batch {tuple(a[3].shape)}"))
        log(f"(l) {name}: pairs at one served batch {tuple(a[3].shape)}: {ms:.3f} ms, plain "
            f"{plain_ms:.1f} ms, bound {bound[0]:.4f} ms ({bound[1]}), max abs err {err:.3e}")
        del fn, blob, lp, calls
        torch.cuda.empty_cache()


@contextlib.contextmanager
def l_sim_started():
    """2. ``python -m cokriging_tpu_torch sim --device cuda`` at the
    experiment's sizes, started in a subprocess with its results in a
    temporary directory; killed if still running when the block ends."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        env = {**os.environ, "PYTHONPATH": str(HERE), "COKRIGING_RESULTS_DIR": tmp}
        env.pop("COKRIGING_NO_RECORD", None)
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "cokriging_tpu_torch", "sim", "--device",
                                 "cuda"], cwd=HERE, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        try:
            yield dict(proc=proc, tmp=Path(tmp), t0=t0)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def l_sim(sim, stages):
    """The sim subprocess's end: exit 0 (the Vecchia assertion inside), only
    ``torch_*`` names written, the JAX manifest's statistics keys; its
    statistics logged beside the JAX manifest's (the same realization: the
    experiment reproduces the JAX script's draws)."""
    out, err = sim["proc"].communicate(timeout=900)
    stages["sim_cli"] = time.perf_counter() - sim["t0"]
    check(sim["proc"].returncode == 0, f"(l) sim --device cuda: exit {sim['proc'].returncode}: "
          f"{out[-1500:]} {err[-1500:]}")
    tmp = sim["tmp"]
    written = sorted(str(p.relative_to(tmp)) for p in tmp.rglob("*") if p.is_file())
    check(written and all(Path(w).name.startswith("torch_") for w in written),
          f"(l) sim wrote {written}")
    manifest = json.loads((tmp / "torch_simulation_experiment.json").read_text())
    missing = [k for k in L_SIM_KEYS if k not in manifest]
    check(not missing, f"(l) the sim manifest lacks {missing}")
    check(manifest["vecchia_rho_gap"] < 0.25, f"(l) sim: Vecchia rho gap {manifest['vecchia_rho_gap']}")
    jax_path = HERE / "results" / "simulation_experiment.json"
    ref = json.loads(jax_path.read_text()) if jax_path.exists() else {}
    log(f"(l) sim --device cuda: {stages['sim_cli']:.1f} s in all (beside the export workers); "
        f"device {manifest.get('device_name')} at {manifest.get('power_limit')}, dtype "
        f"{manifest['dtype']}, figures written: {manifest['figures']}; stage seconds "
        f"{json.dumps(manifest['stage_s'])}")
    log(f"(l) sim: WLS {manifest['wls_flat']}, NLL {manifest['nll_flat']}, Vecchia "
        f"{manifest['vecchia_flat']} (rho gap {manifest['vecchia_rho_gap']}), truth "
        f"{manifest['truth_flat']}; JAX manifest: WLS {ref.get('wls_flat')}, NLL "
        f"{ref.get('nll_flat')}, Vecchia {ref.get('vecchia_flat')}")
    log(f"(l) sim: MSPE cokriging / kriging {manifest['mspe']} (JAX manifest {ref.get('mspe')}); "
        f"LOOCV 95% coverage {manifest['loocv_coverage_95']} (JAX {ref.get('loocv_coverage_95')}), "
        f"z std {manifest['loocv_z_std']} (JAX {ref.get('loocv_z_std')}); written {written}")


def l_entry(stages):
    """3. ``entry("cuda")``'s joint-cokriging step against the same step on
    the CPU on the same arguments (f64; the prediction within 1e-10 of its
    largest value, the variance, whose round-off at cells that hold data the
    square root lifts, within 1e-10 of its largest value), the Matern kernel
    launched; then ``dryrun_multichip(4, device="cuda")`` on four virtual
    shards of the card, its OK line printed and every kernel of its path
    launched."""
    import io

    import torch

    from cokriging_tpu_torch.entry import dryrun_multichip, entry
    from cokriging_tpu_torch.kernels import cuda_ops as K

    fn, args = entry("cuda")
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    card = [o.cpu().numpy() for o in fn(*args)]
    stages["entry_card"] = time.perf_counter() - t0
    launches = K.launch_counts()
    check(launches["matern_correlation"] > 0, f"(l) entry launched no Matern kernel: {launches}")
    t0 = time.perf_counter()
    host = [o.numpy() for o in fn(*[a.cpu() for a in args])]
    stages["entry_cpu"] = time.perf_counter() - t0
    gaps = [float(np.max(np.abs(card[0] - host[0]))) / float(np.max(np.abs(host[0]))),
            float(np.max(np.abs(card[1] ** 2 - host[1] ** 2))) / float(np.max(host[1] ** 2))]
    check(all(np.isfinite(c).all() for c in card) and max(gaps) <= 1e-10,
          f"(l) entry on the card vs the CPU: pred / variance {gaps} of the largest value")
    log(f"(l) entry: {tuple(card[0].shape)} predictions, card {stages['entry_card']:.3f} s vs CPU "
        f"{stages['entry_cpu']:.3f} s, pred / variance gap {gaps[0]:.3e} / {gaps[1]:.3e} of the "
        f"largest value; launches {launches}")
    buf = io.StringIO()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        dryrun_multichip(4, device="cuda")
    torch.cuda.synchronize()
    stages["dryrun_4"] = time.perf_counter() - t0
    launches = K.launch_counts()
    line = buf.getvalue().strip().splitlines()[-1] if buf.getvalue().strip() else ""
    check(line.startswith("dryrun_multichip OK on 4 devices"), f"(l) dryrun printed {buf.getvalue()!r}")
    need = ("variogram_minmax", "variogram_bin", "matern_correlation", "matern_corr_pairs",
            "matern_corr_pairs_grad")
    check(all(launches[k] > 0 for k in need), f"(l) dryrun: a kernel of its path never ran: {launches}")
    log(f"(l) {line} ({stages['dryrun_4']:.1f} s; launches {launches})")


def phase_l():
    """The serving export, the simulation experiment and the entry points on
    the card; returns its rows of the kernels line. The host-bound steps run
    side by side: the two exports (tracing) and the CPU predictor in spawned
    worker processes and the ``sim`` subprocess, while this process runs the
    entry points; the served artifacts are timed after all of them end."""
    import multiprocessing

    t0 = time.perf_counter()
    stages, rows = {}, []
    l_dispatch(stages)
    with multiprocessing.get_context("spawn").Pool(3) as pool, l_sim_started() as sim:
        exports = {name: pool.apply_async(l_export_job, (name,)) for name in ("float32", "float64")}
        cpu = pool.apply_async(l_cpu_job, (None,))
        l_entry(stages)
        l_sim(sim, stages)
        exported = {name: r.get(timeout=900) for name, r in exports.items()}
        cpu_out = cpu.get(timeout=900)
    log(f"(l) workers and sim done, {time.perf_counter() - t0:.1f} s into (l)")
    l_served(stages, rows, exported, cpu_out)
    log(f"(l) stages (s) {json.dumps({k: v if isinstance(v, dict) else round(v, 4) for k, v in stages.items()})}")
    log(f"(l) seconds {time.perf_counter() - t0:.1f}")
    return rows


def main(phases="abcdefghijkl"):
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
    t_start = time.perf_counter()
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
        import cokriging_tpu_torch.cov.spectral  # noqa: F401
        import cokriging_tpu_torch.estimate.bootstrap  # noqa: F401
        import cokriging_tpu_torch.estimate.empirical  # noqa: F401
        import cokriging_tpu_torch.estimate.nll  # noqa: F401
        import cokriging_tpu_torch.estimate.uncertainty  # noqa: F401
        import cokriging_tpu_torch.estimate.vecchia  # noqa: F401
        import cokriging_tpu_torch.estimate.wls  # noqa: F401
        import cokriging_tpu_torch.predict.iterative  # noqa: F401
        import cokriging_tpu_torch.predict.joint  # noqa: F401
        import cokriging_tpu_torch.predict.local  # noqa: F401
        import cokriging_tpu_torch.predict.postprocess  # noqa: F401
        import cokriging_tpu_torch.sim.cofield  # noqa: F401
        import cokriging_tpu_torch.sim.spectral  # noqa: F401
        import cokriging_tpu_torch.stats.spacetime  # noqa: F401
        import cokriging_tpu_torch.utils.io  # noqa: F401
        import cokriging_tpu_torch.parallel  # noqa: F401
        import cokriging_tpu_torch.data.readers  # noqa: F401
        import cokriging_tpu_torch.entry  # noqa: F401
        import cokriging_tpu_torch.experiments.simulation_experiment  # noqa: F401
        import cokriging_tpu_torch.utils.export  # noqa: F401
        from cokriging_tpu_torch.__main__ import _parser  # noqa: F401
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

        # (c) kernels against their plain versions, then small whole paths
        kres = {}
        rows, bigs, large_vario = [], [], []
        if "c" in phases:
            for dtype in (np.float32, np.float64):
                c1, v1, c2, v2 = build_inputs(N_PER_PROC, dtype)
                phase_c_variogram(c1, v1, c2, v2, dtype, kres)
                phase_c_variogram_stress(dtype, kres)
                phase_c_matern(c1, c2, dtype, kres)
                phase_c_block_grad(c1, c2, dtype, kres)
                phase_c_pairs(dtype, kres)
                phase_c_partition(dtype, kres)
                phase_c_hess_edges(dtype, kres)
            for small in (phase_c_small_path, phase_c_small_nll, phase_c_small_large_n):
                log(f"(c) elapsed since start {time.perf_counter() - t_start:.1f} s")
                small()
            log(f"(c) elapsed since start {time.perf_counter() - t_start:.1f} s")

        # (d) the main path at bench size, float32 then float64
        pc = prediction_coords()
        for dtype in (np.float32, np.float64) if "d" in phases else ():
            name = np.dtype(dtype).name
            c1, v1, c2, v2 = build_inputs(N_PER_PROC, dtype, noise_seed=1)
            run_pipeline(c1, v1, c2, v2, pc.astype(dtype), dtype, "cuda", maxiter=WARMUP_MAXITER)
            _, v1b, _, v2b = build_inputs(N_PER_PROC, dtype, noise_seed=2)
            K.reset_launch_counts()
            steps = MAXITER if name == "float32" else MAXITER_F64
            params, result, out, times, lp = run_pipeline(c1, v1b, c2, v2b, pc.astype(dtype), dtype,
                                                          "cuda", maxiter=steps)
            times["fit_ms_per_step"] = 1e3 * times["fit_s"] / steps
            launches = K.launch_counts()
            finite = float(np.isfinite(out.pred).mean())
            x = params.to_flat().cpu().numpy().astype(np.float64)
            lo, hi = params.spec.bounds()
            tol = 1e-6 * (hi - lo)
            counts_line = (f"(d) {name}: variogram counts per pair {times.pop('counts_per_pair')}, "
                           f"sha256 {times.pop('counts_sha256')}")
            log(f"(d) {name}: stages {json.dumps(times)}")
            log(counts_line)
            log(f"(d) {name}: launches {launches}, finite predictions {finite:.4%} of {len(out.pred)}, "
                f"fit cost {result.cost:.6g}, params {np.array2string(x, precision=5)}")
            check(all(launches[k] > 0 for k in ("variogram_minmax", "variogram_bin", "matern_correlation")),
                  f"(d) {name}: a kernel of this path never ran: {launches}")
            check_predictions(lp, out, pc, name)
            check(bool(np.all((x >= lo - tol) & (x <= hi + tol))), f"(d) {name}: params out of bounds")
            # (e) kernel timing at the path's shapes
            r, big = phase_e(c1, v1b, c2, v2b, dtype, launches, kres)
            rows += r
            bigs.append(big)
            # the variogram passes alone at the large-n example's size
            large_vario += vario_rows(*build_inputs(N_LARGE, dtype), dtype, launches,
                                      f"3 pairs x {N_LARGE} points x 15 bins", 5, 1)
        for r in large_vario:
            log(f"(e) {r['name']} at {r['shape']}, kernel only: {r['ms']:.3f} ms, plain "
                f"{r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
                f"{r['bound_ms_edge_scan']:.4f} ms under the edge scan's count), k_cmp "
                f"{r['k_cmp']}, {r['pairs']} pairs, {r['binned']} binned")
        for big in bigs:
            log(f"(e) matern 12,500^2 symmetric {big['dtype']}: {big['ms']:.3f} ms "
                f"[recorded before the redesign {RECORDED_BIG_MS[big['dtype']]} ms], plain {big['plain_ms']:.3f} ms, bound "
                f"{big['bound_ms']:.4f} ms ({big['bound_by']}), max abs err against the plain version "
                f"{big['max_abs_err']:.3e}")

        log(f"(d), (e) elapsed since start {time.perf_counter() - t_start:.1f} s")
        # (f) the exact-likelihood path at bench size, float32 then float64
        for dtype in (np.float32, np.float64) if "f" in phases else ():
            rows += phase_f(dtype, pc, kres)
        log(f"(f) elapsed since start {time.perf_counter() - t_start:.1f} s")
        # (g) the large-n path at the JAX example's size, float32 then float64
        for dtype in (np.float32, np.float64) if "g" in phases else ():
            rows += phase_g(dtype, kres)
            log(f"(g) elapsed since start {time.perf_counter() - t_start:.1f} s")
        # (h) the table-to-map workflow at bench size, float32 then float64
        t_h = time.perf_counter()
        for dtype in (np.float32, np.float64) if "h" in phases else ():
            rows += phase_h(dtype, kres)
            log(f"(h) elapsed since start {time.perf_counter() - t_start:.1f} s")
        if "h" in phases:
            phase_h_cli()
            log(f"(h) seconds {time.perf_counter() - t_h:.1f}; elapsed since start "
                f"{time.perf_counter() - t_start:.1f} s")
        # (i) simulation and the parametric bootstrap
        if "i" in phases:
            rows += phase_i()
            log(f"(i) elapsed since start {time.perf_counter() - t_start:.1f} s")
        # (j) parameter uncertainty
        if "j" in phases:
            rows += phase_j()
            log(f"(j) elapsed since start {time.perf_counter() - t_start:.1f} s")
        # (k) the sharded paths
        if "k" in phases:
            rows += phase_k()
            log(f"(k) elapsed since start {time.perf_counter() - t_start:.1f} s")
        # (l) the serving export, the simulation experiment, the entry points
        if "l" in phases:
            rows += phase_l()
            log(f"(l) elapsed since start {time.perf_counter() - t_start:.1f} s")
    except SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    for r in rows:
        if r["name"] in REDESIGNED:
            src, kernel, recorded = REDESIGNED[r["name"]]
            r["ptxas"] = ptxas_of(info["ptxas"], src, kernel)
            extra = ""
            if "one_launch_ms" in r:
                extra = (f"; one launch {r['one_launch_ms']:.3f} ms [recorded before the redesign "
                         f"{RECORDED_ONE_LAUNCH_MS[r['name'].split('_')[4]]} ms]")
            if "bound_ms_edge_scan" in r:
                extra += f"; bound under the edge scan's count {r['bound_ms_edge_scan']:.4f} ms"
            log(f"(e) redesigned {r['name']}: {r['ms']:.3f} ms [recorded before the redesign "
                f"{recorded if recorded is not None else 'none'} ms]{extra}, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), launches {r['launches']}; ptxas {r['ptxas']}")
    print(json.dumps({"kernels": rows}))
    if phases != "abcdefghijkl":
        print(f"partial run of phases {phases}: no result")
        return 0
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:2]))
