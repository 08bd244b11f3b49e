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
    5e-6 / 1e-12), and the Matern block-gradient kernel with an asymmetric
    cotangent at a ragged 300 x 517 block, nu in {0.3, 0.5, 1.5, 2.7}, and a
    4096^2 symmetric block at nu = 1.5 (each of its four sums within 1e-5 /
    1e-12 of the sum of |terms|; symmetric == full), and the gathered-pairs kernels at
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
    float32 then float64. The float32 half is the port's ``bench``
    (``cokriging_tpu_torch.bench.main("cuda")``, in this process): a warm-up
    run (10 Adam steps), a timed run on fresh noise with the launch counts set
    to 0 just before it and read just after, then its NLL axis (float64, the
    point of (f), a warm-up and three timed evaluations); its JSON line is
    logged and checked (``d_bench``: bench.py's five keys and metric, a
    finite positive wall and rate, no timed NLL value at the penalty, 3 + 3
    launches per evaluation). The float64 half runs the same warm-up and
    timed month itself. In both, every kernel must have run, the fit must
    lie in its bounds, and the
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
    (``block_covariance_sync_free``), both kernels of the evaluation timed
    at its own three 12,500^2 blocks (symmetric, full, symmetric) and
    cotangent for this path's rows of the kernels line and held against
    their plain versions there (the bars of phase (c)) on 1,024-row slabs
    (``F_SLAB``: the Matern forward's first rows of each block, the block
    gradient at the cross block's first rows with their cotangent), the
    Matern forward timed and held there once more at nu = 1.37, where no
    CF2 lane leaves early (its own row), then a maximum-likelihood fit on the
    stride-5 subsample and joint prediction at every land cell with the
    fitted parameters; the joint predictor on all 2 x 12,500 observations in
    float64 runs once, its finite share printed. Phase (f) runs before the
    kernels line is printed, so its rows carry its counts;
(g) the large-n path at the size of the JAX package's example
    (examples/large_n_workflow.py: 2 x 60,000 synthetic CONUS observations),
    float32 then float64, at ``G_FIT`` (the example's float32 Vecchia fit,
    recorded; the host L-BFGS-B Vecchia fit runs in (m), at 1,000,000
    points): the Vecchia value + gradient (m = 20, chunk 4096, coarse order
    and kd neighbors) below the start's (the least of three after a warm-up;
    the launch counts of one equal the number of chunks);
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
    in subprocesses beside (k), checked after it; predict and loocv side by
    side) on tests/test_cli.py's staged tables
    against the same commands with ``--device cpu``, float64: parameters
    rtol 1e-6, columns atol 1e-6.

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
    tables (subprocesses beside (k), checked after it). Each stage runs
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
    the CPU's computed in a worker process started before (i), beside it,
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
    1e-9; float32 against the one-card mesh, logged; each chunk launched
    once) and ``fit_vecchia(mesh=)`` for 3 iterations in float64 (rtol
    1e-8); ``IterativeJointPredictor(mesh=)`` on 2 x 2,500 of the month with
    nuggets 0.1 (tol 1e-10, float64, rtol 1e-8) and on (g)'s 2 x 12,500 at
    256 cells (40 iterations, float32, sharded only: its iterations and
    finite predictions); the parametric bootstrap on (i)'s spectral sample
    (8 replicates, maxiter 30, float64) with its refit sharded and stepped
    in lockstep, bit-equal, both walls logged. The one-card mesh
    ``make_mesh()`` runs the variogram, local, float64 Vecchia and CG paths
    once more, bit-equal to no mesh (the CG on 2 x 2,560 rows, a multiple of
    its 512-row tile, at tol 1e-4). Each path keeps one unsharded twin, its
    smallest comparison. Its rows of the kernels line:
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

(m) the JAX package's million-point workflow (examples/million_point_workflow.py)
    on the port at its TPU manifest's size, float32:
    ``cokriging_tpu_torch.experiments.million_point_workflow.main("cuda")``
    with the launch counts set to 0 just before and read just after: the
    1024 x 1024 spectral cofield of [0, 100]^2 on the JAX manifest's own
    draws (its float32 normals, reproduced), 2 x 500,000 observations, the
    warm-start Vecchia fit on 2 x 30,000 (maxiter 100), the full fit (m =
    20, maxiter 30), the recovery gates (rho within 0.12, sigmas within 0.3)
    and direct local cokriging at 16,384 held-out cells within 0.8 (> 95%
    finite, coverage in (0.90, 0.995)). It logs the stage walls (simulate,
    each fit's host scaffold apart from its evaluations, the fits, predict),
    the evaluations and seconds per evaluation, the pairs launches per
    evaluation (checked: one forward and one gradient per chunk), the peak
    device memory per stage, and the run beside the JAX manifest with the
    differences. Its rows of the kernels line: the Matern forward at the
    three 2048^2 lag-grid blocks (f64, atol 1e-12), the pairs forward and
    gradient at the full fit's first 4,096-window chunk (5e-6; 1e-5 of the
    sum of |terms|) and the pairs forward at the first direct-local batch,
    each held against its plain version at the workflow's own call.

(n) the JAX repo's kriging-vs-cokriging comparison (examples/modelling_comparison.py)
    on the port at the script's sizes, float32:
    ``cokriging_tpu_torch.experiments.modelling_comparison.main("cuda")``
    with the launch counts set to 0 just before and read just after: six
    synthetic months of XCO2 and SIF frames on the 4 x 5-degree main grid
    (the joint covariance of the draw through the Matern kernel), the
    univariate SIF model (one variogram, a 600-step Adam fit, kriging at the
    6,256 land cells with the evi covariate, LOOCV) and the bivariate one
    (three variograms, a 600-step Adam fit, cokriging, LOOCV), each compute
    stage run twice (the script's warm repeat), the error-ratio frame merged
    on lat/lon at every cell. It checks the gates of
    tests/test_modelling_comparison.py (fitted rho < -0.15, over 100 cells,
    > 80% of them with a ratio below 1, median ratio < 0.95, cokriging's
    MSPE <= kriging's, 0 < mean prediction < 2), logs the stage seconds,
    launches and peak memory, the Adam milliseconds per step and the host's
    load, and the run beside the JAX manifest with the differences.
(o) the JAX repo's 71-month record (examples/full_record.py) at the script's
    card sizes, float32: ``cokriging_tpu_torch.experiments.full_record.main(
    "cuda")`` with the launch counts set to 0 just before and read just
    after: 72 synthetic months, the 71 months' fields and variograms (one
    launch per pass and month), one batched WLS fit of all 71 (3 starts
    each, rho within +-0.95, the Cauchy-Schwarz penalty, the parsimonious
    projection), cokriging maps of 3 months at every land cell; the script's
    gates (every cost finite, each map > 90% finite), the fit's iterations
    and seconds per iteration, the stages and the run beside the JAX
    manifest with the differences. In both phases the variogram passes (at
    the workflow's first calls, phase (c)'s float32 bars) and the Matern
    forward (at its first 16 calls, atol 5e-6) are held against their plain
    versions at the workflow's own calls: their rows of the kernels line.
(p) the JAX repo's Vecchia scaling curve (examples/vecchia_scaling.py) at its
    accelerator sizes, float32: ``cokriging_tpu_torch.experiments.
    vecchia_scaling.main("cuda")`` with the launch counts set to 0 just
    before and read just after: the script's CONUS draws at N = 100,000 /
    250,000 / 500,000 / 1,000,000, per N the host scaffold (coarse order, kd
    neighbours, windows; each step's seconds), a warm and three timed value +
    gradient evaluations (m = 20, chunks of 4,096 windows: one forward and
    one gradient launch per chunk and evaluation, checked), finite values and
    gradients, the log-log slopes of every time against N, the run beside the
    JAX package's TPU manifest, and the float32 value and gradient at N =
    100,000 against a float64 evaluation of the same windows
    (``P_VALUE_BAR`` per term, ``P_GRAD_BAR`` of the largest entry). Its rows:
    both pairs kernels at the first chunk of the timed evaluations at N =
    100,000, held against their plain versions there (5e-6; 1e-5 of the sum
    of |terms|).
(q) the JAX repo's trivariate demo (examples/trivariate_demo.py) at its
    sizes with its ``TRIVARIATE_DEMO_LOCAL=1`` branch, float64:
    ``cokriging_tpu_torch.experiments.trivariate_demo.main("cuda")`` with the
    launch counts set to 0 just before and read just after: the 41 x 41
    cofield of three processes on the JAX simulator's draws, six
    (cross-)variograms per draw (one launch per pass over all six, three
    draws pooled), the 21-parameter scipy WLS fit, the 3 x 3-block joint
    predictor against the p = 1 baseline, the local predictor at radius 0.5,
    then ``trivariate_demo.recovery("cuda")``, tests/test_trivariate.py's
    recovery fit on its own 31 x 31 data;
    every gate (cokriging's MSPE at most 1.02 times kriging's, the joint MSPE
    below 0.3, the local predictions finite and within 0.05 of the joint
    MSPE, the recovery fit's rho signs, rho within 0.25, sigma within 0.3,
    diagonal length scales within 0.1), its stages and launches per stage.
    Its rows: the variogram passes at the first draw's six variograms and the
    Matern forward at every block the demo launched, against their plain
    versions (rtol / atol 1e-12).
(r) the JAX repo's exact-NLL scaling curve (examples/nll_scaling.py) at its
    accelerator sizes, float32: ``cokriging_tpu_torch.experiments.
    nll_scaling.main("cuda")`` with the launch counts set to 0 just before and
    read just after: the script's point on the unit square at 2 x 2,500 /
    5,000 / 12,500, a warm and five timed value + gradient evaluations per
    size (three Matern and three block-gradient launches each, checked), ms
    per evaluation and evaluations per second, positive definiteness, and the
    float32 value and gradient at 2 x 2,500 against float64 on the same data
    (``R_VALUE_RTOL``, ``R_GRAD_BAR``). Its rows: both kernels at the first
    evaluation's three 2,500^2 blocks against their plain versions there
    (5e-6; 1e-5 of the sum of |terms|).

Against the time limit, host-bound work runs beside other phases: (h)'s and
(i)'s CLI subprocesses beside (k) (checked after it; their GPU memory is
small, where (h)'s and (i)'s own plain checks fill the card), (j)'s CPU
reference beside (i), (c)'s small paths' CPU halves (``c_small_cpu``) in a
worker beside (c)'s kernel checks, and (n)'s, (o)'s and (q)'s workflows in two
spawned worker processes on the card (``no_worker``: (n) and (o) in one, (q)
in the other, ``WORKER_GROUPS``) beside (l) and (m); their
kernel checks run in the workers, one worker at a time, once (m), (p) and
(r) are done and the card is free, and their output is printed after them
with the wait for them. The two timing curves, (p) and (r), run after (m) and
after the workers' workflows have ended (each wait is logged), with the card
to themselves; their
kernels are timed with a head start (``CURVE_HEAD_START_MS``), so the times are
the card's, the times as launched logged beside them.
Cuts of depth: (d)'s float64 Adam fit runs 200 of
bench.py's 600 steps (its per-step time is logged); (f) holds its kernels
against their plain versions on 1,024 x 12,500 slabs of its blocks, the
block gradient at the cross block's only (it times the kernels at all three
whole blocks); (k) keeps one unsharded twin per path (none for the float32
Vecchia evaluation and CG, none for the one-card bootstrap) and fits by
Vecchia for 3 iterations; (i) refits 4 replicates alone (2 per
dtype, in 4 worker processes), not 16; (j) holds the Hessian sums against
their plain version at the first of the three blocks only (the kernel's time
at all three is logged); (k)'s bootstrap runs 8 replicates, not 16; (g)
fits nothing (its float64 and float32 Vecchia fits, 25-49 s and ~8 s, gave way
to (m)): it evaluates at ``G_FIT``, recorded from its float32 fit; (c) holds
the block gradient against its plain version at the 4096^2 symmetric block at
nu = 1.5 only (the ragged block keeps all four nu).

``python3 chip_smoke.py abcg`` runs only the phases named (a and b always)
and prints no result line; ``python3 chip_smoke.py k`` runs (a), (b) and (k), ``python3
chip_smoke.py l`` (a), (b) and (l), ``python3 chip_smoke.py m`` (a), (b) and (m), ``python3
chip_smoke.py n`` / ``o`` / ``no`` / ``pqr`` (a), (b) and the workflows, in this process. The kernels line's rows of the kernels
redesigned last (the variogram passes, the block forward and the pairs
gradient) carry their ptxas registers, static shared memory and spills from
this run's build; a log line beside each gives the
time recorded for the kernel before the redesign, which is not part of the
kernels line.

The last line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
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
# the float64 Adam fit of (d) is cut to this many steps (its per-step time is
# reported; float32, the port's ``bench``, keeps bench.py's 600)
MAXITER_F64 = 200

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


# cleanups of the work started ahead of its phase (worker pools, background
# subprocesses), run when ``main`` ends however it ends
BACKGROUND = []


class CliChain:
    """``python -m cokriging_tpu_torch`` commands run in the background from
    this script's directory, in stages: a stage's commands ({name: argv})
    run side by side, and the next stage starts once all of them exited with
    code 0. ``wait()`` returns {name: (exit code, stdout, stderr, seconds)};
    the processes are killed when ``main`` ends."""

    def __init__(self, stages):
        import threading

        self.results, self.procs = {}, []
        self._thread = threading.Thread(target=self._run, args=(stages,), daemon=True)
        self._thread.start()
        BACKGROUND.append(self.kill)

    def _run(self, stages):
        import os
        import threading

        env = {**os.environ, "PYTHONPATH": str(HERE)}

        def finish(name, proc, t0):
            try:
                out, err = proc.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
            self.results[name] = (proc.returncode, out, err, time.perf_counter() - t0)

        for stage in stages:
            waits = []
            for name, argv in stage.items():
                proc = subprocess.Popen([sys.executable, "-m", "cokriging_tpu_torch", *argv],
                                        cwd=HERE, env=env, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True)
                self.procs.append(proc)
                waits.append(threading.Thread(target=finish, args=(name, proc, time.perf_counter())))
                waits[-1].start()
            for w in waits:
                w.join()
            if any(self.results[name][0] != 0 for name in stage):
                return

    def wait(self, timeout=900):
        self._thread.join(timeout)
        return self.results

    def kill(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
        self._thread.join(60)


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


# --- bench.py's month and the port's main path (cokriging_tpu_torch/bench.py) ---


def build_inputs(n, dtype, noise_seed=1):
    """bench.py's synthetic CONUS month at ``n`` observations per process
    (``cokriging_tpu_torch.bench.build_inputs``)."""
    from cokriging_tpu_torch import bench

    return bench.build_inputs(dtype, noise_seed, n=n)


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


C_SMALL_N = 400  # per process: (c)'s small paths
C_SMALL_FLAT = [1.0, 1.0, 1.4, 1.3, 1.2, 500.0, 450.0, 550.0, 0.05, 0.04, -0.3]
C_CPU_THREADS = 4  # the CPU halves' worker, beside (c)'s kernel checks


def small_path(device):
    """(c)'s small fit + local prediction on ``device``, float64, from nu =
    1.4 (off the half-integer orders, where the reference's dK/dnu jumps):
    (fitted flat, LocalPrediction)."""
    from cokriging_tpu_torch.bench import run_pipeline
    from cokriging_tpu_torch.data.grids import prediction_coords

    c1, v1, c2, v2 = build_inputs(C_SMALL_N, np.float64)
    params, _, out, _, _ = run_pipeline(c1, v1, c2, v2, prediction_coords()[::10], np.float64, device,
                                        maxiter=50, nu_start=1.4)
    return params.to_flat().cpu().numpy(), out


def small_nll(device, analytic):
    """(c)'s small exact NLL at C_SMALL_FLAT on ``device``, float64: (value,
    gradient)."""
    import torch

    from cokriging_tpu_torch.cov.params import MaternParams
    from cokriging_tpu_torch.estimate.nll import joint_distance_blocks, neg_log_likelihood

    c1, v1, c2, v2 = build_inputs(C_SMALL_N, np.float64)
    coords = [torch.as_tensor(c, device=device) for c in (c1, c2)]
    dists = joint_distance_blocks(coords, geodesic=True)
    z = torch.as_tensor(np.concatenate([v1, v2]), device=device)
    x = torch.tensor(C_SMALL_FLAT, dtype=torch.float64, device=device, requires_grad=True)
    v = neg_log_likelihood(x, dists, z, MaternParams.default(2).spec, None, 1e-8, analytic_grad=analytic)
    (g,) = torch.autograd.grad(v, x)
    return v.item(), g.cpu().numpy()


def small_fields():
    """(c)'s small month as a geodesic MultiField and the model at
    C_SMALL_FLAT."""
    import torch

    from cokriging_tpu_torch.cov.matern import MultivariateMatern
    from cokriging_tpu_torch.cov.params import MaternParams

    c1, v1, c2, v2 = build_inputs(C_SMALL_N, np.float64)
    return (geo_fields(((c1, v1, "Z0"), (c2, v2, "Z1"))),
            MultivariateMatern(params=MaternParams.from_flat(torch.tensor(C_SMALL_FLAT,
                                                                          dtype=torch.float64))))


def small_vecchia(device):
    """(c)'s small Vecchia likelihood (m = 10, chunk 256) on ``device``,
    float64: (ordering, value, gradient at C_SMALL_FLAT)."""
    import torch

    from cokriging_tpu_torch.cov.params import MaternParams
    from cokriging_tpu_torch.estimate.vecchia import VecchiaLikelihood, vecchia_nll_value_and_grad

    c1, v1, c2, v2 = build_inputs(C_SMALL_N, np.float64)
    lik = VecchiaLikelihood([c1, c2], [v1, v2], m=10, geodesic=True, chunk=256, device=device)
    v, g = vecchia_nll_value_and_grad(torch.tensor(C_SMALL_FLAT, dtype=torch.float64, device=device),
                                      lik._win, MaternParams.default(2).spec, True, 256)
    return lik.perm, v.item(), g.cpu().numpy()


def small_few_cells():
    """Every 20th of the small local prediction's cells with data within 500
    km: where the CPU's plain K_nu runs it."""
    import torch

    from cokriging_tpu_torch.data.grids import prediction_coords
    from cokriging_tpu_torch.kernels.distance import haversine_matrix

    c1, _, c2, _ = build_inputs(C_SMALL_N, np.float64)
    pc = prediction_coords()[::10]
    near = haversine_matrix(torch.as_tensor(pc), torch.as_tensor(np.concatenate([c1, c2])))
    return pc[(near <= 500.0).any(dim=1).numpy()][::20]


SMALL_LOCAL_KINDS = {"mat": {}, "dir": dict(materialize_cov=False),
                     "kd": dict(materialize_cov=False, neighbor_method="kd")}


def small_local_few(device, kind):
    """(c)'s small local prediction of ``kind`` at ``small_few_cells`` within
    500 km on ``device``."""
    import warnings

    from cokriging_tpu_torch.predict.local import LocalPredictor

    mf, mod = small_fields()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return LocalPredictor(mod, mf, device=device, **SMALL_LOCAL_KINDS[kind])(
            0, small_few_cells(), max_dist=500.0, postprocess=False)


def c_small_cpu(_):
    """The CPU halves of (c)'s small paths, float64, computed in a worker
    process beside (c)'s kernel checks: {name: result}."""
    import torch

    from cokriging_tpu_torch.data.grids import prediction_coords
    from cokriging_tpu_torch.predict.joint import JointPredictor

    torch.set_num_threads(C_CPU_THREADS)
    mf, mod = small_fields()
    return {"path": small_path("cpu"), "nll": small_nll("cpu", True),
            "joint": JointPredictor(mod, mf, device="cpu")(0, prediction_coords()[::10],
                                                            postprocess=False),
            "vecchia": small_vecchia("cpu"),
            "dir": small_local_few("cpu", "dir"), "kd": small_local_few("cpu", "kd")}


def c_small_cpu_start():
    """``c_small_cpu`` started in a spawned worker process: (pool, pending)."""
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(1)
    BACKGROUND.append(pool.terminate)
    return pool, pool.apply_async(c_small_cpu, (None,))


def phase_c_small_path(cpu):
    """The whole path at 400 points per process on the card against the
    same code on the CPU (``cpu``: ``c_small_cpu``'s results), float64."""
    xg, o_gpu = small_path("cuda")
    xc, o_cpu = cpu["path"]
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
        # the 4096^2 symmetric block at nu = 1.5 only: its plain version is
        # this phase's costliest check ((f) holds the kernel at its path's
        # 12,500^2 cross block)
        for h, sym in ((ragged, False), (big, True)) if nu == 1.5 else ((ragged, False),):
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


def phase_c_small_nll(cpu):
    """The exact-likelihood path at 2 x 400 points on the card against the
    same code on the CPU (``cpu``: ``c_small_cpu``'s results), float64: NLL
    value and gradient (analytic branch both sides), analytic against
    plain-AD branch on the card, and the joint predictor."""
    from cokriging_tpu_torch.data.grids import prediction_coords
    from cokriging_tpu_torch.kernels import cuda_ops as K
    from cokriging_tpu_torch.predict.joint import JointPredictor

    K.reset_launch_counts()
    v_gpu, g_gpu = small_nll("cuda", True)
    counts = K.launch_counts()
    check(counts["matern_correlation"] == 3 and counts["matern_block_grad"] == 3,
          f"small NLL: launches {counts}")
    v_ad, g_ad = small_nll("cuda", False)
    v_cpu, g_cpu = cpu["nll"]
    check(abs(v_gpu - v_cpu) <= 1e-10 * abs(v_cpu), f"small NLL: value {v_gpu} vs CPU {v_cpu}")
    check(np.allclose(g_gpu, g_cpu, rtol=1e-7, atol=1e-10), f"small NLL: gradient {g_gpu} vs CPU {g_cpu}")
    check(abs(v_gpu - v_ad) <= 1e-10 * abs(v_ad) and np.allclose(g_gpu, g_ad, rtol=1e-7, atol=1e-10),
          f"small NLL: analytic {g_gpu} vs plain AD {g_ad} on the card")
    log(f"(c) small NLL card vs CPU f64: value {v_gpu:.12g}, rel err {abs(v_gpu - v_cpu) / abs(v_cpu):.3e}; "
        f"gradient max rel err {float(np.max(np.abs(g_gpu - g_cpu) / np.abs(g_cpu))):.3e}; "
        f"analytic vs plain AD on the card {float(np.max(np.abs(g_gpu - g_ad) / np.abs(g_ad))):.3e}")

    mf, mod = small_fields()
    pc = prediction_coords()[::10]
    out = {"cuda": JointPredictor(mod, mf, device="cuda")(0, pc, postprocess=False), "cpu": cpu["joint"]}
    err = float(max(np.max(np.abs(out["cuda"].pred - out["cpu"].pred)),
                    np.max(np.abs(out["cuda"].pred_err - out["cpu"].pred_err))))
    check(np.isfinite(out["cpu"].pred).all() and err <= 1e-8, f"small joint prediction: abs err {err}")
    log(f"(c) small joint prediction card vs CPU f64: {len(pc)} cells, abs err {err:.3e}")


BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "nll_evals_per_sec")


def d_bench():
    """Phase (d)'s float32 half: the port's ``bench`` in this process
    (``cokriging_tpu_torch.bench.main("cuda")``: its warm-up, its timed month
    with the launch counts set to 0 just before it and read just after, and
    its float64 NLL axis). Its JSON line is captured, logged and checked
    (bench.py's five keys and metric, a finite positive time and rate, the
    rounding of ``vs_baseline``, no penalty among the timed NLL values, 3 + 3
    launches per timed evaluation); returns ``main``'s results."""
    import io

    import torch

    from cokriging_tpu_torch import bench as B
    from cokriging_tpu_torch.estimate.nll import _penalty

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = B.main("cuda")
    secs = time.perf_counter() - t0
    printed = buf.getvalue().splitlines()
    check(len(printed) == 1, f"(d) bench printed {len(printed)} lines: {printed}")
    log(f"(d) bench: {printed[0]}")
    line = json.loads(printed[0])
    check(tuple(line) == BENCH_KEYS and line == res["line"], f"(d) bench line {line}")
    check(line["metric"] == B.METRIC and line["unit"] == "s" and res["dtype"] == "float32",
          f"(d) bench line {line}, fit + predict in {res['dtype']}")
    for key in ("value", "nll_evals_per_sec"):
        check(math.isfinite(line[key]) and line[key] > 0, f"(d) bench {key} {line[key]}")
    check(line["vs_baseline"] == round(B.TARGET_SECONDS / res["elapsed_s"], 3),
          f"(d) bench vs_baseline {line['vs_baseline']} for {res['elapsed_s']} s")
    nll = res["nll"]
    penalty = float(_penalty(2 * B.N_PER_PROC, torch.float64, "cpu"))
    check(all(math.isfinite(v) and v != penalty for v in nll["values"])
          and all(np.isfinite(g).all() and g.any() for g in nll["grads"]),
          f"(d) bench NLL values {nll['values']} (penalty {penalty})")
    n_evals = len(nll["values"])
    check(nll["launches"]["matern_correlation"] == 3 * n_evals
          and nll["launches"]["matern_block_grad"] == 3 * n_evals,
          f"(d) bench NLL: expected 3 + 3 launches per evaluation, got {nll['launches']}")
    log(f"(d) bench: {secs:.1f} s in all; timed month {res['elapsed_s']:.3f} s; NLL values "
        f"{nll['values']}, seconds {nll['seconds']}, launches {nll['launches']}")
    return res


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
        0, pc.astype(out.pred.dtype), max_dist=1_000.0, postprocess=False)
    finite0 = float(np.isfinite(out0.pred).mean())
    # the same fit projected onto the validity region (fit_wls's
    # project_validity=True), logged beside
    from cokriging_tpu_torch.cov.spectral import project_to_valid

    outp = LocalPredictor(MultivariateMatern(params=project_to_valid(lp.params)), lp.mf,
                          device=lp.device)(0, pc.astype(out.pred.dtype), max_dist=1_000.0,
                                            postprocess=False)
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


F_SLAB = 1_024  # rows of a 12,500^2 block at which (f) holds its kernels against the plain versions


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

        def grads_k():
            return [K.matern_block_grad(1.0, 0.1, nu, ls, hb, ct, symmetric=sym, table=rows[1])
                    for hb, ct, sym, nu, ls, rows in blocks]

        _, stages["block_grad_s"] = timed(grads_k)
        log(f"(f) {name}: stages of one evaluation {json.dumps(stages)} "
            f"(sum {sum(stages.values())}, whole evaluation {tg})")
        # (e) the block-gradient kernel's row at these three 12,500^2 blocks
        # with the evaluation's own cotangent, timed there; its four sums
        # held against the plain version at the bar of phase (c) on the
        # first F_SLAB rows of the cross block with their cotangent (the
        # plain version at the whole cross block took ~25 s of the script's
        # time limit in float64; (c) holds the kernel at whole blocks)
        kept = {}
        ms = cuda_time_ms(keep(kept, "kernel", grads_k), 2)
        hb, ct, _, nu, ls, rows_x = blocks[1]
        slab = (hb[:F_SLAB], ct[:F_SLAB])
        kept["kernel"] = [K.matern_block_grad(1.0, 0.1, nu, ls, *slab, table=rows_x[1])]
        plain_ms = cuda_time_ms(keep(kept, "plain", lambda: [K.matern_block_grad_plain(
            1.0, 0.1, nu, ls, *slab)]), 1, warm=False)
        mags = [K.matern_block_grad_plain(1.0, 0.1, nu, ls, *slab, absolute=True)]
        tol = 1e-5 if name == "float32" else 1e-12
        grad_res = dict(results[f"matern_block_grad_{name}"])
        full_rel = 0.0
        for k, (got, ref, mag) in enumerate(zip(kept["kernel"], kept["plain"], mags)):
            diff = (got - ref).abs()
            check(bool(torch.isfinite(got).all()) and bool((diff <= tol * mag).all()),
                  f"(f) block grad {name} {F_SLAB} x 12,500 slab of the cross block: {got.tolist()} "
                  f"vs plain {ref.tolist()}, |terms| {mag.tolist()}")
            full_rel = max(full_rel, float((diff / mag.clamp_min(1e-300)).max()))
            grad_res["max_abs_err"] = max(grad_res["max_abs_err"], float(diff.max()))
        grad_res["max_err"] = max(grad_res["max_err"], full_rel)
        log(f"(f) {name}: block gradient at a {F_SLAB} x 12,500 slab of the cross block: "
            f"|kernel - plain| / sum|terms| {full_rel:.3e} (bar {tol}); plain {plain_ms:.1f} ms there")
        grad_bound = bound_of([matern_bound(hb, nu, ls, sym, grad=True) for hb, _, sym, nu, ls, _ in blocks])
        # the Matern forward at the same three blocks, one at a time, timed
        # there and held against the plain version on each block's first
        # F_SLAB rows (a symmetric block's rows as its plain full form)
        atol = 5e-6 if name == "float32" else 1e-12
        fwd = dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0)
        for k, (hb, _, sym, nu, ls, rows) in enumerate(blocks):
            fwd["ms"] += cuda_time_ms(keep(kept, "kernel", lambda: K.matern_correlation_block(
                nu, ls, hb, symmetric=sym, table=rows[0])), 3)
            fwd["plain_ms"] += cuda_time_ms(
                keep(kept, "plain", lambda: K.matern_correlation_block_plain(nu, ls, hb[:F_SLAB])), 1)
            err = float((kept["kernel"][:F_SLAB] - kept["plain"]).abs().max())
            check(err <= atol and bool(torch.isfinite(kept["kernel"]).all()),
                  f"(f) matern {name} 12,500^2 block {k}, first {F_SLAB} rows: err {err} (bar {atol})")
            fwd["max_abs_err"] = max(fwd["max_abs_err"], err)
        kept.clear()
        log(f"(f) {name}: Matern forward at the three 12,500^2 blocks (plain on their first {F_SLAB} "
            f"rows): max abs err {fwd['max_abs_err']:.3e} (bar {atol})")
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
                NU_GENERAL, ls, hb[:F_SLAB])), 1, warm=False)
            err = float((kept["kernel"][:F_SLAB] - kept["plain"]).abs().max())
            check(err <= atol and bool(torch.isfinite(kept["kernel"]).all()),
                  f"(f) matern {name} 12,500^2 block {k} at nu {NU_GENERAL}, first {F_SLAB} rows: "
                  f"err {err} (bar {atol})")
            gen["max_abs_err"] = max(gen["max_abs_err"], err)
        kept.clear()
        log(f"(f) {name}: Matern forward at the three 12,500^2 blocks at nu {NU_GENERAL}: {gen['ms']:.3f} ms, "
            f"plain {gen['plain_ms']:.3f} ms on their first {F_SLAB} rows, max abs err "
            f"{gen['max_abs_err']:.3e} (bar {atol})")
        gen_bound = bound_of([matern_bound(hb, NU_GENERAL, ls, sym) for hb, _, sym, _, ls, _ in blocks])
    shape = "NLL blocks 12500^2 sym + 12500^2 + 12500^2 sym"
    rows = [
        dict(name=f"matern_correlation_{name}_nll", route="cuda",
             source="cokriging_tpu_torch/kernels/csrc/matern.cu",
             replaces="cokriging_tpu/kernels/pallas_ops.py:782",
             launches=launches["matern_correlation"], launches_per_eval=3,
             bound_ms=fwd_bound[0], bound_by=fwd_bound[1], library_ms=None,
             plain_of=f"the first {F_SLAB} rows of each block",
             path="(f) exact likelihood", shape=shape, max_err=fwd["max_abs_err"], **fwd),
        dict(name=f"matern_correlation_{name}_nll_nu{NU_GENERAL}", route="cuda",
             source="cokriging_tpu_torch/kernels/csrc/matern.cu",
             replaces="cokriging_tpu/kernels/pallas_ops.py:782",
             launches=launches["matern_correlation"], launches_per_eval=3,
             bound_ms=gen_bound[0], bound_by=gen_bound[1], library_ms=None,
             plain_of=f"the first {F_SLAB} rows of each block",
             path=f"(f) exact likelihood, its blocks timed at nu = {NU_GENERAL}", shape=shape,
             max_err=gen["max_abs_err"], **gen),
        dict(name=f"matern_block_grad_{name}", route="cuda",
             source="cokriging_tpu_torch/kernels/csrc/matern_grad.cu",
             replaces="cokriging_tpu/kernels/pallas_ops.py:485",
             launches=launches["matern_block_grad"], launches_per_eval=3, ms=ms, plain_ms=plain_ms,
             plain_of=f"a {F_SLAB} x 12,500 slab of the cross block",
             bound_ms=grad_bound[0], bound_by=grad_bound[1], library_ms=None,
             path="(f) exact likelihood", shape=shape, **grad_res),
    ]
    del g_cov, blocks, dists, mags, slab
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
        out, pred_s = timed(lambda: jp(0, pc.astype(dtype), postprocess=False))
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
                                                       MultiField(fields=full))(
                0, pc, postprocess=False))
        log(f"(f) {name}: joint prediction from all 2 x {N_PER_PROC} points (not gated): finite "
            f"{float(np.isfinite(out.pred).mean()):.4%}, seconds {pred_s}, "
            f"warnings {[str(w.message)[:60] for w in caught]}")
    torch.cuda.empty_cache()
    return rows


# --- the large-n path (examples/large_n_workflow.py) ------------------------


N_LARGE = 60_000  # per process
N_CG = 12_500  # per process: the first observations, the bench month's n
VECCHIA_M, VECCHIA_CHUNK = 20, 4096
LARGE_INIT = [1.0, 1.0, 1.5, 1.5, 1.5, 500.0, 500.0, 500.0, 0.05, 0.05, 0.0]
# (g)'s float32 Vecchia fit from LARGE_INIT (m = 20, maxiter 80; 30 evaluations) in
# the proof run of the commit that added the CLI's ``bench``: (g) runs its
# paths there; phase (m) runs the host L-BFGS-B Vecchia fit at 1,000,000 points
G_FIT = [0.702357, 0.740288, 1.41803, 1.49567, 0.206218, 708.519, 497.217, 150.698, 0.198791,
         0.199851, -0.440507]


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


def pairs_forward_check(calls, atol, what, head_start_ms=0.0):
    """Kernel against plain version over the path's own forward launches
    (``calls``: their argument tuples, the path's table included where it
    passed one): (max abs error, kernel ms, plain ms). ``head_start_ms``:
    ``cuda_time_ms``'s, for the kernel's time."""
    import torch

    from cokriging_tpu_torch.kernels import cuda_ops as K

    kept = {}
    ms = cuda_time_ms(keep(kept, "kernel", lambda: [K.matern_corr_pairs(*a) for a in calls]), 3,
                      head_start_ms=head_start_ms)
    plain_ms = cuda_time_ms(keep(kept, "plain", lambda: [K.matern_corr_pairs_plain(*a[:4]) for a in calls]),
                            1, warm=False)
    err = max(float((k - p).abs().max()) for k, p in zip(kept["kernel"], kept["plain"]))
    finite = all(bool(torch.isfinite(k).all()) for k in kept["kernel"])
    check(finite and err <= atol, f"pairs forward at {what}: err {err} (bar {atol}), finite {finite}")
    tables = sum(len(a) > 4 and a[4] is not None for a in calls)
    log(f"pairs forward at {what}: {tables} of {len(calls)} launches were handed the path's table")
    return err, ms, plain_ms


def pairs_grad_check(calls, tol, what, timed_reps=0, head_start_ms=0.0):
    """Gradient kernel against plain version over ``calls`` (argument tuples
    with their cotangents, then the path's table where it passed one): every
    per-pair sum within tol * sum |terms|, the
    same sums on a second launch. Returns (max rel, max abs, kernel ms, plain
    ms); the times only when ``timed_reps``, the kernel's with
    ``cuda_time_ms``'s ``head_start_ms``."""
    import torch

    from cokriging_tpu_torch.kernels import cuda_ops as K

    kept = {}
    run_k = keep(kept, "kernel", lambda: [K.matern_corr_pairs_grad(*a) for a in calls])
    run_p = keep(kept, "plain", lambda: [K.matern_corr_pairs_grad_plain(*a[:5]) for a in calls])
    ms = plain_ms = None
    if timed_reps:
        ms = cuda_time_ms(run_k, timed_reps, head_start_ms=head_start_ms)
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


def phase_c_small_large_n(cpu):
    """The large-n path's pieces at 2 x 400 points on the card against the
    same code on the CPU (``cpu``: ``c_small_cpu``'s results), float64: the
    Vecchia value and gradient (m = 10), direct-assembly against
    materialized local prediction and kd against the device search, CG
    against the dense joint predictor."""
    import warnings

    from cokriging_tpu_torch.data.grids import prediction_coords
    from cokriging_tpu_torch.kernels import cuda_ops as K
    from cokriging_tpu_torch.predict.iterative import IterativeJointPredictor
    from cokriging_tpu_torch.predict.joint import JointPredictor
    from cokriging_tpu_torch.predict.local import LocalPredictor

    K.reset_launch_counts()
    perm_g, v_g, g_g = small_vecchia("cuda")
    n_g = K.launch_counts()
    perm_c, v_c, g_c = cpu["vecchia"]
    check(np.array_equal(perm_g, perm_c), "small Vecchia: the maxmin orders differ")
    check(n_g["matern_corr_pairs"] == 4 and n_g["matern_corr_pairs_grad"] == 4,
          f"small Vecchia: launches {n_g}")
    check(abs(v_g - v_c) <= 1e-10 * abs(v_c) and np.allclose(g_g, g_c, rtol=1e-7, atol=1e-10),
          f"small Vecchia: value {v_g} vs {v_c}, gradient {g_g} vs {g_c}")
    log(f"(c) small Vecchia card vs CPU f64 (2 x 400, m = 10, 4 chunks): value rel err "
        f"{abs(v_g - v_c) / abs(v_c):.3e}, gradient max rel err "
        f"{float(np.max(np.abs(g_g - g_c) / np.abs(g_c))):.3e}")

    mf, mod = small_fields()
    pc = prediction_coords()[::10]
    few = small_few_cells()
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for kind, kw in SMALL_LOCAL_KINDS.items():
            out["cuda", kind] = LocalPredictor(mod, mf, **kw)(0, pc, postprocess=False)
    for kind in ("dir", "kd"):
        out["cuda", kind, "few"] = small_local_few("cuda", kind)
        out["cpu", kind, "few"] = cpu[kind]
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
    got = ijp(0, cells, postprocess=False)
    want = JointPredictor(mod, mf)(0, cells, postprocess=False)
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
    from cokriging_tpu_torch.estimate.vecchia import VecchiaLikelihood, vecchia_nll_value_and_grad
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
    params = MaternParams.default(2, spec).with_flat(torch.tensor(G_FIT, dtype=td))

    # Vecchia value + gradient at G_FIT (the example's fit, recorded; the
    # scaffold as the example's "auto" builds it: coarse order, kd-tree
    # neighbors): the least of three after a warm-up, the launch counts of
    # the first timed one; the start's value above it
    lik, scaffold_s = timed(lambda: VecchiaLikelihood(
        [c1, c2], [z1, z2], m=VECCHIA_M, geodesic=True, chunk=VECCHIA_CHUNK))
    n_chunks = math.ceil(lik.n / VECCHIA_CHUNK)
    xf = params.to_flat().detach()
    start = float(vecchia_nll_value_and_grad(torch.tensor(LARGE_INIT, dtype=td), lik._win, spec,
                                             True, VECCHIA_CHUNK)[0])

    def evaluate():
        return vecchia_nll_value_and_grad(xf, lik._win, spec, True, VECCHIA_CHUNK)

    with captured("matern_corr_pairs") as fwd_calls, captured("matern_corr_pairs_grad", 1) as grad_calls:
        evaluate()
    K.reset_launch_counts()
    (v, g), s0 = timed(evaluate)
    launches = K.launch_counts()
    secs = [s0] + [timed(evaluate)[1] for _ in range(2)]
    log(f"(g) {name}: scaffold ({lik.ordering} order, {lik.neighbor_method} neighbors) {scaffold_s} s; "
        f"value + gradient at the fit: value {v.item()} (at the start {start}), seconds {secs}, "
        f"evals/s {1.0 / min(secs)}; launches {launches}, chunks {n_chunks}")
    check(v.item() < start, f"(g) {name}: the fit's value {v.item()} is not below the start's {start}")
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
        out, local_s = timed(lambda: lp(1, gg, max_dist=120.0, postprocess=False))
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
        jout, cg_s = timed(lambda: ijp(1, gg[:256], postprocess=False))
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

    from cokriging_tpu_torch.bench import _synthetic_month

    rng = np.random.default_rng(0)
    c1, s1 = _synthetic_month(rng, n)
    c2, s2 = _synthetic_month(rng, n)
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
    raw = lp(0, pc, postprocess=False)
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
    cv_raw = lp_cv.cross_validation(0, max_dist=H_LOOCV_KM, postprocess=False)
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


def h_cli_start():
    """tests/test_cli.py's staged tables in a temporary directory and the
    ``--device cuda`` commands on them started in the background (fit, then
    predict and loocv side by side): ``phase_h_cli`` finishes them."""
    import os
    import tempfile

    from cokriging_tpu_torch.utils.io import save_table

    tmp = tempfile.TemporaryDirectory()
    BACKGROUND.append(tmp.cleanup)
    rng = np.random.default_rng(6)
    paths = []
    for k, nm in enumerate(("xco2", "sif")):
        paths.append(os.path.join(tmp.name, f"{nm}.parquet"))
        save_table(paths[-1], cli_table(nm, rng, 600 + k))
    common = ["--data", *paths, "--timestamp", CLI_TIMES[1], "--timedeltas", "0", "0"]

    def argv(cmd, dev):
        p = os.path.join(tmp.name, f"params_{dev}.npz")
        extra = {"fit": ["--max-dist", "3000", "--n-bins", "8", "--maxiter", "60",
                         "--project-validity", "--out", p],
                 "predict": ["--params", p, "--out", os.path.join(tmp.name, f"pred_{dev}.parquet")],
                 "loocv": ["--params", p, "--out", os.path.join(tmp.name, f"cv_{dev}.parquet")]}[cmd]
        return [cmd, *common, *extra, "--device", dev]

    chain = CliChain([{"fit": argv("fit", "cuda")},
                      {"predict": argv("predict", "cuda"), "loocv": argv("loocv", "cuda")}])
    return dict(tmp=tmp.name, argv=argv, chain=chain)


def phase_h_cli(started):
    """(h)'s CLI: ``python -m cokriging_tpu_torch fit / predict / loocv
    --device cuda`` on tests/test_cli.py's staged tables (started by
    ``h_cli_start``, in subprocesses beside (k)), held against the same commands with
    ``--device cpu`` (in this process), float64: parameters rtol 1e-6,
    predictions and LOOCV columns atol 1e-6."""
    import contextlib as _c
    import io as _io
    import os

    from cokriging_tpu_torch.__main__ import main as cli_main
    from cokriging_tpu_torch.utils.io import load_params, load_table

    tmp, argv = started["tmp"], started["argv"]
    out, secs = {}, {}
    for cmd in ("fit", "predict", "loocv"):
        t0 = time.perf_counter()
        buf = _io.StringIO()
        with _c.redirect_stdout(buf):
            cli_main(argv(cmd, "cpu"))
        out["cpu", cmd, "stdout"] = buf.getvalue()
        secs["cpu", cmd] = time.perf_counter() - t0
    t0 = time.perf_counter()
    runs = started["chain"].wait()
    secs["cuda", "wait"] = time.perf_counter() - t0
    for cmd in ("fit", "predict", "loocv"):
        check(cmd in runs and runs[cmd][0] == 0, f"(h) CLI {cmd} --device cuda: "
              f"{runs[cmd][0] if cmd in runs else 'not run'}: {runs[cmd][2][-2000:] if cmd in runs else ''}")
        out["cuda", cmd, "stdout"] = runs[cmd][1]
        secs["cuda", cmd] = runs[cmd][3]
    for dev in ("cuda", "cpu"):
        out[dev, "params"] = load_params(os.path.join(tmp, f"params_{dev}.npz")).to_flat().numpy()
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
    log(f"(h) CLI fit / predict / loocv, --device cuda (subprocesses beside (k); predict and loocv "
        f"side by side) vs --device cpu: params max rel "
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


def matern_calls_check(calls, atol, what, reps=2, head_start_ms=0.0):
    """The Matern kernel against its plain version at a path's own launches
    (``calls``: the argument tuples ``captured`` kept), one at a time, every
    output finite; ``what`` names them in a failure. Returns (max abs error,
    kernel ms, plain ms, bound ms, bound by); the kernel timed with
    ``cuda_time_ms``'s ``head_start_ms``."""
    import torch

    from cokriging_tpu_torch.kernels import cuda_ops as K

    def sym_of(a):  # block_covariance passes symmetric= and table=, covariance_block table=
        return a[3] if len(a) > 4 else False

    ms = plain_ms = err = 0.0
    for a in calls:
        kept = {}
        sym, table = sym_of(a), (a[-1] if len(a) > 3 else None)
        ms += cuda_time_ms(keep(kept, "kernel", lambda: K.matern_correlation_block(
            *a[:3], symmetric=sym, table=table)), reps, head_start_ms=head_start_ms)
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
                             lambda: jp.sample(0, cells, n_samples=I_COND_SAMPLES, seed=8,
                                               postprocess=False),
                             ("matern_correlation",))
        base = jp(0, cells, postprocess=False)
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


def i_cli_start():
    """tests/test_cli.py's staged tables and a prediction grid in a temporary
    directory, and ``fit --bootstrap 16 --std-errors`` then ``predict --joint
    --conditional-sims 10`` with ``--device cuda`` on them started in the
    background: ``phase_i_cli`` finishes them."""
    import os
    import tempfile

    import pandas as pd

    from cokriging_tpu_torch.data.grids import main_coords_array
    from cokriging_tpu_torch.utils.io import save_table

    tmp = tempfile.TemporaryDirectory()
    BACKGROUND.append(tmp.cleanup)
    rng = np.random.default_rng(6)
    paths = []
    for k, nm in enumerate(("xco2", "sif")):
        paths.append(os.path.join(tmp.name, f"{nm}.parquet"))
        save_table(paths[-1], cli_table(nm, rng, 600 + k))
    mc = main_coords_array()
    grid = os.path.join(tmp.name, "grid.parquet")
    save_table(grid, pd.DataFrame({"lat": mc[::3, 0] + 0.5, "lon": mc[::3, 1] + 0.5}))
    common = ["--data", *paths, "--timestamp", CLI_TIMES[1], "--timedeltas", "0", "0"]
    params = os.path.join(tmp.name, "params.npz")
    chain = CliChain([
        {"fit": ["fit", *common, "--max-dist", "3000", "--n-bins", "8", "--maxiter", "30",
                 "--project-validity", "--bootstrap", "16", "--std-errors", "--out", params,
                 "--device", "cuda"]},
        {"predict": ["predict", *common, "--params", params, "--pred-grid", grid, "--joint",
                     "--conditional-sims", "10", "--seed", "3",
                     "--out", os.path.join(tmp.name, "pred_cuda.parquet"), "--device", "cuda"]},
    ])
    return dict(tmp=tmp.name, paths=paths, grid=grid, common=common, params=params, chain=chain)


def phase_i_cli(started):
    """(i)'s CLI: ``fit --bootstrap 16`` and ``predict --joint
    --conditional-sims 10`` with ``--device cuda`` on tests/test_cli.py's
    staged tables (their projected fit is positive definite; started by
    ``i_cli_start``, in subprocesses beside (k)), the prediction held
    against the same command on the CPU in this process."""
    import io
    import os

    import pandas as pd

    from cokriging_tpu_torch.__main__ import main as cli_main
    from cokriging_tpu_torch.estimate.uncertainty import nll_std_errors
    from cokriging_tpu_torch.utils.io import load_params, load_table

    tmp, paths, grid, common, params = (started[k] for k in ("tmp", "paths", "grid", "common",
                                                              "params"))
    stages = {}
    t0 = time.perf_counter()
    runs = started["chain"].wait()
    stages["cli_wait"] = time.perf_counter() - t0
    out = {}
    for cmd in ("fit", "predict"):
        check(cmd in runs and runs[cmd][0] == 0, f"(i) CLI {cmd} --device cuda: "
              f"{runs[cmd][0] if cmd in runs else 'not run'}: {runs[cmd][2][-2000:] if cmd in runs else ''}")
        out[cmd] = runs[cmd][1]
        stages[f"cli_{cmd}"] = runs[cmd][3]
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
    log(f"(i) CLI fit --bootstrap 16 / predict --joint --conditional-sims 10 --device cuda (beside "
        f"(k), waited {stages['cli_wait']:.1f} s after it): "
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
    BACKGROUND.append(pool.terminate)
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


def phase_j(started):
    """Parameter uncertainty: the observed information of (f)'s ML fit in
    float64 and float32, the demo's (its CPU reference started ahead,
    ``started`` = (stages, ``j_demo_start``'s three)), the space-time
    statistics; returns its rows of the kernels line."""
    import torch

    from cokriging_tpu_torch.estimate.uncertainty import observed_information

    stages, launches, rows = {}, {}, []
    t0 = time.perf_counter()
    demo_stages, demo_mf, pool, pending = started
    stages.update(demo_stages)
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
K_VECCHIA_ITERS = 3
K_CG_SMALL = 2_500  # (h)'s joint and CG LOOCV rows per process
K_CG_TILED = 2_560  # per process: 5,120 rows, a multiple of the 512-row tile
K_CG_CELLS = 256
K_BOOT_REP, K_BOOT_MAXITER = 8, 30
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


def captured_vario_rows(mm_args, bin_args, name, row, path, counts, rtol=None):
    """Both variogram passes at one call a path made (the arguments it
    handed ``variogram_minmax_pairs`` and ``variogram_bin_pairs``, which
    ``captured`` kept), timed beside their plain versions: h ranges and
    counts equal to the plain version's and, with ``rtol`` (phase (c)'s
    bars), the sums and means within it; bounds from that call's pairs.
    Rows of the kernels line, named ``<pass>_<name>_<row>``, with
    ``counts`` the path's launches."""
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
        check(torch.equal(got, want), f"{path}: {kname} {name} differs from the plain version")
        err = 0.0 if minmax else float((kept["kernel"][0] - kept["plain"][0]).abs().max())
        if rtol is not None and not minmax:
            check_bins(f"{path}: {kname} {name}", kept["kernel"], kept["plain"], rtol)
            m_k, m_p = (s_[0] / s_[1].clamp_min(1) for s_ in (kept["kernel"], kept["plain"]))
            rel = float(((m_k - m_p).abs() / m_p.abs().clamp_min(1e-300)).max())
            check(rel <= rtol, f"{path}: {kname} {name} means rel err {rel} (bar {rtol})")
            err = float((m_k - m_p).abs().max())
        bound_ms, bound_by, _ = vario_bound(n_pairs, n_valid, k_cmp, len(edges[0]) - 1, name, minmax)
        rows.append(dict(
            name=f"{kname}_{name}_{row}", route="cuda",
            source="cokriging_tpu_torch/kernels/csrc/variogram.cu",
            replaces="cokriging_tpu/kernels/pallas_ops.py:143", launches=counts.get(kname, 0),
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            max_abs_err=err, max_err=err, path=path,
            shape=f"{len(sides)} variogram(s): {n_pairs} pairs x {len(edges[0]) - 1} bins",
            pairs=n_pairs, binned=sum(n_valid), k_cmp=k_cmp))
    return rows


def k_vario_rows(mm_args, bin_args, name, kind, counts, shards):
    """Both variogram passes over shard 0's sides of a sharded variogram (the
    arguments the sharded call handed its first launch of each pass):
    ``captured_vario_rows``."""
    return captured_vario_rows(
        mm_args, bin_args, name, f"k_{kind}_shard",
        f"(k) sharded_variogram_pair, {kind}, one launch per pass per shard of {shards}", counts)


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

            one = k_stage(stages, launches, key,
                          lambda: predictor()(0, pc, max_dist=K_LOCAL_KM, postprocess=False),
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
        one = k_stage(stages, launches, key,
                      lambda: lp.cross_validation(0, max_dist=H_LOOCV_KM, postprocess=False))
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
    (m = 20, chunk 4096), every chunk launched once and every shard
    launching: in float64 against the unsharded evaluation (rtol 1e-12 /
    1e-9 of max |gradient|) and bit-equal on the one-card mesh, in float32
    against the one-card mesh (logged); then ``fit_vecchia(mesh=)`` for
    ``K_VECCHIA_ITERS`` iterations in float64 against the unsharded fit
    (rtol 1e-8)."""
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
        with captured("matern_corr_pairs") as calls:
            v4, g4 = k_stage(stages, launches, key + "_mesh", lambda: sharded(mesh), every,
                             exact=True)
        shard_devs = {a[3].device for a in calls}
        check(len(calls) == n_chunks and shard_devs == set(mesh.devices),
              f"(k) {key}: {len(calls)} launches on {shard_devs}")
        # the unsharded twin in float64 only: it proves sharded == one call;
        # in float32 the one-card mesh's evaluation is the reference (logged)
        if name == "float64":
            v1, g1 = k_stage(stages, launches, key, lambda: vecchia_nll_value_and_grad(
                xf, lik._win, spec, True, VECCHIA_CHUNK), every, exact=True)
            pairs = [(v4.cpu().numpy(), v1.cpu().numpy()), (g4.cpu().numpy(), g1.cpu().numpy())]
            gap_v = k_same(f"{key} value", pairs[:1], 1e-12)
            gap_g = k_same(f"{key} gradient", pairs[1:], 1e-9, norm=True)
            k_same(f"{key} one-card mesh", [(a.cpu().numpy(), b.cpu().numpy())
                                            for a, b in zip(sharded(one_card), (v1, g1))])
        else:
            v1, g1 = sharded(one_card)
            pairs = [(v4.cpu().numpy(), v1.cpu().numpy()), (g4.cpu().numpy(), g1.cpu().numpy())]
            gap_v = k_same(f"{key} value", pairs[:1], math.inf)
            gap_g = k_same(f"{key} gradient", pairs[1:], math.inf, norm=True)
        log(f"(k) {key}: {lik.n} windows in {n_chunks} chunks over {mesh.size} shards: value "
            f"{float(v4)}, rel gap {gap_v:.3e}, gradient gap / max|g| {gap_g:.3e}"
            f"{' (bars 1e-12, 1e-9)' if name == 'float64' else ' against the one-card mesh (logged)'}; "
            f"{mesh.size} shards {stages[key + '_mesh']:.4f} s"
            f"{f', one device {stages[key]:.4f} s' if key in stages else ''}; scaffold "
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
    (tol 1e-4) bit-equal on the one-card mesh, then (g)'s 2 x 12,500 at 256
    cells (40 iterations, float32) sharded only: its iterations and finite
    predictions."""
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
        out = p(0, pc, postprocess=False)
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
        return p(1, cells, postprocess=False), p.last_diagnostics

    # no unsharded twin here: the float64 system above proves sharded == one call
    got, d4 = k_stage(stages, launches, "cg_float32_mesh", lambda: big(mesh), pairs)
    check(all(0 < d[0] <= 40 for d in d4) and bool(np.isfinite(got.pred).all()),
          f"(k) cg_float32: (iterations, residual) {d4}, finite {np.isfinite(got.pred).mean()}")
    log(f"(k) cg_float32: 2 x {N_CG}, {K_CG_CELLS} cells, 40 iterations: (iterations, residual) "
        f"sharded {d4}; {mesh.size} shards {stages['cg_float32_mesh']:.3f} s")


def k_bootstrap(mesh, one_card, stages, launches):
    """The parametric bootstrap on (i)'s 2 x 12,500 spectral sample (8
    replicates, maxiter 30, float64) with its refit sharded: bit-equal to
    the unsharded bootstrap, walls logged."""
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

    def boot(on):
        return TB.parametric_bootstrap(mod, mf, cfg, n_rep=K_BOOT_REP, seed=3,
                                       maxiter=K_BOOT_MAXITER, mesh=on)

    one = k_stage(stages, launches, "bootstrap", lambda: boot(None), passes)
    got = k_stage(stages, launches, "bootstrap_mesh", lambda: boot(mesh), passes)
    k_same("bootstrap", [(got.flats, one.flats), (got.costs, one.costs)])
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
    out = l_predictor(np.float64, device="cpu")(0, pc[l_cpu_cells(len(pc))], max_dist=K_LOCAL_KM,
                                                postprocess=False)
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
        live = lp(0, pc, max_dist=K_LOCAL_KM, postprocess=False)
        stages[f"live_{name}"] = time.perf_counter() - t0
        with captured("matern_corr_pairs", 1) as calls:
            live_pad = lp(0, pc_pad, max_dist=K_LOCAL_KM, postprocess=False)
        l_same(f"{name} served", got, (live_pad.pred, live_pad.pred_err, live_pad.n_neighbors))
        tail = max(float(np.nanmax(np.abs(g[:n].astype(np.float64) - w)))
                   for g, w in zip(got[:2], (live.pred, live.pred_err)))
        finite = float(np.isfinite(got[0][:n]).mean())
        check(finite > 0.99, f"(l) {name}: only {finite:.2%} finite served predictions")
        # fresh runtime inputs through the same artifact
        f_flat, f_scale = L_FRESH
        fresh = serve(flat * f_flat, (values[0] * f_scale, *values[1:]))
        live_fresh = l_predictor(dtype, L_FRESH)(0, pc_pad, max_dist=K_LOCAL_KM, postprocess=False)
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

# --- phase (m): the million-point workflow -----------------------------------

M_STAGES = ("simulate", "fit_warm", "fit_full", "predict")


@contextlib.contextmanager
def m_armed_captures(names):
    """Spies on ``cuda_ops.<name>`` for each of ``names`` that keep the
    argument tuple of the first call made after the spy is armed
    (``armed[name] = tag``; the call is kept as ``kept[(name, tag)]`` and
    the spy disarms). Yields (armed, kept)."""
    from cokriging_tpu_torch.kernels import cuda_ops as K

    armed, kept, origs = {n: None for n in names}, {}, {n: getattr(K, n) for n in names}

    def spy_of(name):
        def spy(*args, **kwargs):
            if armed[name] is not None:
                kept[(name, armed[name])] = args + tuple(kwargs.values())
                armed[name] = None
            return origs[name](*args, **kwargs)
        return spy

    for n in names:
        setattr(K, n, spy_of(n))
    try:
        yield armed, kept
    finally:
        for n in names:
            setattr(K, n, origs[n])


def phase_m():
    """The JAX package's million-point workflow on the port at its TPU run's
    size (``cokriging_tpu_torch.experiments.million_point_workflow.main("cuda")``,
    float32, N = 1,000,000 on the 1024^2 spectral cofield of the JAX
    manifest's own draws, m = 20, 16,384 held-out cells) with the launch
    counts set to 0 just before and read just after, its stage walls, peak
    memory and the manifest comparison; then its three kernels against their
    plain versions at the calls it made (the 2048^2 lag grid's blocks, the
    full fit's first 4,096-window chunk forward and gradient, the first
    direct-local batch). Returns its rows of the kernels line."""
    import os
    import tempfile

    import torch

    from cokriging_tpu_torch.experiments import Stages
    from cokriging_tpu_torch.experiments import million_point_workflow as W
    from cokriging_tpu_torch.kernels import cuda_ops as K

    t0 = time.perf_counter()
    for var in W.ENV.values():
        check(var not in os.environ, f"(m) {var} is set: phase (m) runs at the script's sizes")

    class ArmingStages(Stages):
        """The workflow's stages; each stage's end arms the captures of the
        next stage's first kernel calls."""

        def __call__(self, name):
            super().__call__(name)
            if name == "fit_warm":
                armed["matern_corr_pairs"] = armed["matern_corr_pairs_grad"] = "vecchia"
            elif name == "fit_full":
                armed["matern_corr_pairs"] = "local"

    with tempfile.TemporaryDirectory() as tmp:
        os.environ["COKRIGING_RESULTS_DIR"] = tmp
        try:
            with captured("matern_correlation_block") as lag_calls, \
                    m_armed_captures(("matern_corr_pairs", "matern_corr_pairs_grad")) as (armed, kept):
                stages = ArmingStages(torch.device("cuda"))
                torch.cuda.synchronize()
                K.reset_launch_counts()
                try:
                    record = W.main("cuda", stages=stages)
                except AssertionError as e:
                    check(False, f"(m) the workflow's gate failed: {e}")
                torch.cuda.synchronize()
                launches = K.launch_counts()
        finally:
            os.environ.pop("COKRIGING_RESULTS_DIR")
        written = json.loads((Path(tmp) / "torch_million_point_workflow.json").read_text())
    check(written["fitted_flat"] == [round(v, 6) for v in record["fitted_flat"]],
          "(m) the manifest written differs from the run's record")
    log(f"(m) workflow: {time.perf_counter() - t0:.1f} s; launches {launches}; manifest keys "
        f"{sorted(written)}")
    for k in ("matern_correlation", "matern_corr_pairs", "matern_corr_pairs_grad"):
        check(launches[k] > 0, f"(m) no {k} launch in the workflow: {launches}")
    want = W.JAX_MANIFEST
    check(record["n_total"] == want["n_total"] and record["grid"] == want["grid"]
          and record["m"] == want["m"] and record["dtype"] == want["dtype"]
          and record["predict_cells"] == want["predict_cells"],
          f"(m) not the manifest's size: {[record[k] for k in ('n_total', 'grid', 'm', 'dtype')]}")
    ref_path = HERE / "results" / "million_point_workflow.json"
    if ref_path.exists():
        ref = json.loads(ref_path.read_text())
        check(all(ref[k] == want[k] for k in ("fitted_flat", "mspe", "coverage_95"))
              and all(ref[f][k] == want[f][k] for f in ("warm_fit", "full_fit") for k in want[f]),
              "(m) JAX_MANIFEST differs from results/million_point_workflow.json")

    # stage walls, the scaffold of each fit apart from its evaluations
    sec, per = record["stage_s"], record["launches"]
    chunks = {}
    for fit in ("warm_fit", "full_fit"):
        info, stage = record[fit], "fit_" + fit.split("_")[0]
        sc, evals = info["scaffold"], info["n_obj_evals"]
        n_chunks = math.ceil(info["n"] / VECCHIA_CHUNK)
        chunks[fit] = n_chunks
        scaffold = sc["order_s"] + sc["neighbors_s"] + sc["windows_s"]
        fwd, grd = (per[stage].get(k, 0) for k in ("matern_corr_pairs", "matern_corr_pairs_grad"))
        log(f"(m) {fit} (N = {info['n']}): {sec[stage]:.3f} s, of it the host scaffold "
            f"{scaffold:.3f} s (ordering {sc['order_s']:.3f}, kd neighbours {sc['neighbors_s']:.3f}, "
            f"windows {sc['windows_s']:.3f}; windows on the card {sc['window_bytes'] / 2**20:.1f} MiB) "
            f"and the evaluations {sec[stage] - scaffold:.3f} s: {evals} evaluations, "
            f"{(sec[stage] - scaffold) / evals:.4f} s each; iterations {info['n_iter']}, success "
            f"{info['success']}, nll {info['nll']}; pairs launches per evaluation {fwd / evals} "
            f"forward, {grd / evals} gradient ({n_chunks} chunks); peak {record['peak_mib'][stage]:.0f} MiB")
        check(fwd == grd == n_chunks * evals,
              f"(m) {fit}: {fwd} / {grd} pairs launches for {evals} evaluations of {n_chunks} chunks")
    log(f"(m) stage walls (s): simulate {sec['simulate']:.3f}, warm fit {sec['fit_warm']:.3f}, full fit "
        f"{sec['fit_full']:.3f}, predict {sec['predict']:.3f}; total {record['wall_total_s']:.3f}; "
        f"peak MiB per stage {json.dumps({k: round(v) for k, v in record['peak_mib'].items()})}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; "
        f"launches per stage {json.dumps(per)}")
    log(f"(m) prediction: {record['predict_cells']} cells, finite {record['predict_finite_frac']:.6f}, "
        f"mean neighbourhood {record['mean_neighbourhood']:.2f}, MSPE {record['mspe']}, coverage "
        f"{record['coverage_95']}; fitted {np.array2string(np.asarray(record['fitted_flat']), precision=5)}")
    log("(m) against the JAX package's TPU manifest (results/million_point_workflow.json):")
    W.compare_manifest(record)

    # the three kernels against their plain versions at the workflow's calls
    rows = []
    fwd_call, grad_call = kept.get(("matern_corr_pairs", "vecchia")), kept.get(("matern_corr_pairs_grad", "vecchia"))
    local_call = kept.get(("matern_corr_pairs", "local"))
    check(fwd_call is not None and grad_call is not None and local_call is not None,
          f"(m) calls not captured: {sorted(kept)}")
    n_win = fwd_call[3].shape[0]
    check(n_win == VECCHIA_CHUNK, f"(m) the full fit's first chunk holds {n_win} windows")
    nus, lss = fwd_call[0].tolist(), fwd_call[1].tolist()
    f_err, f_ms, f_plain = pairs_forward_check([fwd_call], 5e-6, "(m) one Vecchia chunk")
    g_rel, g_err, g_ms, g_plain = pairs_grad_check([grad_call], 1e-5, "(m) one Vecchia chunk", 3)
    l_err, l_ms, l_plain = pairs_forward_check([local_call], 5e-6, "(m) one direct-local batch")
    chunk = [(fwd_call[3], fwd_call[2])]
    fb, gb = bound_of([pairs_bound(chunk, nus, lss)]), bound_of([pairs_bound(chunk, nus, lss, True)])
    lb = bound_of([pairs_bound([(local_call[3], local_call[2])], local_call[0].tolist(),
                               local_call[1].tolist())])
    shape = f"one chunk {tuple(fwd_call[3].shape)} of {chunks['full_fit']} per evaluation"
    vec_f = per["fit_warm"].get("matern_corr_pairs", 0) + per["fit_full"].get("matern_corr_pairs", 0)
    vec_g = (per["fit_warm"].get("matern_corr_pairs_grad", 0)
             + per["fit_full"].get("matern_corr_pairs_grad", 0))
    common = dict(route="cuda", source="cokriging_tpu_torch/kernels/csrc/matern_pairs.cu",
                  library_ms=None)
    rows.append(dict(name="matern_corr_pairs_float32_m_vecchia", replaces="cokriging_tpu/kernels/pallas_ops.py:631",
                     launches=vec_f, ms=f_ms, plain_ms=f_plain, bound_ms=fb[0], bound_by=fb[1],
                     max_abs_err=f_err, max_err=f_err, path="(m) Vecchia fits at 2 x 30,000 and 1,000,000",
                     shape=shape, **common))
    rows.append(dict(name="matern_corr_pairs_grad_float32_m_vecchia",
                     replaces="cokriging_tpu/kernels/pallas_ops.py:767", launches=vec_g, ms=g_ms,
                     plain_ms=g_plain, bound_ms=gb[0], bound_by=gb[1], max_abs_err=g_err, max_err=g_rel,
                     path="(m) Vecchia fits at 2 x 30,000 and 1,000,000", shape=shape, **common))
    rows.append(dict(name="matern_corr_pairs_float32_m_local", replaces="cokriging_tpu/kernels/pallas_ops.py:631",
                     launches=per["predict"].get("matern_corr_pairs", 0), ms=l_ms, plain_ms=l_plain,
                     bound_ms=lb[0], bound_by=lb[1], max_abs_err=l_err, max_err=l_err,
                     path="(m) direct local prediction from 1,000,000 data",
                     shape=f"one batch {tuple(local_call[3].shape)}", **common))
    log(f"(m) pairs at one Vecchia chunk {tuple(fwd_call[3].shape)} (nu {np.round(nus, 4).tolist()}, ls "
        f"{np.round(lss, 3).tolist()}): forward max abs err {f_err:.3e} (bar 5e-6), {f_ms:.3f} ms, plain "
        f"{f_plain:.1f} ms, bound {fb[0]:.4f} ms ({fb[1]}); gradient |kernel - plain| / sum|terms| "
        f"{g_rel:.3e} (bar 1e-5), {g_ms:.3f} ms, plain {g_plain:.1f} ms, bound {gb[0]:.4f} ms ({gb[1]})")
    log(f"(m) pairs at one direct-local batch {tuple(local_call[3].shape)}: max abs err {l_err:.3e}, "
        f"{l_ms:.3f} ms, plain {l_plain:.1f} ms, bound {lb[0]:.4f} ms ({lb[1]})")
    check(len(lag_calls) >= 3 and all(tuple(a[2].shape) == (2048, 2048) for a in lag_calls[-3:]),
          f"(m) lag-grid blocks {[tuple(a[2].shape) for a in lag_calls]}")
    rows.append(matern_row("matern_correlation_float64_m_spectral", per["simulate"].get("matern_correlation", 0),
                           "(m) spectral cofield lag-grid blocks", f"{len(lag_calls)} x 2048 x 2048 full",
                           matern_calls_check(lag_calls, 1e-12, "(m) Matern at the spectral lag grid", reps=3)))
    log(f"(m) matern at the {len(lag_calls)} lag-grid blocks 2048^2 f64: max abs err "
        f"{rows[-1]['max_abs_err']:.3e} (bar 1e-12), {rows[-1]['ms']:.3f} ms, plain {rows[-1]['plain_ms']:.1f} ms, "
        f"bound {rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_by']})")
    del lag_calls, kept
    torch.cuda.empty_cache()
    log(f"(m) seconds {time.perf_counter() - t0:.1f}")
    return rows


# --- phases (n) and (o): the JAX repo's kriging-vs-cokriging comparison and
# its 71-month record (examples/modelling_comparison.py, examples/full_record.py)

VARIO_RTOL = {"float32": 1e-5, "float64": 1e-12}  # phase (c)'s bars
MATERN_ATOL = {"float32": 5e-6, "float64": 1e-12}
NO_CAPTURES = 16  # Matern calls kept per workflow (the synthesizer's 3, then the predictors')
HOST_PROBE_OPS = 20_000


def host_load():
    """The host's speed and load beside a wall: the microseconds a small
    torch operation takes on the host (what the launch-bound fits pay per
    launch on top of the card), the 1-minute load average and the CPU
    count."""
    import os

    import torch

    x = torch.ones(8)
    t0 = time.perf_counter()
    for _ in range(HOST_PROBE_OPS):
        x = x + 1.0
    us = (time.perf_counter() - t0) / HOST_PROBE_OPS * 1e6
    return f"host probe {us:.3f} us per torch op, load {os.getloadavg()[0]:.2f} on {os.cpu_count()} CPUs"


@contextlib.contextmanager
def workflow_run(tag, manifest, matern_limit=NO_CAPTURES):
    """A workflow's run on the card with the launch counts set to 0 just
    before and read just after, its manifest written to a temporary
    directory, and its first calls of the three kernels it launches kept
    (the variogram passes as ``estimate.empirical`` calls them, the Matern
    forward's first ``matern_limit``). Yields a dict that holds, after the
    block, the kernels' calls, the launches, the written manifest and the
    stages."""
    import os
    import tempfile

    import torch

    from cokriging_tpu_torch.estimate import empirical as E
    from cokriging_tpu_torch.experiments import Stages
    from cokriging_tpu_torch.kernels import cuda_ops as K

    out = {"stages": Stages(torch.device("cuda"))}
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["COKRIGING_RESULTS_DIR"] = tmp
        try:
            with captured("variogram_minmax_pairs", 2, module=E) as mm, \
                    captured("variogram_bin_pairs", 2, module=E) as bp, \
                    captured("matern_correlation_block", matern_limit) as mat:
                torch.cuda.synchronize()
                K.reset_launch_counts()
                out["stages"].skip()
                try:
                    yield out
                except AssertionError as e:
                    check(False, f"{tag} the workflow's gate failed: {e}")
                torch.cuda.synchronize()
                out["launches"] = K.launch_counts()
        finally:
            os.environ.pop("COKRIGING_RESULTS_DIR")
        out["written"] = json.loads((Path(tmp) / f"{manifest}.json").read_text())
    out.update(minmax=mm, bins=bp, matern=mat)
    for k in ("variogram_minmax", "variogram_bin", "matern_correlation"):
        check(out["launches"][k] > 0, f"{tag} no {k} launch in the workflow: {out['launches']}")


def workflow_kernel_rows(tag, run, vario_rows, name="float32",
                         matern_what="the synthesizer's and the local predictors' covariance blocks"):
    """The workflow's three kernels against their plain versions at its own
    calls: the variogram passes at each kept call named in ``vario_rows``
    ({index: (row suffix, what)}) at phase (c)'s bars for the workflow's
    dtype ``name`` (rtol 1e-5 / 1e-12), the Matern forward at every kept
    call (atol 5e-6 / 1e-12). Returns rows of the kernels line, each with
    the workflow's launch counts."""
    launches, rows = run["launches"], []
    for k, (suffix, what) in vario_rows.items():
        rows += captured_vario_rows(run["minmax"][k], run["bins"][k], name, suffix,
                                    f"{tag} {what}", launches, VARIO_RTOL[name])
    calls = run["matern"]
    check(calls and all(str(a[2].dtype) == f"torch.{name}" for a in calls),
          f"{tag} Matern calls {[(tuple(a[2].shape), a[2].dtype) for a in calls]}")
    tail = f"_{tag[1]}"
    rows.append(matern_row(f"matern_correlation_{name}{tail}", launches["matern_correlation"],
                           f"{tag} {matern_what}",
                           f"{len(calls)} blocks up to {max(tuple(a[2].shape) for a in calls)}",
                           matern_calls_check(calls, MATERN_ATOL[name], f"{tag} Matern", reps=5)))
    for r in rows:
        log(f"{tag} {r['name']} at {r['shape']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.2f} ms, "
            f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}), launches {r['launches']}, max abs "
            f"err {r['max_abs_err']:.3e}")
    return rows


def stage_lines(tag, stages):
    """Log a workflow's stage seconds, launches and peak memory."""
    log(f"{tag} stages (s): {json.dumps(stages.seconds)}")
    log(f"{tag} launches per stage: {json.dumps(stages.launches)}")
    log(f"{tag} peak MiB per stage: {json.dumps({k: round(v, 1) for k, v in stages.peak_mib.items()})}")


def phase_n():
    """The JAX repo's kriging-vs-cokriging comparison on the port at the
    script's sizes (``modelling_comparison.main("cuda")``: 6 months, every
    land cell, 600 Adam steps, float32), with the gates of the JAX test
    (tests/test_modelling_comparison.py), its stages, the manifest
    comparison. Returns a thunk that holds its kernels against their plain
    versions at its own calls and returns its rows of the kernels line."""
    from cokriging_tpu_torch.experiments import modelling_comparison as MC

    t0 = time.perf_counter()
    log(f"(n) start: {host_load()}")
    with workflow_run("(n)", "torch_modelling_comparison") as run:
        record = MC.main("cuda", stages=run["stages"])
    check(run["written"]["mspe"] == {k: round(v, 6) for k, v in record["mspe"].items()},
          "(n) the manifest written differs from the run's record")
    check(record["sizes"] == MC.CARD_SIZES and record["dtype"] == "float32",
          f"(n) not the script's card run: {record['sizes']} {record['dtype']}")
    check(record["n_pred_cells"] == record["n_merged_cells"] == MC.JAX_MANIFEST["n_pred_cells"],
          f"(n) {record['n_pred_cells']} cells, {record['n_merged_cells']} merged on lat/lon")
    # the gates of tests/test_modelling_comparison.py
    mspe = record["mspe"]
    gates = {"fitted rho < -0.15": record["rho"] < -0.15,
             "over 100 cells with a ratio": record["n_ratio_cells"] > 100,
             "ratio < 1 at over 80% of them": record["err_ratio_lt1_frac"] > 0.8,
             "median ratio < 0.95": record["err_ratio_median"] < 0.95,
             "cokriging MSPE <= kriging's": mspe["cokriging"] <= mspe["kriging"],
             "0 < mean cokriged SIF < 2": 0.0 < record["pred_mean_cokrig"] < 2.0}
    log(f"(n) gates {json.dumps(gates)}: rho {record['rho']:.5f}, {record['n_ratio_cells']} cells, "
        f"ratio < 1 at {record['err_ratio_lt1_frac']:.5f}, median {record['err_ratio_median']:.5f}, "
        f"MSPE {mspe}, MAPE {record['mape']}, mean pred {record['pred_mean_cokrig']:.5f}, finite "
        f"{record['pred_finite_frac']}")
    check(all(gates.values()), f"(n) gates {gates}")
    stages = run["stages"]
    stage_lines("(n)", stages)
    fits = {k: stages.seconds[k] / MC.CARD_SIZES["maxiter"] * 1e3
            for k in ("fit_uni", "fit_uni_warm", "fit_biv", "fit_biv_warm")}
    log(f"(n) walls: total {record['wall_total_s']:.3f} s, warm {record['warm_wall_s']:.3f} s; Adam "
        f"ms per step {json.dumps({k: round(v, 3) for k, v in fits.items()})}; {host_load()}")
    log("(n) against the JAX package's TPU manifest (results/modelling_comparison.json):")
    MC.compare_manifest(record)
    log(f"(n) seconds {time.perf_counter() - t0:.1f}; {host_load()}")
    return lambda: workflow_kernel_rows("(n)", run, {0: ("n_uni", "the univariate variogram (SIF)"),
                                                    1: ("n_biv", "the bivariate variograms")})


def phase_o():
    """The JAX repo's 71-month record on the port at the script's card
    sizes (``full_record.main("cuda")``: 71 months, 3 predicted months,
    every land cell, float32), with the script's gates, the batched fit's
    iterations and seconds per iteration, its stages and the manifest
    comparison. Returns a thunk that holds its kernels against their plain
    versions at its own calls and returns its rows of the kernels line."""
    import os

    from cokriging_tpu_torch.experiments import full_record as FR

    t0 = time.perf_counter()
    check("FULL_RECORD_MONTHS" not in os.environ, "(o) FULL_RECORD_MONTHS is set: (o) runs 71 months")
    log(f"(o) start: {host_load()}")
    with workflow_run("(o)", "torch_full_record") as run:
        record = FR.main("cuda", stages=run["stages"])
    check(run["written"]["months_fit"] == record["months_fit"] == FR.N_MONTHS
          and record["record_span"] == FR.JAX_MANIFEST["record_span"]
          and record["pred_months"] == FR.JAX_MANIFEST["pred_months"]
          and record["pred_cells_per_month"] == FR.JAX_MANIFEST["pred_cells_per_month"],
          f"(o) not the script's card run: {record['months_fit']} months {record['record_span']}, "
          f"predicted {record['pred_months']} at {record['pred_cells_per_month']} cells")
    stages = run["stages"]
    stage_lines("(o)", stages)
    per = stages.launches["variograms_all_months"]
    check(per.get("variogram_minmax") == per.get("variogram_bin") == FR.N_MONTHS,
          f"(o) variogram launches {per} for {FR.N_MONTHS} months (one per pass and month)")
    log(f"(o) batched fit: {record['months_fit']} months x 3 starts, {record['fit_iterations']} "
        f"iterations in {record['wall_s']['batched_fit']:.3f} s, {record['fit_s_per_iteration']:.5f} s "
        f"per iteration; {record['n_converged']} converged, {record['n_rho_bound']} on the rho bound, "
        f"median cost {record['median_cost']:.4f}; rho track "
        f"{np.round(record['rho_track'], 4).tolist()}")
    log(f"(o) walls {json.dumps(record['wall_s'])}, total {record['wall_total_s']:.3f} s; finite "
        f"{record['pred_finite_frac']}; {host_load()}")
    log("(o) against the JAX package's TPU manifest (results/full_record.json):")
    FR.compare_manifest(record)
    log(f"(o) seconds {time.perf_counter() - t0:.1f}; {host_load()}")
    return lambda: workflow_kernel_rows("(o)", run, {0: ("o_month", "the first month's variograms")})


# --- phases (p), (q) and (r): the JAX repo's Vecchia scaling curve, its
# trivariate demo and its exact-NLL scaling curve (examples/vecchia_scaling.py,
# examples/trivariate_demo.py, examples/nll_scaling.py)

# float32 against float64 on the same inputs; the bars keep 20-80x over the
# gaps of the first card run (value 1.8e-7 per term and gradient 1.2e-7 at
# N = 100,000; value 1.4e-6 and gradient 5.3e-6 at 2 x 2,500)
P_REF_N = 100_000  # the size whose float32 evaluation is held against float64 on its windows
P_VALUE_BAR = 1e-5  # |value f32 - value f64| <= P_VALUE_BAR * N (per term)
P_GRAD_BAR = 1e-5  # |gradient f32 - gradient f64| <= P_GRAD_BAR * max |gradient f64|
R_REF_N = 2_500  # per process: the size at which (r) holds float32 against float64
R_VALUE_RTOL = 1e-5
R_GRAD_BAR = 1e-4  # of max |gradient f64|
R_BLOCK_GRAD_TOL = 1e-5  # phase (c)'s float32 bar: of each sum's sum of |terms|
# (p)'s and (r)'s kernel times: the card first sleeps this long, so the host
# has queued every timed launch before the card reaches them (each wrapper's
# host work is of the order of its kernel's time at these shapes) and the time
# is the card's; the time as launched is logged beside it
CURVE_HEAD_START_MS = 20.0


def f32_against_f64(tag, v32, g32, v64, g64, value_bar, grad_bar, value_scale):
    """Log and check a float32 value and gradient against float64 ones on
    the same inputs: |v32 - v64| <= value_bar * value_scale and every
    |g32 - g64| <= grad_bar * max |g64|. Returns (value gap, gradient gap
    relative to max |g64|)."""
    g32, g64 = np.asarray(g32, np.float64), np.asarray(g64, np.float64)
    dv = abs(float(v32) - float(v64))
    dg = float(np.abs(g32 - g64).max() / np.abs(g64).max())
    log(f"{tag} float32 against float64 on the same inputs: value {float(v32)!r} / {float(v64)!r}, "
        f"|diff| {dv:.4g} ({dv / value_scale:.3e} of {value_scale:g}; bar {value_bar}); gradient "
        f"max |diff| / max |g64| {dg:.3e} (bar {grad_bar}); g32 {np.array2string(g32, precision=6)}, "
        f"g64 {np.array2string(g64, precision=6)}")
    check(np.isfinite(g32).all() and dv <= value_bar * value_scale and dg <= grad_bar,
          f"{tag} float32 against float64: value gap {dv}, gradient gap {dg}")
    return dv, dg


def phase_p():
    """The JAX repo's Vecchia scaling curve on the port at the script's
    accelerator sizes (``vecchia_scaling.main("cuda")``: N = 100,000 /
    250,000 / 500,000 / 1,000,000, m = 20, float32, three timed evaluations
    after a warm one) with the launch counts set to 0 just before and read
    just after: per N the host scaffold split into ordering, kd neighbours
    and windows, the evaluation seconds and terms per second, one forward
    and one gradient launch per chunk and evaluation; the log-log slopes;
    the run beside the JAX package's TPU manifest; the float32 value and
    gradient at N = 100,000 against a float64 evaluation of the same
    windows. Returns its rows of the kernels line: both pairs kernels at the
    first chunk of the timed evaluations at N = 100,000, held against their
    plain versions there."""
    import os
    import tempfile

    import torch

    from cokriging_tpu_torch.cov.params import ParamSpec
    from cokriging_tpu_torch.estimate.vecchia import vecchia_nll_value_and_grad
    from cokriging_tpu_torch.experiments import Stages
    from cokriging_tpu_torch.experiments import vecchia_scaling as VS
    from cokriging_tpu_torch.kernels import cuda_ops as K

    t0 = time.perf_counter()
    for var in VS.ENV.values():
        check(var not in os.environ, f"(p) {var} is set: phase (p) runs at the script's sizes")
    log(f"(p) start: {host_load()}")
    ref, orig_evaluate = {}, VS.evaluate

    def evaluate(lik, flat, spec):  # keeps the reference size's windows
        if lik.n == P_REF_N and not ref:
            ref.update(win=lik._win, chunk=lik.chunk)
        return orig_evaluate(lik, flat, spec)

    class ArmingStages(Stages):
        """The curve's stages; the end of the reference size's warm
        evaluation arms the captures of the timed evaluations' first
        chunk."""

        def __call__(self, name):
            super().__call__(name)
            if name == f"warm_{P_REF_N}":
                armed["matern_corr_pairs"] = armed["matern_corr_pairs_grad"] = "p"

    with tempfile.TemporaryDirectory() as tmp:
        os.environ["COKRIGING_RESULTS_DIR"] = tmp
        VS.evaluate = evaluate
        try:
            with m_armed_captures(("matern_corr_pairs", "matern_corr_pairs_grad")) as (armed, kept):
                stages = ArmingStages(torch.device("cuda"))
                torch.cuda.synchronize()
                K.reset_launch_counts()
                stages.skip()
                try:
                    record = VS.main("cuda", stages=stages)
                except AssertionError as e:
                    check(False, f"(p) the script's assertion failed: {e}")
                torch.cuda.synchronize()
                launches = K.launch_counts()
        finally:
            VS.evaluate = orig_evaluate
            os.environ.pop("COKRIGING_RESULTS_DIR")
        written = json.loads((Path(tmp) / "torch_vecchia_scaling.json").read_text())
    check([r["n_total"] for r in written["rows"]] == [r["n_total"] for r in record["rows"]],
          "(p) the manifest written differs from the run's record")
    check(record["sizes"] == VS.CARD_SIZES and record["dtype"] == "float32",
          f"(p) not the script's accelerator run: {record['sizes']} {record['dtype']}")
    log(f"(p) curve: {time.perf_counter() - t0:.1f} s; launches {launches}")
    per, reps = record["launches"], VS.CARD_SIZES["reps"]
    for row in record["rows"]:
        n = row["n_total"]
        n_chunks = math.ceil(n / VECCHIA_CHUNK)
        got = {s: tuple(per[f"{s}_{n}"].get(k, 0) for k in ("matern_corr_pairs", "matern_corr_pairs_grad"))
               for s in ("scaffold", "warm", "eval")}
        check(got == {"scaffold": (0, 0), "warm": (n_chunks,) * 2, "eval": (n_chunks * reps,) * 2},
              f"(p) N = {n}: pairs launches {got} for {n_chunks} chunks and {reps} timed evaluations")
        check((row["ordering"], row["neighbor_method"]) == ("coarse", "kd"),
              f"(p) N = {n}: scaffold {row['ordering']} / {row['neighbor_method']}")
        check(np.isfinite(row["value"]) and row["grad_finite"], f"(p) N = {n}: value {row['value']}")
        log(f"(p) N = {n}: scaffold {row['build_s']:.3f} s (ordering {row['order_s']:.3f}, kd neighbours "
            f"{row['neighbors_s']:.3f}, windows {row['windows_s']:.3f}; {row['window_bytes'] / 2**20:.1f} MiB "
            f"on the card); evaluation {row['eval_s']:.4f} s (reps {np.round(row['eval_reps_s'], 4).tolist()}, "
            f"warm {record['stage_s'][f'warm_{n}']:.4f} s), {row['terms_per_s']:.0f} terms/s, {n_chunks} "
            f"chunks; value {row['value']!r}; peak {record['peak_mib'].get(f'eval_{n}', math.nan):.0f} MiB")
    log(f"(p) log-log slopes against N: {json.dumps(record['slopes'])}")
    log("(p) beside the JAX package's TPU manifest (results/vecchia_scaling.json; its times, not targets):")
    VS.compare_manifest(record)

    # float32 against float64 on the reference size's windows, at FLAT
    check(bool(ref), f"(p) the windows of N = {P_REF_N} were not kept")
    spec = ParamSpec(n_procs=2)
    win64 = tuple(a.double() if a is not None and a.is_floating_point() else a for a in ref["win"])
    flat = torch.tensor(VS.FLAT, dtype=torch.float32, device="cuda")
    v32, g32 = vecchia_nll_value_and_grad(flat.float(), ref["win"], spec, True, ref["chunk"])
    v64, g64 = vecchia_nll_value_and_grad(flat.double(), win64, spec, True, ref["chunk"])
    p_gap = f32_against_f64(f"(p) N = {P_REF_N}", v32.item(), g32.cpu().numpy(), v64.item(),
                            g64.cpu().numpy(), P_VALUE_BAR, P_GRAD_BAR, P_REF_N)
    del win64, ref

    # both pairs kernels at the timed evaluations' first chunk at N = 100,000
    fwd_call, grad_call = kept.get(("matern_corr_pairs", "p")), kept.get(("matern_corr_pairs_grad", "p"))
    check(fwd_call is not None and grad_call is not None, f"(p) calls not captured: {sorted(kept)}")
    check(fwd_call[3].shape[0] == VECCHIA_CHUNK, f"(p) the first chunk holds {fwd_call[3].shape[0]} windows")
    nus, lss = fwd_call[0].tolist(), fwd_call[1].tolist()
    what = f"(p) one Vecchia chunk {tuple(fwd_call[3].shape)} at N = {P_REF_N}"
    f_err, f_ms, f_plain = pairs_forward_check([fwd_call], 5e-6, what, CURVE_HEAD_START_MS)
    g_rel, g_err, g_ms, g_plain = pairs_grad_check([grad_call], 1e-5, what, 3, CURVE_HEAD_START_MS)
    as_launched = (cuda_time_ms(lambda: K.matern_corr_pairs(*fwd_call), 3),
                   cuda_time_ms(lambda: K.matern_corr_pairs_grad(*grad_call), 3))
    chunk = [(fwd_call[3], fwd_call[2])]
    fb, gb = bound_of([pairs_bound(chunk, nus, lss)]), bound_of([pairs_bound(chunk, nus, lss, True)])
    shape = f"one chunk {tuple(fwd_call[3].shape)}; N = 100,000-1,000,000: 25-245 chunks per evaluation"
    common = dict(route="cuda", source="cokriging_tpu_torch/kernels/csrc/matern_pairs.cu", library_ms=None,
                  path="(p) the Vecchia scaling curve", shape=shape)
    rows = [dict(name="matern_corr_pairs_float32_p_vecchia", replaces="cokriging_tpu/kernels/pallas_ops.py:631",
                 launches=launches["matern_corr_pairs"], ms=f_ms, plain_ms=f_plain, bound_ms=fb[0],
                 bound_by=fb[1], max_abs_err=f_err, max_err=f_err, **common),
            dict(name="matern_corr_pairs_grad_float32_p_vecchia",
                 replaces="cokriging_tpu/kernels/pallas_ops.py:767", launches=launches["matern_corr_pairs_grad"],
                 ms=g_ms, plain_ms=g_plain, bound_ms=gb[0], bound_by=gb[1], max_abs_err=g_err,
                 max_err=g_rel, f32_vs_f64=p_gap, **common)]
    log(f"{what} (nu {np.round(nus, 4).tolist()}, ls {np.round(lss, 3).tolist()}): forward max abs err "
        f"{f_err:.3e} (bar 5e-6), {f_ms:.4f} ms, plain {f_plain:.1f} ms, bound {fb[0]:.4f} ms ({fb[1]}); "
        f"gradient |kernel - plain| / sum|terms| {g_rel:.3e} (bar 1e-5), {g_ms:.4f} ms, plain {g_plain:.1f} "
        f"ms, bound {gb[0]:.4f} ms ({gb[1]}); launches {launches['matern_corr_pairs']} / "
        f"{launches['matern_corr_pairs_grad']}; as launched (no head start) {as_launched[0]:.4f} / "
        f"{as_launched[1]:.4f} ms")
    del kept
    torch.cuda.empty_cache()
    log(f"(p) seconds {time.perf_counter() - t0:.1f}; {host_load()}")
    return rows


def phase_q():
    """The JAX repo's trivariate demo on the port at the script's sizes
    (``trivariate_demo.main("cuda")`` with the script's
    ``TRIVARIATE_DEMO_LOCAL=1``: the 41 x 41 cofield of three processes,
    three pooled draws of 280 samples, six variograms per draw, the moment
    initializer and the 21-parameter scipy WLS fit, the 3 x 3-block joint
    predictor and the p = 1 baseline, the local predictor at radius 0.5;
    then ``trivariate_demo.recovery("cuda")``, tests/test_trivariate.py's
    recovery fit on its 31 x 31 data; float64)
    with the launch counts set to 0 just before and read just after: every
    gate of the demo and of tests/test_trivariate.py, the launches per stage,
    its stages and the host's load. Returns a thunk that holds its kernels
    against their plain versions at its own calls (the six variograms of the
    first draw, every Matern block) and returns its rows of the kernels
    line."""
    import os

    from cokriging_tpu_torch.experiments import trivariate_demo as T

    t0 = time.perf_counter()
    check("TRIVARIATE_DEMO_LOCAL" not in os.environ, "(q) TRIVARIATE_DEMO_LOCAL is set already")
    log(f"(q) start: {host_load()}")
    os.environ["TRIVARIATE_DEMO_LOCAL"] = "1"  # the script's knob: the local branch runs
    try:
        with workflow_run("(q)", "torch_trivariate_demo", matern_limit=None) as run:
            record = T.main("cuda", stages=run["stages"])
            rec = T.recovery("cuda", stages=run["stages"])
    finally:
        os.environ.pop("TRIVARIATE_DEMO_LOCAL")
    check(run["written"]["mspe_tri"] == round(record["mspe_tri"], 6),
          "(q) the manifest written differs from the run's record")
    check(record["sizes"] == {**T.CARD_SIZES, "local": 1} and record["dtype"] == "float64",
          f"(q) not the script's run with its local branch: {record['sizes']} {record['dtype']}")
    gates = {**record["gates"], **{f"recovery: {k}": v for k, v in rec["gates"].items()}}
    log(f"(q) gates {json.dumps(gates)}")
    check(len(gates) == 8 and all(gates.values()), f"(q) gates {gates}")
    log(f"(q) demo: MSPE trivariate {record['mspe_tri']:.6f}, univariate {record['mspe_uni']:.6f}, mean "
        f"pred-err ratio {record['err_ratio']:.5f}, local-vs-joint MSD {record['local_vs_joint_msd']:.3e}, "
        f"local MSPE {record['mspe_local']:.6f}, mean neighbourhood {record['mean_neighbourhood']:.1f} at "
        f"{record['n_pred']} cells; fitted rho {np.round(record['rho'], 4).tolist()} (truth {list(T.TRUE_RHO)}), "
        f"sigma {np.round(record['sigma'], 4).tolist()}, diagonal l {np.round(record['len_scale_diag'], 4).tolist()}"
        f", WLS cost {record['wls_cost']:.4f}; against tests/test_trivariate.py's bars (recorded, not held: "
        f"the JAX package's fit of this draw misses them too) {json.dumps(record['demo_fit_against_test_bars'])}")
    log(f"(q) recovery fit on tests/test_trivariate.py's data: rho {np.round(rec['rho'], 4).tolist()}, sigma "
        f"{np.round(rec['sigma'], 4).tolist()}, diagonal l {np.round(rec['len_scale_diag'], 4).tolist()}, WLS "
        f"cost {rec['wls_cost']:.4f}")
    stages = run["stages"]
    stage_lines("(q)", stages)
    per = stages.launches
    vario = {s: (per[s].get("variogram_minmax"), per[s].get("variogram_bin")) for s in ("variograms", "recovery_fit")}
    check(vario == {"variograms": (3, 3), "recovery_fit": (4, 4)},
          f"(q) variogram launches {vario}: one per pass and draw over all six variograms")
    check(per["simulate"].get("matern_correlation") == 6,
          f"(q) the cofield's launches {per['simulate']}: one per block of the 3 x 3 upper triangle")
    sides = [len(run["minmax"][0][0]), len(run["bins"][0][0])]
    check(sides == [6, 6], f"(q) the first variogram launches hold {sides} variograms")
    log(f"(q) seconds {time.perf_counter() - t0:.1f}; {host_load()}")
    return lambda: workflow_kernel_rows(
        "(q)", run, {0: ("q_demo", "the six variograms of the first draw")}, name="float64",
        matern_what="the cofield's, the predictors' and the recovery draws' 3 x 3-block covariances")


def block_grad_calls_check(calls, tol, what, reps=3, head_start_ms=0.0):
    """``matern_block_grad`` against its plain version at a path's own
    launches (``calls``: the argument tuples ``captured`` kept: scale,
    nugget, nu, ls, h, ct, symmetric, table), every one of the four sums
    within ``tol`` of its sum of |terms| and the same on a second launch.
    Returns (max relative error, max abs error, kernel ms, plain ms, bound
    ms, bound by); the kernel timed with ``cuda_time_ms``'s
    ``head_start_ms``."""
    import torch

    from cokriging_tpu_torch.kernels import cuda_ops as K

    kept = {}
    ms = cuda_time_ms(keep(kept, "kernel", lambda: [K.matern_block_grad(*a[:7], table=a[7]) for a in calls]),
                      reps, head_start_ms=head_start_ms)
    plain_ms = cuda_time_ms(keep(kept, "plain", lambda: [K.matern_block_grad_plain(*a[:7]) for a in calls]),
                            1, warm=False)
    rel = err = 0.0
    for a, got, ref in zip(calls, kept["kernel"], kept["plain"]):
        mag = K.matern_block_grad_plain(*a[:7], absolute=True)
        diff = (got - ref).abs()
        check(bool(torch.isfinite(got).all()) and bool((diff <= tol * mag).all()),
              f"{what}: {got.tolist()} vs plain {ref.tolist()}, |terms| {mag.tolist()}")
        check(torch.equal(got, K.matern_block_grad(*a[:7], table=a[7])), f"{what}: sums differ run to run")
        rel = max(rel, float((diff / mag.clamp_min(1e-300)).max()))
        err = max(err, float(diff.max()))
    b = bound_of([matern_bound(a[4], float(torch.as_tensor(a[2]).detach()),
                               float(torch.as_tensor(a[3]).detach()), a[6], grad=True) for a in calls])
    return rel, err, ms, plain_ms, b[0], b[1]


def phase_r():
    """The JAX repo's exact-NLL scaling curve on the port at the script's
    accelerator sizes (``nll_scaling.main("cuda")``: 2 x 2,500 / 5,000 /
    12,500 on the unit square at the script's point, float32, five timed
    value + gradient evaluations after a warm one) with the launch counts
    set to 0 just before and read just after: ms per evaluation and
    evaluations per second per size, positive definiteness, three forward
    and three block-gradient launches per evaluation; the float32 value and
    gradient at 2 x 2,500 against float64 on the same data. Returns its rows
    of the kernels line: both kernels at the first evaluation's three
    2,500^2 blocks, held against their plain versions there."""
    import os
    import tempfile

    import torch

    from cokriging_tpu_torch.cov.params import ParamSpec
    from cokriging_tpu_torch.experiments import Stages
    from cokriging_tpu_torch.experiments import nll_scaling as NS
    from cokriging_tpu_torch.kernels import cuda_ops as K

    t0 = time.perf_counter()
    log(f"(r) start: {host_load()}")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["COKRIGING_RESULTS_DIR"] = tmp
        try:
            with captured("matern_correlation_block", 3) as fwd_calls, \
                    captured("matern_block_grad", 3) as grad_calls:
                stages = Stages(torch.device("cuda"))
                torch.cuda.synchronize()
                K.reset_launch_counts()
                stages.skip()
                record = NS.main("cuda", stages=stages)
                torch.cuda.synchronize()
                launches = K.launch_counts()
        finally:
            os.environ.pop("COKRIGING_RESULTS_DIR")
        written = json.loads((Path(tmp) / "torch_nll_scaling.json").read_text())
    check([r["n_per"] for r in written["rows"]] == [r["n_per"] for r in record["rows"]],
          "(r) the manifest written differs from the run's record")
    check(record["sizes"] == NS.CARD_SIZES and record["dtype"] == "float32",
          f"(r) not the script's accelerator run: {record['sizes']} {record['dtype']}")
    per, reps = record["launches"], NS.CARD_SIZES["reps"]
    for row in record["rows"]:
        n = row["n_per"]
        got = {s: tuple(per[f"{s}_{n}"].get(k, 0) for k in ("matern_correlation", "matern_block_grad"))
               for s in ("distances", "warm", "evals")}
        check(got == {"distances": (0, 0), "warm": (3, 3), "evals": (3 * reps, 3 * reps)},
              f"(r) 2 x {n}: launches {got} for {reps} timed evaluations of three blocks")
        check(not row["positive_definite"] or (np.isfinite(row["nll"]) and row["grad_finite"]),
              f"(r) 2 x {n}: nll {row['nll']}, gradient finite {row['grad_finite']}")
        log(f"(r) n = 2 x {n}: {row['ms_per_eval']:.3f} ms per value + gradient ({row['evals_per_s']:.4f} "
            f"evals/s; reps {np.round(np.asarray(row['reps_s']) * 1e3, 3).tolist()} ms, warm "
            f"{record['stage_s'][f'warm_{n}'] * 1e3:.1f} ms), nll {row['nll']!r}"
            + ("" if row["positive_definite"] else " (not positive definite in float32: the penalty)")
            + f", distances {record['stage_s'][f'distances_{n}'] * 1e3:.1f} ms, peak "
              f"{record['peak_mib'].get(f'evals_{n}', math.nan):.0f} MiB")
    row = record["rows"][0]
    check(row["n_per"] == R_REF_N and row["positive_definite"], f"(r) 2 x {R_REF_N}: {row['n_per']}")
    coords, z = NS.draw(np.random.default_rng(NS.SEED), R_REF_N)
    flat = torch.tensor(NS.FLAT, dtype=torch.float32)
    flat[0] += 1e-6 * reps  # the last timed point, as the curve's float32 arithmetic made it
    dists, z64 = NS.problem(coords, z, torch.float64, torch.device("cuda"))
    v64, g64 = NS.evaluate(flat.double().cuda(), dists, z64, ParamSpec(2, **NS.BOUNDS))
    gap = f32_against_f64(f"(r) 2 x {R_REF_N}", row["nll"], row["grad"], v64.item(), g64.cpu().numpy(),
                          R_VALUE_RTOL, R_GRAD_BAR, abs(v64.item()))
    del dists, z64

    check(len(fwd_calls) == 3 and len(grad_calls) == 3
          and all(tuple(a[2].shape) == (R_REF_N, R_REF_N) for a in fwd_calls)
          and all(tuple(a[4].shape) == (R_REF_N, R_REF_N) for a in grad_calls),
          f"(r) captured {[tuple(a[2].shape) for a in fwd_calls]} / {[tuple(a[4].shape) for a in grad_calls]}")
    shape = f"three {R_REF_N}^2 blocks (sym, full, sym) of the first evaluation"
    rows = [matern_row("matern_correlation_float32_r", launches["matern_correlation"],
                       "(r) the exact-NLL scaling curve, 2 x 2,500 to 2 x 12,500", shape,
                       matern_calls_check(fwd_calls, 5e-6, "(r) Matern at 2 x 2,500", reps=5,
                                          head_start_ms=CURVE_HEAD_START_MS))]
    rel, err, ms, plain_ms, bound_ms, bound_by = block_grad_calls_check(
        grad_calls, R_BLOCK_GRAD_TOL, "(r) block gradient at 2 x 2,500", head_start_ms=CURVE_HEAD_START_MS)
    as_launched = (cuda_time_ms(lambda: [K.matern_correlation_block(  # as matern_calls_check reads them
        *a[:3], symmetric=a[3] if len(a) > 4 else False, table=a[-1] if len(a) > 3 else None)
        for a in fwd_calls], 5),
                   cuda_time_ms(lambda: [K.matern_block_grad(*a[:7], table=a[7]) for a in grad_calls], 3))
    rows.append(dict(name="matern_block_grad_float32_r", route="cuda",
                     source="cokriging_tpu_torch/kernels/csrc/matern_grad.cu",
                     replaces="cokriging_tpu/kernels/pallas_ops.py:485", launches=launches["matern_block_grad"],
                     ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                     max_abs_err=err, max_err=rel, path="(r) the exact-NLL scaling curve, 2 x 2,500 to 2 x 12,500",
                     shape=shape, f32_vs_f64=gap))
    for r, t in zip(rows, as_launched):
        log(f"(r) {r['name']} at {r['shape']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.2f} ms, bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}), launches {r['launches']}, max err {r['max_err']:.3e}; "
            f"as launched (no head start) {t:.4f} ms")
    del fwd_calls, grad_calls
    torch.cuda.empty_cache()
    log(f"(r) seconds {time.perf_counter() - t0:.1f}; {host_load()}")
    return rows


#: the launch-bound workflows that run in workers beside (l) and (m): (n)
#: and (o) in one, (q), as long as the two, in the other, so that the workflows
#: end with (m) and (p) and (r) do not wait for them
WORKER_PHASES = (("n", phase_n), ("o", phase_o), ("q", phase_q))
WORKER_GROUPS = ("no", "q")


def _tag(phases):
    return ", ".join(f"({p})" for p in phases)


def no_worker(phases, workflows_done, gpu_free, out):
    """The phases of ``phases`` among (n), (o) and (q) in a spawned worker
    process beside (l) and (m): the workflows, then ``workflows_done`` is
    set (also where one failed), then, once ``gpu_free`` is set (the card
    has no other work), their kernels against the plain versions, so the
    kernels' times are the card's alone. Puts {"rows", "log", "failure"
    (None or the message), "seconds", "workflows_s"} on the queue ``out``,
    the output kept apart from this script's."""
    import io
    import traceback

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    buf, rows, failure, workflows_s = io.StringIO(), [], None, None
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        try:
            try:
                thunks = [fn() for ph, fn in WORKER_PHASES if ph in phases]
            finally:
                workflows_done.set()
            workflows_s = time.perf_counter() - t0
            check(gpu_free.wait(1800), f"{_tag(phases)}: the card was not free within 1800 s")
            for rows_of in thunks:
                rows += rows_of()
        except SmokeFailure as e:
            failure = str(e)
        except Exception:  # a crash of the workflow is a failure of the phase
            failure = traceback.format_exc()
    out.put({"rows": rows, "log": buf.getvalue(), "failure": failure,
             "seconds": time.perf_counter() - t0, "workflows_s": workflows_s})


def no_start(phases):
    """``no_worker`` of ``phases`` started in a spawned process: a namespace
    of the process, its workflows-done and card-free events, its queue and
    its phases' tag."""
    import multiprocessing
    import types

    ctx = multiprocessing.get_context("spawn")
    w = types.SimpleNamespace(workflows_done=ctx.Event(), gpu_free=ctx.Event(), out=ctx.Queue(),
                              tag=_tag(phases))
    w.proc = ctx.Process(target=no_worker, args=(phases, w.workflows_done, w.gpu_free, w.out), daemon=True)
    w.proc.start()
    BACKGROUND.append(lambda: w.proc.is_alive() and w.proc.terminate())
    return w


def no_wait_workflows(w, t_start):
    """Wait until worker ``w``'s workflows have ended, so that (p) and (r),
    the two timing curves, have the card to themselves; log the wait."""
    t0 = time.perf_counter()
    while not w.workflows_done.wait(5):
        check(w.proc.is_alive(), f"{w.tag}: the worker exited with code {w.proc.exitcode} and no result")
    log(f"{w.tag} worker: waited {time.perf_counter() - t0:.1f} s for its workflows to end before (p) and (r); "
        f"elapsed since start {time.perf_counter() - t_start:.1f} s")


def no_finish(w, t_start):
    """Let worker ``w`` time its kernels on the free card, wait for it,
    print its output and return its rows; its failure fails the run."""
    import queue

    t0 = time.perf_counter()
    w.gpu_free.set()
    while True:
        try:
            res = w.out.get(timeout=5)
            break
        except queue.Empty:
            check(w.proc.is_alive(), f"{w.tag}: the worker exited with code {w.proc.exitcode} and no result")
    w.proc.join(60)
    log(f"{w.tag} worker: its workflows {res['workflows_s'] or 0.0:.1f} s beside (l) and (m), "
        f"{res['seconds']:.1f} s in all; waited {time.perf_counter() - t0:.1f} s for it after (p) and (r) "
        f"(its kernel checks); elapsed since start {time.perf_counter() - t_start:.1f} s. Its output:")
    print(res["log"], end="", flush=True)
    check(res["failure"] is None, f"{w.tag} in the worker: {res['failure']}")
    return res["rows"]


def main(phases="abcdefghijklmnopqr"):
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
        import cokriging_tpu_torch.experiments.million_point_workflow  # noqa: F401
        import cokriging_tpu_torch.experiments.modelling_comparison  # noqa: F401
        import cokriging_tpu_torch.experiments.full_record  # noqa: F401
        import cokriging_tpu_torch.experiments.nll_scaling  # noqa: F401
        import cokriging_tpu_torch.experiments.trivariate_demo  # noqa: F401
        import cokriging_tpu_torch.experiments.vecchia_scaling  # noqa: F401
        import cokriging_tpu_torch.utils.export  # noqa: F401
        from cokriging_tpu_torch.__main__ import _parser  # noqa: F401
        from cokriging_tpu_torch import bench as B
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
            small_pool, small_cpu = c_small_cpu_start()
            c_seconds = {}
            for dtype in (np.float32, np.float64):
                c1, v1, c2, v2 = build_inputs(N_PER_PROC, dtype)
                for fn, args in ((phase_c_variogram, (c1, v1, c2, v2)), (phase_c_variogram_stress, ()),
                                 (phase_c_matern, (c1, c2)), (phase_c_block_grad, (c1, c2)),
                                 (phase_c_pairs, ()), (phase_c_partition, ()), (phase_c_hess_edges, ())):
                    t_c = time.perf_counter()
                    fn(*args, dtype, kres)
                    c_seconds[f"{fn.__name__[8:]} {np.dtype(dtype).name}"] = round(time.perf_counter() - t_c, 2)
            log(f"(c) seconds per check: {json.dumps(c_seconds)}")
            t_c = time.perf_counter()
            cpu = small_cpu.get(timeout=900)
            small_pool.terminate()
            log(f"(c) the small paths' CPU halves (a worker beside the checks above): waited "
                f"{time.perf_counter() - t_c:.1f} s; elapsed since start {time.perf_counter() - t_start:.1f} s")
            for small in (phase_c_small_path, phase_c_small_nll, phase_c_small_large_n):
                small(cpu)
                log(f"(c) elapsed since start {time.perf_counter() - t_start:.1f} s")

        # (d) the main path at bench size: float32 is the port's ``bench``
        # (its warm-up, its timed month and its NLL axis), float64 the same
        # month with the fit cut to MAXITER_F64 steps
        pc = prediction_coords()
        for dtype in (np.float32, np.float64) if "d" in phases else ():
            name = np.dtype(dtype).name
            t_d = time.perf_counter()
            if name == "float32":
                res = d_bench()
                params, result, out, times, lp, launches = (
                    res[k] for k in ("params", "result", "out", "times", "lp", "launches"))
                steps = B.MAXITER
            else:
                c1, v1, c2, v2 = build_inputs(N_PER_PROC, dtype, noise_seed=1)
                B.run_pipeline(c1, v1, c2, v2, pc.astype(dtype), dtype, "cuda",
                               maxiter=B.WARMUP_MAXITER)
                _, v1b, _, v2b = build_inputs(N_PER_PROC, dtype, noise_seed=2)
                K.reset_launch_counts()
                steps = MAXITER_F64
                params, result, out, times, lp = B.run_pipeline(c1, v1b, c2, v2b, pc.astype(dtype),
                                                                dtype, "cuda", maxiter=steps)
                launches = K.launch_counts()
            c1, v1b, c2, v2b = build_inputs(N_PER_PROC, dtype, noise_seed=2)
            times["fit_ms_per_step"] = 1e3 * times["fit_s"] / steps
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
            log(f"(d) {name}: seconds {time.perf_counter() - t_d:.1f}")
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
            log(f"(h) seconds {time.perf_counter() - t_h:.1f} (its CLI runs beside (k)); elapsed since "
                f"start {time.perf_counter() - t_start:.1f} s")
        # (i) simulation and the parametric bootstrap; (j)'s CPU reference
        # starts ahead, beside it
        if "j" in phases:
            j_stages = {}
            j_started = (j_stages, *j_demo_start(j_stages))
        if "i" in phases:
            rows += phase_i()
            log(f"(i) elapsed since start {time.perf_counter() - t_start:.1f} s")
        # (j) parameter uncertainty
        if "j" in phases:
            rows += phase_j(j_started)
            log(f"(j) elapsed since start {time.perf_counter() - t_start:.1f} s")
        # (k) the sharded paths, with (h)'s and (i)'s CLI subprocesses beside
        # them (their GPU memory is small where (k)'s is), finished after
        cli_h = h_cli_start() if "h" in phases else None
        cli_i = i_cli_start() if "i" in phases else None
        if "k" in phases:
            rows += phase_k()
            log(f"(k) elapsed since start {time.perf_counter() - t_start:.1f} s")
        if cli_h is not None:
            phase_h_cli(cli_h)
        if cli_i is not None:
            phase_i_cli(cli_i)
        log(f"(h), (i) CLI done, elapsed since start {time.perf_counter() - t_start:.1f} s")
        # (n), (o) and (q), the launch-bound workflows, run in two workers
        # (WORKER_GROUPS) beside (l) and (m) in a whole run, alone in this
        # process otherwise
        no_phases = "".join(p for p, _ in WORKER_PHASES if p in phases)
        workers = []
        if no_phases and ("l" in phases or "m" in phases):
            groups = ("".join(p for p in group if p in no_phases) for group in WORKER_GROUPS)
            workers = [no_start(group) for group in groups if group]
        # (l) the serving export, the simulation experiment, the entry points
        if "l" in phases:
            rows += phase_l()
            log(f"(l) elapsed since start {time.perf_counter() - t_start:.1f} s")
        # (m) the million-point workflow
        if "m" in phases:
            rows += phase_m()
            log(f"(m) elapsed since start {time.perf_counter() - t_start:.1f} s")
        # (p) and (r), the two timing curves, on the card alone: after the
        # worker's workflows, before its kernel checks
        if "p" in phases or "r" in phases:
            for w in workers:
                no_wait_workflows(w, t_start)
        if "p" in phases:
            rows += phase_p()
            log(f"(p) elapsed since start {time.perf_counter() - t_start:.1f} s")
        if "r" in phases:
            rows += phase_r()
            log(f"(r) elapsed since start {time.perf_counter() - t_start:.1f} s")
        for w in workers:
            rows += no_finish(w, t_start)
        if not workers:
            for ph, fn in WORKER_PHASES:
                if ph in no_phases:
                    rows += fn()()
        if no_phases:
            log(f"({'), ('.join(no_phases)}) elapsed since start {time.perf_counter() - t_start:.1f} s")
    except SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        for cleanup in reversed(BACKGROUND):
            cleanup()
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
    if phases != "abcdefghijklmnopqr":
        print(f"partial run of phases {phases}: no result")
        return 0
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:2]))
