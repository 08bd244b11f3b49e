#!/usr/bin/env python3
"""The PyTorch port's fitters on chip_smoke.py's paths, on one CUDA card, for
comparing two checkouts of ``cokriging_tpu_torch`` in one call.

    python3 tools/torch_fit_timing.py [ROOT] [--adam-steps N] [--profile N]
                                      [--only-adam64]

ROOT is the checkout whose ``cokriging_tpu_torch`` is imported (default:
this one); its kernels are built into ROOT/build. Per dtype (float32,
float64), on chip_smoke.py's inputs:

- ``adam``: phase (d)'s eager Adam WLS fit (bench.py's month, 2 x 12,500
  points, values of noise seed 2, 15 bins to 3000 km, ``moment_init``):
  a 10-step warm-up, then ``--adam-steps`` steps (default 150) timed on the
  host clock around a synchronize; ``ms_per_step`` is their mean;
- ``lbfgs_scipy``: the CLI's scipy L-BFGS-B WLS fit of the same estimate
  (``fit_wls``'s default, maxiter 60), seconds and iterations;
- ``ml``: phase (f)'s maximum-likelihood fit (``fit_nll_device``, L-BFGS,
  maxiter 60, jitter 1e-6, on every 5th point of the month: 2 x 2,500),
  seconds, objective evaluations and ``ms_per_eval``;
- ``vecchia``: phase (g)'s Vecchia fit (2 x 60,000, m = 20, maxiter 80,
  chunk 4096, from ``LARGE_INIT``), seconds, objective evaluations and
  ``ms_per_eval``.

``--only-adam64`` times the float64 Adam fit alone (a fresh process's
first fit). ``--profile N`` (after the timings) runs N float64 Adam steps under
``torch.profiler`` and prints the operators' self CPU and device times
(the 25 largest by self CPU time) and the host time per step.

Prints the card's name and power limit and one JSON line. Run it from each
checkout in turns (parent, change, change, parent) and compare.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]


def timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main(root, adam_steps, profile=0, only_adam64=False):
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import chip_smoke as S  # this checkout's, before ROOT (which has its own) comes first

    sys.path.insert(0, str(root))
    from cokriging_tpu_torch.cov.params import MaternParams, ParamSpec
    from cokriging_tpu_torch.estimate.empirical import (
        EmpiricalVariogram, VarioConfig, empirical_variograms_device,
    )
    from cokriging_tpu_torch.estimate.nll import fit_nll_device
    from cokriging_tpu_torch.estimate.vecchia import fit_vecchia
    from cokriging_tpu_torch.estimate.wls import fit_wls, moment_init
    from cokriging_tpu_torch.fields.field import Field, MultiField
    from cokriging_tpu_torch.kernels import _build

    _build.build()
    out = {"root": str(root), "package": str(Path(_build.__file__).resolve().parents[1]),
           "device": torch.cuda.get_device_name(0), "adam_steps": adam_steps}
    print(S.nvidia_smi_line(), flush=True)
    cfg = VarioConfig(max_dist=3_000.0, n_bins=15, geodesic=True)
    for dtype in (np.float64,) if only_adam64 else (np.float32, np.float64):
        name = np.dtype(dtype).name
        c1, _, c2, _ = S.build_inputs(S.N_PER_PROC, dtype)
        _, v1, _, v2 = S.build_inputs(S.N_PER_PROC, dtype, noise_seed=2)
        pairs, centers, means, counts = empirical_variograms_device(
            [c1, c2], [v1, v2], cfg, device="cuda")
        est = EmpiricalVariogram(config=cfg, pairs=pairs, bin_centers=centers.astype(dtype),
                                 bin_means=means.astype(dtype), bin_counts=counts.astype(dtype))
        init = moment_init(est)
        fit_wls(est, init=init, method="adam", maxiter=10, device="cuda")
        (_, res), adam_s = timed(lambda: fit_wls(est, init=init, method="adam",
                                                 maxiter=adam_steps, device="cuda"))
        out[name] = {"adam": {"seconds": adam_s, "ms_per_step": 1e3 * adam_s / adam_steps,
                              "cost": float(res.cost)}}
        if only_adam64:
            break
        (_, res_l), scipy_s = timed(lambda: fit_wls(est, init=init, maxiter=60, device="cuda"))
        c1, v1, c2, v2 = S.build_inputs(S.N_PER_PROC, dtype, noise_seed=1)
        fields = [Field.from_arrays(c[::5], v[::5], f"Z{k}")
                  for k, (c, v) in enumerate(((c1, v1), (c2, v2)))]
        for f in fields:
            f.geodesic = True
        (_, ml), ml_s = timed(lambda: fit_nll_device(
            MultiField(fields=fields), init=MaternParams.default(2, dtype=getattr(torch, name)),
            jitter=1e-6, maxiter=60, method="lbfgs"))
        c1, z1, c2, z2 = S.large_n_month(dtype)
        mf = S.geo_fields(((c1, z1, "XCO2"), (c2, z2, "SIF")))
        v_init = MaternParams.default(2, ParamSpec(n_procs=2)).with_flat(
            torch.tensor(S.LARGE_INIT, dtype=torch.float64))
        (_, info), vec_s = timed(lambda: fit_vecchia(
            mf, init=v_init, m=S.VECCHIA_M, maxiter=S.VECCHIA_MAXITER, main=False,
            chunk=S.VECCHIA_CHUNK))
        out[name].update({
            "lbfgs_scipy": {"seconds": scipy_s, "iterations": int(res_l.n_iter),
                            "cost": float(res_l.cost)},
            "ml": {"seconds": ml_s, "evaluations": int(ml["n_obj_evals"]),
                   "ms_per_eval": 1e3 * ml_s / int(ml["n_obj_evals"]), "nll": float(ml["nll"])},
            "vecchia": {"seconds": vec_s, "evaluations": int(info["n_obj_evals"]),
                        "iterations": int(info["n_iter"]),
                        "ms_per_eval": 1e3 * vec_s / int(info["n_obj_evals"]),
                        "nll": float(info["nll"])},
        })
        print(f"{name}: {json.dumps(out[name])}", flush=True)
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof

        with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            (_, _), prof_s = timed(lambda: fit_wls(est, init=init, method="adam",
                                                   maxiter=profile, device="cuda"))
        print(p.key_averages().table(sort_by="self_cpu_time_total", row_limit=25))
        out["profile"] = {"steps": profile, "ms_per_step": 1e3 * prof_s / profile}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    only = "--only-adam64" in args
    if only:
        args.remove("--only-adam64")
    opts = {"--adam-steps": 150, "--profile": 0}
    for flag in opts:
        if flag in args:
            k = args.index(flag)
            opts[flag] = int(args[k + 1])
            del args[k:k + 2]
    sys.exit(main(Path(args[0]).resolve() if args else HERE, opts["--adam-steps"],
                  opts["--profile"], only))
