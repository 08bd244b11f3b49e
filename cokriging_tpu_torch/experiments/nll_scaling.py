"""Exact-NLL throughput: value + gradient evaluations per second against n.

Counterpart of ``examples/nll_scaling.py``. One evaluation assembles the
(n1 + n2)^2 joint Matern covariance (``matern.cu`` on the card), factors
it once, solves, and takes the gradient in the same call (above 4,096
observations through the closed-form covariance cotangent and
``matern_grad.cu``); the distance blocks are made once per size. The point
is the script's: nuggets 0.05 and length scales 0.2 on the unit square,
jitter 1e-6, where the covariance is positive definite in float32 too.
Past this path's O(n^2) memory see ``vecchia_scaling``.

Per size the data come from one numpy generator (seed 0) across all sizes,
in the script's order: two (n, 2) unit-square coordinate sets, then 2 n
standard normals, cast to the run's dtype (float32 on the card, float64 on
the CPU). One warm evaluation, then ``reps`` timed ones with
``flat[0] += 1e-6 (k + 1)``. A size whose evaluation is the non-PD penalty
is recorded as not positive definite; the point is never changed.

Sizes: ``CARD_SIZES`` on the card (the script's accelerator sizes, per
process), ``CPU_SIZES`` on the CPU; keyword arguments of ``main`` override
them. The manifest ``torch_nll_scaling.json`` goes through
``utils.results`` (``COKRIGING_RESULTS_DIR`` and ``COKRIGING_NO_RECORD``
apply).

    python -m cokriging_tpu_torch.experiments.nll_scaling [--device cuda|cpu]
"""

import argparse
import time

import numpy as np
import torch

from cokriging_tpu_torch.experiments import Stages, resolve_sizes

#: the script's point: sigma(2), nu(3), len_scale(3), nugget(2), rho
FLAT = [1.0, 1.0, 1.5, 1.5, 1.5, 0.2, 0.2, 0.2, 0.05, 0.05, -0.5]
BOUNDS = dict(sigma_bounds=(0.1, 3.0), len_scale_bounds=(0.02, 1.0), nugget_bounds=(0.0, 0.5))
JITTER = 1e-6
SEED = 0

#: per-process sizes on the card (the script's TPU sizes) and on the CPU
CARD_SIZES = dict(sizes=(2_500, 5_000, 12_500), reps=5)
CPU_SIZES = dict(sizes=(2_500, 5_000), reps=5)


def sizes_for(device, **sizes) -> dict:
    """The run's sizes on ``device`` (``CARD_SIZES`` on the card,
    ``CPU_SIZES`` on the CPU), ``sizes`` over them."""
    return resolve_sizes(device, CARD_SIZES, CPU_SIZES, sizes)


def draw(rng, n_per):
    """The script's data for ``n_per`` points per process from ``rng``, in
    float64: ([coords 1, coords 2], z of length 2 n_per)."""
    coords = [rng.uniform(0, 1, size=(n_per, 2)) for _ in range(2)]
    return coords, rng.normal(size=2 * n_per)


def problem(coords, z, dtype, device):
    """(distance blocks, z) of the data on ``device`` in ``dtype``."""
    from cokriging_tpu_torch.estimate.nll import joint_distance_blocks

    cs = [torch.as_tensor(c, dtype=dtype, device=device) for c in coords]
    return joint_distance_blocks(cs, geodesic=False), torch.as_tensor(z, dtype=dtype, device=device)


def evaluate(flat, dists, z, spec):
    """One NLL value + gradient at ``flat``: (value, gradient) on the
    device."""
    from cokriging_tpu_torch.estimate.nll import nll_value_and_grad

    return nll_value_and_grad(flat, dists, z, spec, None, JITTER)


def main(device=None, stages=None, **sizes):
    """The curve on ``device`` (the card unless ``device="cpu"``) at the
    script's sizes for that device (``sizes_for``; ``sizes`` (per process)
    and ``reps`` as keywords). ``stages``: a ``Stages`` on that device, or
    None for a new one; each size adds ``distances_<n>``, ``warm_<n>`` and
    ``evals_<n>``. Returns the run's record: one row per size (ms per
    value + gradient, evaluations per second, the NLL and gradient, whether
    the point is positive definite there), the stage seconds and launches."""
    from cokriging_tpu_torch.cov.params import ParamSpec
    from cokriging_tpu_torch.estimate.nll import _penalty
    from cokriging_tpu_torch.utils.config import resolve_device
    from cokriging_tpu_torch.utils.results import record_manifest

    dev = resolve_device(device)
    s = sizes_for(dev, **sizes)
    dtype = torch.float32 if dev.type == "cuda" else torch.float64
    stages = stages or Stages(dev)
    spec = ParamSpec(2, **BOUNDS)
    flat = torch.tensor(FLAT, dtype=dtype, device=dev)
    rng = np.random.default_rng(SEED)
    print(f"backend={dev.type} dtype={str(dtype).split('.')[-1]}", flush=True)
    rows = []
    for n_per in s["sizes"]:
        coords, z_host = draw(rng, n_per)
        stages.skip()
        dists, z = problem(coords, z_host, dtype, dev)
        stages(f"distances_{n_per}")
        v, g = evaluate(flat, dists, z, spec)
        float(v), g.cpu()
        stages(f"warm_{n_per}")
        reps = []
        for k in range(s["reps"]):
            fk = flat.clone()
            fk[0] += 1e-6 * (k + 1)
            t0 = time.perf_counter()
            v, g = evaluate(fk, dists, z, spec)
            value, grad = float(v), g.cpu().numpy()
            reps.append(time.perf_counter() - t0)
        stages(f"evals_{n_per}")
        dt = float(np.mean(reps))
        pd_ok = value != float(_penalty(2 * n_per, dtype, "cpu"))
        rows.append({"n_per": n_per, "ms_per_eval": 1e3 * dt, "evals_per_s": 1.0 / dt,
                     "reps_s": reps, "nll": value, "grad": grad.astype(np.float64).tolist(),
                     "positive_definite": pd_ok, "grad_finite": bool(np.isfinite(grad).all())})
        print(f"n = 2x{n_per:>6}: {dt * 1e3:8.1f} ms/eval+grad ({1 / dt:6.2f} evals/sec)  "
              f"nll={value:.1f}" + ("" if pd_ok else "  (not positive definite: the penalty)"),
              flush=True)
        del dists, z
    record = {"dtype": str(dtype).split(".")[-1], "sizes": s, "flat": FLAT, "jitter": JITTER,
              "rows": rows, "stage_s": dict(stages.seconds), "launches": dict(stages.launches),
              "peak_mib": dict(stages.peak_mib)}
    record_manifest("torch_nll_scaling", record)
    return record


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    main(ap.parse_args().device)
