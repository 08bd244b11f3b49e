"""Vecchia-likelihood scaling: the scaffold and the NLL + gradient against N.

Counterpart of ``examples/vecchia_scaling.py``. The exact NLL
(``nll_scaling``) is O(n^2) memory and O(n^3) work; the Vecchia
approximation (``estimate/vecchia.py``) is O(N m) memory and O(N m^3)
work. For growing N at a fixed conditioning-set size m this times

- the one-off scaffold (``VecchiaLikelihood``): the ordering, the
  neighbour search and the term windows' gather and copy to the device,
  each apart (``VecchiaLikelihood.scaffold``), and
- the NLL value + gradient (``vecchia_nll_value_and_grad``): one warm
  evaluation, then the mean of ``reps`` timed ones at ``flat + 1e-6 k``.

The data are the script's (``draw``: one numpy generator, seed 0, across
all sizes; CONUS [lat, lon] degrees; process 2 at process 1's locations
rolled by one and jittered) in its dtype: float32 on the card, float64 on
the CPU. Past 20,000 points the scaffold is the coarse-to-fine ordering
and the kd neighbours on the host; up to it the exact maxmin ordering and
the device's neighbour search. On the card each evaluation launches the
pairs kernels of ``matern_pairs.cu`` once per 4,096-window chunk, forward
and gradient.

Sizes: ``CARD_SIZES`` on the card (the script's accelerator sizes),
``CPU_SIZES`` on the CPU; the script's environment knobs ``BENCH_SIZES``
(comma-separated N) and ``BENCH_M`` override them, and keyword arguments of
``main`` override both. ``JAX_MANIFEST`` holds the JAX package's own run on
a TPU (``results/vecchia_scaling.json``) for ``compare_manifest``: its
times are that package's, quoted beside the port's, not targets. The
manifest ``torch_vecchia_scaling.json`` and, where matplotlib is
installed, the figure ``torch_vecchia_scaling.png`` go through
``utils.results`` (``COKRIGING_RESULTS_DIR`` and ``COKRIGING_NO_RECORD``
apply).

    python -m cokriging_tpu_torch.experiments.vecchia_scaling [--device cuda|cpu]
"""

import argparse
import importlib.util
import time

import numpy as np
import torch

from cokriging_tpu_torch.experiments import Stages, resolve_sizes

#: the script's evaluation point: sigma(2), nu(3), len_scale(3) km, nugget(2), rho
FLAT = [1.0, 1.0, 1.5, 1.5, 1.5, 300.0, 300.0, 300.0, 0.02, 0.02, -0.5]
SEED = 0

#: the script's sizes on an accelerator (its TPU run) and on the CPU
CARD_SIZES = dict(sizes=(100_000, 250_000, 500_000, 1_000_000), m=20, reps=3)
CPU_SIZES = dict(sizes=(400, 800), m=15, reps=1)
ENV = dict(sizes="BENCH_SIZES", m="BENCH_M")

#: the JAX package's run on a TPU (results/vecchia_scaling.json)
JAX_MANIFEST = {
    "backend": "tpu",
    "m": 20,
    "rows": [
        {"n_total": 100000, "build_s": 8.81, "eval_s": 3.541, "terms_per_s": 28243},
        {"n_total": 250000, "build_s": 26.84, "eval_s": 8.421, "terms_per_s": 29687},
        {"n_total": 500000, "build_s": 49.13, "eval_s": 16.805, "terms_per_s": 29752},
        {"n_total": 1000000, "build_s": 88.99, "eval_s": 33.579, "terms_per_s": 29781},
    ],
}
STEPS = ("order_s", "neighbors_s", "windows_s")


def sizes_for(device, **sizes) -> dict:
    """The run's sizes on ``device``: the script's (``CARD_SIZES`` on the
    card, ``CPU_SIZES`` on the CPU), its environment knobs over them, then
    ``sizes``."""
    return resolve_sizes(device, CARD_SIZES, CPU_SIZES, sizes, ENV,
                         parse={"sizes": lambda v: tuple(int(n) for n in v.split(","))})


def draw(rng, n_total, dtype):
    """The script's data at N = ``n_total`` from ``rng``, in ``dtype``:
    ([c1, c2], [v1, v2]), each process n_total // 2 [lat, lon] rows."""
    n = n_total // 2
    lat = rng.uniform(24.0, 50.0, n).astype(dtype)
    lon = rng.uniform(-124.0, -67.0, n).astype(dtype)
    c1 = np.column_stack([lat, lon])
    c2 = np.roll(c1, 1, axis=0) + rng.normal(scale=0.05, size=c1.shape).astype(dtype)
    v1 = np.sin(np.deg2rad(lat) * 6).astype(dtype)
    v2 = (-0.5 * v1 + 0.3 * rng.normal(size=n)).astype(dtype)
    return [c1, c2], [v1, v2]


def evaluate(lik, flat, spec):
    """One value + gradient of the likelihood's NLL at ``flat``: (value,
    gradient) on its device."""
    from cokriging_tpu_torch.estimate.vecchia import vecchia_nll_value_and_grad

    return vecchia_nll_value_and_grad(flat, lik._win, spec, geodesic=True, chunk=lik.chunk)


def log_slopes(rows, keys=("eval_s", "build_s") + STEPS):
    """The least-squares slope of log(seconds) against log(N) for each of
    ``keys`` over ``rows`` (None with fewer than two sizes)."""
    n = np.log([r["n_total"] for r in rows])
    return {k: (float(np.polyfit(n, np.log([r[k] for r in rows]), 1)[0]) if len(rows) > 1 else None)
            for k in keys}


def _figure(rows, m):
    """The script's figure, as ``torch_vecchia_scaling``, where matplotlib
    is installed. Returns whether it was written."""
    if importlib.util.find_spec("matplotlib") is None:
        print("figure not written: matplotlib is not installed", flush=True)
        return False
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from cokriging_tpu_torch.utils.results import save_figure

    ns = [r["n_total"] for r in rows]
    fig, (ax0, ax1) = plt.subplots(1, 2, figsize=(9.0, 3.4))
    ax0.loglog(ns, [r["eval_s"] for r in rows], "o-", label="NLL value+grad")
    ax0.loglog(ns, [r["build_s"] for r in rows], "s--", label="scaffold build")
    ax0.loglog(ns, [rows[0]["eval_s"] * n / ns[0] for n in ns], ":", color="gray", label="O(N)")
    ax0.set_xlabel("observations N")
    ax0.set_ylabel("seconds")
    ax0.legend(fontsize=8)
    ax0.set_title(f"Vecchia scaling (m={m})")
    ax1.semilogx(ns, [r["terms_per_s"] / 1e3 for r in rows], "o-")
    ax1.set_xlabel("observations N")
    ax1.set_ylabel("k terms / s")
    ax1.set_title("throughput")
    fig.tight_layout()
    save_figure(fig, "torch_vecchia_scaling")
    plt.close(fig)
    return True


def main(device=None, stages=None, **sizes):
    """The scaling curve on ``device`` (the card unless ``device="cpu"``)
    at the script's sizes for that device (``sizes_for``; ``sizes``, ``m``,
    ``reps`` as keywords). ``stages``: a ``Stages`` on that device, or None
    for a new one; each N adds the stages ``scaffold_<N>``, ``warm_<N>`` and
    ``eval_<N>``. Raises AssertionError where a value or a gradient entry
    is not finite (the script's assertion). Returns the run's record: one
    row per N (the scaffold's seconds per step and device bytes, the mean
    evaluation seconds and each repetition's, terms per second, the value,
    whether the gradient is finite), the log-log slopes, the stage seconds
    and launches."""
    from cokriging_tpu_torch.cov.params import ParamSpec
    from cokriging_tpu_torch.estimate.vecchia import VecchiaLikelihood
    from cokriging_tpu_torch.utils.config import resolve_device
    from cokriging_tpu_torch.utils.results import record_manifest

    dev = resolve_device(device)
    s = sizes_for(dev, **sizes)
    dtype = np.float32 if dev.type == "cuda" else np.float64
    stages = stages or Stages(dev)
    spec = ParamSpec(n_procs=2)
    flat = torch.tensor(FLAT, dtype=getattr(torch, np.dtype(dtype).name), device=dev)
    rng = np.random.default_rng(SEED)
    print(f"backend={dev.type} dtype={np.dtype(dtype).name} m={s['m']}", flush=True)
    print(f"{'N_total':>9} {'build_s':>8} {'order_s':>8} {'nbrs_s':>8} {'win_s':>7} {'eval_s':>8} "
          f"{'terms/s':>10}", flush=True)
    rows = []
    for n_total in s["sizes"]:
        coords, values = draw(rng, n_total, dtype)
        stages.skip()
        t0 = time.perf_counter()
        lik = VecchiaLikelihood(coords, values, m=s["m"], geodesic=True, device=dev)
        stages(f"scaffold_{n_total}")
        t_build = time.perf_counter() - t0
        evaluate(lik, flat, spec)  # the first evaluation, untimed
        stages(f"warm_{n_total}")
        reps = []
        for k in range(s["reps"]):
            t0 = time.perf_counter()
            v, g = evaluate(lik, flat + 1e-6 * k, spec)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            reps.append(time.perf_counter() - t0)
        stages(f"eval_{n_total}")
        value, grad = float(v), g.cpu().numpy()
        t_eval = float(np.mean(reps))
        row = {"n_total": n_total, "build_s": t_build,
               **{k: lik.scaffold[k] for k in STEPS},
               "window_bytes": int(lik.scaffold["window_bytes"]),
               "ordering": lik.ordering, "neighbor_method": lik.neighbor_method,
               "eval_s": t_eval, "eval_reps_s": reps, "terms_per_s": n_total / t_eval,
               "value": value, "grad_finite": bool(np.isfinite(grad).all()),
               "grad": grad.astype(np.float64).tolist()}
        rows.append(row)
        print(f"{n_total:>9} {t_build:>8.2f} {row['order_s']:>8.2f} {row['neighbors_s']:>8.2f} "
              f"{row['windows_s']:>7.2f} {t_eval:>8.3f} {row['terms_per_s']:>10.0f}", flush=True)
        if not (np.isfinite(value) and row["grad_finite"]):
            raise AssertionError(f"N = {n_total}: value {value}, gradient {grad.tolist()}")
        del lik
    slopes = log_slopes(rows)
    print("log-log slope against N: " + ", ".join(
        f"{k} {v:.3f}" for k, v in slopes.items() if v is not None), flush=True)
    figure = _figure(rows, s["m"])
    stages.skip()
    record = {"m": s["m"], "dtype": np.dtype(dtype).name, "sizes": s, "flat": FLAT, "rows": rows,
              "slopes": slopes, "figure": figure, "stage_s": dict(stages.seconds),
              "launches": dict(stages.launches), "peak_mib": dict(stages.peak_mib)}
    record_manifest("torch_vecchia_scaling", record)
    return record


def compare_manifest(record):
    """Print the run beside the JAX package's own TPU run (its times are
    that package's, quoted, not targets): per N the build and evaluation
    seconds and the terms per second of both. Returns the rows (N, port
    build_s, JAX build_s, port eval_s, JAX eval_s, port terms/s, JAX
    terms/s); a size the manifest lacks has None on its JAX side."""
    jax_rows = {r["n_total"]: r for r in JAX_MANIFEST["rows"]}
    out = []
    print(f"{'N':>9} {'build_s port':>12} {'JAX (TPU)':>10} {'eval_s port':>11} {'JAX (TPU)':>10} "
          f"{'terms/s port':>12} {'JAX (TPU)':>10}")
    for r in record["rows"]:
        j = jax_rows.get(r["n_total"], {})
        row = (r["n_total"], r["build_s"], j.get("build_s"), r["eval_s"], j.get("eval_s"),
               r["terms_per_s"], j.get("terms_per_s"))
        out.append(row)
        print(f"{row[0]:>9} {row[1]:>12.3f} {row[2] or float('nan'):>10.2f} {row[3]:>11.4f} "
              f"{row[4] or float('nan'):>10.3f} {row[5]:>12.0f} {row[6] or float('nan'):>10.0f}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    main(ap.parse_args().device)
