#!/usr/bin/env python3
"""Time the second-order kernels of ``kernels/csrc/matern_hess.cu`` (the
Hessian sums and the block tangent) and the second-order row build for the
port checkout at ROOT, on one CUDA card.

    python3 tools/torch_hess_timing.py [ROOT] [--bits DIR] [--hessian]

ROOT (default: this checkout) is put first on ``sys.path``, so a ``git
archive`` of another commit unpacked beside this one can be timed in the
same call: run parent, change, change, parent. The blocks are chip_smoke
phase (j)'s shapes: every 5th point of bench.py's synthetic month (2 x
2,500), its three 2,500^2 blocks (symmetric, full, symmetric) with a random
cotangent, at nu = 1.37 (every CF2 lane runs to convergence), nu = 1.5 -+ one
ulp of the dtype (lanes that stop after CF2's first trip) and nu = 1.5, ls =
700 km. Per dtype and order it prints the CUDA-event time (the least of
three runs of 5 calls each, after a warm-up) of:

- ``hess_built_ms``: the three Hessian-sum launches with no ``table``, each
  building its second-order row first (how (j) timed the row before the rows
  were built once per Hessian);
- ``hess_kernel_ms``: the same three launches with the row built once
  beforehand, the kernel alone;
- ``row_build_ms``: one ``recurrence_table(nu, ls, dtype, order=2)``;
- ``tangent_hessian_ms``: a Hessian's tangent work at the three blocks,
  11 rows of weights (random, seed 5) each: 3 partials launches and 33
  combines of them where the checkout has ``matern_block_partials``, else
  the 33 fused tangent launches of a checkout before the split; with the
  split also ``partials_ms`` (the 3 partials) and ``combines_ms`` (the 33
  combines) alone, and ``combines_device_ms``: the 33 combines queued
  behind a 20 ms sleep of the card, the card's time alone;
- ``tangent_peak_mb``: the most device memory that work held beyond what
  was allocated before it (``torch.cuda.max_memory_allocated``);
- ``block_grad_ms``: the three block-gradient launches (``matern_grad.cu``,
  whose kernel shares the Hessian sums' tiled skeleton, ``tile_sum.cuh``)
  with their dual row built beforehand;

the largest relative gap between the kernel's sums with and without a
prebuilt row (0: the same bits), the sums and block gradients themselves
(``float.hex``, to compare two checkouts' bits), the sha256 of the 33
tangents' bytes (``tangent_sha256``, equal in two checkouts where every
tangent is bit-equal), then the ptxas lines of ``matern_hess.cu`` and
``matern_grad.cu`` and one JSON line with all of it and the card's name and
power limit. With ``--bits DIR`` the first row's three tangents are saved
under DIR by the first checkout run, and each later run reads them back and
reports ``tangent_vs_saved``: whether its own are bit-equal, and the largest
gap relative to the block's largest |entry|. With ``--hessian`` it also runs
chip_smoke phase (j)'s Hessian (this checkout's ``chip_smoke.j_problem``:
the ML fit at 2 x 2,500, then ``torch.autograd.functional.hessian`` of the
plain-AD NLL, float64 at the fit and float32 at the fit with its nuggets
raised to 0.1, as (j) runs them) and prints per dtype its wall (host clock
around a synchronize: the least of three after a warm-up, and all three)
and its peak device memory (``torch.cuda.max_memory_allocated`` over the
Hessian, and what was allocated before it); then one float64 Hessian at
chip_smoke's ``K_PARAMS`` (l = 700 km, nuggets 0.1, rho = -0.5: a valid
model, so positive definite at every size, where (j)'s fit is not on the
whole month) on every 5th, 2nd and every observation of the month and on
a month of 2 x 14,000 (N = 5,000, 12,500, 25,000 and 28,000): at each its
NLL, peak memory (or that it ran out of memory) and wall, and the N at which
the least-squares quadratic through those peaks reaches the memory the
process can allocate (what the card has free, plus what the process
holds), the largest N whose float64 Hessian fits.
"""

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


# the memory scan's data: (observations per process, stride) of chip_smoke's
# synthetic month, N = 5,000, 12,500, 25,000, and a larger month, 28,000
MEMORY_SIZES = ((12_500, 5), (12_500, 2), (12_500, 1), (14_000, 1))


def timed(fn, reps=5, runs=3, head_start_ms=0.0):
    """The least of ``runs`` CUDA-event means over ``reps`` calls, after a
    warm-up; ``head_start_ms``: the card sleeps that long first, so the host
    queues the calls before the card reaches them (the card's time alone)."""
    import torch

    fn()
    best = None
    for _ in range(runs):
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if head_start_ms:
            torch.cuda._sleep(int(head_start_ms * 2e6))  # cycles at <= 2 GHz
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop) / reps
        best = ms if best is None else min(best, ms)
    return best


def tangent_rows(K, blocks, nu_t, ls_t, dual, scale, weights, parts=None):
    """A Hessian's tangents one at a time (rows outer, blocks inner, as the
    backward runs them): with the split, the blocks' partials built first
    (or ``parts``, built beforehand) and each row combined from them; in a
    checkout before the split, the fused tangent launch per row and block."""
    if not hasattr(K, "matern_block_partials"):
        for w in weights:
            for h, s in blocks:
                yield K.matern_block_tangent(scale, nu_t, ls_t, h, w, s, table=dual)
        return
    if parts is None:
        parts = [K.matern_block_partials(nu_t, ls_t, h, s, table=dual) for h, s in blocks]
    for w in weights:
        for p in parts:
            yield K.matern_block_tangent(scale, w, p)


def drain(rows):
    for _ in rows:
        pass


def compare_bits(path, tangents, hs):
    """Save the tangents at ``path``, or where a file is there already,
    compare with it: whether they are bit-equal, how many entries differ,
    the largest gap over the block's max |entry|, and at that entry its
    block, index, h and both values (``float.hex``)."""
    import torch

    if not path.exists():
        torch.save(tangents, path)
        return "saved"
    saved = torch.load(path)
    out = {"bit_equal": all(torch.equal(a, b) for a, b in zip(tangents, saved)),
           "entries_differing": sum(int((a != b).sum()) for a, b in zip(tangents, saved)),
           "max_rel_gap": 0.0}
    for k, (a, b, h) in enumerate(zip(tangents, saved, hs)):
        gap = (a.double() - b.double()).abs()
        rel = float(gap.max() / b.abs().max())
        if rel > out["max_rel_gap"]:
            i = int(gap.argmax())
            out.update(max_rel_gap=rel, worst_block=k, worst_index=divmod(i, a.shape[1]),
                       worst_h=float(h.reshape(-1)[i]).hex(), worst_saved=float(b.reshape(-1)[i]).hex(),
                       worst_got=float(a.reshape(-1)[i]).hex())
    return out


def hessian_walls(out):
    """(j)'s Hessian in both dtypes: wall and peak memory (see above)."""
    import importlib.util

    import torch

    from cokriging_tpu_torch.cov.params import MaternParams
    from cokriging_tpu_torch.estimate.nll import _fit_inputs, neg_log_likelihood

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    mf, params, _ = cs.j_problem()
    lifted = params.to_flat().detach().clone()
    lifted[8:10] = torch.clamp_min(lifted[8:10], 0.1)
    for name, p in (("float64", params), ("float32", params.with_flat(lifted))):
        td = getattr(torch, name)
        m, p = mf.astype(td), p.astype(td)
        _, dists, z, _ = _fit_inputs(m, p, False, True, "cuda")
        flat = p.to_flat().detach().to("cuda")

        def fn(f):
            return neg_log_likelihood(f, dists, z, p.spec, None, cs.J_JITTER, analytic_grad=False)

        torch.autograd.functional.hessian(fn, flat)
        walls, peaks = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            h = torch.autograd.functional.hessian(fn, flat)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated() / 2**20)
            del h
        rec = {"wall_s": min(walls), "walls_s": walls, "peak_mb": max(peaks),
               "base_mb": base / 2**20}
        out[f"hessian {name}"] = rec
        print(f"(j)'s Hessian {name}: wall {rec['wall_s']:.4f} s (runs "
              f"{', '.join(f'{w:.4f}' for w in walls)}), peak {rec['peak_mb']:.1f} MiB "
              f"({rec['base_mb']:.1f} before)", flush=True)
    del m, p, dists, z, flat, fn
    torch.cuda.empty_cache()
    memory_scan(cs, MaternParams.from_flat(torch.tensor(cs.K_PARAMS, dtype=torch.float64)), out)


def memory_scan(cs, params, out):
    """Peak memory and wall of one float64 Hessian at ``params`` against N
    (see above)."""
    import torch

    from cokriging_tpu_torch.estimate.nll import _fit_inputs, neg_log_likelihood
    from cokriging_tpu_torch.fields.field import Field, MultiField

    month = cs.build_inputs(cs.N_PER_PROC, np.float64, noise_seed=1)
    runs = {}
    for n_proc, stride in MEMORY_SIZES:
        c1, v1, c2, v2 = month if n_proc == cs.N_PER_PROC else cs.build_inputs(
            n_proc, np.float64, noise_seed=1)
        fields = [Field.from_arrays(c[::stride], v[::stride], f"Z{k}")
                  for k, (c, v) in enumerate(((c1, v1), (c2, v2)))]
        for f in fields:
            f.geodesic = True
        n = sum(len(f.values) for f in fields)
        _, dists, z, _ = _fit_inputs(MultiField(fields=fields), params, False, True, "cuda")
        flat = params.to_flat().detach().to("cuda")

        def fn(f):
            return neg_log_likelihood(f, dists, z, params.spec, None, cs.J_JITTER,
                                      analytic_grad=False)

        with torch.no_grad():
            value = float(fn(flat))
        run = {"nll": value, "pd": value < 1e6 * (1 + n / 2)}  # the not-PD penalty
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            h = torch.autograd.functional.hessian(fn, flat)
            torch.cuda.synchronize()
            run.update(peak_mb=torch.cuda.max_memory_allocated() / 2**20,
                       wall_s=time.perf_counter() - t0, finite=bool(torch.isfinite(h).all()))
            del h
        except torch.cuda.OutOfMemoryError:
            run["peak_mb"] = None
        runs[n] = run
        print(f"float64 Hessian at N = {n}: {run}", flush=True)
        del dists, z, flat, fn
        torch.cuda.empty_cache()
    rec = {"runs": runs}
    free, _ = torch.cuda.mem_get_info()
    limit = (free + torch.cuda.memory_reserved()) / 2**20
    known = {n: r["peak_mb"] for n, r in runs.items() if r["pd"] and r["peak_mb"] is not None}
    if len(known) >= 3:
        a, b, c = np.polyfit(list(known), list(known.values()), 2)
        rec.update(limit_mb=limit, fit=[a, b, c],
                   largest_n=float(max(np.roots([a, b, c - limit]).real)))
        print(f"float64 Hessian: peak ~ {a:.6g} N^2 + {b:.6g} N + {c:.6g} MiB over N in "
              f"{sorted(known)}; {limit:.0f} MiB allocatable: largest N "
              f"{rec['largest_n']:.0f}", flush=True)
    out["hessian float64 memory"] = rec


def main(root, bits=None, hessian=False):
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    from cokriging_tpu_torch.kernels import _build
    from cokriging_tpu_torch.kernels import cuda_ops as K
    from cokriging_tpu_torch.kernels.distance import haversine_matrix

    ptxas, keep = [], False
    for ln in _build.build()["ptxas"]:
        keep = ("matern_hess" in ln or "matern_grad" in ln) if ln.startswith("==") else keep
        if keep:
            ptxas.append(ln)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    rng = np.random.default_rng(0)
    pts = []
    for _ in range(2):
        lat, lon = rng.uniform(24.0, 50.0, 12_500), rng.uniform(-124.0, -67.0, 12_500)
        pts.append(np.column_stack([lat, lon])[::5])
    out = {"root": str(root), "card": smi}
    if hessian:  # first, with nothing else held on the card
        hessian_walls(out)
    for name in ("float32", "float64"):
        td = getattr(torch, name)
        ft = getattr(np, name)
        a, b = (torch.as_tensor(p, dtype=td, device="cuda") for p in pts)
        blocks = [(haversine_matrix(a, a), True), (haversine_matrix(a, b), False),
                  (haversine_matrix(b, b), True)]
        gen = torch.Generator(device="cuda").manual_seed(3)
        cts = [torch.randn(h.shape, dtype=td, device="cuda", generator=gen) for h, _ in blocks]
        weights = list(torch.as_tensor(np.random.default_rng(5).normal(size=(11, 4)),
                                       device="cuda"))
        t_scale = torch.tensor(1.7, dtype=torch.float64, device="cuda")
        for nu in (1.37, float(np.nextafter(ft(1.5), ft(0))), float(np.nextafter(ft(1.5), ft(2))),
                   1.5):
            nu_t = torch.tensor(nu, dtype=td, device="cuda")
            ls_t = torch.tensor(700.0, dtype=td, device="cuda")
            row = K.recurrence_table(nu_t, ls_t, td, order=2)[0]
            dual = K.recurrence_table(nu_t, ls_t, td, order=1)[0]
            one = torch.ones((), dtype=td, device="cuda")

            def sums(table):
                return [K.matern_block_hess(nu, 700.0, h, ct, symmetric=s, table=table)
                        for (h, s), ct in zip(blocks, cts)]

            args = (K, blocks, nu_t, ls_t, dual, t_scale, weights)
            rec = {"hess_built_ms": timed(lambda: sums(None)),
                   "hess_kernel_ms": timed(lambda: sums(row)),
                   "row_build_ms": timed(lambda: K.recurrence_table(nu_t, ls_t, td, order=2)),
                   "tangent_hessian_ms": timed(lambda: drain(tangent_rows(*args)))}
            if hasattr(K, "matern_block_partials"):
                def partials():
                    return [K.matern_block_partials(nu_t, ls_t, h, s, table=dual)
                            for h, s in blocks]

                parts = partials()
                rec["partials_ms"] = timed(partials)
                rec["combines_ms"] = timed(lambda: drain(tangent_rows(*args, parts=parts)))
                rec["combines_device_ms"] = timed(
                    lambda: drain(tangent_rows(*args, parts=parts)), reps=1, head_start_ms=20.0)
                del parts
            rec["block_grad_ms"] = timed(lambda: [K.matern_block_grad(one, one, nu_t, ls_t, h, ct,
                                                                      s, table=dual)
                                                  for (h, s), ct in zip(blocks, cts)])
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            sha, first, finite = hashlib.sha256(), [], True
            for k, t in enumerate(tangent_rows(*args)):
                sha.update(t.cpu().numpy().tobytes())
                finite = finite and bool(torch.isfinite(t).all())
                if k < len(blocks):
                    first.append(t.cpu())
            rec["tangent_peak_mb"] = (torch.cuda.max_memory_allocated() - base) / 2**20
            rec["tangent_sha256"] = sha.hexdigest()
            rec["tangent_finite"] = finite
            if bits is not None:
                rec["tangent_vs_saved"] = compare_bits(bits / f"{name}_nu{nu!r}.pt", first,
                                                       [h.cpu() for h, _ in blocks])
            got, built = torch.stack(sums(row)), torch.stack(sums(None))
            scale = got.abs().clamp_min(1e-300)
            rec["prebuilt_vs_built_rel"] = float(((got - built).abs() / scale).max())
            rec["finite"] = bool(torch.isfinite(got).all())
            grads = torch.stack([K.matern_block_grad(one, one, nu_t, ls_t, h, ct, s, table=dual)
                                 for (h, s), ct in zip(blocks, cts)])
            rec["sums_hex"] = [float(v).hex() for v in got.flatten().tolist()]
            rec["block_grad_hex"] = [float(v).hex() for v in grads.flatten().tolist()]
            out[f"{name} nu={nu!r}"] = rec
            print(f"{name} nu={nu!r}: " + ", ".join(
                f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}" for k, v in rec.items()
                if not k.endswith("_hex"))
                + " (three 2500^2 blocks)", flush=True)
    for line in ptxas:
        print(line)
    print(smi)
    out["ptxas"] = ptxas
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    hessian = "--hessian" in args
    if hessian:
        args.remove("--hessian")
    bits = None
    if "--bits" in args:
        i = args.index("--bits")
        bits = Path(args[i + 1]).resolve()
        bits.mkdir(parents=True, exist_ok=True)
        del args[i:i + 2]
    sys.exit(main(Path(args[0]).resolve() if args else Path(__file__).resolve().parents[1], bits,
                  hessian))
