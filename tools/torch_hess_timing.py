#!/usr/bin/env python3
"""Time the second-order kernels of ``kernels/csrc/matern_hess.cu`` (the
Hessian sums and the block tangent) and the second-order row build for the
port checkout at ROOT, on one CUDA card.

    python3 tools/torch_hess_timing.py [ROOT]

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
- ``tangent_ms``: the three tangent launches;
- ``block_grad_ms``: the three block-gradient launches (``matern_grad.cu``,
  whose kernel shares the Hessian sums' tiled skeleton, ``tile_sum.cuh``)
  with their dual row built beforehand;

the largest relative gap between the kernel's sums with and without a
prebuilt row (0: the same bits), the sums and block gradients themselves
(``float.hex``, to compare two checkouts' bits), then the ptxas lines of
``matern_hess.cu`` and ``matern_grad.cu`` and one JSON line with all of it
and the card's name and power limit.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np


def timed(fn, reps=5, runs=3):
    import torch

    fn()
    best = None
    for _ in range(runs):
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop) / reps
        best = ms if best is None else min(best, ms)
    return best


def main(root):
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
    for name in ("float32", "float64"):
        td = getattr(torch, name)
        ft = getattr(np, name)
        a, b = (torch.as_tensor(p, dtype=td, device="cuda") for p in pts)
        blocks = [(haversine_matrix(a, a), True), (haversine_matrix(a, b), False),
                  (haversine_matrix(b, b), True)]
        gen = torch.Generator(device="cuda").manual_seed(3)
        cts = [torch.randn(h.shape, dtype=td, device="cuda", generator=gen) for h, _ in blocks]
        w = torch.tensor([0.7, -1.3, 0.4, 2.1e-3], dtype=torch.float64, device="cuda")
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

            rec = {"hess_built_ms": timed(lambda: sums(None)),
                   "hess_kernel_ms": timed(lambda: sums(row)),
                   "row_build_ms": timed(lambda: K.recurrence_table(nu_t, ls_t, td, order=2)),
                   "tangent_ms": timed(lambda: [K.matern_block_tangent(1.7, nu, 700.0, h, w,
                                                                       symmetric=s)
                                                for h, s in blocks]),
                   "block_grad_ms": timed(lambda: [K.matern_block_grad(one, one, nu_t, ls_t, h, ct,
                                                                       s, table=dual)
                                                   for (h, s), ct in zip(blocks, cts)])}
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
    sys.exit(main(Path(sys.argv[1]).resolve() if len(sys.argv) > 1
                  else Path(__file__).resolve().parents[1]))
