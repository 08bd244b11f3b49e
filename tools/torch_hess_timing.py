#!/usr/bin/env python3
"""Time the second-order kernels of ``kernels/csrc/matern_hess.cu`` (the
Hessian sums and the block tangent) for the port checkout at ROOT, on one
CUDA card.

    python3 tools/torch_hess_timing.py [ROOT]

ROOT (default: this checkout) is put first on ``sys.path``, so a ``git
archive`` of another commit unpacked beside this one can be timed in the
same call: run parent, change, change, parent. The blocks are chip_smoke
phase (j)'s shapes: every 5th point of bench.py's synthetic month (2 x
2,500), its three 2,500^2 blocks (symmetric, full, symmetric) with a random
cotangent, at nu = 1.37 (every CF2 lane runs to convergence), nu = 1.5 -+ one
ulp of the dtype (lanes that stop after CF2's first trip) and nu = 1.5, ls =
700 km. Per dtype and order it prints the CUDA-event time of the three
Hessian-sum launches and of the three tangent launches (the least of three
runs of 5 launches each, after a warm-up), then one JSON line with all of
them and the card's name and power limit.
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

    _build.build()
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
            hess = timed(lambda: [K.matern_block_hess(nu, 700.0, h, ct, symmetric=s)
                                  for (h, s), ct in zip(blocks, cts)])
            tan = timed(lambda: [K.matern_block_tangent(1.7, nu, 700.0, h, w, symmetric=s)
                                 for h, s in blocks])
            out[f"{name} nu={nu!r}"] = {"hess_ms": hess, "tangent_ms": tan}
            print(f"{name} nu={nu!r}: Hessian sums {hess:.3f} ms, tangent {tan:.3f} ms "
                  f"(three 2500^2 blocks)", flush=True)
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(Path(sys.argv[1]).resolve() if len(sys.argv) > 1
                  else Path(__file__).resolve().parents[1]))
