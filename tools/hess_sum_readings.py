#!/usr/bin/env python3
"""The Hessian-sum kernel (``kernels/csrc/matern_hess.cu``) against its plain
version at the cases of ``tests/test_torch_cuda.py::
test_block_hess_kernel_matches_plain``, on one CUDA card.

    python3 tools/hess_sum_readings.py

Per case (dtype, nu, ls, full or symmetric block) it prints, sum by sum,
|kernel - plain| / sum|terms| (the quantity the test bounds) and what a
kernel that left that sum out would read, |plain| / sum|terms|; for the
symmetric blocks also the symmetric launch against the full one. The last
line holds the largest reading per dtype and sum, from which the test's bars
are set.
"""

import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main():
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_cuda import _points

    from cokriging_tpu_torch.kernels import cuda_ops as K
    from cokriging_tpu_torch.kernels.distance import haversine_matrix

    cuda = torch.device("cuda")
    worst = {}
    fmt = {"float_kind": lambda v: f"{v:.2e}"}
    for dtype in (torch.float32, torch.float64):
        w = worst.setdefault(str(dtype).replace("torch.", ""), np.zeros(5))
        for nu, ls in [(0.3, 300.0), (0.5, 300.0), (1.5, 800.0), (2.7, 1500.0)]:
            rng = np.random.default_rng(42)  # the test's draws, in its order
            a = _points(rng, 300, dtype, cuda)
            b = torch.cat([a[:7], _points(rng, 210, dtype, cuda)])
            h = haversine_matrix(a, torch.cat([b, b]))[:, :217]
            hs = haversine_matrix(a, a)
            for hh, sym in ((h, False), (hs, True)):
                ct = torch.as_tensor(rng.normal(size=tuple(hh.shape)), dtype=dtype, device=cuda)
                got = K.matern_block_hess(nu, ls, hh, ct, symmetric=sym)
                ref, mag = K.matern_block_hess_plain(nu, ls, hh, ct, symmetric=sym,
                                                     magnitude=True)
                rel = ((got - ref).abs() / mag).cpu().numpy()
                drop = (ref.abs() / mag).cpu().numpy()
                np.maximum(w, rel, out=w)
                line = (f"{dtype} nu {nu} ls {ls} {'symmetric' if sym else 'full'}: "
                        f"err {np.array2string(rel, formatter=fmt)} "
                        f"left out {np.array2string(drop, formatter=fmt)}")
                if sym:
                    full = K.matern_block_hess(nu, ls, hh, ct)
                    relf = ((got - full).abs() / mag).cpu().numpy()
                    np.maximum(w, relf, out=w)
                    line += f" symmetric vs full {np.array2string(relf, formatter=fmt)}"
                print(line, flush=True)
    print(json.dumps({k: v.tolist() for k, v in worst.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
