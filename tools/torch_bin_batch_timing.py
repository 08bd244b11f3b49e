#!/usr/bin/env python3
"""Time the replicate-batched bin pass of ``kernels/csrc/variogram.cu``
(``cuda_ops.variogram_bin_batch``, the parametric bootstrap's re-estimate)
for the port checkout at ROOT, on one CUDA card.

    python3 tools/torch_bin_batch_timing.py [ROOT] [--profile]

ROOT (default: this checkout) is put first on ``sys.path``, so a ``git
archive`` of another commit unpacked beside this one can be timed in the
same call: run parent, change, change, parent. The shapes are chip_smoke
phase (i)'s: 2 x 12,500 points drawn uniformly on [0, 100]^2 (seed 0; the
spectral sample's domain), Euclidean, 15 bins to 30, the three variograms
of ``estimate.bootstrap.batched_variograms`` (whose launch arguments are
captured and replayed), with B standard normal replicates: float64 at 200,
float32 at 50 and at 200; and float64 at 200 with 20 bins to 40 (a window
over 16 bins: the walk's wider instantiation). Per case it prints the CUDA-event time of one
batched launch (the least of three runs of 3 calls, after a warm-up), of
the B single-replicate launches of the one-replicate pass
(``variogram_bin_pairs``, the yardstick, one run), the batched sums' largest
relative gap to those launches (bar 1e-12 / 1e-5) with their counts equal,
whether two batched runs are bit-equal, whether the first replicates'
sums equal those of a smaller B of the same dtype and bins bit for bit (the
order of a replicate's sums does not depend on B), the pairs and binned
pairs (with
``--profile``, each kernel's device time in one call, from
``torch.profiler``), then
the ptxas lines of ``variogram.cu``'s batched kernels and one JSON line with
all of it and the card's name and power limit.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

N = 12_500
CASES = (("float64", 200, 15), ("float32", 50, 15), ("float32", 200, 15), ("float64", 200, 20))


def timed(fn, reps=3, runs=3, warm=True):
    import torch

    if warm:
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


def kernel_times(fn):
    """Device time per kernel name (ms) of one call of ``fn`` under
    ``torch.profiler`` (CUPTI), after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0.0)
        if t and e.key and not e.key.startswith(("aten::", "cuda", "Memcpy", "Memset")):
            out[e.key[:60]] = t / 1e3
    return out


def main(root, profile=False):
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    from cokriging_tpu_torch.estimate import bootstrap as TB
    from cokriging_tpu_torch.estimate.empirical import VarioConfig
    from cokriging_tpu_torch.kernels import _build
    from cokriging_tpu_torch.kernels import cuda_ops as K

    ptxas, keep = [], False
    for ln in _build.build()["ptxas"]:
        if ln.startswith("=="):
            keep = "variogram" in ln
        elif keep and ("batch" in ln or "registers" in ln or "spill" in ln):
            ptxas.append(ln)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    rng = np.random.default_rng(0)
    coords = [rng.uniform(0.0, 100.0, (N, 2)) for _ in range(2)]
    values = [rng.standard_normal((max(c[1] for c in CASES), N)) for _ in range(2)]
    out = {"root": str(root), "card": smi}
    smaller = {}
    for name, B, n_bins in CASES:
        cfg = VarioConfig(max_dist=2.0 * n_bins, n_bins=n_bins, geodesic=False)
        td = getattr(torch, name)
        calls = []
        orig = TB.variogram_bin_batch

        def spy(*args):
            calls.append(args)
            return orig(*args)

        TB.variogram_bin_batch = spy
        try:
            TB.batched_variograms([torch.as_tensor(c, dtype=td) for c in coords],
                                  [torch.as_tensor(v[:B], dtype=td) for v in values], cfg)
        finally:
            TB.variogram_bin_batch = orig
        sides, edges, geodesic, cov, h_max = calls[0]
        rec = {"ms": timed(lambda: K.variogram_bin_batch(sides, edges, geodesic, cov, h_max))}
        s1, n1 = K.variogram_bin_batch(sides, edges, geodesic, cov, h_max)
        s2, n2 = K.variogram_bin_batch(sides, edges, geodesic, cov, h_max)
        rec["run_to_run_equal"] = bool(torch.equal(s1, s2) and torch.equal(n1, n2))
        if (name, n_bins) in smaller:
            s0 = smaller[name, n_bins]
            rec["first_reps_equal_smaller_B"] = bool(torch.equal(s1[:, :s0.shape[1]], s0))
        else:
            smaller[name, n_bins] = s1
        singles = [[(fa, fb, va[b].contiguous(), vb[b].contiguous(), m)
                    for fa, fb, va, vb, m in sides] for b in range(B)]
        kept = {}

        def yard():
            kept["out"] = [K.variogram_bin_pairs(s, edges, geodesic, cov, h_max) for s in singles]

        rec["yardstick_ms"] = timed(yard, reps=1, runs=1, warm=False)
        rel, counts_equal = 0.0, True
        for b, (sb, nb) in enumerate(kept["out"]):
            counts_equal = counts_equal and bool(torch.equal(nb, n1))
            rel = max(rel, float(((s1[:, b] - sb).abs() / sb.abs().clamp_min(1e-300)).max()))
        rec["rel_to_singles"] = rel
        rec["counts_equal"] = counts_equal
        rec["pairs"] = int(sum(fa.shape[0] * (fa.shape[0] - 1) // 2 if m
                               else fa.shape[0] * fb.shape[0] for fa, fb, _, _, m in sides))
        rec["binned"] = int(n1.sum())
        if profile:
            rec["kernels_ms"] = kernel_times(lambda: K.variogram_bin_batch(sides, edges, geodesic,
                                                                           cov, h_max))
        key = f"{name} B={B}" + ("" if n_bins == 15 else f" bins={n_bins}")
        out[key] = rec
        print(f"{key}: " + ", ".join(f"{k} {v:.4g}" if isinstance(v, float) else
                                           f"{k} {v}" for k, v in rec.items()), flush=True)
        del kept, singles
        torch.cuda.empty_cache()
    for line in ptxas:
        print(line)
    print(smi)
    out["ptxas"] = ptxas
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--profile"]
    sys.exit(main(Path(args[0]).resolve() if args else Path(__file__).resolve().parents[1],
                  profile="--profile" in sys.argv[1:]))
