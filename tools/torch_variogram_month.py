#!/usr/bin/env python3
"""The PyTorch port's variogram stage on bench.py's month, on one CUDA card,
for comparing two checkouts of ``cokriging_tpu_torch`` in one call.

    python3 tools/torch_variogram_month.py [ROOT]

ROOT is the checkout whose ``cokriging_tpu_torch`` is imported (default:
this one); its kernels are built into ROOT/build. Inputs are chip_smoke.py's
copy of bench.py's synthetic month (2 x 12,500 points, seed 0, values of
noise seed 2; 15 bins to 3000 km, geodesic, semivariogram). Per dtype
(float32, float64):

- ``stage_s``: wall of ``empirical_variograms_device`` (host clock, ending in
  a synchronize), five runs after a warm-up, and the launches of one run;
- ``minmax_ms`` / ``bin_ms``: CUDA-event time of one pass over the three
  variograms as the stage launches it (the one-variogram wrappers once per
  variogram where the checkout has no multi-variogram wrappers), the mean of
  20 calls queued behind a 50 ms sleep of the card so that the wrappers' host
  work is hidden, the least of three such rounds;
- the counts' totals per variogram and their sha256;
- the same two passes at 2 x 60,000 points (``large``), kernel only.

Prints the card's name and power limit and one JSON line. Run it from each
checkout in turns (parent, change, change, parent) and compare.
"""

import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]


def passes(K, E, month, dtype):
    """Thunks of the two passes over the month's three variograms, as the
    checkout's stage launches them."""
    import chip_smoke as S

    np_dt = np.dtype(dtype)
    feats, vals, h_max, h_snap, snap = S.variogram_case(*month, dtype, "cuda")
    mm_sides, sides = S.vario_sides(feats, vals, S.MONTH_PAIRS)
    if hasattr(K, "variogram_minmax_pairs"):
        hr = K.variogram_minmax_pairs(mm_sides, True, h_max, h_snap).cpu().numpy()
        edges = [E._device_bins(lo, hi, True, np_dt.type(snap), 15, np_dt)[1] for lo, hi in hr]
        return (lambda: K.variogram_minmax_pairs(mm_sides, True, h_max, h_snap),
                lambda: K.variogram_bin_pairs(sides, edges, True, False, h_max))
    import torch

    edges = [torch.as_tensor(E._device_bins(*K.variogram_minmax(*sd, True, h_max, h_snap)
                                            .cpu().numpy(), True, np_dt.type(snap), 15, np_dt)[1],
                             device="cuda") for sd in mm_sides]
    return (lambda: [K.variogram_minmax(*sd, True, h_max, h_snap) for sd in mm_sides],
            lambda: [K.variogram_bin(*sd[:4], e, sd[4], True, False, h_max)
                     for sd, e in zip(sides, edges)])


def main(root):
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import chip_smoke as S  # this checkout's, before ROOT (which has its own) comes first

    sys.path.insert(0, str(root))
    from cokriging_tpu_torch.estimate import empirical as E
    from cokriging_tpu_torch.kernels import cuda_ops as K

    out = {"root": str(root), "package": str(Path(K.__file__).resolve().parents[1]),
           "device": torch.cuda.get_device_name(0)}
    print(S.nvidia_smi_line(), flush=True)
    cfg = E.VarioConfig(max_dist=3_000.0, n_bins=15, geodesic=True)
    for dtype in (np.float32, np.float64):
        c1, _, c2, _ = S.build_inputs(S.N_PER_PROC, dtype)
        _, v1, _, v2 = S.build_inputs(S.N_PER_PROC, dtype, noise_seed=2)
        E.empirical_variograms_device([c1, c2], [v1, v2], cfg)
        walls = []
        for _ in range(5):
            K.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, _, counts = E.empirical_variograms_device([c1, c2], [v1, v2], cfg)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        res = {"stage_s": walls, "stage_min_s": min(walls), "launches": K.launch_counts(),
               "counts_per_pair": counts.sum(axis=1).tolist(),
               "counts_sha256": hashlib.sha256(np.ascontiguousarray(counts).tobytes()).hexdigest()}
        for key, month, reps in (("month", (c1, v1, c2, v2), 20),
                                 ("large", S.build_inputs(S.N_LARGE, dtype), 5)):
            mm, bn = passes(K, E, month, dtype)
            times = {f"{k}_ms": min(S.cuda_time_ms(fn, reps, head_start_ms=50.0) for _ in range(3))
                     for k, fn in (("minmax", mm), ("bin", bn))}
            if key == "month":
                res.update(times)
            else:
                res["large"] = times
        out[np.dtype(dtype).name] = res
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE))
