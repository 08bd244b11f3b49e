"""bench.py's month at full size: the port on the card against the JAX
package on the host, float64.

Run on a machine with an NVIDIA card and the JAX package's dependencies
(jax, optax, pandas):

    python -m pytest --noconftest -m gpu -s tests/test_torch_bench_month.py

It takes minutes (two 600-step fits at n = 2 x 12,500). Without a card it
skips (the check is made in a fixture).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def card_and_reference():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pytest.importorskip("optax")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, str(ROOT))


def test_bench_month_fit_and_predictions_follow_the_reference(card_and_reference):
    import bench
    import chip_smoke
    from cokriging_tpu_torch.data.grids import prediction_coords

    dt = np.float64
    pc = prediction_coords()
    c1, v1, c2, v2 = bench.build_inputs(dt, noise_seed=2)
    jparams, jout = bench.run_pipeline(c1, v1, c2, v2, pc, None, dt)
    tparams, _, tout, times, _ = chip_smoke.run_pipeline(
        *(np.asarray(a) for a in (c1, v1, c2, v2)), pc, dt, "cuda")
    jx = np.asarray(jparams.to_flat())
    tx = tparams.to_flat().cpu().numpy()
    j_ok = np.isfinite(jout["pred"].values)
    t_ok = np.isfinite(tout.pred)
    print(f"\nreference params {np.array2string(jx, precision=5)}")
    print(f"port params      {np.array2string(tx, precision=5)}")
    print(f"finite predictions: reference {j_ok.mean():.6f}, port {t_ok.mean():.6f}; "
          f"port stages {times}")
    # Both fits start at nu = 1.5, where the reference's CF2 dK/dnu jumps by
    # ~1.7% across the order, and their box transforms land on different
    # sides of it (ROADMAP Queue 3): the trajectories part at ~5e-3.
    np.testing.assert_allclose(tx, jx, rtol=1e-2)
    assert abs(t_ok.mean() - j_ok.mean()) < 5e-3
    # under this indefinite fitted model some local systems that still
    # factor are near-singular, so the ~5e-3 parameter gap moves a few
    # predictions by ~0.15; the bulk agrees closely
    both = j_ok & t_ok
    gap = np.abs(tout.pred[both] - jout["pred"].values[both])
    print(f"prediction gap at {both.sum()} shared cells: median {np.median(gap):.3e}, "
          f"95th percentile {np.percentile(gap, 95):.3e}, max {gap.max():.3e}")
    assert np.percentile(gap, 95) < 5e-2
