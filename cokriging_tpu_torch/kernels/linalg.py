"""Batched SPD solves for the local cokriging systems.

Counterpart of ``cokriging_tpu/kernels/linalg.py::blocked_spd_solve``. The
JAX package hand-blocks its Cholesky to keep a TPU's matrix unit busy; on
the card, the batched factorization and triangular solves of
``torch.linalg`` (cuSOLVER/cuBLAS) do the same work.
"""

import torch


def spd_solve(A, c):
    """Solve the batched SPD systems A x = c.

    Args:
        A: (..., k, k) SPD matrices (masked lanes already identity rows).
        c: (..., k) right-hand sides.

    Returns:
        (x, ok): the solutions, NaN on every lane whose factorization failed
        (the reference's LinAlgError -> NaN path,
        src/point_prediction.py:218-222), and the (...,) success flags.
    """
    L, info = torch.linalg.cholesky_ex(A)
    ok = info == 0
    x = torch.cholesky_solve(c.unsqueeze(-1), L).squeeze(-1)
    return torch.where(ok[..., None], x, torch.nan), ok
