"""Dense linear algebra of the port: batched SPD solves for the local
cokriging systems, and the inverses the exact likelihood needs.

Counterpart of ``cokriging_tpu/kernels/linalg.py``. The JAX package
hand-blocks its Cholesky (``blocked_spd_solve``) to keep a TPU's matrix unit
busy, and its triangular inverse and SPD inverse (``tri_inv_lower``,
``spd_inverse_from_chol``) to get around XLA's triangular-solve expander;
none of that is a Pallas kernel. On the card the factorizations, triangular
solves and inverses of ``torch.linalg`` (cuSOLVER/cuBLAS) do the same work;
the names are kept so a reader finds them.
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


def tri_inv_lower(L):
    """Inverse of a lower-triangular (n, n) matrix (strictly-upper entries
    of ``L`` are ignored)."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def spd_inverse_from_chol(chol):
    """C^-1 = L^-T L^-1 from the lower Cholesky factor L of C."""
    return torch.cholesky_inverse(chol)
