"""The JAX package's random draws, reproduced with numpy.

``jax.random`` with its default generator (threefry2x32, partitionable
counters) is a counter-based hash, so its normals can be computed without
JAX: the key of a seed is its two 32-bit halves, ``split`` hashes the
counters 0 .. num - 1, and ``normal`` hashes the counters 0 .. n - 1 to
64 bits, keeps 52 of them as a float in [1, 2), maps it to (-1, 1) and takes
sqrt(2) erfinv. The bits, the uniforms and the keys are exact; the normals
agree with ``jax.random.normal`` to ~1e-14 (scipy's ``erfinv`` against
XLA's, in the far tails).

``ReferenceDrawField`` is ``sim.BivariateRandomField`` with the JAX
simulator's draws (``cokriging_tpu/sim/cofield.py``): the cofield's
normals from ``PRNGKey(seed)``, each process's measurement noise from a
split of ``PRNGKey(sample seed + 1)``. With it the simulation experiment
runs the JAX script's own realization (up to the two Cholesky factors'
rounding), so its statistics compare with the JAX package's manifest.
"""

import numpy as np
import torch

from cokriging_tpu_torch.sim.cofield import BivariateRandomField

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _threefry2x32(key, count):
    """Threefry-2x32 (20 rounds) of the 64-bit counters ``count`` under
    ``key``: the two uint32 output words."""
    k1, k2 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(count >> np.uint64(32)).astype(np.uint32) + ks[0],
         (count & np.uint64(0xFFFFFFFF)).astype(np.uint32) + ks[1]]
    for r in range(5):
        for rot in _ROTATIONS[r % 2]:
            x[0] = x[0] + x[1]
            x[1] = (x[1] << np.uint32(rot)) | (x[1] >> np.uint32(32 - rot))
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(r + 1) % 3]
        x[1] = x[1] + ks[(r + 2) % 3] + np.uint32(r + 1)
    return x


def prng_key(seed: int):
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32 bits."""
    seed = int(seed)
    return np.uint32((seed >> 32) & 0xFFFFFFFF), np.uint32(seed & 0xFFFFFFFF)


def split(key, num: int = 2):
    """``jax.random.split(key, num)`` as a list of keys."""
    b1, b2 = _threefry2x32(key, np.arange(num, dtype=np.uint64))
    return [(b1[j], b2[j]) for j in range(num)]


def normal(key, n: int) -> np.ndarray:
    """``jax.random.normal(key, (n,), float64)``."""
    from scipy.special import erfinv

    b1, b2 = _threefry2x32(key, np.arange(n, dtype=np.uint64))
    bits = (b1.astype(np.uint64) << np.uint64(32)) | b2.astype(np.uint64)
    one = np.array(1.0).view(np.uint64)
    u01 = ((bits >> np.uint64(12)) | one).view(np.float64) - 1.0
    lo = np.nextafter(-1.0, 0.0)
    return np.sqrt(2.0) * erfinv(np.maximum(lo, u01 * (1.0 - lo) + lo))


class ReferenceDrawField(BivariateRandomField):
    """``BivariateRandomField`` whose normals are the JAX simulator's."""

    def _field_noise(self) -> torch.Tensor:
        z = normal(prng_key(self.seed), self.n_procs * self.grid.count)
        return torch.as_tensor(z, device=self.device)

    def _sample_noise(self, seed: int, size: int) -> np.ndarray:
        key, rows = prng_key(seed), []
        for _ in range(self.n_procs):
            key, sub = split(key)
            rows.append(normal(sub, size))
        return np.stack(rows)
