"""The JAX package's random draws, reproduced with numpy.

``jax.random`` with its default generator (threefry2x32, partitionable
counters) is a counter-based hash, so its normals can be computed without
JAX: the key of a seed is its two 32-bit halves, ``split`` hashes the
counters 0 .. num - 1, and ``normal`` hashes the counters 0 .. n - 1 to
64 bits, keeps 52 of them as a float in [1, 2), maps it to (-1, 1) and takes
sqrt(2) erfinv with XLA's float64 ``erf_inv`` (Giles' polynomials, their
multiply-adds fused through long double as XLA's CPU code fuses them). The
bits, the uniforms and the keys are exact; the normals agree with
``jax.random.normal`` bit for bit but in about 4 of 10^4 entries, which are
1 to 3 ulp apart. The float32 form hashes the same
counters to 32 bits (the two words' xor), keeps 23 of them and runs XLA's
float32 ``log1p`` and ``erf_inv`` (the polynomials of its CPU code, each
multiply-add fused as its CPU compiler fuses them) operation by operation,
so its normals are ``jax.random.normal(key, (n,), float32)``'s bit for bit
on an x86 host with FMA (within an ulp or two where XLA's arithmetic
differs).

``ReferenceDrawField`` is ``sim.MultivariateRandomField`` (any p; the
bivariate ``BivariateRandomField`` is its p = 2 alias) with the JAX
simulator's draws (``cokriging_tpu/sim/cofield.py``): the cofield's
normals from ``PRNGKey(seed)``, each process's measurement noise from a
split of ``PRNGKey(sample seed + 1)``. With it the simulation experiment
(p = 2) and the trivariate demo (p = 3) run the JAX scripts' own
realizations (up to the two Cholesky factors' rounding), so their
statistics compare with the JAX package's.

``ReferenceSpectralField`` is ``sim.SpectralRandomField`` with the JAX
spectral simulator's draws (``cokriging_tpu/sim/spectral.py:182-207``): the
real and imaginary normals from the two halves of ``split(PRNGKey(seed))``,
in float64 (the JAX package on the CPU) or float32 (on a TPU, where the
million-point workflow's manifest was drawn), and the sample's measurement
noise as ``ReferenceDrawField``'s.
"""

import math
import warnings

import numpy as np
import torch

from cokriging_tpu_torch.sim.cofield import MultivariateRandomField
from cokriging_tpu_torch.sim.spectral import SpectralRandomField

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
_CHUNK = 1 << 20  # counters hashed per numpy pass
# ``_fma64`` needs a long double with at least x87's 64-bit significand
# (IEEE quad's 113 do too); where long double is float64 the multiply-adds
# round twice in float64, as they did before they were fused, and the float64
# normals differ from jax.random.normal in about 7% of entries by 1-3 ulp
_LONGDOUBLE_BITS = np.finfo(np.longdouble).nmant + 1
if _LONGDOUBLE_BITS < 64:
    warnings.warn(f"np.longdouble has a {_LONGDOUBLE_BITS}-bit significand here: the float64 reference "
                  "normals are not fused as XLA fuses them (about 7% of entries 1-3 ulp off "
                  "jax.random.normal's)", RuntimeWarning)
_F32 = np.float32
# XLA's log1p (CPU): log(1 + x); for |x| < sqrt(2) - 1, x - x^2/2 + x^3 P(x) / Q(x)
# (Cephes' log1p). Its float32 log is Cephes' logf: the polynomial and ln 2 split.
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
            2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
            3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOGF_A = _F32((7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1))
_LOGF_B = _F32((-1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1))
_LOGF_D = _F32((2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))
_LN2_LO, _LN2_HI = _F32(-2.12194440e-4), _F32(0.693359375)
# XLA's erf_inv (Giles 2010, "Approximating the erfinv function"). float32: a
# degree-8 polynomial in w - 2.5 for w = -log1p(-x^2) < 5, else in sqrt(w) - 3.
_ERFINV32 = (_F32((2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                   -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)),
             _F32((-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                   -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)))
# float64: in w - 3.125 for w < 6.25, sqrt(w) - 3.25 for w < 16, else sqrt(w) - 5
_ERFINV64 = (
    (-3.6444120640178196996e-21, -1.685059138182016589e-19, 1.2858480715256400167e-18,
     1.115787767802518096e-17, -1.333171662854620906e-16, 2.0972767875968561637e-17,
     6.6376381343583238325e-15, -4.0545662729752068639e-14, -8.1519341976054721522e-14,
     2.6335093153082322977e-12, -1.2975133253453532498e-11, -5.4154120542946279317e-11,
     1.051212273321532285e-09, -4.1126339803469836976e-09, -2.9070369957882005086e-08,
     4.2347877827932403518e-07, -1.3654692000834678645e-06, -1.3882523362786468719e-05,
     0.0001867342080340571352, -0.00074070253416626697512, -0.0060336708714301490533,
     0.24015818242558961693, 1.6536545626831027356),
    (2.2137376921775787049e-09, 9.0756561938885390979e-08, -2.7517406297064545428e-07,
     1.8239629214389227755e-08, 1.5027403968909827627e-06, -4.013867526981545969e-06,
     2.9234449089955446044e-06, 1.2475304481671778723e-05, -4.7318229009055733981e-05,
     6.8284851459573175448e-05, 2.4031110387097893999e-05, -0.0003550375203628474796,
     0.00095328937973738049703, -0.0016882755560235047313, 0.0024914420961078508066,
     -0.0037512085075692412107, 0.005370914553590063617, 1.0052589676941592334,
     3.0838856104922207635),
    (-2.7109920616438573243e-11, -2.5556418169965252055e-10, 1.5076572693500548083e-09,
     -3.7894654401267369937e-09, 7.6157012080783393804e-09, -1.4960026627149240478e-08,
     2.9147953450901080826e-08, -6.7711997758452339498e-08, 2.2900482228026654717e-07,
     -9.9298272942317002539e-07, 4.5260625972231537039e-06, -1.9681778105531670567e-05,
     7.5995277030017761139e-05, -0.00021503011930044477347, -0.00013871931833623122026,
     1.0103004648645343977, 4.8499064014085844221),
)


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


def _fma32(a, b, c):
    """float32 a * b + c with one rounding (the product of two float32
    values is exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


def _log1p32(x):
    """XLA's float32 ``log1p`` on the CPU, operation by operation."""
    one = _F32(1.0)
    v = x + one
    bits = np.maximum(v, _F32(2.0 ** -126)).view(np.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(_F32)  # mantissa in [0.5, 1)
    below = m < _F32(0.707106781186547524)
    e = ((bits >> 23) - 127).astype(_F32) + one - below.astype(_F32)
    t = (m - one) + np.where(below, m, _F32(0.0))
    t2 = t * t
    t3 = t2 * t
    a, b, d = (_fma32(_fma32(t, c[0], c[1]), t, c[2]) for c in (_LOGF_A, _LOGF_B, _LOGF_D))
    poly = _fma32(_fma32(_fma32(a, t3, b), t3, d), t3, e * _LN2_LO)
    large = _fma32(e, _LN2_HI, _fma32(-t2, _F32(0.5), t) + poly)
    with np.errstate(invalid="ignore", divide="ignore"):
        large = np.where(v == _F32(np.inf), _F32(np.inf), large)
        large = np.where(v == 0, _F32(-np.inf), np.where(v < 0, _F32(np.nan), large))
        q = np.ones_like(x)
        for c in _LOG1P_Q:
            q = _fma32(q, x, _F32(c))
        p = np.full_like(x, _F32(_LOG1P_P[0]))
        for c in _LOG1P_P[1:]:
            p = _fma32(p, x, _F32(c))
        x2 = x * x
        small = x + _fma32(x2, _F32(-0.5), (x * x2) * (p / q))
    return np.where(np.abs(x) < _F32(0.41421356237309504880), small, large)


def _erf_inv32(x):
    """XLA's float32 ``erf_inv`` on the CPU, operation by operation."""
    w = -_log1p32(x * -x)
    lo = w < _F32(5.0)
    with np.errstate(invalid="ignore"):
        z = np.where(lo, w - _F32(2.5), np.sqrt(w) - _F32(3.0))
    p = np.where(lo, *(c[0] for c in _ERFINV32))
    for a, b in zip(*(c[1:] for c in _ERFINV32)):
        p = _fma32(p, z, np.where(lo, a, b))
    with np.errstate(invalid="ignore"):
        return np.where(np.abs(x) == _F32(1.0), x * _F32(np.inf), p * x)


def _fma64(a, b, c):
    """float64 a * b + c as XLA's CPU code fuses it: the product and sum in
    long double (64-bit significand on x86; see ``_LONGDOUBLE_BITS``), then
    one rounding to float64. The product of two doubles needs 106 bits, so
    this rounds twice where a true fused multiply-add rounds once: the
    normals differ from jax.random.normal's in about 3 of 10^4 entries, by 1
    to 3 ulp (3 in about 1 of 10^5; tests/test_torch_trivariate.py's
    ``test_float64_normals_ulps_at_scale`` counts them)."""
    return (np.asarray(a, np.longdouble) * np.asarray(b, np.longdouble)
            + np.asarray(c, np.longdouble)).astype(np.float64)


def _log1p64(x):
    """XLA's float64 ``log1p`` on the CPU (its log is the C library's), its
    multiply-adds fused."""
    q = np.ones_like(x)
    for c in _LOG1P_Q:
        q = _fma64(q, x, c)
    p = np.full_like(x, _LOG1P_P[0])
    for c in _LOG1P_P[1:]:
        p = _fma64(p, x, c)
    x2 = x * x
    small = x + _fma64(x2, -0.5, (x * x2) * (p / q))
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(np.abs(x) < 0.41421356237309504880, small, np.log(1.0 + x))


def _erf_inv64(x):
    """XLA's float64 ``erf_inv``, its multiply-adds fused (``_fma64``)."""
    w = -_log1p64(x * -x)
    a, b = w < 6.25, w < 16.0
    with np.errstate(invalid="ignore"):
        z = np.where(a, w - 3.125, np.sqrt(w) - np.where(b, 3.25, 5.0))
    c625, c16, c_inf = _ERFINV64
    p = np.where(a, c625[0], np.where(b, c16[0], c_inf[0]))
    for i in range(1, 17):
        p = _fma64(p, z, np.where(a, c625[i], np.where(b, c16[i], c_inf[i])))
    for i in range(17, 19):
        p = np.where(b, _fma64(p, z, np.where(a, c625[i], c16[i])), p)
    for i in range(19, 23):
        p = np.where(a, _fma64(p, z, c625[i]), p)
    with np.errstate(invalid="ignore"):
        return np.where(np.abs(x) == 1.0, x * np.inf, p * x)


def normal(key, n: int, dtype=np.float64) -> np.ndarray:
    """``jax.random.normal(key, (n,), dtype)``, dtype float64 or float32:
    uniforms on [nextafter(-1, 0), 1) from the hashed counters, then
    sqrt(2) erfinv."""
    f32 = np.dtype(dtype) == np.float32
    out = np.empty(n, _F32 if f32 else np.float64)
    for s in range(0, n, _CHUNK):
        b1, b2 = _threefry2x32(key, np.arange(s, min(n, s + _CHUNK), dtype=np.uint64))
        if f32:
            u01 = (((b1 ^ b2) >> np.uint32(9)) | np.uint32(0x3F800000)).view(_F32) - _F32(1.0)
            lo = np.nextafter(_F32(-1.0), _F32(0.0))
            out[s:s + u01.size] = _F32(np.sqrt(2.0)) * _erf_inv32(
                np.maximum(lo, _fma32(u01, _F32(1.0) - lo, lo)))
        else:
            bits = (b1.astype(np.uint64) << np.uint64(32)) | b2.astype(np.uint64)
            one = np.array(1.0).view(np.uint64)
            u01 = ((bits >> np.uint64(12)) | one).view(np.float64) - 1.0
            lo = np.nextafter(-1.0, 0.0)
            out[s:s + u01.size] = np.sqrt(2.0) * _erf_inv64(np.maximum(lo, u01 * (1.0 - lo) + lo))
    return out


class ReferenceDrawField(MultivariateRandomField):
    """``MultivariateRandomField`` (any p) whose normals are the JAX
    simulator's: the cofield's p n from ``PRNGKey(seed)``, each process's
    sample noise from its split of ``PRNGKey(sample seed + 1)``."""

    def _field_noise(self) -> torch.Tensor:
        z = normal(prng_key(self.seed), self.n_procs * self.grid.count)
        return torch.as_tensor(z, device=self.device)

    def _sample_noise(self, seed: int, size: int) -> np.ndarray:
        return _sample_noise(self.n_procs, seed, size)


def _sample_noise(n_procs: int, seed: int, size: int) -> np.ndarray:
    """(n_procs, size) measurement-error normals of the JAX simulators'
    ``sample``: process i's from the i-th split of ``PRNGKey(seed)``."""
    key, rows = prng_key(seed), []
    for _ in range(n_procs):
        key, sub = split(key)
        rows.append(normal(sub, size))
    return np.stack(rows)


class ReferenceSpectralField(SpectralRandomField):
    """``SpectralRandomField`` whose normals are the JAX spectral
    simulator's, drawn in ``normals`` (float64: the JAX package on the CPU;
    float32: on a TPU). The draws themselves run as the port's, in
    float64 / complex128 on the field's device."""

    def __init__(self, model, grid, seed: int = 0, normals=np.float64, **kwargs) -> None:
        self.normals = np.dtype(normals)
        super().__init__(model, grid, seed=seed, **kwargs)

    def _eps(self, seed: int, n_draw: int) -> torch.Tensor:
        shape = (n_draw, self._mx, self._my, self.n_procs)
        re, im = (torch.as_tensor(normal(k, math.prod(shape), self.normals).reshape(shape),
                                  dtype=torch.float64, device=self.device)
                  for k in split(prng_key(seed)))
        return torch.complex(re, im)

    def _sample_noise(self, seed: int, size: int) -> np.ndarray:
        return _sample_noise(self.n_procs, seed, size)
