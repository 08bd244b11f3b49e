"""The table-driven per-entry functions of ``csrc/kv.cuh`` (the arithmetic
of the pairs forward and block-gradient kernels), compiled for the host with
``g++`` and a stub ``cuda_runtime.h``, against the plain torch
``cov.matern.matern_correlation`` and its autograd partials; and the
recurrence tables they read against a float64 numpy computation.

    python -m pytest tests/test_torch_kv_host.py

Skips where ``g++`` is missing (decided inside the tests).
"""

import ctypes
import math
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from cokriging_tpu_torch.cov.matern import matern_correlation
from cokriging_tpu_torch.kernels import cuda_ops as K
from cokriging_tpu_torch.kernels.bessel import CF2_ITERS, SERIES_ITERS, _kv_value

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "cokriging_tpu_torch" / "kernels" / "csrc"
STUB = "#pragma once\n#define __host__\n#define __device__\n#define __forceinline__ inline\n"
HARNESS = """
#include "kv.cuh"

template <typename T>
void values(const T* x, long n, const T* row, int early_exit, T* out) {
  for (long i = 0; i < n; ++i)
    out[i] = ckt::matern_value_tab(x[i], ckt::ValueRow<T>{row}, early_exit != 0);
}

template <typename T>
void partials(const T* x, long n, const T* row, T* m, T* dnu, T* dls, int* ok) {
  for (long i = 0; i < n; ++i)
    ok[i] = ckt::matern_partials_tab(x[i], ckt::DualRow<T>{row}, m[i], dnu[i], dls[i]);
}

extern "C" {
void values_f32(const float* x, long n, const float* r, int e, float* o) { values(x, n, r, e, o); }
void values_f64(const double* x, long n, const double* r, int e, double* o) { values(x, n, r, e, o); }
void partials_f32(const float* x, long n, const float* r, float* m, float* a, float* b, int* ok) {
  partials(x, n, r, m, a, b, ok);
}
void partials_f64(const double* x, long n, const double* r, double* m, double* a, double* b,
                  int* ok) {
  partials(x, n, r, m, a, b, ok);
}
}
"""
DTYPES = {"f32": torch.float32, "f64": torch.float64}
FWD_ATOL = {"f32": 5e-6, "f64": 1e-12}
GRAD_RTOL = {"f32": 1e-5, "f64": 1e-12}
LS = 700.0


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels' device functions for the host")
    d = tmp_path_factory.mktemp("kv_host")
    (d / "cuda_runtime.h").write_text(STUB)
    (d / "harness.cpp").write_text(HARNESS)
    lib = d / "libkvhost.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", f"-I{d}", f"-I{CSRC}",
                    "-o", str(lib), str(d / "harness.cpp")], check=True)
    return ctypes.CDLL(str(lib))


def _nus(sfx):
    """nu in {0.3, 0.5, 1.2, 1.5, 2.7} and 1.5 -+ one ulp of the dtype."""
    ft = np.float32 if sfx == "f32" else np.float64
    return [0.3, 0.5, 1.2, 1.5, 2.7, float(np.nextafter(ft(1.5), ft(0))),
            float(np.nextafter(ft(1.5), ft(2)))]


def _entries(nu, dtype):
    """Distances whose x = sqrt(2 nu) h / ls spans 1e-3 .. 50 with points
    either side of x = 2, and that x as the kernels form it."""
    x0 = np.concatenate([np.geomspace(1e-3, 50.0, 397), 2.0 + np.array([-1e-3, -1e-9, 0.0, 1e-9,
                                                                        1e-3])])
    h = torch.as_tensor(x0 * LS / math.sqrt(2.0 * nu), dtype=dtype)
    nu_t, ls_t = torch.tensor(nu, dtype=dtype), torch.tensor(LS, dtype=dtype)
    return h, torch.sqrt(2.0 * nu_t) * (h / ls_t)


def _run_values(lib, sfx, x, row, early_exit=True):
    ct = ctypes.c_float if sfx == "f32" else ctypes.c_double
    x = x.contiguous()
    out = torch.empty_like(x)
    f = getattr(lib, f"values_{sfx}")
    f.argtypes = [ctypes.POINTER(ct), ctypes.c_long, ctypes.POINTER(ct), ctypes.c_int,
                  ctypes.POINTER(ct)]
    row = row.contiguous()
    f(ctypes.cast(x.data_ptr(), ctypes.POINTER(ct)), x.numel(),
      ctypes.cast(row.data_ptr(), ctypes.POINTER(ct)), int(early_exit),
      ctypes.cast(out.data_ptr(), ctypes.POINTER(ct)))
    return out


def _run_partials(lib, sfx, x, row):
    ct = ctypes.c_float if sfx == "f32" else ctypes.c_double
    x, row = x.contiguous(), row.contiguous()
    outs = [torch.empty_like(x) for _ in range(3)]
    ok = torch.zeros(x.numel(), dtype=torch.int32)
    f = getattr(lib, f"partials_{sfx}")
    p = ctypes.POINTER(ct)
    f.argtypes = [p, ctypes.c_long, p, p, p, p, ctypes.POINTER(ctypes.c_int)]
    f(ctypes.cast(x.data_ptr(), p), x.numel(), ctypes.cast(row.data_ptr(), p),
      *(ctypes.cast(o.data_ptr(), p) for o in outs),
      ctypes.cast(ok.data_ptr(), ctypes.POINTER(ctypes.c_int)))
    return (*outs, ok.bool())


@pytest.mark.parametrize("sfx", ["f32", "f64"])
def test_table_value_matches_plain_matern(harness, sfx):
    dtype = DTYPES[sfx]
    for nu in _nus(sfx):
        h, x = _entries(nu, dtype)
        row = K.recurrence_table(torch.tensor([nu], dtype=dtype), torch.tensor([LS], dtype=dtype),
                                 dtype)[0]
        got = _run_values(harness, sfx, x, row)
        want = matern_correlation(torch.tensor(nu, dtype=dtype), torch.tensor(LS, dtype=dtype), h)
        err = float((got - want).abs().max())
        assert torch.isfinite(got).all() and err <= FWD_ATOL[sfx], (nu, err)


def _partial_magnitudes(nu, x, dtype):
    """The size of each partial's rounding error: per entry the sum of the
    absolute values of the parts it adds up, from the plain K_nu, dK/dnu
    and dK/dx (dM/dnu = M dlp/dnu + e^lp (dK/dnu + dK/dx da/dnu), dM/dls =
    -M nu/ls + e^lp dK/dx da/dls), as the kernels' sums are held to
    sum |terms|."""
    nu_t = torch.tensor(nu, dtype=dtype)
    k, dk_dnu, dk_dx = _kv_value(nu_t, x, True)
    elp = torch.exp((1.0 - nu_t) * math.log(2.0) - torch.lgamma(nu_t) + nu_t * torch.log(x))
    m = elp * k
    dlp = -math.log(2.0) - torch.digamma(nu_t) + torch.log(x) + 0.5
    mag_nu = (m * dlp).abs() + (elp * dk_dnu).abs() + (elp * dk_dx * x / (2.0 * nu_t)).abs()
    mag_ls = (m * nu_t / LS).abs() + (elp * dk_dx * x / LS).abs()
    return mag_nu, mag_ls


@pytest.mark.parametrize("sfx", ["f32", "f64"])
def test_table_partials_match_plain_autograd(harness, sfx):
    """M, dM/dnu and dM/dls of the dual pass against autograd of the plain
    elementwise model (the exact dK/dnu with nl pinned): M within the
    forward's bar, each partial within tol times its magnitude
    (``_partial_magnitudes``); at 1.5 -+ ulp the plain version's truncated
    CF2 tangent (the reference's, ROADMAP Queue 3)."""
    dtype = DTYPES[sfx]
    tol = GRAD_RTOL[sfx]
    for nu in _nus(sfx):
        h, x = _entries(nu, dtype)
        row = K.recurrence_table(torch.tensor([nu], dtype=dtype), torch.tensor([LS], dtype=dtype),
                                 dtype, dual=True)[0]
        m, dnu, dls, ok = _run_partials(harness, sfx, x, row)
        nu_t = torch.full_like(h, nu).requires_grad_(True)
        ls_t = torch.full_like(h, LS).requires_grad_(True)
        want = matern_correlation(nu_t, ls_t, h)
        g_nu, g_ls = torch.autograd.grad(want.sum(), (nu_t, ls_t))
        assert bool(ok.all()), nu
        assert float((m - want.detach()).abs().max()) <= FWD_ATOL[sfx], nu
        mag_nu, mag_ls = _partial_magnitudes(nu, x, dtype)
        for got, ref, mag in ((dnu, g_nu, mag_nu), (dls, g_ls, mag_ls)):
            rel = float(((got - ref).abs() / mag).max())
            assert rel <= tol, (nu, rel)


@pytest.mark.parametrize("sfx", ["f32", "f64"])
def test_degenerate_lane_early_exit_changes_no_bit(harness, sfx):
    """At half-integer nu (a1 == 0) the value pass leaves CF2 after its
    setup; the result equals the full trip loop's bit for bit."""
    dtype = DTYPES[sfx]
    for nu in (0.5, 1.5, 2.5):
        _, x = _entries(nu, dtype)
        row = K.recurrence_table(torch.tensor([nu], dtype=dtype), torch.tensor([LS], dtype=dtype),
                                 dtype)[0]
        assert float(row[12]) == 0.0  # a1
        fast = _run_values(harness, sfx, x, row, early_exit=True)
        full = _run_values(harness, sfx, x, row, early_exit=False)
        assert torch.equal(fast, full), nu


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dual", [False, True])
def test_recurrence_table_matches_float64_host(dtype, dual):
    """``pairs_constants`` (the forward's table) and the block gradient's
    dual table, built with torch on the device of nu (here the CPU), against
    the same head and reciprocals in float64 numpy."""
    nus = np.array([0.3, -0.5, 1.2, 1.5, 2.7])
    lss = np.array([250.0, 300.0, 800.0, 700.0, 1500.0])
    nu_t, ls_t = torch.tensor(nus, dtype=dtype), torch.tensor(lss, dtype=dtype)
    got = (K.recurrence_table(nu_t, ls_t, dtype, dual=True) if dual
           else K.pairs_constants(nu_t, ls_t, dtype)).double().numpy()
    S, C = SERIES_ITERS[dtype], CF2_ITERS[dtype]
    width = 13 + 3 * S + 3 * C
    assert got.shape == (len(nus), 2 * width if dual else width)
    val = got[:, 0::2] if dual else got
    ft = np.float32 if dtype == torch.float32 else np.float64
    nu_d = np.abs(nus) if dual else nus
    mu = (np.abs(nus.astype(ft)) - np.floor(np.abs(nus.astype(ft)) + ft(0.5))).astype(np.float64)
    nl = np.floor(np.abs(nus) + 0.5)
    a1 = 0.25 - mu * mu
    i_s = np.arange(1, S + 1, dtype=np.float64)
    i_c = np.arange(2, C + 2, dtype=np.float64)
    a_n = -a1[:, None] - i_c * (i_c - 1.0)
    with np.errstate(invalid="ignore"):
        head = [nu_d, lss, np.sqrt(2 * nu_d), mu, nl]
    pimu = np.pi * mu
    fact = np.where(np.abs(pimu) < 1e-4, 1 + pimu ** 2 / 6, pimu / np.sin(np.where(pimu == 0, 1, pimu)))
    want = {
        "head": np.stack(head, 1), "fact": fact, "a1": a1,
        "series": np.stack([1 / (i_s ** 2 - mu[:, None] ** 2), 1 / (i_s - mu[:, None]),
                            1 / (i_s + mu[:, None])], 2).reshape(len(nus), -1),
        "cf2": np.stack([a_n, 1 / a_n, -a_n / i_c], 2).reshape(len(nus), -1),
    }
    rtol = 1e-6 if dtype == torch.float32 else 1e-14
    np.testing.assert_allclose(val[:, :5], want["head"], rtol=rtol)
    np.testing.assert_allclose(val[:, 11], want["fact"], rtol=rtol)
    np.testing.assert_allclose(val[:, 12], want["a1"], rtol=rtol, atol=rtol)
    np.testing.assert_allclose(val[:, 13:13 + 3 * S], want["series"], rtol=rtol)
    np.testing.assert_allclose(val[:, 13 + 3 * S:], want["cf2"], rtol=rtol)
    if dual:
        tan = got[:, 1::2]
        two_mu = 2 * mu[:, None]
        np.testing.assert_allclose(tan[:, 3], 1.0)
        np.testing.assert_allclose(tan[:, 12], -2 * mu, rtol=rtol, atol=rtol)
        np.testing.assert_allclose(
            tan[:, 13:13 + 3 * S],
            np.stack([two_mu / (i_s ** 2 - mu[:, None] ** 2) ** 2, 1 / (i_s - mu[:, None]) ** 2,
                      -1 / (i_s + mu[:, None]) ** 2], 2).reshape(len(nus), -1), rtol=rtol, atol=1e-30)
        np.testing.assert_allclose(
            tan[:, 13 + 3 * S:],
            np.stack([np.broadcast_to(two_mu, a_n.shape), -two_mu / a_n ** 2, -two_mu / i_c],
                     2).reshape(len(nus), -1), rtol=rtol, atol=1e-30)
