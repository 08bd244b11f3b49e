"""The table-driven per-entry functions of ``csrc/kv.cuh`` (the arithmetic
of every Matern kernel), compiled for the host with ``g++`` and a stub
``cuda_runtime.h``, against the plain torch ``cov.matern.matern_correlation``
and its autograd partials; the kernels' own per-entry steps (the block
forward's masked h -> x -> M and the pairs gradient's masked, weighted
terms) against ``matern_correlation_block_plain`` and
``matern_corr_pairs_grad_plain``; and the recurrence tables they read
against a float64 numpy computation and against ``cov.matern``'s
per-parameter-set tables.

    python -m pytest tests/test_torch_kv_host.py

Skips where ``g++`` is missing (decided inside the tests).
"""

import ctypes
import math
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cokriging_tpu.cov import matern as JM
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

template <typename T>
void entries(const T* h, long n, const T* row, int early_exit, T* out) {
  for (long i = 0; i < n; ++i)
    out[i] = ckt::matern_entry_tab(h[i], ckt::ValueRow<T>{row}, early_exit != 0);
}

template <typename T>
void grad_terms(const T* h, const T* w, const int* k, long n, const T* rows, T* g_nu, T* g_ls,
                int* ok) {
  for (long i = 0; i < n; ++i) {
    const ckt::DualRow<T> row{rows + k[i] * 2 * ckt::TabLayout<T>::width};
    T x;
    g_nu[i] = g_ls[i] = T(0);
    ok[i] = ckt::entry_x(h[i], row, x) && ckt::pairs_grad_term(x, w[i], row, g_nu[i], g_ls[i]);
  }
}

template <typename T>
void second(const T* x, long n, const T* row, T* out, int* ok) {
  for (long i = 0; i < n; ++i) {
    T* o = out + 6 * i;
    ok[i] = ckt::matern_second_tab(x[i], ckt::Dual2Row<T>{row}, o[0], o[1], o[2], o[3], o[4],
                                   o[5]);
  }
}

template <typename T>
void tangents(const T* h, long n, const T* row, const T* w, T* out) {
  for (long i = 0; i < n; ++i)
    out[i] = ckt::tangent_entry(h[i], ckt::DualRow<T>{row}, w[0], w[1], w[2], w[3]);
}

template <typename T>
void hess(const T* h, const T* w, long n, const T* row, T* out, int* ok) {
  for (long i = 0; i < n; ++i) {
    const ckt::Dual2Row<T> r{row};
    T x;
    for (int k = 0; k < 5; ++k) out[5 * i + k] = T(0);
    ok[i] = ckt::entry_x(h[i], r, x) && ckt::hess_terms(x, w[i], r, out + 5 * i);
  }
}

extern "C" {
void second_f32(const float* x, long n, const float* r, float* o, int* ok) { second(x, n, r, o, ok); }
void second_f64(const double* x, long n, const double* r, double* o, int* ok) {
  second(x, n, r, o, ok);
}
void tangents_f32(const float* h, long n, const float* r, const float* w, float* o) {
  tangents(h, n, r, w, o);
}
void tangents_f64(const double* h, long n, const double* r, const double* w, double* o) {
  tangents(h, n, r, w, o);
}
void hess_f32(const float* h, const float* w, long n, const float* r, float* o, int* ok) {
  hess(h, w, n, r, o, ok);
}
void hess_f64(const double* h, const double* w, long n, const double* r, double* o, int* ok) {
  hess(h, w, n, r, o, ok);
}
void entries_f32(const float* h, long n, const float* r, int e, float* o) { entries(h, n, r, e, o); }
void entries_f64(const double* h, long n, const double* r, int e, double* o) {
  entries(h, n, r, e, o);
}
void grad_terms_f32(const float* h, const float* w, const int* k, long n, const float* r,
                    float* a, float* b, int* ok) {
  grad_terms(h, w, k, n, r, a, b, ok);
}
void grad_terms_f64(const double* h, const double* w, const int* k, long n, const double* r,
                    double* a, double* b, int* ok) {
  grad_terms(h, w, k, n, r, a, b, ok);
}
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


def _partial_magnitudes(nu, x, dtype, ls=LS):
    """The size of each partial's rounding error: per entry the sum of the
    absolute values of the parts it adds up, from the plain K_nu, dK/dnu
    and dK/dx (dM/dnu = M dlp/dnu + e^lp (dK/dnu + dK/dx da/dnu), dM/dls =
    -M nu/ls + e^lp dK/dx da/dls), as the kernels' sums are held to
    sum |terms|. ``nu`` and ``ls``: numbers or per-entry tensors."""
    nu_t = torch.as_tensor(nu, dtype=dtype)
    k, dk_dnu, dk_dx = _kv_value(nu_t, x, True)
    elp = torch.exp((1.0 - nu_t) * math.log(2.0) - torch.lgamma(nu_t) + nu_t * torch.log(x))
    m = elp * k
    dlp = -math.log(2.0) - torch.digamma(nu_t) + torch.log(x) + 0.5
    mag_nu = (m * dlp).abs() + (elp * dk_dnu).abs() + (elp * dk_dx * x / (2.0 * nu_t)).abs()
    mag_ls = (m * nu_t / ls).abs() + (elp * dk_dx * x / ls).abs()
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
                                 dtype, order=1)[0]
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
    """``recurrence_table``, the forward kernels' value table and the
    gradient kernels' dual table, built with torch on the device of nu
    (here the CPU), against the same head and reciprocals in float64
    numpy."""
    nus = np.array([0.3, -0.5, 1.2, 1.5, 2.7])
    lss = np.array([250.0, 300.0, 800.0, 700.0, 1500.0])
    nu_t, ls_t = torch.tensor(nus, dtype=dtype), torch.tensor(lss, dtype=dtype)
    got = K.recurrence_table(nu_t, ls_t, dtype, order=int(dual)).double().numpy()
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


def _ptr(t, ct):
    return ctypes.cast(t.data_ptr(), ctypes.POINTER(ct))


def _run_entries(lib, sfx, h, row, early_exit=True):
    ct = ctypes.c_float if sfx == "f32" else ctypes.c_double
    h, row = h.contiguous(), row.contiguous()
    out = torch.empty_like(h)
    f = getattr(lib, f"entries_{sfx}")
    p = ctypes.POINTER(ct)
    f.argtypes = [p, ctypes.c_long, p, ctypes.c_int, p]
    f(_ptr(h, ct), h.numel(), _ptr(row, ct), int(early_exit), _ptr(out, ct))
    return out


def _run_grad_terms(lib, sfx, h, w, k, rows):
    ct = ctypes.c_float if sfx == "f32" else ctypes.c_double
    h, w, rows = h.contiguous(), w.contiguous(), rows.contiguous()
    k = k.to(torch.int32).contiguous()
    g_nu, g_ls = torch.empty_like(h), torch.empty_like(h)
    ok = torch.zeros(h.numel(), dtype=torch.int32)
    f = getattr(lib, f"grad_terms_{sfx}")
    p, pi = ctypes.POINTER(ct), ctypes.POINTER(ctypes.c_int)
    f.argtypes = [p, p, pi, ctypes.c_long, p, p, p, pi]
    f(_ptr(h, ct), _ptr(w, ct), _ptr(k, ctypes.c_int), h.numel(), _ptr(rows, ct), _ptr(g_nu, ct),
      _ptr(g_ls, ct), _ptr(ok, ctypes.c_int))
    return g_nu, g_ls, ok.bool()


def _masked_entries(nu, dtype):
    """``_entries``' distances, then the masks: h = 0, h < 0, +-inf, NaN, and
    x = 60 .. 1000 where M underflows to 0 (f32 first, then f64)."""
    h, _ = _entries(abs(nu) if nu else 1.0, dtype)
    far = torch.as_tensor(np.geomspace(60.0, 1000.0, 24) * LS / math.sqrt(2.0 * max(abs(nu), 0.1)),
                          dtype=dtype)
    special = torch.tensor([0.0, -0.0, -350.0, -1e-3, math.inf, -math.inf, math.nan], dtype=dtype)
    return torch.cat([h, -h[::7], far, special])


@pytest.mark.parametrize("sfx", ["f32", "f64"])
def test_block_forward_entry_matches_plain(harness, sfx):
    """``matern.cu``'s per-entry step, h -> x -> matern_value_tab with its
    |h| not > 0 and non-finite masks, against ``matern_correlation_block_plain``
    entry by entry (atol 5e-6 / 1e-12), at nu 0.5, 1.5 -+ ulp, 2.7 and a
    negative nu (signed, as the plain path keeps it: M = 0 for h != 0), over
    x from 1e-3 to where M underflows, h = 0, h < 0, +-inf and NaN; and the
    degenerate lanes' early CF2 exit changes no bit."""
    dtype = DTYPES[sfx]
    ft = np.float32 if sfx == "f32" else np.float64
    nus = [0.5, float(np.nextafter(ft(1.5), ft(0))), float(np.nextafter(ft(1.5), ft(2))), 2.7, -0.7]
    for nu in nus:
        h = _masked_entries(nu, dtype)
        row = K.recurrence_table(torch.tensor([nu], dtype=dtype), torch.tensor([LS], dtype=dtype),
                                 dtype)[0]
        got = _run_entries(harness, sfx, h, row)
        want = K.matern_correlation_block_plain(torch.tensor(nu, dtype=dtype),
                                                torch.tensor(LS, dtype=dtype), h)
        assert torch.isfinite(got).all() and torch.isfinite(want).all(), nu
        err = float((got - want).abs().max())
        assert err <= FWD_ATOL[sfx], (nu, err)
        assert bool((got[-7:] == torch.tensor([1, 1, 0, 0, 0, 0, 1], dtype=dtype)).all()
                    if nu < 0 else (got[-7:-5] == 1).all() and (got[-3:-1] == 0).all()
                    and got[-1] == 1), (nu, got[-7:])
        assert torch.equal(_run_entries(harness, sfx, h, row, early_exit=False), got), nu


def _grad_case(sfx, rng, spread):
    """Ten pairs with signed nu (1.5 -+ ulp among them), random cotangents,
    and per pair the masks of ``_masked_entries`` and entries at x =
    sqrt(2 |nu|) |h| / ls either ``"uniform"`` over the series and CF2
    ranges (as the card's stress cases) or ``"geometric"`` over 1e-3 .. 50,
    a third of them below x = 0.05."""
    dtype = DTYPES[sfx]
    ft = np.float32 if sfx == "f32" else np.float64
    nus = [0.3, -0.5, 1.2, float(np.nextafter(ft(1.5), ft(0))), float(np.nextafter(ft(1.5), ft(2))),
           2.7, -1.3, 0.8, 2.5, -2.2]
    lss = [300.0, 450.0, 800.0, 1500.0, 600.0, 350.0, 900.0, 1200.0, LS, 500.0]
    hs, ks = [], []
    for k, (nu, ls) in enumerate(zip(nus, lss)):
        if spread == "uniform":
            x = np.concatenate([rng.uniform(1e-3, 1.99, 40), rng.uniform(2.0, 40.0, 24)])
        else:
            x = np.geomspace(1e-3, 50.0, 64)
        x = np.concatenate([x, [1.999, 2.0, 2.001]])
        h = torch.as_tensor(x * ls / math.sqrt(2.0 * abs(nu)), dtype=dtype)
        far = torch.as_tensor(np.geomspace(60.0, 1000.0, 6) * ls / math.sqrt(2.0 * abs(nu)),
                              dtype=dtype)
        special = torch.tensor([0.0, -0.0, -ls, math.inf, math.nan], dtype=dtype)
        hs.append(torch.cat([h, -h[::9], far, special]))
        ks.append(torch.full((hs[-1].numel(),), k))
    h, k = torch.cat(hs), torch.cat(ks)
    w = torch.as_tensor(rng.normal(size=h.numel()), dtype=dtype)
    return (torch.tensor(nus, dtype=dtype), torch.tensor(lss, dtype=dtype), h, k, w)


@pytest.mark.parametrize("spread", ["uniform", "geometric"])
@pytest.mark.parametrize("sfx", ["f32", "f64"])
def test_pairs_grad_entry_matches_plain(harness, sfx, spread):
    """The pairs gradient's per-entry step (entry_x, then the masked,
    weighted pairs_grad_term) over a dual table of ten pairs with signed
    nu, against the plain version at |nu| (the dual table takes |nu|, as
    the reference's gradient table does). Each entry's terms against the
    plain version's own (autograd of the elementwise model, non-finite
    terms zeroed) within tol (1e-5 / 1e-12) times |w| times the size of the
    parts each partial adds up (``_partial_magnitudes``). At the uniform
    spread, the terms summed per pair also against
    ``matern_corr_pairs_grad_plain`` within tol * sum |terms|. (Not at the
    geometric one: towards x = 0 dM/dnu cancels between its parts, and two
    float32 evaluations in different operation orders, this and the plain
    version, differ there by up to 1.6e-5 of sum |terms| when a third of a
    pair's entries lie below x = 0.05; both are 8e-3 of sum |terms| from
    the float64 value.) Entries with |h| not > 0, +-inf or NaN, or whose M
    underflows, have no terms."""
    dtype = DTYPES[sfx]
    tol = GRAD_RTOL[sfx]
    nu, ls, h, k, w = _grad_case(sfx, np.random.default_rng(31), spread)
    rows = K.recurrence_table(nu, ls, dtype, order=1)
    g_nu, g_ls, ok = _run_grad_terms(harness, sfx, h, w, k, rows)
    nu_abs = nu.abs()
    if spread == "uniform":
        idx_f = k.to(dtype)
        want = K.matern_corr_pairs_grad_plain(nu_abs, ls, idx_f, h, w)
        mag = K.matern_corr_pairs_grad_plain(nu_abs, ls, idx_f, h, w, absolute=True)
        got = torch.stack([torch.bincount(k, weights=g.double(), minlength=len(nu))
                           for g in (g_nu, g_ls)], dim=1)
        assert torch.isfinite(got).all() and bool(((got - want).abs() <= tol * mag).all()), \
            (got, want, mag)
    nu_e = nu_abs[k].clone().requires_grad_(True)
    ls_e = ls[k].clone().requires_grad_(True)
    terms = torch.autograd.grad((w * matern_correlation(nu_e, ls_e, h)).sum(), (nu_e, ls_e))
    x = torch.sqrt(2.0 * nu_abs[k]) * h.abs() / ls[k]
    live = (x > 0) & torch.isfinite(x)
    parts = _partial_magnitudes(nu_abs[k][live], x[live], dtype, ls[k][live])
    for g, t, part in zip((g_nu, g_ls), terms, parts):
        t = torch.where(torch.isfinite(t), t, 0.0)
        assert not g[~live].any() and not t[~live].any(), "the masked entries"
        err = (g[live] - t[live]).abs()
        bar = tol * w[live].abs() * torch.nan_to_num(part, nan=0.0)  # M's parts overflow: exact
        assert bool((err <= bar).all()), float((err / bar).max())
    assert int((~live).sum()) == 4 * len(nu) and not ok[~live].any()  # 0, -0, inf, NaN
    assert ok[live & (x < 50)].all()  # every entry short of M's underflow has its terms


def _jax_pair_grad(nu, ls, h, k, w, dtype):
    """The JAX package's float32 or float64 gradient terms at the same
    (float32) inputs, summed per pair in float64 with non-finite terms
    zeroed: autograd of the elementwise ``_matern_corr_raw`` that
    ``matern_corr_pairs`` evaluates on the CPU, per entry."""
    kk = k.numpy()

    def loss(nu_e, ls_e):
        return jnp.sum(jnp.asarray(w.numpy(), dtype) * JM._matern_corr_raw(
            nu_e, ls_e, jnp.asarray(h.numpy(), dtype)))

    terms = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(nu.numpy()[kk], dtype),
                                           jnp.asarray(ls.numpy()[kk], dtype))
    return np.stack([np.bincount(kk, weights=np.where(np.isfinite(t), t, 0.0).astype(np.float64),
                                 minlength=len(nu)) for t in map(np.asarray, terms)], axis=1)


def test_pairs_grad_f32_distance_from_f64_is_shared_with_jax(harness):
    """The f32 pairs gradient at the geometric spread (a third of each
    pair's entries below x = 0.05), per-pair sums as a share of the float64
    sum of |terms|, against the float64 value of the JAX package: the JAX
    float32 terms, the kernel's (``pairs_grad_term``) and the plain
    version's are all about 1e-5 away (measured 1.1e-5, 1.2e-5, 1.2e-5)
    except in the dM/dnu sums at nu = 1.5 -+ one float32 ulp, where all
    three are 8.1e-3 and 3.8e-3 away and within 4e-6 of each other: the reference's CF2 tangent,
    truncated at a degenerate lane, is truncated at another trip in float64
    (ROADMAP Queue 3). JAX's float32 is no closer to float64 than the port's,
    so this is a limit of float32 that both packages share, not a fault of
    the port."""
    nu, ls, h, k, w = _grad_case("f32", np.random.default_rng(31), "geometric")
    nu_abs = nu.abs()
    jax32 = _jax_pair_grad(nu_abs, ls, h, k, w, jnp.float32)
    jax64 = _jax_pair_grad(nu_abs, ls, h, k, w, jnp.float64)
    mag = K.matern_corr_pairs_grad_plain(nu_abs.double(), ls.double(), k.double(), h.double(),
                                         w.double(), absolute=True).numpy()
    plain32 = K.matern_corr_pairs_grad_plain(nu_abs, ls, k.float(), h, w).numpy()
    g_nu, g_ls, _ = _run_grad_terms(harness, "f32", h, w, k, K.recurrence_table(
        nu, ls, torch.float32, order=1))
    kernel32 = torch.stack([torch.bincount(k, weights=g.double(), minlength=len(nu))
                            for g in (g_nu, g_ls)], dim=1).numpy()
    ulp = np.zeros(mag.shape, bool)
    ulp[[3, 4], 0] = True  # the sums of dM/dnu at nu = 1.5 -+ ulp
    dist = {name: np.abs(v - jax64) / mag
            for name, v in (("jax", jax32), ("kernel", kernel32), ("plain", plain32))}
    for name, d in dist.items():
        assert d[~ulp].max() <= 3e-5, (name, d)
        assert 1e-3 <= d[ulp].min() and d[ulp].max() <= 1e-2, (name, d)
    for name in ("kernel", "plain"):
        assert np.abs(dist[name] - dist["jax"])[ulp].max() <= 1e-5, name
        assert dist[name][~ulp].max() <= 2.0 * dist["jax"][~ulp].max(), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pair_table_rows_match_recurrence_table(dtype):
    """``cov.matern.pair_table``'s kernel tables (built as on the card, here
    on the CPU): the row of each process pair (i, j), value and dual,
    equals ``recurrence_table`` of that pair alone, to the last bit or two
    of the CPU's vectorized against scalar loops."""
    from cokriging_tpu_torch.cov.matern import _kernel_tables, _pairs
    from cokriging_tpu_torch.cov.params import MaternParams

    flat = torch.tensor([1.1, 0.9, 1.3, 1.0,  # sigma
                         0.8, 1.2, 0.4, 1.5, 2.7, 0.6, 1.9, 0.5, 1.05, 2.2,  # nu
                         300.0, 450.0, 800.0, 1500.0, 600.0, 350.0, 900.0, 1200.0, 700.0, 500.0,
                         0.02, 0.01, 0.03, 0.04, -0.3, 0.2, -0.1, 0.4, 0.1, -0.5],
                        dtype=torch.float64)
    params = MaternParams.from_flat(flat, n_procs=4)
    value, dual, _ = _kernel_tables(params, "cpu", dtype, True)
    rtol = 4 * torch.finfo(dtype).eps
    for k, (i, j) in enumerate(_pairs(4)):
        nu, ls = params.nu[i, j].to(dtype), params.len_scale[i, j].to(dtype)
        for got, want in ((value[k], K.recurrence_table(nu, ls, dtype)[0]),
                          (dual[k], K.recurrence_table(nu, ls, dtype, order=1)[0])):
            assert got.dtype == dtype and got.shape == want.shape
            torch.testing.assert_close(got, want, rtol=rtol, atol=0.0)


# bars of the second-order entry against autograd of the plain model,
# relative to each column's largest |value| (float64 measured <= 6e-12;
# float32: d2M/dnu2 cancels to ~3e-3 of its size in either evaluation, and the
# first partials to ~1.5e-4)
SECOND_TOL = {"f32": (1e-6, 1e-3, 1e-2), "f64": (1e-14, 1e-10, 1e-10)}


def _second_plain(nu, h, dtype):
    """The plain model's M and its five partials per entry (autograd,
    ``cuda_ops._plain_model_partials``), masked as the kernels mask them."""
    mat, d = K._plain_model_partials(torch.tensor(abs(nu), dtype=dtype),
                                     torch.tensor(LS, dtype=dtype), h.abs(), True)
    return mat, d


def _tie_entries(nu, dtype):
    """Distances h within 64 ulp of 2 LS / sqrt(2 nu) whose x = sqrt(2 nu) h /
    LS, formed as ``_entries`` (and the kernels) form it, is 2 exactly, and
    that x; None where no distance gives x == 2 (float32 at nu = 1.5 and
    1.5 - ulp: no float32 h / LS does)."""
    nu_t, ls_t = torch.tensor(nu, dtype=dtype), torch.tensor(LS, dtype=dtype)
    toward = torch.tensor(math.inf, dtype=dtype)
    h = torch.tensor(2.0 * LS / math.sqrt(2.0 * nu), dtype=dtype)
    for _ in range(64):
        h = torch.nextafter(h, -toward)
    found = []
    for _ in range(128):
        if float(torch.sqrt(2.0 * nu_t) * (h / ls_t)) == 2.0:
            found.append(h.clone())
        h = torch.nextafter(h, toward)
    if not found:
        return None
    h = torch.stack(found)
    return h, torch.sqrt(2.0 * nu_t) * (h / ls_t)


@pytest.mark.parametrize("sfx", ["f32", "f64"])
def test_second_order_entry_matches_plain_autograd(harness, sfx):
    """``kv.cuh::matern_second_tab`` over a second-order table row (M, its
    partials in nu and ls, first and second) against autograd of the
    elementwise model, over x from 1e-3 to 50 on both branches and at x = 2
    exactly, at nu 0.3, 0.5, 1.2, 1.5, 2.7 and 1.5 -+ ulp. Two kinds of
    entry take the reference's x-derivatives, which differ there from the
    true mixed partials: at 1.5 -+ ulp the reference's CF2 tangent is
    truncated after one trip, and it takes d/dx of the truncated dK/dnu for
    one mixed term of d2M/dnu2 and for d2M/dnu dls; at x = 2 its branch
    clamps pass half of x's gradient each. The elementwise model follows the
    reference there (``tests/test_torch_kv_second.py``), and the entry
    holds every column's bar."""
    dtype = DTYPES[sfx]
    ct = ctypes.c_float if sfx == "f32" else ctypes.c_double
    p = ctypes.POINTER(ct)
    f = getattr(harness, f"second_{sfx}")
    f.argtypes = [p, ctypes.c_long, p, p, ctypes.POINTER(ctypes.c_int)]
    ties = 0
    for nu in _nus(sfx):
        row = K.recurrence_table(torch.tensor([nu], dtype=dtype), torch.tensor([LS], dtype=dtype),
                                 dtype, order=2)[0].contiguous()
        cases = [_entries(nu, dtype), _tie_entries(nu, dtype)]
        ties += cases[1] is not None
        for h, x in filter(None, cases):
            x = x.contiguous()
            out = torch.zeros(x.numel(), 6, dtype=dtype)
            ok = torch.zeros(x.numel(), dtype=torch.int32)
            f(_ptr(x, ct), x.numel(), _ptr(row, ct), _ptr(out, ct),
              ctypes.cast(ok.data_ptr(), ctypes.POINTER(ctypes.c_int)))
            mat, d = _second_plain(nu, h, dtype)
            assert bool(ok.bool().all()), nu
            want = torch.stack([mat] + d, 1)
            size = want.abs().max(0).values
            rel = ((out - want).abs().max(0).values / size).tolist()
            bars = [SECOND_TOL[sfx][0]] + [SECOND_TOL[sfx][1]] * 2 + [SECOND_TOL[sfx][2]] * 3
            assert all(r <= b for r, b in zip(rel, bars)), (nu, float(x.max()), rel)
    assert ties >= 5  # x == 2 at all seven orders in float64, five in float32


@pytest.mark.parametrize("sfx", ["f32", "f64"])
def test_tangent_and_hessian_entries_match_plain(harness, sfx):
    """``matern_hess.cu``'s per-entry steps: ``tangent_entry`` (the block
    tangent's value) against ``matern_block_tangent_plain`` and
    ``hess_terms`` (the five weighted terms) against the plain model's
    partials times the cotangent, at ``_masked_entries`` (h = 0, h < 0,
    +-inf, NaN, M underflowing): where |h| is not > 0 the tangent is w_s
    (plus w_n at h = 0) and there are no terms; where M underflows or is not
    finite both are 0."""
    dtype = DTYPES[sfx]
    ct = ctypes.c_float if sfx == "f32" else ctypes.c_double
    p = ctypes.POINTER(ct)
    tan = getattr(harness, f"tangents_{sfx}")
    tan.argtypes = [p, ctypes.c_long, p, p, p]
    hes = getattr(harness, f"hess_{sfx}")
    hes.argtypes = [p, p, ctypes.c_long, p, p, ctypes.POINTER(ctypes.c_int)]
    rng = np.random.default_rng(17)
    scale, w = 1.7, torch.tensor([0.7, -1.3, 0.4, 2.1e-3], dtype=torch.float64)
    for nu in (0.3, 1.2, 1.5, 2.7):
        h = _masked_entries(nu, dtype).contiguous()
        cot = torch.as_tensor(rng.normal(size=h.numel()), dtype=dtype)
        dual = K.recurrence_table(torch.tensor([nu], dtype=dtype), torch.tensor([LS], dtype=dtype),
                                  dtype, order=1)[0].contiguous()
        second = K.recurrence_table(torch.tensor([nu], dtype=dtype),
                                    torch.tensor([LS], dtype=dtype), dtype,
                                    order=2)[0].contiguous()
        wt = torch.tensor([w[0], w[1], scale * w[2], scale * w[3]], dtype=dtype)
        got = torch.empty_like(h)
        tan(_ptr(h, ct), h.numel(), _ptr(dual, ct), _ptr(wt, ct), _ptr(got, ct))
        want = K.matern_block_tangent_plain(scale, nu, LS, h[None, :], w)[0]
        size = float(want.abs().max())
        assert torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= SECOND_TOL[sfx][1] * size, nu
        n_sp = 7  # 0, -0, -350, -1e-3, inf, -inf, NaN
        assert got[-n_sp:-n_sp + 2].tolist() == [float(wt[0] + wt[1])] * 2
        assert got[-3:-1].tolist() == [0.0, 0.0] and float(got[-1]) == float(wt[0])
        terms = torch.zeros(h.numel(), 5, dtype=dtype)
        ok = torch.zeros(h.numel(), dtype=torch.int32)
        hes(_ptr(h, ct), _ptr(cot, ct), h.numel(), _ptr(second, ct), _ptr(terms, ct),
            ctypes.cast(ok.data_ptr(), ctypes.POINTER(ctypes.c_int)))
        _, d = _second_plain(nu, h, dtype)
        ref = cot[:, None] * torch.stack(d, 1)
        size = ref.abs().max(0).values
        rel = ((terms - ref).abs().max(0).values / size).tolist()
        bars = [SECOND_TOL[sfx][1]] * 2 + [SECOND_TOL[sfx][2]] * 3
        assert all(r <= b for r, b in zip(rel, bars)), (nu, rel)
        assert not bool(ok[-n_sp:][[0, 1, 4, 5, 6]].any())  # no terms at 0, inf, NaN
        assert bool((terms[~ok.bool()] == 0).all())



def _autograd_second_columns(nu_pairs, dtype):
    """The second tangents of the gamma constants' columns (gam1, gam2,
    0.5 Gamma(1 +- mu)), of digamma's column and of pi mu / sin(pi mu) as
    the second-order table took them by autograd before their closed
    forms: ``torch.autograd.grad`` of ``gam12_tangent``, of ``trigamma``
    (float64) and a double backward of pi mu / sin(pi mu) (float64)."""
    import math

    from cokriging_tpu_torch.kernels.bessel import _gam12, gam12_tangent, trigamma

    nu = torch.abs(torch.as_tensor(nu_pairs, dtype=dtype))
    mu = nu - torch.floor(nu + 0.5)
    _, _, inv_gp, inv_gm = _gam12(mu)
    _, _, d_gp, d_gm = gam12_tangent(mu)
    m = mu.double()
    small = (math.pi * m).abs() < 1e-4
    with torch.enable_grad():
        mg = mu.detach().requires_grad_(True)
        dd_gam1, dd_gam2, dd_gp, dd_gm = (
            torch.autograd.grad(t.sum(), mg, retain_graph=True)[0] for t in gam12_tangent(mg))
        pg = (math.pi * m).requires_grad_(True)
        f = torch.where(small, 1.0 + pg * pg / 6.0, pg / torch.sin(torch.where(small, 1.0, pg)))
        (df,) = torch.autograd.grad(f.sum(), pg, create_graph=True)
        (ddf,) = torch.autograd.grad(df.sum(), pg)
        ng = nu.detach().double().requires_grad_(True)
        (psi2,) = torch.autograd.grad(trigamma(ng).sum(), ng)
    return {5: dd_gam1, 6: dd_gam2,
            7: -0.5 * dd_gp / (inv_gp * inv_gp) + d_gp * d_gp / (inv_gp * inv_gp * inv_gp),
            8: -0.5 * dd_gm / (inv_gm * inv_gm) + d_gm * d_gm / (inv_gm * inv_gm * inv_gm),
            10: psi2.to(dtype), 11: (math.pi ** 2 * ddf).to(dtype)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_second_order_rows_in_one_call_match_autograd_rows(dtype):
    """``recurrence_table(..., order=2)`` for six (nu, ls) pairs in one call
    (nu = 1.5 -+ one ulp of the dtype, 1.5, 0.2, 1.37, 3.5): each row equals
    the row of its pair alone, and the closed-form second tangents of the
    gamma constants, of digamma and of pi mu / sin(pi mu) equal the ones
    autograd gave the table before (``_autograd_second_columns``), bit for
    bit (the bar the rows are held to is 1e-15 relative; they meet it
    exactly). Every call counts one second-order build."""
    np_dt = np.dtype(str(dtype).removeprefix("torch."))
    nus = [float(np.nextafter(np_dt.type(1.5), np_dt.type(0))),
           float(np.nextafter(np_dt.type(1.5), np_dt.type(2))), 1.5, 0.2, 1.37, 3.5]
    nu_t = torch.tensor(nus, dtype=dtype)
    ls_t = torch.tensor([700.0, 300.0, 1500.0, 800.0, 450.0, 2000.0], dtype=dtype)
    before = K.LAUNCHES["recurrence_table_order2"]
    rows = K.recurrence_table(nu_t, ls_t, dtype, order=2)
    assert K.LAUNCHES["recurrence_table_order2"] == before + 1
    assert rows.shape == (6, 3 * (13 + 3 * SERIES_ITERS[dtype] + 3 * CF2_ITERS[dtype]))
    for k in range(6):
        assert torch.equal(K.recurrence_table(nu_t[k], ls_t[k], dtype, order=2)[0], rows[k])
    ref = _autograd_second_columns(nu_t, dtype)
    for col, want in ref.items():
        got = rows[:, 3 * col + 2]
        assert got.dtype == dtype
        assert torch.equal(got, want.to(dtype)), (col, got, want)
        assert bool((((got - want).abs()) <= 1e-15 * want.abs()).all())
    # the first tangents are the dual table's, but for the nu-only columns
    dual = K.recurrence_table(nu_t, ls_t, dtype, order=1)
    same = [c for c in range(dual.shape[1] // 2) if c not in (0, 2, 9, 10)]
    for c in same:
        assert torch.equal(rows[:, 3 * c], dual[:, 2 * c])
        assert torch.equal(rows[:, 3 * c + 1], dual[:, 2 * c + 1])
