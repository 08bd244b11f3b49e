"""The per-pair arithmetic of the variogram pair passes (``csrc/vario.cuh``),
compiled for the host with ``g++`` and a stub ``cuda_runtime.h``: h bit-equal
to ``cuda_ops.h_block``; the histogram slot that the lookup record of
``cuda_ops._bin_record`` gives, against ``torch.searchsorted(side="left") - 1``
clipped into the first / last bin and dropped outside its window, at h = 0,
on every edge, one ulp either side, at h_max and past the last edge; and the
upper-triangle tile map against an enumeration. Then the multi-variogram
plain forms against the one-variogram ones and, through
``empirical_variograms_device(device="cpu")``, against the JAX package.

    python -m pytest tests/test_torch_vario_host.py

The g++ tests skip where ``g++`` is missing (decided inside the fixture).
"""

import ctypes
import shutil
import subprocess
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from cokriging_tpu.estimate import empirical as JE
from cokriging_tpu_torch.estimate import empirical as TE
from cokriging_tpu_torch.kernels import cuda_ops as K

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "cokriging_tpu_torch" / "kernels" / "csrc"
STUB = "#pragma once\n#define __host__\n#define __device__\n#define __forceinline__ inline\n"
HARNESS = """
#include "vario.cuh"

template <typename T, bool GEO>
void hs(const T* fa, long n, const T* fb, long m, T* out) {
  constexpr int F = GEO ? 5 : 2;
  for (long i = 0; i < n; ++i)
    for (long j = 0; j < m; ++j) out[i * m + j] = ckv::h_pair<T, GEO>(fa + i * F, fb + j * F);
}

template <typename T>
void slots(const T* h, const int* valid, long n, const unsigned char* rec, int n_win, int* out) {
  const ckv::BinLookup<T> L = ckv::lookup_of<T>(rec);
  for (long i = 0; i < n; ++i) {
    const int general = ckv::bin_slot<0>(h[i], valid[i] != 0, L, n_win);
    // the kernels' one-compare path, where the record allows it
    out[i] = L.k_cmp == 1 && ckv::bin_slot<1>(h[i], valid[i] != 0, L, n_win) != general
                 ? -1 : general;
  }
}

template <typename T> void layout(int* out) {
  out[0] = ckv::Record<T>::edges;
  out[1] = ckv::Record<T>::slot;
  out[2] = ckv::Record<T>::below;
  out[3] = ckv::Record<T>::bytes;
}

extern "C" {
void h_f32(const float* a, long n, const float* b, long m, int geo, float* o) {
  geo ? hs<float, true>(a, n, b, m, o) : hs<float, false>(a, n, b, m, o);
}
void h_f64(const double* a, long n, const double* b, long m, int geo, double* o) {
  geo ? hs<double, true>(a, n, b, m, o) : hs<double, false>(a, n, b, m, o);
}
void slots_f32(const float* h, const int* v, long n, const unsigned char* r, int w, int* o) {
  slots(h, v, n, r, w, o);
}
void slots_f64(const double* h, const int* v, long n, const unsigned char* r, int w, int* o) {
  slots(h, v, n, r, w, o);
}
void tri(long long t, int nr, int* rb, int* cb) { ckv::tri_coords(t, nr, *rb, *cb); }
void layout_f32(int* o) { layout<float>(o); }
void layout_f64(int* o) { layout<double>(o); }
void constants(int* o) {
  o[0] = ckv::MAX_BINS;
  o[1] = ckv::EDGE_CAP;
  o[2] = ckv::MAX_CELLS;
  o[3] = ckv::SLOT_CAP;
}
}
"""
DTYPES = {"f32": (torch.float32, np.float32), "f64": (torch.float64, np.float64)}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels' device functions for the host")
    d = tmp_path_factory.mktemp("vario_host")
    (d / "cuda_runtime.h").write_text(STUB)
    (d / "harness.cpp").write_text(HARNESS)
    out = d / "libvariohost.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC", f"-I{d}",
                    f"-I{CSRC}", "-o", str(out), str(d / "harness.cpp")], check=True)
    return ctypes.CDLL(str(out))


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


def _points(rng, n):
    return np.column_stack([rng.uniform(24, 50, n), rng.uniform(-124, -67, n)])


def test_record_layout_matches_header(lib):
    got = (ctypes.c_int * 4)()
    lib.constants(got)
    assert list(got) == [K.VARIO_MAX_BINS, K._EDGE_CAP, K._MAX_CELLS, K._SLOT_CAP]
    for sfx, (_, np_dt) in DTYPES.items():
        getattr(lib, f"layout_{sfx}")(got)
        assert tuple(got) == K._record_offsets(np.dtype(np_dt)), sfx


@pytest.mark.parametrize("sfx", ["f32", "f64"])
@pytest.mark.parametrize("geodesic", [True, False])
def test_h_bit_equal_to_h_block(lib, sfx, geodesic):
    t_dt, _ = DTYPES[sfx]
    rng = np.random.default_rng(11)
    ca, cb = _points(rng, 37), _points(rng, 23)
    cb[:3] = ca[:3]  # exact zeros
    fa = TE.point_features(torch.as_tensor(ca, dtype=t_dt), geodesic).contiguous()
    fb = TE.point_features(torch.as_tensor(cb, dtype=t_dt), geodesic).contiguous()
    out = torch.empty((37, 23), dtype=t_dt)
    getattr(lib, f"h_{sfx}").argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
                                        ctypes.c_long, ctypes.c_int, ctypes.c_void_p]
    getattr(lib, f"h_{sfx}")(_p(fa), 37, _p(fb), 23, int(geodesic), _p(out))
    assert torch.equal(out, K.h_block(fa, fb, geodesic))
    assert (out[:3, :3].diagonal() == 0).all()


def _edge_cases(n_bins, np_dt, degenerate=False):
    """All edges of ``n_bins`` bins from a CONUS-like h range (or one whose
    h_min equals h_max, so every edge but the first is one value up to the
    rounding of the linspace, sorted here), and h at
    0, on each edge and one ulp either side, at h_max, past the last edge
    and at random."""
    snap = np_dt(1e-6)
    hmin = np_dt(TE._h_of_d(np_dt(30.0), True))
    hmax = hmin if degenerate else np_dt(TE._h_of_d(np_dt(2900.0), True))
    _, edges = TE._device_bins(hmin, hmax, True, snap, n_bins, np.dtype(np_dt))
    edges = np.sort(edges)
    h_max = np_dt(TE._h_of_d(np_dt(3000.0), True))
    rng = np.random.default_rng(n_bins)
    hs = np.concatenate([
        [0.0, np.nextafter(np_dt(0), np_dt(1)), h_max, np.nextafter(h_max, np_dt(1)),
         2.0 * edges[-1], np.inf],
        edges, np.nextafter(edges, np_dt(-1)), np.nextafter(edges, np_dt(np.inf)),
        rng.uniform(0.0, 1.1 * edges[-1], 400),
    ]).astype(np_dt)
    return edges, np.abs(hs)  # nextafter(0, -1) is -tiny: h >= +0


@pytest.mark.parametrize("sfx", ["f32", "f64"])
@pytest.mark.parametrize("n_bins,window", [(15, 24), (40, 24), (40, 8), (15, 4)])
def test_bin_slot_matches_searchsorted(lib, sfx, n_bins, window):
    """Every window (first, middle, last) of a CONUS-like set of edges and of
    a degenerate one: the slot of each h is its bin
    clamp(searchsorted(edges, h, side="left") - 1, 0, n_bins - 1) less the
    window's first bin where that bin lies in the window, else n_win; an
    invalid pair's is n_win. The kernels' one-compare path agrees."""
    t_dt, np_dt = DTYPES[sfx]
    f = getattr(lib, f"slots_{sfx}")
    f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_void_p]
    for degenerate in (False, True):
        edges, hs = _edge_cases(n_bins, np_dt, degenerate)
        h = torch.as_tensor(hs)
        valid = torch.as_tensor(np.random.default_rng(3).uniform(size=h.numel()) > 0.1,
                                dtype=torch.int32)
        ref = torch.clamp(torch.searchsorted(torch.as_tensor(edges), h, side="left") - 1,
                          0, n_bins - 1)
        k_seen = set()
        for bin0 in range(0, n_bins, window):
            n_win = min(window, n_bins - bin0)
            rec, k_cmp, _ = K._bin_record(edges[bin0:bin0 + n_win + 1], bin0 == 0,
                                       bin0 + n_win == n_bins, np.dtype(np_dt))
            k_seen.add(k_cmp)
            rec_t = torch.from_numpy(rec)
            out = torch.empty(h.numel(), dtype=torch.int32)
            f(_p(h), _p(valid), h.numel(), _p(rec_t), n_win, _p(out))
            inside = (ref >= bin0) & (ref < bin0 + n_win) & (valid != 0)
            want = torch.where(inside, ref - bin0, n_win).to(torch.int32)
            assert torch.equal(out, want), (sfx, degenerate, bin0, k_cmp)
        assert (k_seen == {1}) != degenerate, k_seen  # the degenerate edges take many


def test_record_rejects_negative_edges_and_other_dtypes():
    np_dt = np.dtype(np.float64)
    for bad in ([-1.0, 0.0, 1.0], [0.0, np.nan, 1.0]):
        with pytest.raises(ValueError):
            K._bin_record(np.array(bad), True, True, np_dt)
    with pytest.raises(ValueError):
        K._bin_record(np.array([0.0, 1.0], np.float32), True, True, np_dt)


def test_triangle_tile_map_matches_enumeration(lib):
    rb, cb = ctypes.c_int(), ctypes.c_int()
    for nr in list(range(1, 41)) + [235, 30_000]:
        tiles = [(r, c) for r in range(nr) for c in range(r, nr)] if nr <= 235 else None
        ts = range(nr * (nr + 1) // 2) if tiles is not None else [
            0, 1, nr - 1, nr, 2 * nr - 2, nr * (nr + 1) // 2 - 2, nr * (nr + 1) // 2 - 1]
        for t in ts:
            lib.tri(ctypes.c_longlong(t), nr, ctypes.byref(rb), ctypes.byref(cb))
            if tiles is not None:
                assert (rb.value, cb.value) == tiles[t], (nr, t)
            else:
                r = rb.value
                assert r <= cb.value < nr
                assert r * nr - r * (r - 1) // 2 + cb.value - r == t, (nr, t)


def _sides(rng, dtype, geodesic):
    """Three processes (one of a single point), all six i <= j variograms."""
    pts = [_points(rng, 70), _points(rng, 1), _points(rng, 45)]
    if not geodesic:
        pts = [p / 10.0 for p in pts]
    feats = [TE.point_features(torch.as_tensor(p, dtype=dtype), geodesic) for p in pts]
    vals = [torch.as_tensor(rng.normal(size=len(p)), dtype=dtype) for p in pts]
    pairs = [(i, j) for i in range(3) for j in range(i, 3)]
    return feats, vals, pairs


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("geodesic,covariogram", [(True, False), (True, True), (False, False)])
def test_pairs_plain_forms_equal_one_variogram_calls(dtype, geodesic, covariogram):
    """The multi-variogram forms (the CPU path of the launches that cover all
    variograms at once) equal the one-variogram plain calls, bit for bit."""
    rng = np.random.default_rng(21)
    feats, vals, pairs = _sides(rng, dtype, geodesic)
    np_dt = np.dtype(str(dtype).removeprefix("torch."))
    h_max = float(TE._h_of_d(np_dt.type(2500.0 if geodesic else 4.0), geodesic))
    h_snap = float(TE._h_of_d(np_dt.type(1e-6), geodesic))
    mm = K.variogram_minmax_pairs([(feats[i], feats[j], i == j) for i, j in pairs], geodesic,
                                  h_max, h_snap)
    edges = []
    for k, (i, j) in enumerate(pairs):
        one = K.variogram_minmax_plain(feats[i], feats[j], i == j, geodesic, h_max, h_snap)
        assert torch.equal(mm[k], one), (i, j)
        hmin, hmax = (one if (i, j) != (1, 1) else torch.tensor([0.5, 0.5])).numpy()
        edges.append(TE._device_bins(hmin, hmax, geodesic, np_dt.type(1e-6), 12, np_dt)[1])
    assert torch.equal(mm[3], torch.tensor([np.inf, -np.inf], dtype=dtype))  # one point
    sums, counts = K.variogram_bin_pairs(
        [(feats[i], feats[j], vals[i], vals[j], i == j) for i, j in pairs], edges, geodesic,
        covariogram, h_max)
    assert sums.shape == counts.shape == (6, 12)
    for k, (i, j) in enumerate(pairs):
        s, c = K.variogram_bin_plain(feats[i], feats[j], vals[i], vals[j],
                                     torch.as_tensor(edges[k]), i == j, geodesic, covariogram,
                                     h_max)
        assert torch.equal(sums[k], s) and torch.equal(counts[k], c), (i, j)
    assert counts[3].sum() == 0 and counts[0].sum() > 0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_three_process_variograms_match_all_pairs_program(dtype):
    """All six variograms of three processes in one call of each package, in
    the points' dtype: counts exact, means at rtol 1e-5 (the bar of
    tests/test_torch_empirical.py, here in float32 as well), centers at rtol
    1e-12 in float64 and 1e-4 in float32: there the h of the closest pair,
    whose x = sin(a) cos(b) - cos(a) sin(b) cancels, takes the two packages'
    operation orders apart by ~1e-5 of its distance (1.8e-5 here), and every
    center is a linspace from it."""
    rng = np.random.default_rng(9)
    coords = [_points(rng, n).astype(dtype) for n in (90, 75, 60)]
    values = [rng.normal(size=len(c)).astype(dtype) for c in coords]
    jcfg = JE.VarioConfig(max_dist=2500.0, n_bins=10)
    tcfg = TE.VarioConfig(max_dist=2500.0, n_bins=10)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp, jc, jm, jn = JE.empirical_variograms_device(coords, values, jcfg)
        tp, tc, tm, tn = TE.empirical_variograms_device(coords, values, tcfg, device="cpu")
    assert list(tp) == list(jp) and len(tp) == 6
    np.testing.assert_array_equal(tn, np.asarray(jn))
    np.testing.assert_allclose(tc, np.asarray(jc), rtol=1e-4 if dtype == np.float32 else 1e-12)
    np.testing.assert_allclose(tm, np.asarray(jm), rtol=1e-5)
