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

template <typename T, bool COV, int NB>
void walks(const unsigned short* perm, const unsigned short* seg, int n_chunks, int n_win,
           int steps, const T* row_v, const T* col_v, int width, double* out) {
  for (int w = 0; w < steps; ++w)
    for (int pos = 0; pos < width; pos += 2) {
      double hist[2][NB] = {};
      for (int k = 0; k < n_chunks; ++k)
        ckv::walk_chunk<T, COV, NB>(perm + k * ckv::BATCH_PAIRS, seg + k * ckv::BATCH_SEG, n_win,
                                    w, steps, row_v, col_v + k * ckv::BATCH_CHUNK * width, pos,
                                    width, hist);
      for (int j = 0; j < 2; ++j)
        for (int s = 0; s < NB; ++s) out[(w * width + pos + j) * NB + s] = hist[j][s];
    }
}

template <typename T>
void walk(const unsigned short* perm, const unsigned short* seg, int n_chunks, int n_win,
          int steps, const T* row_v, const T* col_v, int width, int cov, int nb, double* out) {
  if (nb == 16) {
    (cov ? walks<T, true, 16> : walks<T, false, 16>)(perm, seg, n_chunks, n_win, steps, row_v,
                                                     col_v, width, out);
  } else {
    (cov ? walks<T, true, ckv::MAX_BINS> : walks<T, false, ckv::MAX_BINS>)(
        perm, seg, n_chunks, n_win, steps, row_v, col_v, width, out);
  }
}

extern "C" {
void walk_f32(const unsigned short* p, const unsigned short* s, int k, int w, int st,
              const float* r, const float* c, int wd, int cov, int nb, double* o) {
  walk(p, s, k, w, st, r, c, wd, cov, nb, o);
}
void walk_f64(const unsigned short* p, const unsigned short* s, int k, int w, int st,
              const double* r, const double* c, int wd, int cov, int nb, double* o) {
  walk(p, s, k, w, st, r, c, wd, cov, nb, o);
}
void batch_constants(int* o) {
  o[0] = ckv::BATCH_STRIP;
  o[1] = ckv::BATCH_CHUNK;
  o[2] = ckv::BATCH_PAIRS;
  o[3] = ckv::BATCH_SEG;
}
// the rounds of the batched pass, 6 numbers each (s_lo, s_hi, c_lo, c_hi,
// max_chunks, max_spans); returns their number
int batch_rounds(int count, const long long* dims, long long* o, long long* caps) {
  long long strips = 0;
  for (int p = 0; p < count; ++p) strips += (dims[4 * p] + ckv::BATCH_STRIP - 1) / ckv::BATCH_STRIP;
  int r = 0;
  for (long long s = 0; s < strips; ++r) {
    const ckv::BatchRound R = ckv::batch_round(count, dims, s, ckv::BATCH_LIST, ckv::BATCH_SLOTS);
    const long long v[6] = {R.s_lo, R.s_hi, R.c_lo, R.c_hi, R.max_chunks, R.max_spans};
    for (int k = 0; k < 6; ++k) o[6 * r + k] = v[k];
    s = R.s_hi;
  }
  caps[0] = ckv::BATCH_SPAN;
  caps[1] = ckv::BATCH_LIST;
  caps[2] = ckv::BATCH_SLOTS;
  ckv::batch_scratch(count, dims, caps + 3);
  return r;
}
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


def test_batch_constants_match_header(lib):
    got = (ctypes.c_int * 4)()
    lib.batch_constants(got)
    assert list(got) == [K.VARIO_STRIP, K._BATCH_PAIRS // K.VARIO_STRIP, K._BATCH_PAIRS,
                         K._BATCH_SEG]


def _walk_case(rng, np_dt, n_win, n_chunks, width, integer):
    """A strip's chunks as the batched pass's slot pass leaves them: each
    pair's slot (n_win: dropped), the binned pairs stably sorted by slot
    (``perm``, ``seg``), and row / column values of ``width`` replicates."""
    strip, chunk = K.VARIO_STRIP, K._BATCH_PAIRS // K.VARIO_STRIP
    # ~85% of the pairs dropped, as beyond h_max in the bootstrap's month
    slots = np.where(rng.uniform(size=(n_chunks, strip * chunk)) < 0.85, n_win,
                     rng.integers(0, n_win, size=(n_chunks, strip * chunk)))
    perm = np.zeros((n_chunks, K._BATCH_PAIRS), dtype=np.uint16)
    seg = np.zeros((n_chunks, K._BATCH_SEG), dtype=np.uint16)
    for k in range(n_chunks):
        order = np.argsort(slots[k], kind="stable")
        kept = order[slots[k][order] < n_win]
        perm[k, :kept.size] = kept
        seg[k, :n_win + 1] = np.searchsorted(slots[k][kept], np.arange(n_win + 1))
    if integer:  # clouds and sums exact in either dtype: any order gives the same bits
        row_v = rng.integers(-8, 9, size=(strip, width)).astype(np_dt)
        col_v = rng.integers(-8, 9, size=(n_chunks * chunk, width)).astype(np_dt)
    else:
        row_v = rng.normal(size=(strip, width)).astype(np_dt)
        col_v = rng.normal(size=(n_chunks * chunk, width)).astype(np_dt)
    return slots, perm, seg, row_v, col_v


def _pair_order_sums(slots, row_v, col_v, n_win, cov):
    """Per (replicate, slot) the clouds of the pairs in pair order (chunk,
    row, column), each formed in the values' dtype and added in float64,
    with the sum of their magnitudes."""
    strip, chunk = K.VARIO_STRIP, K._BATCH_PAIRS // K.VARIO_STRIP
    width = row_v.shape[1]
    sums = np.zeros((width, n_win))
    mags = np.zeros((width, n_win))
    for k in range(slots.shape[0]):
        for e in range(strip * chunk):
            s = slots[k, e]
            if s == n_win:
                continue
            a, v = row_v[e // chunk], col_v[k * chunk + e % chunk]
            cl = a * v if cov else (a.dtype.type(0.5) * (a - v)) * (a - v)
            sums[:, s] += cl.astype(np.float64)
            mags[:, s] += np.abs(cl.astype(np.float64))
    return sums, mags


def _run_walk(lib, sfx, perm, seg, n_win, steps, row_v, col_v, cov, nb):
    n_chunks, width = perm.shape[0], row_v.shape[1]
    out = np.zeros((steps, width, nb))
    p, sg = np.ascontiguousarray(perm), np.ascontiguousarray(seg)
    r, c = np.ascontiguousarray(row_v), np.ascontiguousarray(col_v)
    getattr(lib, f"walk_{sfx}")(p.ctypes.data_as(ctypes.c_void_p), sg.ctypes.data_as(
        ctypes.c_void_p), n_chunks, n_win, steps, r.ctypes.data_as(ctypes.c_void_p),
        c.ctypes.data_as(ctypes.c_void_p), width, int(cov), nb,
        out.ctypes.data_as(ctypes.c_void_p))
    return out


@pytest.mark.parametrize("sfx", ["f32", "f64"])
@pytest.mark.parametrize("cov", [False, True])
@pytest.mark.parametrize("n_win,steps", [(15, 8), (24, 1), (6, 3)])
def test_slot_sorted_walk_matches_pair_order_sums(lib, sfx, cov, n_win, steps):
    """``vario.cuh::walk_chunk``, the batched pass's walk of slot-sorted
    chunks for two adjacent replicates at once (each walker every
    ``steps``-th entry of a slot, over two chunks, six replicates), against
    the clouds added in pair order: equal to the last
    bit on integer-valued replicates (every sum exact, so any order agrees:
    each binned pair counted once, in its slot, with its row and column
    values) and, on random values, within 1e-15 of the sum of |cloud| per
    slot and replicate; the dropped slot adds nothing."""
    np_dt = DTYPES[sfx][1]
    nb = 16 if n_win <= 16 else K.VARIO_MAX_BINS
    rng = np.random.default_rng(40 + n_win + steps + int(cov))
    for integer in (True, False):
        slots, perm, seg, row_v, col_v = _walk_case(rng, np_dt, n_win, 2, 6, integer)
        want, mag = _pair_order_sums(slots, row_v, col_v, n_win, cov)
        out = _run_walk(lib, sfx, perm, seg, n_win, steps, row_v, col_v, cov, nb)
        assert not out[:, :, n_win:].any()
        got = out.sum(axis=0)[:, :n_win]
        if integer:
            assert np.array_equal(got, want)
        else:
            assert np.all(np.abs(got - want) <= 1e-15 * mag)


@pytest.mark.parametrize("sizes", [
    [(12_500, 12_500, 1), (12_500, 12_500, 0), (12_500, 12_500, 1)],  # the bootstrap's three
    [(50_000, 50_000, 1), (50_000, 40_000, 0)],  # the list's and the partials' caps bind
    [(70, 70, 1), (0, 5, 0), (130, 1, 0), (64, 64, 1)],  # ragged, an empty variogram
])
def test_batch_rounds_cover_the_strips_within_their_scratch(lib, sizes):
    """``vario.cuh::batch_round``, the batched pass's rounds of strips:
    every strip once, in order, each round's chunks contiguous and its
    count, most chunks and most spans of a strip those of its strips; a
    round stays within the list's and the partials' caps (a single strip
    may exceed them) and stops only where its next strip would not fit; and
    ``batch_scratch`` is the largest round's need. The rounds depend on the
    shapes only, so the order of a replicate's sums does not move with the
    number of replicates."""
    dims, per_strip = [], []
    for n, m, marginal in sizes:
        dims += [n, m, marginal, len(per_strip)]
        ns, nc = -(-n // K.VARIO_STRIP), -(-m // (K._BATCH_PAIRS // K.VARIO_STRIP))
        per_strip += [nc - s if marginal else nc for s in range(ns)]
    c_dims = (ctypes.c_longlong * len(dims))(*dims)
    out = (ctypes.c_longlong * (6 * (len(per_strip) + 1)))()
    caps = (ctypes.c_longlong * 5)()
    lib.batch_rounds.restype = ctypes.c_int
    n_rounds = lib.batch_rounds(len(sizes), c_dims, out, caps)
    span, list_cap, slot_cap, need_list, need_slots = list(caps)
    rounds = np.frombuffer(out, dtype=np.int64)[:6 * n_rounds].reshape(n_rounds, 6)
    chunk0 = np.concatenate([[0], np.cumsum(per_strip)])
    spans = [-(-c // span) for c in per_strip]
    assert rounds[0, 0] == 0 and rounds[-1, 1] == len(per_strip)
    assert (rounds[1:, 0] == rounds[:-1, 1]).all()
    for k, (s_lo, s_hi, c_lo, c_hi, max_c, max_sp) in enumerate(rounds):
        assert s_hi > s_lo
        assert (c_lo, c_hi) == (chunk0[s_lo], chunk0[s_hi])
        assert max_c == max(per_strip[s_lo:s_hi]) and max_sp == max(spans[s_lo:s_hi])
        if s_hi - s_lo > 1:
            assert c_hi - c_lo <= list_cap and (s_hi - s_lo) * max_sp <= slot_cap
        if s_hi < len(per_strip):
            grown_sp = max(max_sp, spans[s_hi])
            assert (chunk0[s_hi + 1] - c_lo > list_cap
                    or (s_hi - s_lo + 1) * grown_sp > slot_cap)
    assert need_list == max(1, (rounds[:, 3] - rounds[:, 2]).max())
    assert need_slots == max(1, ((rounds[:, 1] - rounds[:, 0]) * rounds[:, 5]).max())
    assert need_list <= max(list_cap, max(per_strip)) and need_slots <= max(
        slot_cap, max(spans))
