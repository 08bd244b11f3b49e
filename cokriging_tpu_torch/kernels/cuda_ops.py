"""Hand-written CUDA kernels of the port and their plain torch versions.

Counterpart of ``cokriging_tpu/kernels/pallas_ops.py``:

- ``variogram_minmax_pairs`` and ``variogram_bin_pairs`` (``csrc/variogram.cu``,
  one launch per pass over all the variograms of a call; ``variogram_minmax``
  and ``variogram_bin`` are their one-variogram forms) replace
  ``variogram_bin_pallas``, built to the two-pass contract of
  ``estimate/empirical.py::_all_pairs_program`` on the distance surrogate h;
  ``variogram_bin_batch`` (the same source) is pass 2 for a batch of value
  replicates over one set of pairs, the parametric bootstrap's re-estimate
  (``estimate/bootstrap.py::_batched_bin_program`` in the JAX package);
- ``matern_correlation_block`` (``csrc/matern.cu``) replaces
  ``matern_correlation_pallas``;
- ``matern_block_grad`` (``csrc/matern_grad.cu``) replaces
  ``matern_block_grad_pallas``;
- ``matern_corr_pairs`` and ``matern_corr_pairs_grad`` (``csrc/matern_pairs.cu``)
  replace ``matern_corr_pairs_pallas`` and ``matern_corr_pairs_grad_pallas``;
- ``matern_block_partials``, ``matern_block_tangent`` and ``matern_block_hess``
  (``csrc/matern_hess.cu``) are the block's second order, the backward of
  ``matern_block_grad`` (the reference takes it by XLA's AD of the
  elementwise model; no Pallas kernel): the tangent's partials once per
  block and Hessian, one combine of them per Hessian row, and the Hessian
  sums.

The Matern kernels share ``csrc/kv.cuh`` (the K_nu recurrences and the
per-entry steps) and ``csrc/partition.cuh`` (the tile sort by pair, branch
and CF2 half-octave of x), and read their per-(nu, ls) constants from
``recurrence_table``, built with torch on the device of nu and ls: no host
read, no synchronization. A caller that launches many times with one
parameter set passes its table rows in (``cov.matern.pair_table``).

Each wrapper runs the plain torch version only for tensors on the CPU. For
a CUDA tensor it launches its kernel or raises; there is no fallback. Each
wrapper adds one to its entry of ``LAUNCHES`` per kernel launch, so a run
can show that its main path went through the kernels.
"""

import ctypes
import math

import numpy as np
import torch

from cokriging_tpu_torch.kernels import _build
from cokriging_tpu_torch.kernels.bessel import (
    CF2_ITERS, SERIES_ITERS, _gam12, _kv_value, gam12_second, gam12_tangent, tetragamma,
    trigamma,
)

#: Kernel launches per wrapper since the last ``reset_launch_counts()``.
LAUNCHES = {
    "variogram_minmax": 0, "variogram_bin": 0, "variogram_bin_batch": 0, "matern_correlation": 0,
    "matern_block_grad": 0, "matern_corr_pairs": 0, "matern_corr_pairs_grad": 0,
    "matern_block_partials": 0, "matern_block_tangent": 0, "matern_block_hess": 0,
    # not a kernel: builds of the second-order table (~500 small torch
    # launches each on the card), one per Hessian on the live path
    "recurrence_table_order2": 0,
}

_FLOATS = (torch.float32, torch.float64)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_CT = {torch.float32: ctypes.c_float, torch.float64: ctypes.c_double}
_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_ERROR_STRING = {
    "variogram.cu": "vario_error_string",
    "matern.cu": "matern_error_string",
    "matern_grad.cu": "matern_grad_error_string",
    "matern_pairs.cu": "pairs_error_string",
    "matern_hess.cu": "hess_error_string",
}

# rows per block of the plain pair pass (bounds its (rows, m) temporaries)
_PLAIN_PAIR_ELEMS = 1 << 22
# entries per row chunk of the plain block gradient (the reference's
# BWD_CHUNK_ELEMS idea: the dual K_nu pass holds ~60 chunk-sized temporaries)
_PLAIN_GRAD_ELEMS = 1 << 20
# the same for the plain block tangent and Hessian sums, which keep the graph
# of the elementwise model's K_nu pass (and of its tangent) per chunk, ~20 kB
# an entry for the Hessian sums: on the card larger chunks, since each chunk
# is thousands of small launches
_PLAIN_TANGENT_ELEMS = {"cpu": 1 << 18, "cuda": 1 << 20}
_PLAIN_HESS_ELEMS = {"cpu": 1 << 16, "cuda": 1 << 19}
_LN2 = math.log(2.0)


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def _fn(src, name, argtypes):
    f = getattr(_build.load(src), name)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def _fn_ll(src, name, argtypes):
    f = getattr(_build.load(src), name)
    f.argtypes = argtypes
    f.restype = _LL
    return f


def _check_rc(src, rc, what):
    if rc != 0:
        err = getattr(_build.load(src), _ERROR_STRING[src])
        err.argtypes = [_I]
        err.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {rc} ({err(rc).decode()})")


def _ptr(t):
    return _P(t.data_ptr())


def _stream(device):
    return _P(torch.cuda.current_stream(device).cuda_stream)


def _check_cuda(name, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if t.dtype != tensors[0].dtype or t.dtype not in _FLOATS:
            raise ValueError(f"{name}: tensors must share one float32/float64 dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _check_features(fa, fb, geodesic, marginal):
    width = 5 if geodesic else 2
    if fa.ndim != 2 or fb.ndim != 2 or fa.shape[1] != width or fb.shape[1] != width:
        raise ValueError(f"point features must be (n, {width}) for geodesic={geodesic}")
    if marginal and fa.shape[0] != fb.shape[0]:
        raise ValueError("a marginal pass needs one point set on both sides")
    if fa.device.type != fb.device.type:
        raise ValueError("point features must lie on one device")


# ---------------------------------------------------------------------------
# Variogram pair passes
# ---------------------------------------------------------------------------

#: Rows and columns of pairs per block of ``csrc/variogram.cu`` (``TILE``); the
#: library checks the tile offsets it is given against its own.
VARIO_TILE = 256
#: Variograms per launch of ``csrc/variogram.cu`` (``MAX_PAIRS``).
VARIO_MAX_PAIRS = 32
#: Bins of one window of the bin pass, and the layout of a window's lookup
#: record (``csrc/vario.cuh``: ``MAX_BINS``, ``EDGE_CAP``, ``MAX_CELLS``,
#: ``SLOT_CAP``, ``Record``).
VARIO_MAX_BINS = 24
_EDGE_CAP = 2 * (VARIO_MAX_BINS + 1)
_MAX_CELLS = 1024
_SLOT_CAP = 32
#: Rows per strip of the batched bin pass (``csrc/vario.cuh`` ``BATCH_STRIP``),
#: and its chunks' pairs and slot offsets (``BATCH_PAIRS``, ``BATCH_SEG``).
VARIO_STRIP = 64
_BATCH_PAIRS = 64 * 64
_BATCH_SEG = 32


def h_block(fa, fb, geodesic):
    """Distance surrogate h for all (row, col) pairs of two feature sets:
    the same operations, in the same order, as the kernel's ``h_pair``."""
    if geodesic:
        x = fa[:, 0:1] * fb[:, 1] - fa[:, 1:2] * fb[:, 0]
        y = fa[:, 2:3] * fb[:, 3] - fa[:, 3:4] * fb[:, 2]
        return x * x + (fa[:, 4:5] * fb[:, 4]) * (y * y)
    dx = fa[:, 0:1] - fb[:, 0]
    dy = fa[:, 1:2] - fb[:, 1]
    return dx * dx + dy * dy


def _plain_blocks(fa, fb, marginal, batch=1):
    """Row blocks of the plain pair pass (of ``batch`` value replicates):
    (first row, end row, first column, row < col mask or None). Marginal
    blocks skip the columns left of their first row."""
    n, m = fa.shape[0], fb.shape[0]
    rows = max(1, _PLAIN_PAIR_ELEMS // max(batch * m, 1))
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        c0 = r0 if marginal else 0
        ri = torch.arange(r0, r1, device=fa.device)[:, None]
        ci = torch.arange(c0, m, device=fa.device)[None, :]
        yield r0, r1, c0, (ri < ci) if marginal else None


def variogram_minmax_plain(fa, fb, marginal, geodesic, h_max, h_snap):
    """Plain torch pass 1: tensor [min of h over valid pairs with h > h_snap,
    max of h over valid pairs] (inf / -inf when there is none)."""
    _check_features(fa, fb, geodesic, marginal)
    hmin = torch.tensor(torch.inf, dtype=fa.dtype, device=fa.device)
    hmax = torch.tensor(-torch.inf, dtype=fa.dtype, device=fa.device)
    for r0, r1, c0, tri in _plain_blocks(fa, fb, marginal):
        h = h_block(fa[r0:r1], fb[c0:], geodesic)
        valid = h <= h_max
        if tri is not None:
            valid = valid & tri
        hmin = torch.minimum(hmin, torch.where(valid & (h > h_snap), h, torch.inf).min())
        hmax = torch.maximum(hmax, torch.where(valid, h, -torch.inf).max())
    return torch.stack([hmin, hmax])


def variogram_bin_plain(fa, fb, va, vb, h_edges, marginal, geodesic, covariogram, h_max):
    """Plain torch pass 2: per-bin cloud sums (float64) and pair counts
    (int64), bin = #(h_edges < h) - 1 clipped."""
    _check_features(fa, fb, geodesic, marginal)
    n_bins = h_edges.shape[0] - 1
    sums = torch.zeros(n_bins + 1, dtype=torch.float64, device=fa.device)
    counts = torch.zeros(n_bins + 1, dtype=torch.int64, device=fa.device)
    for r0, r1, c0, tri in _plain_blocks(fa, fb, marginal):
        h = h_block(fa[r0:r1], fb[c0:], geodesic)
        a, b = va[r0:r1, None], vb[None, c0:]
        if covariogram:
            cloud = a * b
        else:
            diff = a - b
            cloud = 0.5 * diff * diff
        valid = h <= h_max
        if tri is not None:
            valid = valid & tri
        idx = torch.clamp(torch.searchsorted(h_edges, h, side="left") - 1, 0, n_bins - 1)
        idx = torch.where(valid, idx, n_bins).reshape(-1)  # slot n_bins: dropped
        sums += torch.bincount(idx, weights=cloud.reshape(-1).double(), minlength=n_bins + 1)
        counts += torch.bincount(idx, minlength=n_bins + 1)
    return sums[:n_bins], counts[:n_bins]


def variogram_minmax_pairs_plain(sides, geodesic, h_max, h_snap):
    """Plain torch pass 1 over several variograms: ``variogram_minmax_plain``
    of each ``(fa, fb, marginal)`` of ``sides``, stacked to (P, 2)."""
    return torch.stack([variogram_minmax_plain(fa, fb, marg, geodesic, h_max, h_snap)
                        for fa, fb, marg in sides])


def variogram_bin_pairs_plain(sides, h_edges, geodesic, covariogram, h_max):
    """Plain torch pass 2 over several variograms: ``variogram_bin_plain`` of
    each ``(fa, fb, va, vb, marginal)`` of ``sides`` with its edges of
    ``h_edges``, stacked to sums (P, n_bins) and counts (P, n_bins)."""
    out = [variogram_bin_plain(fa, fb, va, vb, torch.as_tensor(e, device=fa.device), marg,
                               geodesic, covariogram, h_max)
           for (fa, fb, va, vb, marg), e in zip(sides, h_edges, strict=True)]
    return torch.stack([s for s, _ in out]), torch.stack([c for _, c in out])


def _record_offsets(np_dtype):
    """(edges, slot, below, bytes): the byte layout of ``csrc/vario.cuh``'s
    ``Record<T>``."""
    slot = 16 + _EDGE_CAP * np_dtype.itemsize
    below = slot + _SLOT_CAP
    return 16, slot, below, (below + _MAX_CELLS + 15) // 16 * 16


def _key_bits(x, np_dtype):
    """``csrc/vario.cuh::key_bits``: the top 32 bits of each value."""
    x = np.ascontiguousarray(x, np_dtype)
    if np_dtype == np.float32:
        return x.view(np.uint32).astype(np.int64)
    return (x.view(np.uint64) >> np.uint64(32)).astype(np.int64)


def _bin_record(edges, first, last, np_dtype):
    """The lookup record (``csrc/vario.cuh::Record``) of one window's
    n_win + 1 non-negative h-edges: (uint8 array, k_cmp, n_cells). With it the kernel
    counts #(edges < h), which for sorted edges is
    ``searchsorted(edges, h, side="left")``.

    A cell is the top bits of h shifted right by ``shift``, less ``cell_lo``
    (one below the least positive edge's, so zero edges have a cell of their
    own), clipped to [0, n_cells); ``below[c]`` counts the edges in earlier
    cells; ``k_cmp`` is the most edges one cell holds. The shift is the
    coarsest that puts at most one edge in a cell, or, where no shift within
    ``_MAX_CELLS`` cells does (edges closer than the cells can part), the one
    with the fewest edges per cell. ``slot[c]`` for c = #(edges < h) is the
    bin in the window, n_win where the pair belongs to another window;
    ``first`` / ``last``: the window holds the first / last bin of all, which
    take the pairs clipped from below / above."""
    edges = np.asarray(edges)
    n_win = edges.shape[0] - 1
    if edges.dtype != np_dtype or edges.ndim != 1 or not 1 <= n_win <= VARIO_MAX_BINS:
        raise ValueError(f"variogram_bin: a window needs 2 .. {VARIO_MAX_BINS + 1} edges "
                         f"of the points' dtype {np_dtype}")
    if not np.all(edges >= 0):  # NaN fails too
        raise ValueError("variogram_bin: edges must be non-negative")
    # #(edges < h) does not depend on their order; the linspace of equal
    # ends can put an edge an ulp out of order
    edges = np.sort(edges)
    keys = _key_bits(edges, np_dtype)
    # every shift at once, coarsest first: cells (32, n_win + 1), sorted rows
    shifts = np.arange(31, -1, -1)[:, None]
    positive = keys[edges > 0]
    lo = (positive[0] >> shifts[:, 0]) - 1 if positive.size else np.zeros(32, np.int64)
    n_cells = (keys[-1] >> shifts[:, 0]) - lo + 1
    cells = np.clip((keys >> shifts) - lo[:, None], 0, (n_cells - 1)[:, None])
    # most edges in one cell: the longest run of equal cells in each row
    at = np.arange(cells.shape[1])
    starts = np.where(np.diff(cells, axis=1, prepend=-1) != 0, at, 0)
    k_all = (at - np.maximum.accumulate(starts, axis=1) + 1).max(axis=1)
    fits = n_cells <= _MAX_CELLS  # a prefix: cells only grow as the shift falls
    best = int(np.flatnonzero(fits & (k_all == k_all[fits].min()))[0])
    shift, lo, n_cells, k_cmp = (int(v[best]) for v in (shifts[:, 0], lo, n_cells, k_all))
    cells = cells[best]
    o_edges, o_slot, o_below, size = _record_offsets(np_dtype)
    rec = np.zeros(size, np.uint8)
    rec[:16] = np.array([shift, lo, n_cells, k_cmp], np.int32).view(np.uint8)
    padded = np.full(_EDGE_CAP, np.inf, np_dtype)
    padded[:n_win + 1] = edges
    rec[o_edges:o_slot] = padded.view(np.uint8)
    slot = np.concatenate([[0 if first else n_win], np.arange(n_win),
                           [n_win - 1 if last else n_win]])
    rec[o_slot:o_slot + n_win + 2] = slot
    rec[o_below:o_below + n_cells] = np.searchsorted(cells, np.arange(n_cells), side="left")
    return rec, k_cmp, n_cells


def _vario_launch_args(name, sides, n_ptrs):
    """The C arrays of one launch over ``sides``: ``n_ptrs`` device pointers
    per variogram, {n, m, marginal, first tile} per variogram (the tile grid
    of ``csrc/variogram.cu``, counted here), and the total of tiles."""
    ptrs, dims, tiles = [], [], 0
    for side in sides:
        n, m, marginal = side[0].shape[0], side[1].shape[0], bool(side[-1])
        ptrs += [t.data_ptr() for t in side[:n_ptrs]]
        dims += [n, m, int(marginal), tiles]
        nr, nc = -(-n // VARIO_TILE), -(-m // VARIO_TILE)
        tiles += nr * (nr + 1) // 2 if marginal else nr * nc
    if tiles >= 2 ** 31:
        raise ValueError(f"{name}: {tiles} tiles exceed one launch")
    return (_P * len(ptrs))(*ptrs), (_LL * len(dims))(*dims), tiles


def _check_sides(name, sides, geodesic, with_values):
    if not sides:
        raise ValueError(f"{name}: needs at least one variogram")
    tensors = []
    for side in sides:
        fa, fb = side[0], side[1]
        _check_features(fa, fb, geodesic, side[-1])
        if with_values and (side[2].shape != (fa.shape[0],) or side[3].shape != (fb.shape[0],)):
            raise ValueError(f"{name}: values must be (n,) and (m,)")
        tensors += side[:4 if with_values else 2]
    _check_cuda(name, *tensors)
    return tensors[0].dtype, tensors[0].device


def variogram_minmax_pairs(sides, geodesic, h_max, h_snap):
    """Pass 1 of the pair stream over every variogram of a call:
    ``sides[k] = (fa, fb, marginal)`` with point features ``fa`` (n, F) and
    ``fb`` (m, F). Returns the (P, 2) tensor of [hmin, hmax] per variogram
    (see ``variogram_minmax_plain``). CUDA tensors run ``csrc/variogram.cu``:
    one launch over all the variograms' pairs (per ``VARIO_MAX_PAIRS``) and
    one reduce, which writes every row; CPU tensors the plain version."""
    if sides and sides[0][0].device.type == "cpu":
        return variogram_minmax_pairs_plain(sides, geodesic, h_max, h_snap)
    dtype, device = _check_sides("variogram_minmax", sides, geodesic, False)
    T = _CT[dtype]
    f = _fn("variogram.cu", f"vario_minmax_{_SUFFIX[dtype]}",
            [_I, _P, _P, _I, T, T, _P, _P, _P, _P])
    out = torch.empty((len(sides), 2), dtype=dtype, device=device)
    for g0 in range(0, len(sides), VARIO_MAX_PAIRS):
        group = sides[g0:g0 + VARIO_MAX_PAIRS]
        ptrs, dims, tiles = _vario_launch_args("variogram_minmax", group, 2)
        part = torch.empty((2, max(tiles, 1)), dtype=dtype, device=device)
        with torch.cuda.device(device):
            rc = f(len(group), ptrs, dims, int(geodesic), T(float(h_max)), T(float(h_snap)),
                   _ptr(part[0]), _ptr(part[1]), _ptr(out[g0]), _stream(device))
        _check_rc("variogram.cu", rc, "variogram_minmax")
        if tiles:
            LAUNCHES["variogram_minmax"] += 1
    return out


def variogram_bin_pairs(sides, h_edges, geodesic, covariogram, h_max):
    """Pass 2 of the pair stream over every variogram of a call:
    ``sides[k] = (fa, fb, va, vb, marginal)`` with values ``va`` (n,) and
    ``vb`` (m,), binned at ``h_edges[k]``, its n_bins + 1 sorted,
    non-negative h-edges (numpy, or a tensor, which is read to the host) in
    the points' dtype. Returns sums (P, n_bins) float64 and counts (P, n_bins)
    int64 (see ``variogram_bin_plain``). CUDA tensors run
    ``csrc/variogram.cu``: per window of ``VARIO_MAX_BINS`` bins one launch
    over all the variograms' pairs (per ``VARIO_MAX_PAIRS``) and one reduce,
    which writes every bin; CPU tensors the plain version."""
    if sides and sides[0][0].device.type == "cpu":
        return variogram_bin_pairs_plain(sides, h_edges, geodesic, covariogram, h_max)
    dtype, device = _check_sides("variogram_bin", sides, geodesic, True)
    np_dtype = np.dtype(str(dtype).removeprefix("torch."))
    edges = [e.cpu().numpy() if torch.is_tensor(e) else np.asarray(e) for e in h_edges]
    n_bins = edges[0].shape[0] - 1 if edges else 0
    if len(edges) != len(sides) or n_bins < 1 or any(e.shape != (n_bins + 1,) for e in edges):
        raise ValueError("variogram_bin: one 1-D array of n_bins + 1 >= 2 edges per variogram")
    T = _CT[dtype]
    f = _fn("variogram.cu", f"vario_bin_{_SUFFIX[dtype]}",
            [_I, _P, _P, _P, _I, _I, _I, _I, _I, T, _P, _P, _P, _P, _I, _I, _P])
    sums = torch.empty((len(sides), n_bins), dtype=torch.float64, device=device)
    counts = torch.empty((len(sides), n_bins), dtype=torch.int64, device=device)
    window = min(n_bins, VARIO_MAX_BINS)
    for g0 in range(0, len(sides), VARIO_MAX_PAIRS):
        group = sides[g0:g0 + VARIO_MAX_PAIRS]
        ptrs, dims, tiles = _vario_launch_args("variogram_bin", group, 4)
        part_sums = torch.empty(max(tiles, 1) * window, dtype=torch.float64, device=device)
        part_counts = torch.empty(max(tiles, 1) * window, dtype=torch.int64, device=device)
        # the kernel's shared-memory histogram holds one window of bins: one
        # launch per window (the edges are sorted, so each knows its pairs)
        for bin0 in range(0, n_bins, window):
            n_win = min(window, n_bins - bin0)
            recs = [_bin_record(e[bin0:bin0 + n_win + 1], bin0 == 0, bin0 + n_win == n_bins,
                                np_dtype) for e in edges[g0:g0 + VARIO_MAX_PAIRS]]
            records = torch.from_numpy(np.concatenate([r[0] for r in recs])).pin_memory().to(
                device, non_blocking=True)
            with torch.cuda.device(device):
                rc = f(len(group), ptrs, dims, _ptr(records), max(r[2] for r in recs), n_win,
                       max(r[1] for r in recs), int(geodesic), int(covariogram),
                       T(float(h_max)), _ptr(part_sums), _ptr(part_counts), _ptr(sums[g0]),
                       _ptr(counts[g0]), n_bins, bin0, _stream(device))
            _check_rc("variogram.cu", rc, "variogram_bin")
            if tiles:
                LAUNCHES["variogram_bin"] += 1
    return sums, counts


def variogram_bin_batch_plain(sides, h_edges, geodesic, covariogram, h_max):
    """Plain torch pass 2 over a batch of value replicates: ``sides[k] =
    (fa, fb, va, vb, marginal)`` with ``va`` (B, n) and ``vb`` (B, m).
    Returns sums (P, B, n_bins) float64 and counts (P, n_bins) int64; each
    block of pairs finds its bins once for all replicates, bin = #(h_edges <
    h) - 1 clipped."""
    sums, counts = [], []
    for (fa, fb, va, vb, marginal), e in zip(sides, h_edges, strict=True):
        _check_features(fa, fb, geodesic, marginal)
        e = torch.as_tensor(e, device=fa.device)
        n_bins, B = e.shape[0] - 1, va.shape[0]
        s = torch.zeros((B, n_bins + 1), dtype=torch.float64, device=fa.device)
        c = torch.zeros(n_bins + 1, dtype=torch.int64, device=fa.device)
        for r0, r1, c0, tri in _plain_blocks(fa, fb, marginal, B):
            h = h_block(fa[r0:r1], fb[c0:], geodesic)
            valid = h <= h_max
            if tri is not None:
                valid = valid & tri
            idx = torch.clamp(torch.searchsorted(e, h, side="left") - 1, 0, n_bins - 1)
            idx = torch.where(valid, idx, n_bins).reshape(-1)  # slot n_bins: dropped
            a, b = va[:, r0:r1, None], vb[:, None, c0:]
            if covariogram:
                cloud = a * b
            else:
                diff = a - b
                cloud = 0.5 * diff * diff
            s.index_add_(1, idx, cloud.reshape(B, -1).double())
            c += torch.bincount(idx, minlength=n_bins + 1)
        sums.append(s[:, :n_bins])
        counts.append(c[:n_bins])
    return torch.stack(sums), torch.stack(counts)


def variogram_bin_batch(sides, h_edges, geodesic, covariogram, h_max):
    """Pass 2 of the pair stream for a batch of B value replicates over one
    set of pairs: ``sides[k] = (fa, fb, va, vb, marginal)`` as
    ``variogram_bin_pairs`` takes them but with values ``va`` (B, n) and
    ``vb`` (B, m), each replicate centered by the caller. Returns sums (P, B,
    n_bins) float64 and counts (P, n_bins) int64. CUDA tensors run
    ``csrc/variogram.cu``'s batched form: per window of ``VARIO_MAX_BINS``
    bins one launch over all the variograms' pairs and replicates (per
    ``VARIO_MAX_PAIRS`` variograms), in rounds of strips: a slot pass that
    bins each pair once for all replicates and sorts each chunk's binned
    pairs by slot, a walk of those lists per replicate, and the reduces;
    CPU tensors the plain version."""
    if sides and sides[0][0].device.type == "cpu":
        return variogram_bin_batch_plain(sides, h_edges, geodesic, covariogram, h_max)
    if not sides:
        raise ValueError("variogram_bin_batch: needs at least one variogram")
    B = sides[0][2].shape[0]
    flat = []
    for fa, fb, va, vb, marginal in sides:
        _check_features(fa, fb, geodesic, marginal)
        if va.shape != (B, fa.shape[0]) or vb.shape != (B, fb.shape[0]) or B < 1:
            raise ValueError("variogram_bin_batch: values must be (B, n) and (B, m), one B")
        # (n, B): a warp's replicates read contiguous values
        flat.append((fa, fb, va.T.contiguous(), vb.T.contiguous(), marginal))
    _check_cuda("variogram_bin_batch", *[t for side in flat for t in side[:4]])
    dtype, device = sides[0][0].dtype, sides[0][0].device
    np_dtype = np.dtype(str(dtype).removeprefix("torch."))
    edges = [e.cpu().numpy() if torch.is_tensor(e) else np.asarray(e) for e in h_edges]
    n_bins = edges[0].shape[0] - 1 if edges else 0
    if len(edges) != len(sides) or n_bins < 1 or any(e.shape != (n_bins + 1,) for e in edges):
        raise ValueError("variogram_bin_batch: one 1-D array of n_bins + 1 >= 2 edges per "
                         "variogram")
    T = _CT[dtype]
    f = _fn("variogram.cu", f"vario_bin_batch_{_SUFFIX[dtype]}",
            [_I, _P, _P, _P, _I, _I, _I, _I, _I, T, _I, _LL, _LL, _P, _P, _P, _P, _P, _I, _I, _P])
    scratch_of = _build.load("variogram.cu").vario_batch_scratch
    scratch_of.argtypes, scratch_of.restype = [_I, _P, _P], None
    sums = torch.empty((len(sides), B, n_bins), dtype=torch.float64, device=device)
    counts = torch.empty((len(sides), n_bins), dtype=torch.int64, device=device)
    window = min(n_bins, VARIO_MAX_BINS)
    for g0 in range(0, len(sides), VARIO_MAX_PAIRS):
        group = flat[g0:g0 + VARIO_MAX_PAIRS]
        ptrs, dims, strips = _vario_strip_args(group)
        # the scratch of one round of strips (csrc/vario.cuh batch_round),
        # reused by the next: at most 8,192 chunks of sorted entries (64 MB
        # and 0.5 MB of offsets) and 2,048 partials per replicate and bin,
        # whatever the number of points
        cap = (_LL * 2)()
        scratch_of(len(group), dims, cap)
        entries = torch.empty(cap[0] * _BATCH_PAIRS, dtype=torch.int16, device=device)
        seg = torch.empty(cap[0] * _BATCH_SEG, dtype=torch.int16, device=device)
        part_sums = torch.empty(cap[1] * B * window, dtype=torch.float64, device=device)
        for bin0 in range(0, n_bins, window):
            n_win = min(window, n_bins - bin0)
            recs = [_bin_record(e[bin0:bin0 + n_win + 1], bin0 == 0, bin0 + n_win == n_bins,
                                np_dtype) for e in edges[g0:g0 + VARIO_MAX_PAIRS]]
            records = torch.from_numpy(np.concatenate([r[0] for r in recs])).pin_memory().to(
                device, non_blocking=True)
            with torch.cuda.device(device):
                rc = f(len(group), ptrs, dims, _ptr(records), max(r[2] for r in recs), n_win,
                       max(r[1] for r in recs), int(geodesic), int(covariogram),
                       T(float(h_max)), B, cap[0], cap[1], _ptr(entries), _ptr(seg),
                       _ptr(part_sums), _ptr(sums[g0]), _ptr(counts[g0]), n_bins, bin0,
                       _stream(device))
            _check_rc("variogram.cu", rc, "variogram_bin_batch")
            if strips:
                LAUNCHES["variogram_bin_batch"] += 1
    return sums, counts


def _vario_strip_args(sides):
    """The C arrays of one batched launch over ``sides``: 4 device pointers
    per variogram and {n, m, marginal, first strip} per variogram (strips of
    ``VARIO_STRIP`` rows, counted here), and the total of strips."""
    ptrs, dims, strips = [], [], 0
    for fa, fb, va, vb, marginal in sides:
        ptrs += [t.data_ptr() for t in (fa, fb, va, vb)]
        dims += [fa.shape[0], fb.shape[0], int(bool(marginal)), strips]
        strips += -(-fa.shape[0] // VARIO_STRIP)
    if strips >= 2 ** 31:
        raise ValueError(f"variogram_bin_batch: {strips} strips exceed one launch")
    return (_P * len(ptrs))(*ptrs), (_LL * len(dims))(*dims), strips


def variogram_minmax(fa, fb, marginal, geodesic, h_max, h_snap):
    """Pass 1 of one variogram: ``variogram_minmax_pairs`` of the one side
    ``(fa, fb, marginal)``, the tensor [hmin, hmax]."""
    return variogram_minmax_pairs([(fa, fb, marginal)], geodesic, h_max, h_snap)[0]


def variogram_bin(fa, fb, va, vb, h_edges, marginal, geodesic, covariogram, h_max):
    """Pass 2 of one variogram: ``variogram_bin_pairs`` of the one side
    ``(fa, fb, va, vb, marginal)`` at ``h_edges``, (sums, counts) per bin."""
    sums, counts = variogram_bin_pairs([(fa, fb, va, vb, marginal)], [h_edges], geodesic,
                                       covariogram, h_max)
    return sums[0], counts[0]


# ---------------------------------------------------------------------------
# Recurrence tables
# ---------------------------------------------------------------------------


def _table_width(dtype):
    """Values in one row of the kernels' value table of ``dtype`` (kv.cuh's
    ``TabLayout``, asked of the built library; a dual row holds twice as
    many)."""
    return _fn("matern.cu", "matern_table_width", [_I])(int(dtype == torch.float64))


def _check_table(name, table, shape, h):
    if (tuple(table.shape) != shape or table.dtype != h.dtype or table.device != h.device
            or not table.is_contiguous()):
        raise ValueError(f"{name}: table must be {shape} contiguous {h.dtype} on {h.device}")


def _fact_second(p, small):
    """d^2/dp^2 of pi mu / sin(pi mu) at p = pi mu (1/3 where |p| < 1e-4,
    the series branch): the operations of the double reverse pass of
    ``torch.autograd.grad`` through ``where(small, 1 + p^2 / 6, p /
    sin(where(small, 1, p)))``, in its engine's order, so it equals that
    pass bit for bit without building it."""
    s = torch.sin(torch.where(small, 1.0, p))
    c = torch.cos(torch.where(small, 1.0, p))
    g_q = torch.where(small, 0.0, torch.ones_like(p))
    q = p / s
    q_s = q / s
    g_q_s = c * (-g_q)
    g_quot = g_q_s / s
    # sin's gradient: from the cosine's backward, then the three quotients'
    g_s = (((-g_q_s) * ((q / s) / s) + (-torch.ones_like(p)) * ((g_q / s) / s))
           + (-g_quot) * ((p / s) / s))
    g_w = (-((-g_q) * q_s)) * s + g_s * c
    sixth = torch.where(small, torch.full_like(p, 1.0 / 6.0), 0.0)
    return ((sixth + sixth) + g_quot / s) + torch.where(small, 0.0, g_w)


def recurrence_table(nu_pairs, ls_pairs, dtype, order=0):
    """Per-(nu, ls) table of ``csrc/kv.cuh``'s table-driven recurrences, one
    row per pair, in ``dtype`` on the device of ``nu_pairs``, with no host
    read. Columns (kv.cuh ``TabLayout``): nu, ls, sqrt(2 nu), mu, nl, gam1,
    gam2, 0.5 Gamma(1+mu), 0.5 Gamma(1-mu), lgamma(nu), digamma(nu),
    pi mu / sin(pi mu), a1 = 0.25 - mu^2; per series trip i = 1 .. S
    1/(i^2 - mu^2), 1/(i - mu), 1/(i + mu); per CF2 trip i = 2 .. C + 1
    a_n = -a1 - i (i - 1), 1/a_n, -a_n / i. mu, nl, the gamma constants and
    a1 come from the same torch functions, in ``dtype``, as the plain path;
    the trip columns are formed in float64 from that mu and a1.

    ``order=0`` (the forward kernels) keeps nu's sign as the plain path
    does; ``order=1`` (the gradient kernels) takes |nu| and stores each
    column with its d/dmu beside it (mu's own is 1; the gamma tangents from
    ``gam12_tangent``), so a row holds twice the values.

    ``order=2`` (the Hessian kernel, ``csrc/matern_hess.cu``) takes |nu|
    and stores each column as (value, d/dmu, d^2/dmu^2), three values per
    column (kv.cuh ``Dual2Row``): the mu-only columns' first tangents as the
    dual table's, their second tangents in closed form: for the gamma
    constants, pi mu / sin(pi mu) (float64) and digamma's derivative
    (``tetragamma``, float64) the operations reverse-mode AD of their first
    tangents performs, in its order (``bessel.gam12_second``,
    ``_fact_second``), so the rows equal that AD's bit for bit with no graph
    built; a1's and the trip columns' directly. The nu-only columns carry
    their true derivatives in nu = mu + nl (sqrt(2 nu)'s, lgamma's = digamma
    and trigamma, digamma's), nl and ls none. Rows are elementwise in the
    pairs, so one call for every pair gives each pair's own row; each call
    adds one to ``LAUNCHES["recurrence_table_order2"]`` (a build is several
    hundred small torch operations, launches of their own on the card)."""
    nu = torch.as_tensor(nu_pairs, dtype=dtype).detach().reshape(-1)
    ls = torch.as_tensor(ls_pairs, dtype=dtype, device=nu.device).detach().reshape(-1)
    nu_abs = torch.abs(nu)
    nl = torch.floor(nu_abs + 0.5)
    mu = nu_abs - nl
    gam1, gam2, inv_gp, inv_gm = _gam12(mu)
    nu_c = nu_abs if order else nu
    a1 = 0.25 - mu * mu
    m = mu.double()
    pimu = math.pi * m
    small = pimu.abs() < 1e-4
    sin_p = torch.sin(torch.where(small, 1.0, pimu))
    fact = torch.where(small, 1.0 + pimu * pimu / 6.0, pimu / sin_p)
    i_s = torch.arange(1, SERIES_ITERS[dtype] + 1, dtype=torch.float64, device=nu.device)
    i_c = torch.arange(2, CF2_ITERS[dtype] + 2, dtype=torch.float64, device=nu.device)
    r2 = 1.0 / (i_s * i_s - (m * m)[:, None])
    rm = 1.0 / (i_s - m[:, None])
    rp = 1.0 / (i_s + m[:, None])
    a_n = -a1.double()[:, None] - i_c * (i_c - 1.0)
    head = [nu_c, ls, torch.sqrt(2.0 * nu_c), mu, nl, gam1, gam2, 0.5 / inv_gp, 0.5 / inv_gm,
            torch.lgamma(nu_c), torch.digamma(nu_c), fact.to(dtype), a1]
    series = torch.stack([r2, rm, rp], dim=2).flatten(1)
    cf2 = torch.stack([a_n, 1.0 / a_n, -a_n / i_c], dim=2).flatten(1)
    val = torch.cat([torch.stack(head, dim=1), series.to(dtype), cf2.to(dtype)], dim=1)
    if order == 0:
        return val
    zero = torch.zeros_like(mu)
    d_gam1, d_gam2, d_gp, d_gm = gam12_tangent(mu)
    d_fact = torch.where(small, pimu * math.pi / 3.0,
                         math.pi * (sin_p - pimu * torch.cos(pimu)) / (sin_p * sin_p))
    d_head = [zero, zero, zero, torch.ones_like(mu), zero, d_gam1, d_gam2,
              -0.5 * d_gp / (inv_gp * inv_gp), -0.5 * d_gm / (inv_gm * inv_gm), zero, zero,
              d_fact.to(dtype), -2.0 * mu]
    two_mu = 2.0 * m[:, None]
    d_series = torch.stack([two_mu * r2 * r2, rm * rm, -rp * rp], dim=2).flatten(1)
    d_cf2 = torch.stack([two_mu.expand_as(a_n), -two_mu / (a_n * a_n),
                         -two_mu / i_c], dim=2).flatten(1)
    tan = torch.cat([torch.stack(d_head, dim=1), d_series.to(dtype), d_cf2.to(dtype)], dim=1)
    if order == 1:
        return torch.stack([val, tan], dim=2).flatten(1)
    LAUNCHES["recurrence_table_order2"] += 1
    sq = torch.sqrt(2.0 * nu_c)
    # one trigamma pass for nu and, in float64, the gamma constants' 1 +- mu
    tri = trigamma(torch.stack([nu_c, 1.0 + mu, 1.0 - mu]) if dtype == torch.float64 else nu_c)
    psi1 = tri[0] if dtype == torch.float64 else tri
    dd_gam1, dd_gam2, dd_gp, dd_gm = gam12_second(
        mu, (gam1, gam2, inv_gp, inv_gm), (d_gam1, d_gam2, d_gp, d_gm),
        (tri[1], tri[2]) if dtype == torch.float64 else None)
    tan[:, 0] = 1.0
    tan[:, 2] = 1.0 / sq
    tan[:, 9] = torch.digamma(nu_c)
    tan[:, 10] = psi1
    dd_head = [zero, zero, -1.0 / (sq * sq * sq), zero, zero, dd_gam1, dd_gam2,
               -0.5 * dd_gp / (inv_gp * inv_gp) + d_gp * d_gp / (inv_gp * inv_gp * inv_gp),
               -0.5 * dd_gm / (inv_gm * inv_gm) + d_gm * d_gm / (inv_gm * inv_gm * inv_gm),
               psi1, tetragamma(nu_c.double()).to(dtype),
               (math.pi ** 2 * _fact_second(pimu, small)).to(dtype), torch.full_like(mu, -2.0)]
    dd_series = torch.stack([2.0 * r2 * r2 + 2.0 * two_mu * two_mu * r2 * r2 * r2,
                             2.0 * rm * rm * rm, 2.0 * rp * rp * rp], dim=2).flatten(1)
    dd_cf2 = torch.stack([torch.full_like(a_n, 2.0), -2.0 / (a_n * a_n)
                          + 2.0 * two_mu * two_mu / (a_n * a_n * a_n),
                          (-2.0 / i_c).expand_as(a_n)], dim=2).flatten(1)
    tan2 = torch.cat([torch.stack(dd_head, dim=1), dd_series.to(dtype), dd_cf2.to(dtype)], dim=1)
    return torch.stack([val, tan, tan2], dim=2).flatten(1)


# ---------------------------------------------------------------------------
# Matern correlation
# ---------------------------------------------------------------------------


def matern_correlation_block_plain(nu, len_scale, h, symmetric=False):
    """Plain torch Matern correlation of a distance block: the elementwise
    ``cov.matern.matern_correlation`` applied to every entry (``symmetric``
    changes nothing in the result)."""
    from cokriging_tpu_torch.cov.matern import matern_correlation

    return matern_correlation(nu, len_scale, h)


def matern_correlation_block(nu, len_scale, h, symmetric=False, table=None, early_exit=True):
    """Matern correlation M(nu, len_scale, h) of a 2-D distance block.

    ``symmetric=True`` (square symmetric h) evaluates the lower triangle and
    mirrors it. CUDA tensors run ``csrc/matern.cu`` (forward only; ``h``
    contiguous); CPU tensors the plain version. ``table``: the kernel's
    value row ``recurrence_table(nu, len_scale, h.dtype)[0]`` on h's
    device, built once by a caller that launches many times with one
    parameter set; by default it is built here, on the card. Neither way
    reads the card from the host. ``early_exit=False`` runs the CF2 trips of
    half-integer orders that the kernel skips (they change no bit), for
    checks."""
    if h.device.type == "cpu":
        return matern_correlation_block_plain(nu, len_scale, h, symmetric)
    _check_cuda("matern_correlation_block", h)
    if h.ndim != 2 or (symmetric and h.shape[0] != h.shape[1]):
        raise ValueError("matern_correlation_block: h must be 2-D (square if symmetric)")
    n, m = h.shape
    out = torch.empty_like(h)
    if n == 0 or m == 0:
        return out
    if table is None:
        table = recurrence_table(torch.as_tensor(nu, dtype=h.dtype, device=h.device),
                                 torch.as_tensor(len_scale, dtype=h.dtype, device=h.device),
                                 h.dtype)[0]
    _check_table("matern_correlation_block", table, (_table_width(h.dtype),), h)
    f = _fn("matern.cu", f"matern_{_SUFFIX[h.dtype]}", [_P, _I, _I, _I, _P, _I, _P, _P])
    with torch.cuda.device(h.device):
        rc = f(_ptr(h), n, m, int(symmetric), _ptr(table), int(early_exit), _ptr(out),
               _stream(h.device))
    _check_rc("matern.cu", rc, "matern_correlation_block")
    LAUNCHES["matern_correlation"] += 1
    return out


# ---------------------------------------------------------------------------
# Matern block gradient
# ---------------------------------------------------------------------------


def matern_block_grad_plain(scale, nugget, nu, ls, h, ct, symmetric=False,
                            absolute=False):
    """Plain torch backward of the block C = scale * M(nu, ls, h) + nugget *
    [h == 0] against the cotangent ``ct``: the float64 tensor [sum ct M,
    sum ct [h == 0], scale sum ct dM/dnu, scale sum ct dM/dls].

    The value triple and the exact dK/dnu come from ``_kv_value(...,
    with_grads=True)``, in row chunks that bound the temporaries, each
    chunk's terms summed in float64. ``symmetric=True`` (square symmetric h)
    reads the lower triangle only, with ct[i, j] + ct[j, i] below the
    diagonal and ct[i, i] on it. ``nugget`` does not enter its own
    cotangent. ``absolute=True`` sums |ct * term| instead: the scale of the
    sums' rounding error, which comparisons of two evaluations are stated
    against."""
    if h.ndim != 2 or h.shape != ct.shape or (symmetric and h.shape[0] != h.shape[1]):
        raise ValueError("matern_block_grad: h and ct must be one 2-D shape (square if symmetric)")
    dt, dev = h.dtype, h.device
    scale = torch.as_tensor(scale, dtype=torch.float64, device=dev).detach()
    nu = torch.abs(torch.as_tensor(nu, dtype=dt, device=dev).detach())
    ls = torch.as_tensor(ls, dtype=dt, device=dev).detach()
    lgam, digam = torch.lgamma(nu), torch.digamma(nu)
    n, m = h.shape
    out = torch.zeros(4, dtype=torch.float64, device=dev)
    rows = max(1, _PLAIN_GRAD_ELEMS // max(m, 1))
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        c1 = r1 if symmetric else m
        hc = torch.abs(h[r0:r1, :c1])
        w = ct[r0:r1, :c1]
        if symmetric:
            ri = torch.arange(r0, r1, device=dev)[:, None]
            ci = torch.arange(c1, device=dev)[None, :]
            w = torch.where(ci < ri, w + ct[:c1, r0:r1].T, torch.where(ci == ri, w, 0.0))
        pos = hc > 0.0
        a = torch.sqrt(2.0 * nu) * (torch.where(pos, hc, 1.0) / ls)
        k_mid, dk_dnu, dk_dx = _kv_value(nu, a, True)
        log_a = torch.log(a)
        elp = torch.exp((1.0 - nu) * _LN2 - lgam + nu * log_a)
        mat = elp * k_mid
        ok = torch.isfinite(mat) & (mat > 0.0) & pos
        m_val = torch.where(pos, torch.where(ok, mat, 0.0), 1.0)
        dm_dnu = mat * (-_LN2 - digam + log_a + 0.5) + elp * (dk_dnu + dk_dx * (a / (2.0 * nu)))
        dm_dls = mat * (-nu / ls) + elp * dk_dx * (-a / ls)
        terms = (
            m_val,
            (hc == 0.0).to(dt),
            torch.where(ok & torch.isfinite(dm_dnu), dm_dnu, 0.0),
            torch.where(ok & torch.isfinite(dm_dls), dm_dls, 0.0),
        )
        for k, term in enumerate(terms):
            prod = w * term
            out[k] += (prod.abs() if absolute else prod).sum(dtype=torch.float64)
    out[2:] *= scale.abs() if absolute else scale
    return out


def matern_block_grad(scale, nugget, nu, ls, h, ct, symmetric=False, table=None):
    """The four scalar cotangents of one covariance block C = scale *
    M(nu, ls, h) + nugget * [h == 0] against ``ct``: float64 tensor
    [g_scale, g_nugget, g_nu, g_ls] (see ``matern_block_grad_plain``).

    ``symmetric=True`` (square symmetric h, any ct) evaluates the lower
    triangle only. ``h`` and ``ct`` may be row-strided views (unit column
    stride). CUDA tensors run ``csrc/matern_grad.cu``, with ``scale`` as a
    device value; CPU tensors the plain version. ``table``: the kernel's
    dual row ``recurrence_table(nu, ls, h.dtype, order=1)[0]`` on h's
    device, built once by a caller that launches many times with one
    parameter set; by default it is built here, on the card. Neither way
    reads the card from the host."""
    if h.device.type == "cpu":
        return matern_block_grad_plain(scale, nugget, nu, ls, h, ct, symmetric)
    for t in (h, ct):
        if not t.is_cuda or t.device != h.device or t.dtype != h.dtype or t.dtype not in _FLOATS:
            raise ValueError("matern_block_grad: h and ct must share one CUDA device and "
                             "one float32/float64 dtype")
    if h.ndim != 2 or h.shape != ct.shape or (symmetric and h.shape[0] != h.shape[1]):
        raise ValueError("matern_block_grad: h and ct must be one 2-D shape (square if symmetric)")
    n, m = h.shape
    out = torch.zeros(4, dtype=torch.float64, device=h.device)
    if n == 0 or m == 0:
        return out
    if h.stride(1) != 1 or h.stride(0) < m:
        raise ValueError("matern_block_grad: h needs unit column stride")
    if ct.stride(1) != 1 or ct.stride(0) < m:
        ct = ct.contiguous()
    if table is None:
        table = recurrence_table(torch.as_tensor(nu, dtype=h.dtype, device=h.device),
                                 torch.as_tensor(ls, dtype=h.dtype, device=h.device), h.dtype,
                                 order=1)[0]
    _check_table("matern_block_grad", table, (2 * _table_width(h.dtype),), h)
    scale = torch.as_tensor(scale, dtype=torch.float64, device=h.device).detach().reshape(())
    tiles = _fn_ll("matern_grad.cu", "matern_grad_num_tiles", [_I, _I, _I])(n, m, int(symmetric))
    part = torch.empty(4 * tiles, dtype=torch.float64, device=h.device)
    f = _fn("matern_grad.cu", f"matern_grad_{_SUFFIX[h.dtype]}",
            [_P, _P, _I, _I, _LL, _LL, _I, _P, _P, _P, _P, _P])
    with torch.cuda.device(h.device):
        rc = f(_ptr(h), _ptr(ct), n, m, h.stride(0), ct.stride(0), int(symmetric),
               _ptr(table), _ptr(scale), _ptr(part), _ptr(out), _stream(h.device))
    _check_rc("matern_grad.cu", rc, "matern_block_grad")
    LAUNCHES["matern_block_grad"] += 1
    return out


# ---------------------------------------------------------------------------
# Matern block second order
# ---------------------------------------------------------------------------


def _plain_model_partials(nu, ls, hc, second):
    """Per entry of the chunk ``hc``: the elementwise model's M and, by
    autograd of ``cov.matern.matern_correlation`` in per-entry copies of nu
    and ls, dM/dnu and dM/dls, and with ``second`` d2M/dnu2, d2M/dnu dls and
    d2M/dls2 (a double backward through ``kernels.bessel.kv``); each
    derivative 0 where M is not > 0 or not finite, h is not > 0 (the
    kernels' masks) or the derivative is not finite."""
    from cokriging_tpu_torch.cov.matern import matern_correlation

    with torch.enable_grad():
        nu_e = nu.expand(hc.shape).clone().requires_grad_(True)
        ls_e = ls.expand(hc.shape).clone().requires_grad_(True)
        mat = matern_correlation(nu_e, ls_e, hc)
        d = list(torch.autograd.grad(mat.sum(), (nu_e, ls_e), create_graph=second))
        if second:
            d += list(torch.autograd.grad(d[0].sum(), (nu_e, ls_e), retain_graph=True))
            d += list(torch.autograd.grad(d[1].sum(), (ls_e,)))
    ok = (mat > 0.0) & (hc > 0.0)
    return mat.detach(), [torch.where(ok & torch.isfinite(t), t, 0.0).detach() for t in d]


# the codes of kv.cuh's tangent_partials in the M field where the partials
# are not the entry's own: h == 0, |h| not > 0 otherwise (NaN); 0 where M is
# not finite and > 0
_TANGENT_AT_ZERO = -1.0
_TANGENT_NOT_POS = -2.0


def _partials_buffer(h):
    """An uninitialized (3, n, m) view in h's dtype on h's device whose
    fields start 16 bytes apart from one another (field stride rounded up),
    so that the combine kernel reads each with 16-byte loads."""
    n, m = h.shape
    per = 16 // h.element_size()
    ld = -(-(n * m) // per) * per
    return torch.empty((3, ld), dtype=h.dtype, device=h.device)[:, :n * m].view(3, n, m)


def matern_block_partials_plain(nu, ls, h, symmetric=False):
    """Plain torch partials of the block tangent (see
    ``matern_block_partials``): a contiguous (3, n, m) tensor in h's dtype,
    M and the autograd partials dM/dnu, dM/dls of the elementwise model
    (``_plain_model_partials``, in row chunks), with the kernel's codes in
    the M field: -1 where h == 0, -2 where |h| is not > 0 otherwise, M
    itself (0 where it is not > 0) elsewhere; both partials 0 where M is not
    > 0 or |h| is not > 0, and where they are not finite (the kernel keeps
    those raw; the combine masks either way). ``symmetric`` changes nothing
    in the result."""
    if h.ndim != 2 or (symmetric and h.shape[0] != h.shape[1]):
        raise ValueError("matern_block_partials: h must be 2-D (square if symmetric)")
    dt, dev = h.dtype, h.device
    nu = torch.abs(torch.as_tensor(nu, dtype=dt, device=dev).detach())
    ls = torch.as_tensor(ls, dtype=dt, device=dev).detach()
    n, m = h.shape
    out = torch.empty((3, n, m), dtype=dt, device=dev)
    rows = max(1, _PLAIN_TANGENT_ELEMS[dev.type] // max(m, 1))
    for r0 in range(0, n, rows):
        hc = torch.abs(h[r0:r0 + rows])
        mat, (dnu, dls) = _plain_model_partials(nu, ls, hc, False)
        out[0, r0:r0 + rows] = torch.where(
            hc > 0.0, mat, torch.where(hc == 0.0, _TANGENT_AT_ZERO, _TANGENT_NOT_POS))
        out[1, r0:r0 + rows] = dnu
        out[2, r0:r0 + rows] = dls
    return out


def matern_block_tangent_plain(scale, w, partials):
    """Plain torch directional derivative of the block C = scale * M(nu, ls,
    h) + nugget * [h == 0] in (scale, nugget, nu, ls) along the weights
    ``w`` = (w_s, w_n, w_nu, w_ls): the (n, m) matrix

        w_s M + w_n [h == 0] + scale (w_nu dM/dnu + w_ls dM/dls)

    in the dtype of ``partials``, the cotangent the block's gradient
    ``matern_block_grad`` hands back to its own cotangent. ``partials``: the
    block's three fields (``matern_block_partials_plain(nu, ls, h)``: M and
    its autograd partials, with the kernel's codes); where M is not > 0 or
    not finite it counts as 0 with no terms, as in the kernels."""
    if partials.ndim != 3 or partials.shape[0] != 3:
        raise ValueError("matern_block_tangent: partials must be the block's (3, n, m) fields")
    dt, dev = partials.dtype, partials.device
    w = torch.as_tensor(w, dtype=torch.float64, device=dev).detach()
    s = torch.as_tensor(scale, dtype=torch.float64, device=dev).detach()
    _, n, m = partials.shape
    out = torch.empty((n, m), dtype=dt, device=dev)
    rows = max(1, _PLAIN_TANGENT_ELEMS[dev.type] // max(m, 1))
    for r0 in range(0, n, rows):
        code, dnu, dls = partials[:, r0:r0 + rows]
        ok = code > 0.0
        m_val = torch.where(code < 0.0, 1.0, code)
        dnu = torch.where(ok & torch.isfinite(dnu), dnu, 0.0)
        dls = torch.where(ok & torch.isfinite(dls), dls, 0.0)
        t = (w[0] * m_val + w[1] * (code == _TANGENT_AT_ZERO) + s * (w[2] * dnu + w[3] * dls))
        out[r0:r0 + rows] = t.to(dt)
    return out


def _symmetric_weights(ct, r0, r1, symmetric):
    """The chunk of rows r0:r1 of the cotangent as the block's sums read it:
    ``ct`` itself, or under ``symmetric`` the lower triangle with ct[i, j] +
    ct[j, i] below the diagonal and ct[i, i] on it (columns up to r1)."""
    if not symmetric:
        return ct[r0:r1]
    dev = ct.device
    w = ct[r0:r1, :r1]
    ri = torch.arange(r0, r1, device=dev)[:, None]
    ci = torch.arange(r1, device=dev)[None, :]
    return torch.where(ci < ri, w + ct[:r1, r0:r1].T, torch.where(ci == ri, w, 0.0))


def matern_block_hess_plain(nu, ls, h, ct, symmetric=False, magnitude=False):
    """Plain torch second-order sums of one Matern block against ``ct``:
    the float64 tensor [sum ct dM/dnu, sum ct dM/dls, sum ct d2M/dnu2,
    sum ct d2M/dnu dls, sum ct d2M/dls2] (unscaled), with which the block's
    gradient ``matern_block_grad`` is differentiated in (scale, nu, ls).
    The partials are autograd of the elementwise model (first and second,
    ``_plain_model_partials``), in row chunks, each chunk's terms summed in
    float64; ``symmetric=True`` reads the lower triangle only, as
    ``matern_block_grad_plain`` does. ``magnitude=True`` returns (sums,
    sums of |ct * term|): the second is the scale of the sums' rounding
    error, which comparisons of two evaluations are stated against."""
    if h.ndim != 2 or h.shape != ct.shape or (symmetric and h.shape[0] != h.shape[1]):
        raise ValueError("matern_block_hess: h and ct must be one 2-D shape (square if symmetric)")
    dt, dev = h.dtype, h.device
    nu = torch.abs(torch.as_tensor(nu, dtype=dt, device=dev).detach())
    ls = torch.as_tensor(ls, dtype=dt, device=dev).detach()
    n, m = h.shape
    out = torch.zeros(5, dtype=torch.float64, device=dev)
    mag = torch.zeros(5, dtype=torch.float64, device=dev)
    rows = max(1, _PLAIN_HESS_ELEMS[dev.type] // max(m, 1))
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        w = _symmetric_weights(ct, r0, r1, symmetric)
        hc = torch.abs(h[r0:r1, :w.shape[1]])
        _, terms = _plain_model_partials(nu, ls, hc, True)
        for k, term in enumerate(terms):
            prod = w * term
            out[k] += prod.sum(dtype=torch.float64)
            mag[k] += prod.abs().sum(dtype=torch.float64)
    return (out, mag) if magnitude else out


def _check_block(name, h, ct, symmetric):
    for t in (h, ct):
        if not t.is_cuda or t.device != h.device or t.dtype != h.dtype or t.dtype not in _FLOATS:
            raise ValueError(f"{name}: h and ct must share one CUDA device and one "
                             "float32/float64 dtype")
    if h.ndim != 2 or h.shape != ct.shape or (symmetric and h.shape[0] != h.shape[1]):
        raise ValueError(f"{name}: h and ct must be one 2-D shape (square if symmetric)")


def matern_block_partials(nu, ls, h, symmetric=False, table=None):
    """The block tangent's partials (kv.cuh ``tangent_partials``): a (3, n,
    m) tensor in h's dtype, the fields M, dM/dnu and dM/dls, each stored
    raw, with codes in the M field where the partials are not the entry's
    own (see ``matern_block_partials_plain``). They depend on (nu, ls, h)
    alone, so a Hessian builds them once per block and combines them per
    row (``matern_block_tangent``).

    ``symmetric=True`` (square symmetric h) evaluates the lower triangle
    and mirrors it, so every field is whole. CUDA tensors run
    ``csrc/matern_hess.cu``'s partials kernel (h contiguous; the fields of
    the result 16 bytes aligned, one row stride apart); CPU tensors the
    plain version. ``table``: the kernel's dual row ``recurrence_table(nu,
    ls, h.dtype, order=1)[0]`` on h's device, by default built here."""
    if h.device.type == "cpu":
        return matern_block_partials_plain(nu, ls, h, symmetric)
    _check_block("matern_block_partials", h, h, symmetric)
    if not h.is_contiguous():
        raise ValueError("matern_block_partials: h must be contiguous")
    n, m = h.shape
    out = _partials_buffer(h)
    if n == 0 or m == 0:
        return out
    if table is None:
        table = recurrence_table(torch.as_tensor(nu, dtype=h.dtype, device=h.device),
                                 torch.as_tensor(ls, dtype=h.dtype, device=h.device), h.dtype,
                                 order=1)[0]
    _check_table("matern_block_partials", table, (2 * _table_width(h.dtype),), h)
    f = _fn("matern_hess.cu", f"partials_{_SUFFIX[h.dtype]}", [_P, _I, _I, _I, _P, _LL, _P, _P])
    with torch.cuda.device(h.device):
        rc = f(_ptr(h), n, m, int(symmetric), _ptr(table), out.stride(0), _ptr(out),
               _stream(h.device))
    _check_rc("matern_hess.cu", rc, "matern_block_partials")
    LAUNCHES["matern_block_partials"] += 1
    return out


def matern_block_tangent(scale, w, partials):
    """The block's directional derivative along the weights ``w`` (see
    ``matern_block_tangent_plain``): an (n, m) matrix in the dtype of
    ``partials``, the block's ``matern_block_partials``, built once for all
    the weights of a Hessian.

    CUDA tensors run ``csrc/matern_hess.cu``'s combine kernel over them
    (``scale`` and ``w`` read as float64 device values, nothing read back);
    CPU tensors the plain version."""
    if partials.device.type == "cpu":
        return matern_block_tangent_plain(scale, w, partials)
    dt, dev = partials.dtype, partials.device
    if (partials.ndim != 3 or partials.shape[0] != 3 or dt not in _FLOATS
            or partials.stride(2) != 1 or partials.stride(1) != partials.shape[2]
            or partials.stride(0) < partials.shape[1] * partials.shape[2]):
        raise ValueError("matern_block_tangent: partials must be the block's (3, n, m) fields, "
                         "each row-major")
    _, n, m = partials.shape
    out = torch.empty((n, m), dtype=dt, device=dev)
    if n == 0 or m == 0:
        return out
    scale = torch.as_tensor(scale, dtype=torch.float64, device=dev).detach()
    w = torch.as_tensor(w, dtype=torch.float64, device=dev).detach().contiguous()
    if scale.numel() != 1 or w.numel() != 4:
        raise ValueError("matern_block_tangent: scale must be one value and w four")
    ld = partials.stride(0)
    vec = (partials.data_ptr() % 16 == 0 and ld * partials.element_size() % 16 == 0
           and out.data_ptr() % 16 == 0)
    f = _fn("matern_hess.cu", f"combine_{_SUFFIX[dt]}", [_P, _LL, _LL, _I, _P, _P, _P, _P])
    with torch.cuda.device(dev):
        rc = f(_ptr(partials), ld, n * m, int(vec), _ptr(scale), _ptr(w), _ptr(out), _stream(dev))
    _check_rc("matern_hess.cu", rc, "matern_block_tangent")
    LAUNCHES["matern_block_tangent"] += 1
    return out


def matern_block_hess(nu, ls, h, ct, symmetric=False, table=None):
    """The block's five second-order sums against ``ct`` (see
    ``matern_block_hess_plain``): float64 [sum ct dM/dnu, sum ct dM/dls,
    sum ct d2M/dnu2, sum ct d2M/dnu dls, sum ct d2M/dls2].

    ``symmetric=True`` (square symmetric h, any ct) evaluates the lower
    triangle only. ``h`` and ``ct`` may be row-strided views (unit column
    stride). CUDA tensors run ``csrc/matern_hess.cu``'s Hessian kernel and
    its fixed-order reduce (nothing read back); CPU tensors the plain
    version. ``table``: the kernel's second-order row
    ``recurrence_table(nu, ls, h.dtype, order=2)[0]`` on h's device, by
    default built here."""
    if h.device.type == "cpu":
        return matern_block_hess_plain(nu, ls, h, ct, symmetric)
    _check_block("matern_block_hess", h, ct, symmetric)
    n, m = h.shape
    out = torch.zeros(5, dtype=torch.float64, device=h.device)
    if n == 0 or m == 0:
        return out
    if h.stride(1) != 1 or h.stride(0) < m:
        raise ValueError("matern_block_hess: h needs unit column stride")
    if ct.stride(1) != 1 or ct.stride(0) < m:
        ct = ct.contiguous()
    if table is None:
        table = recurrence_table(torch.as_tensor(nu, dtype=h.dtype, device=h.device),
                                 torch.as_tensor(ls, dtype=h.dtype, device=h.device), h.dtype,
                                 order=2)[0]
    _check_table("matern_block_hess", table, (3 * _table_width(h.dtype),), h)
    tiles = _fn_ll("matern_hess.cu", "hess_num_tiles", [_I, _I, _I])(n, m, int(symmetric))
    part = torch.empty(5 * tiles, dtype=torch.float64, device=h.device)
    f = _fn("matern_hess.cu", f"hess_{_SUFFIX[h.dtype]}",
            [_P, _P, _I, _I, _LL, _LL, _I, _P, _P, _P, _P])
    with torch.cuda.device(h.device):
        rc = f(_ptr(h), _ptr(ct), n, m, h.stride(0), ct.stride(0), int(symmetric), _ptr(table),
               _ptr(part), _ptr(out), _stream(h.device))
    _check_rc("matern_hess.cu", rc, "matern_block_hess")
    LAUNCHES["matern_block_hess"] += 1
    return out


# ---------------------------------------------------------------------------
# Matern correlation over gathered pairs
# ---------------------------------------------------------------------------

#: Most (nu, ls) pairs one call of the pairs kernels takes (p <= 4 processes).
MAX_PAIRS = 10
# entries per chunk of the plain pairs forward (bounds the K_nu temporaries)
_PLAIN_PAIRS_ELEMS = 1 << 22


def pair_index(idx_f, n_pairs):
    """The pair of each entry of the float index plane ``idx_f``: k where the
    value equals k (1 <= k < n_pairs), else 0 (the reference's ``_sel_pairs``
    rule), as int64."""
    valid = (idx_f >= 1.0) & (idx_f <= n_pairs - 1.0) & (idx_f == torch.floor(idx_f))
    return torch.where(valid, idx_f, 0.0).long()


def _check_pairs(name, nu_pairs, ls_pairs, idx_f, h):
    n_pairs = int(nu_pairs.shape[0]) if nu_pairs.ndim else 0
    if nu_pairs.ndim != 1 or ls_pairs.shape != nu_pairs.shape or not 1 <= n_pairs <= MAX_PAIRS:
        raise ValueError(f"{name}: nu_pairs and ls_pairs must be (n_pairs,), "
                         f"1 <= n_pairs <= {MAX_PAIRS}")
    if idx_f.shape != h.shape:
        raise ValueError(f"{name}: idx_f and h must have one shape")
    return n_pairs


def matern_corr_pairs_plain(nu_pairs, ls_pairs, idx_f, h):
    """Plain torch Matern correlation over gathered entries: each entry
    selects its pair's (nu, ls) by ``pair_index`` and goes through the
    elementwise ``cov.matern.matern_correlation`` (differentiable in
    ``nu_pairs``, ``ls_pairs`` and ``h``), in flat chunks."""
    from cokriging_tpu_torch.cov.matern import matern_correlation

    h = torch.as_tensor(h)
    nu_pairs = torch.as_tensor(nu_pairs, device=h.device)
    ls_pairs = torch.as_tensor(ls_pairs, device=h.device)
    n_pairs = _check_pairs("matern_corr_pairs", nu_pairs, ls_pairs, idx_f, h)
    k = pair_index(idx_f.reshape(-1), n_pairs)
    hf = h.reshape(-1)
    parts = [
        matern_correlation(nu_pairs[k[s:s + _PLAIN_PAIRS_ELEMS]],
                           ls_pairs[k[s:s + _PLAIN_PAIRS_ELEMS]],
                           hf[s:s + _PLAIN_PAIRS_ELEMS])
        for s in range(0, hf.shape[0], _PLAIN_PAIRS_ELEMS)
    ]
    if not parts:
        return torch.empty_like(h)
    return torch.cat(parts).reshape(h.shape)


def matern_corr_pairs_grad_plain(nu_pairs, ls_pairs, idx_f, h, ct, absolute=False):
    """Plain torch backward of ``matern_corr_pairs_plain`` against ``ct``:
    the float64 (n_pairs, 2) tensor of per-pair sums [sum ct dM/dnu, sum ct
    dM/dls]. Per flat chunk, autograd of sum(ct * M) through the per-entry
    select and ``matern_correlation`` gives each entry's two terms, which are
    zeroed where not finite and summed per pair in float64. ``absolute=True``
    sums |terms| instead: the scale of the sums' rounding error, which
    comparisons of two evaluations are stated against."""
    from cokriging_tpu_torch.cov.matern import matern_correlation

    h = torch.as_tensor(h)
    dt, dev = h.dtype, h.device
    nu = torch.as_tensor(nu_pairs, device=dev).detach().to(dt)
    ls = torch.as_tensor(ls_pairs, device=dev).detach().to(dt)
    n_pairs = _check_pairs("matern_corr_pairs_grad", nu, ls, idx_f, h)
    if ct.shape != h.shape:
        raise ValueError("matern_corr_pairs_grad: ct and h must have one shape")
    k_all = pair_index(idx_f.reshape(-1), n_pairs)
    hf, cf = h.reshape(-1), ct.reshape(-1).to(dt)
    out = torch.zeros(n_pairs, 2, dtype=torch.float64, device=dev)
    for s in range(0, hf.shape[0], _PLAIN_GRAD_ELEMS):
        k = k_all[s:s + _PLAIN_GRAD_ELEMS]
        with torch.enable_grad():
            nu_e = nu[k].requires_grad_(True)
            ls_e = ls[k].requires_grad_(True)
            m = matern_correlation(nu_e, ls_e, hf[s:s + _PLAIN_GRAD_ELEMS])
            terms = torch.autograd.grad((cf[s:s + _PLAIN_GRAD_ELEMS] * m).sum(), (nu_e, ls_e))
        for c, t in enumerate(terms):
            t = torch.where(torch.isfinite(t), t, 0.0).double()
            out[:, c] += torch.bincount(k, weights=t.abs() if absolute else t,
                                        minlength=n_pairs)
    return out


def _pairs_forward_launch(nu_pairs, ls_pairs, idx_f, h, table, early_exit):
    """One launch of ``csrc/matern_pairs.cu``'s forward on CUDA tensors (the
    CUDA implementation of the registered op; see ``matern_corr_pairs``)."""
    n_pairs = _check_pairs("matern_corr_pairs", nu_pairs, ls_pairs, idx_f, h)
    h = h.contiguous()
    idx = idx_f.to(h.dtype).contiguous()
    _check_cuda("matern_corr_pairs", h, idx)
    out = torch.empty_like(h)
    if h.numel() == 0:
        return out
    if table is None:
        table = recurrence_table(nu_pairs, ls_pairs, h.dtype).to(h.device)
    _check_table("matern_corr_pairs", table, (n_pairs, _table_width(h.dtype)), h)
    f = _fn("matern_pairs.cu", f"pairs_fwd_{_SUFFIX[h.dtype]}", [_P, _P, _LL, _P, _I, _I, _P, _P])
    with torch.cuda.device(h.device):
        rc = f(_ptr(h), _ptr(idx), h.numel(), _ptr(table), n_pairs, int(early_exit), _ptr(out),
               _stream(h.device))
    _check_rc("matern_pairs.cu", rc, "matern_corr_pairs")
    LAUNCHES["matern_corr_pairs"] += 1
    return out


def _pairs_op_cpu(nu_pairs, ls_pairs, idx_f, h, table, early_exit):
    return matern_corr_pairs_plain(nu_pairs, ls_pairs, idx_f, h)


# ``cokriging_tpu_torch::matern_corr_pairs``: the plain version on CPU tensors,
# ``_pairs_forward_launch`` on CUDA ones, an empty tensor shaped as h under
# tracing. Defined through ``torch.library.Library`` rather than
# ``torch.library.custom_op``, whose Python wrapper costs several times the
# dispatch per call (PERF.md section 6), and the CG matvec launches thousands.
_LIB = torch.library.Library("cokriging_tpu_torch", "DEF")
_LIB.define("matern_corr_pairs(Tensor nu_pairs, Tensor ls_pairs, Tensor idx_f, Tensor h, "
            "Tensor? table, bool early_exit) -> Tensor")
_LIB.impl("matern_corr_pairs", _pairs_op_cpu, "CPU")
_LIB.impl("matern_corr_pairs", _pairs_forward_launch, "CUDA")


@torch.library.register_fake("cokriging_tpu_torch::matern_corr_pairs", lib=_LIB)
def _pairs_op_fake(nu_pairs, ls_pairs, idx_f, h, table, early_exit):
    return torch.empty_like(h, memory_format=torch.contiguous_format)


def matern_corr_pairs(nu_pairs, ls_pairs, idx_f, h, table=None, early_exit=True):
    """Matern correlation over gathered entries of any shape: entry e takes
    pair ``pair_index(idx_f)[e]`` of ``nu_pairs``/``ls_pairs`` (see
    ``matern_corr_pairs_plain``). Forward only. It is the registered op
    ``torch.ops.cokriging_tpu_torch.matern_corr_pairs``, so the live path
    and a program traced by ``torch.export`` (``utils.export``) run one piece
    of code: on CUDA tensors ``csrc/matern_pairs.cu`` over the flat arrays
    (``h`` made contiguous; ``idx_f`` in h's dtype is read as it is), on CPU
    tensors the plain version; the op's fake implementation gives an empty
    tensor shaped as ``h``.

    ``table``: the kernel's ``recurrence_table(nu_pairs, ls_pairs, h.dtype)``
    on h's device, built once by a caller that launches many times with one
    parameter set; by default it is built here, on the device of
    ``nu_pairs``. Neither way reads the card from the host. ``early_exit=False`` runs the CF2 trips of
    half-integer orders that the kernel skips (they change no bit), for
    checks."""
    return torch.ops.cokriging_tpu_torch.matern_corr_pairs(
        torch.as_tensor(nu_pairs), torch.as_tensor(ls_pairs), idx_f, torch.as_tensor(h), table,
        bool(early_exit))


def matern_corr_pairs_grad(nu_pairs, ls_pairs, idx_f, h, ct, table=None):
    """Backward of ``matern_corr_pairs`` against the cotangent ``ct``: the
    float64 (n_pairs, 2) tensor [g_nu, g_ls] of per-pair sums (see
    ``matern_corr_pairs_grad_plain``); ``h`` and ``idx_f`` get none. CUDA
    tensors run ``csrc/matern_pairs.cu`` (a fixed-order reduction, the same
    sums from run to run); CPU tensors the plain version. ``table``: the
    kernel's dual table ``recurrence_table(nu_pairs, ls_pairs, h.dtype,
    order=1)`` on h's device (|nu|, as the reference's gradient table
    takes it), built once by a caller that launches many times with one
    parameter set; by default it is built here, on the device of
    ``nu_pairs``."""
    if h.device.type == "cpu":
        return matern_corr_pairs_grad_plain(nu_pairs, ls_pairs, idx_f, h, ct)
    nu_pairs, ls_pairs = torch.as_tensor(nu_pairs), torch.as_tensor(ls_pairs)
    n_pairs = _check_pairs("matern_corr_pairs_grad", nu_pairs, ls_pairs, idx_f, h)
    if ct.shape != h.shape:
        raise ValueError("matern_corr_pairs_grad: ct and h must have one shape")
    h = h.contiguous()
    idx = idx_f.to(h.dtype).contiguous()
    ct = ct.to(h.dtype).contiguous()
    _check_cuda("matern_corr_pairs_grad", h, idx, ct)
    out = torch.zeros(n_pairs, 2, dtype=torch.float64, device=h.device)
    n = h.numel()
    if n == 0:
        return out
    if table is None:
        table = recurrence_table(nu_pairs, ls_pairs, h.dtype, order=1).to(h.device)
    _check_table("matern_corr_pairs_grad", table, (n_pairs, 2 * _table_width(h.dtype)), h)
    blocks = int(_fn_ll("matern_pairs.cu", "pairs_grad_blocks", [_LL])(n))
    part = torch.empty(2 * n_pairs * blocks, dtype=torch.float64, device=h.device)
    f = _fn("matern_pairs.cu", f"pairs_grad_{_SUFFIX[h.dtype]}",
            [_P, _P, _P, _LL, _P, _I, _P, _P, _P])
    with torch.cuda.device(h.device):
        rc = f(_ptr(h), _ptr(idx), _ptr(ct), n, _ptr(table), n_pairs, _ptr(part), _ptr(out),
               _stream(h.device))
    _check_rc("matern_pairs.cu", rc, "matern_corr_pairs_grad")
    LAUNCHES["matern_corr_pairs_grad"] += 1
    return out
