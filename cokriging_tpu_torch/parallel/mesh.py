"""Device-mesh sharding for the prediction and estimation paths.

Counterpart of ``cokriging_tpu/parallel/mesh.py``. The JAX package drives a
``jax.sharding.Mesh`` of local devices from one process; the port drives a
``Mesh`` of torch devices from one process, PyTorch's own single-process
multi-device idiom, so a caller gets the whole result as it does in JAX.
The collectives are explicit, on the mesh's first device (its home):

- ``psum``: the shards' partials moved home and added in shard order;
- ``pmin`` / ``pmax``: their min / max, the same way;
- a tiled ``all_gather``: ``torch.cat`` of the shards' rows.

A mesh may list one device several times (``make_mesh(n, device=...)``):
its shards then run one after another on that device, which is the
counterpart of XLA's ``--xla_force_host_platform_device_count`` and how the
CPU tests exercise the shard logic. Each shard's work is launched on its
own device; where a path reads the device once per iteration (the batched
fits), the shards step in lockstep (``estimate.nll.lockstep``) so that
several cards work at once.

The sharded paths:

- ``sharded_variogram_pair``: the pair space row-sharded, one launch per
  pass per shard of ``csrc/variogram.cu`` over the shard's sides;
- ``sharded_local_predict``: the local-cokriging batch with its location
  axis sharded, the joint covariance replicated;
- ``sharded_vecchia_nll``: the Vecchia terms sharded in ranges aligned on
  the chunk;
- ``sharded_wls_grad_step``: one gradient step of many WLS fits, members
  sharded;

and ``mesh=`` in ``fit_vecchia``, ``fit_wls_batch`` /
``fit_wls_batch_arrays``, ``parametric_bootstrap`` and
``IterativeJointPredictor``.
"""

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from cokriging_tpu_torch.utils.config import resolve_device


@dataclass(frozen=True)
class Mesh:
    """A 1-d mesh: one torch device per shard (a device may repeat), the
    axis name, and the shard count ``size``. ``devices[0]`` is the home
    device, where the collectives put their results."""

    devices: Tuple[torch.device, ...]
    axis: str = "data"

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    @property
    def axis_names(self) -> Tuple[str]:
        return (self.axis,)


def check_mesh(mesh):
    """``mesh`` where it is a ``Mesh`` or None; a TypeError for anything
    else (the ``mesh=`` argument of the entry points)."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError("mesh= takes a cokriging_tpu_torch.parallel.Mesh (make_mesh), not "
                        f"{type(mesh).__name__}")
    return mesh


def _indexed(device) -> torch.device:
    """``device`` resolved as an entry point resolves it, with a CUDA
    device's index made explicit."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: Optional[int] = None, axis: str = "data", device=None) -> Mesh:
    """1-d mesh of ``n_devices`` shards.

    With no ``device``, the first ``n_devices`` cards (all of them when
    None); raises when the machine has fewer, or none: a mesh never falls
    back to the CPU, and a silent truncation would shard onto fewer devices
    than the caller laid the batch out for. With ``device`` (``"cpu"``,
    ``"cuda:0"``, ...), ``n_devices`` (default 1) virtual shards on that one
    device.
    """
    if device is not None:
        return Mesh(tuple([_indexed(device)] * (1 if n_devices is None else int(n_devices))), axis)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    want = have if n_devices is None else int(n_devices)
    if have == 0 or have < want:
        raise RuntimeError(
            f"make_mesh: requested {n_devices if n_devices is not None else 'all'} CUDA "
            f"devices but this machine has {have}. For virtual shards on one device, pass "
            f"device=, e.g. make_mesh({want or 8}, device='cpu')."
        )
    return Mesh(tuple(torch.device("cuda", k) for k in range(want)), axis)


def shard_ranges(n: int, parts: int, align: int = 1):
    """``parts`` contiguous [start, end) ranges covering range(n), each
    starting at a multiple of ``align`` and at most ceil(n / parts) rows
    (rounded up to ``align``) long; trailing ranges may be empty."""
    per = -(-max(-(-n // parts), 1) // align) * align
    return [(min(n, k * per), min(n, (k + 1) * per)) for k in range(parts)]


def shard_batch(mesh: Mesh, arr, axis_name: str = "data"):
    """The leading axis of ``arr`` split into ``mesh.size`` contiguous
    shards, shard k on ``mesh.devices[k]``: a list of tensors. Padding to a
    multiple of the mesh size is the caller's job, as in the JAX package."""
    if axis_name != mesh.axis:
        raise ValueError(f"shard_batch: the mesh's axis is {mesh.axis!r}, not {axis_name!r}")
    t = torch.as_tensor(arr)
    if t.shape[0] % mesh.size:
        raise ValueError(f"shard_batch: {t.shape[0]} rows do not split over {mesh.size} shards")
    return [c.to(dev) for c, dev in zip(torch.chunk(t, mesh.size), mesh.devices)]


def _tree_to(tree, device):
    if torch.is_tensor(tree) or hasattr(tree, "spec"):  # a tensor or MaternParams
        return tree.to(device=device)
    if isinstance(tree, np.ndarray):
        return torch.as_tensor(tree, device=device)
    if isinstance(tree, (tuple, list)):
        items = [_tree_to(t, device) for t in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree


def replicate(mesh: Mesh, tree):
    """A copy of ``tree`` (tensors, arrays and MaternParams in tuples, named
    tuples, lists and dicts) on each shard's device: a list, shard k's on
    ``mesh.devices[k]`` (the object itself where it already lies there)."""
    return [_tree_to(tree, dev) for dev in mesh.devices]


def _psum(parts, home):
    """Sum of the shards' partials on ``home``, in shard order."""
    total = parts[0].to(home)
    for p in parts[1:]:
        total = total + p.to(home)
    return total


def _gather(parts, home):
    """The tiled all_gather: the shards' rows concatenated on ``home``."""
    return torch.cat([p.to(home) for p in parts])


def _pad_to(arr, multiple):
    """Rows of ``arr`` padded to a multiple by repeating the last row (the
    JAX package's ``np.pad(mode="edge")``), and the real row count."""
    n = arr.shape[0]
    pad = (-n) % multiple
    if pad:
        arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)])
    return arr, n


def sharded_local_predict(predictor, i: int, pcoords, max_dist: float = 1e3,
                          mesh: Optional[Mesh] = None, cv: bool = False):
    """``LocalPredictor``'s batched local cokriging with the location axis
    sharded over the mesh: (pred, pred_err) numpy arrays in input order.
    ``cv=True`` runs the LOOCV variant (pass the data coordinates of
    process ``i`` as ``pcoords``; the self-datum leaves by the d > 0 rule).

    The locations are padded to a multiple of the mesh, the neighborhood
    widths come from the whole padded set (so every shard's local systems
    have the unsharded call's shapes), the predictor's joint covariance (or,
    with ``materialize_cov=False``, its parameter table) is replicated, and
    each shard runs ``_local_predict_batch`` over its rows in the
    predictor's batch size on its own device."""
    from cokriging_tpu_torch.cov.matern import pair_table
    from cokriging_tpu_torch.predict.local import _local_predict_batch, coord_rows

    mesh = mesh or make_mesh()
    p_arr = np.asarray(coord_rows(pcoords), dtype=np.float64)
    pc, n = _pad_to(p_arr, mesh.size)
    pc = torch.as_tensor(pc, dtype=predictor.dtype, device=predictor.device)
    with torch.no_grad():
        k_each = predictor._neighborhood_widths(pc, max_dist, i, cv)
        table = None
        if predictor.joint_cov is None:
            table = pair_table(predictor.params, predictor.device, predictor._coords[0].dtype)
        shared = (predictor.params, predictor._coords, predictor._values, predictor.joint_cov,
                  table)
        preds, errs = [], []
        for rows, (params, coords, values, jc, tab) in zip(shard_batch(mesh, pc),
                                                           replicate(mesh, shared)):
            chunk = predictor._batch_size(k_each, rows.shape[0])
            parts = [
                _local_predict_batch(params, coords, values, jc, rows[s:s + chunk], max_dist, i,
                                     predictor.mf.geodesic, k_each, predictor._n_valid,
                                     predictor.dtype, tab, cv)
                for s in range(0, rows.shape[0], chunk)
            ]
            preds.append(torch.cat([q[0] for q in parts]))
            errs.append(torch.cat([q[1] for q in parts]))
        pred, err = _gather(preds, mesh.home), _gather(errs, mesh.home)
    return pred.cpu().numpy()[:n], err.cpu().numpy()[:n]


def sharded_variogram_pair(coords_a, values_a, coords_b, values_b, config, marginal: bool,
                           mesh: Optional[Mesh] = None):
    """Empirical (cross-)variogram with the pair space row-sharded over the
    mesh: (centers, means, counts) as ``estimate.empirical.
    empirical_variogram_pair`` returns them, with equal centers and counts.

    Both sides are prepared on the home device and centered by their global
    means before sharding. Shard k's rows [r0, r1) are one side
    ``(a[r0:r1], b)`` of a cross variogram, and two of a marginal one: its
    own strict triangle ``(a[r0:r1], a[r0:r1])`` and its rectangle against
    the later rows ``(a[r0:r1], a[r1:])``. Each pass is one
    ``variogram_minmax_pairs`` / ``variogram_bin_pairs`` launch per shard
    over its sides; the h range is reduced over the shards (pmin / pmax),
    the bins are built from it as the unsharded call builds them, and the
    float64 sums and int64 counts are added in shard order (psum)."""
    from cokriging_tpu_torch.estimate.empirical import (
        _d_of_h, _h_of_d, _prepare, variogram_bins,
    )
    from cokriging_tpu_torch.kernels.cuda_ops import variogram_bin_pairs, variogram_minmax_pairs

    mesh = mesh or make_mesh()
    home = mesh.home
    (fa, fb), (va, vb), np_dtype, _, h_max, h_snap = _prepare(
        [coords_a, coords_b], [values_a, values_b], config, home)
    geodesic = config.geodesic
    n = fa.shape[0]
    shards = []
    for dev, (r0, r1) in zip(mesh.devices, shard_ranges(n, mesh.size)):
        if r1 == r0:
            continue
        rows = (fa[r0:r1].to(dev), va[r0:r1].to(dev))
        if marginal:
            sides = [(rows[0], rows[0], rows[1], rows[1], True)]
            if r1 < n:
                sides.append((rows[0], fa[r1:].to(dev), rows[1], va[r1:].to(dev), False))
        else:
            sides = [(rows[0], fb.to(dev), rows[1], vb.to(dev), False)]
        shards.append(sides)
    hr = [variogram_minmax_pairs([(s[0], s[1], s[4]) for s in sides], geodesic, h_max, h_snap)
          for sides in shards]
    hmin = torch.min(torch.stack([h[:, 0].min().to(home) for h in hr]))
    hmax = torch.max(torch.stack([h[:, 1].max().to(home) for h in hr]))
    hmin, hmax = torch.stack([hmin, hmax]).cpu().numpy()
    if not (np.isfinite(hmin) and np.isfinite(hmax)):
        raise ValueError("No pairs within max_dist; cannot build variogram bins.")
    dmin, dmax = (float(_d_of_h(h, geodesic)) for h in (hmin, hmax))
    centers, edges = variogram_bins(dmin, dmax, config.n_bins)
    h_edges = _h_of_d(edges.astype(np_dtype), geodesic).astype(np_dtype)
    sums, counts = [], []
    for sides in shards:
        s, c = variogram_bin_pairs(sides, [h_edges] * len(sides), geodesic, config.covariogram,
                                   h_max)
        sums.append(_psum(list(s), s.device))
        counts.append(_psum(list(c), c.device))
    sums, counts = _psum(sums, home).cpu().numpy(), _psum(counts, home).cpu().numpy()
    means = np.where(counts > 0, sums / np.maximum(counts, 1), np.nan).astype(np_dtype)
    return centers, means, counts


def vecchia_shards(lik, mesh: Mesh, chunk: int = 4096):
    """A ``VecchiaLikelihood``'s windows split over the mesh: shard k's
    contiguous range of terms on ``mesh.devices[k]``, each range starting at
    a multiple of ``chunk`` so that every shard evaluates the unsharded
    call's chunks (empty ranges left out)."""
    n = lik._win[0].shape[0]
    return [tuple(a[s0:s1].to(dev) for a in lik._win)
            for dev, (s0, s1) in zip(mesh.devices, shard_ranges(n, mesh.size, align=chunk))
            if s1 > s0]


def sharded_windows_nll(flat, shards, spec, geodesic, chunk, n, home):
    """The Vecchia NLL over window shards (``vecchia_shards``): each
    shard's sum of -2 log p terms on its device, the sums added on ``home``
    in shard order, then 0.5 (total + n log 2 pi) with the global term
    count ``n``. Differentiable in ``flat``."""
    from cokriging_tpu_torch.estimate.vecchia import _windows_nll_sum

    total = _psum([_windows_nll_sum(flat, w, spec, geodesic, chunk) for w in shards], home)
    return 0.5 * (total + n * math.log(2.0 * math.pi))


def sharded_vecchia_nll(lik, flat, spec, mesh: Optional[Mesh] = None, chunk: int = 4096):
    """Vecchia NLL with the term axis sharded over the mesh, differentiable
    in ``flat``: each shard evaluates its range of terms (aligned on
    ``chunk``) with the unsharded path's chunk loop on its own device, and
    the partial sums are added on the home device (psum). No padded windows
    are needed.

    Args:
        lik: an ``estimate.vecchia.VecchiaLikelihood`` scaffold.
        flat: flat parameter vector.
    """
    mesh = mesh or make_mesh()
    return sharded_windows_nll(flat, vecchia_shards(lik, mesh, chunk), spec, lik.geodesic,
                               chunk, lik._win[0].shape[0], mesh.home)


def sharded_wls_grad_step(flats, centers, means, counts, pairs, spec, lr: float = 1e-3,
                          mesh: Optional[Mesh] = None):
    """One gradient step of every month's WLS fit, months sharded over the
    mesh: each shard takes the value and gradient of ``composite_wls_cost``
    for its members on its device and steps x - lr g, clipped to the box.
    Returns (updated flats, costs) as float64 numpy arrays in input order."""
    from cokriging_tpu_torch.estimate.wls import composite_wls_cost

    mesh = mesh or make_mesh()
    arrays = [np.asarray(a, dtype=np.float64) for a in (flats, centers, means, counts)]
    lo_np, hi_np = spec.bounds()
    new, values = [], []
    for dev, (b0, b1) in zip(mesh.devices, shard_ranges(arrays[0].shape[0], mesh.size)):
        if b1 == b0:
            continue
        x, c, m, k = (torch.as_tensor(a[b0:b1], device=dev) for a in arrays)
        lo = torch.as_tensor(lo_np, dtype=x.dtype, device=dev)
        hi = torch.as_tensor(hi_np, dtype=x.dtype, device=dev)
        with torch.enable_grad():
            x = x.requires_grad_(True)
            v = composite_wls_cost(x, c, m, k, tuple(pairs), spec)
            (g,) = torch.autograd.grad(v.sum(), x)
        new.append(torch.minimum(torch.maximum(x.detach() - lr * g, lo), hi))
        values.append(v.detach())
    return _gather(new, mesh.home).cpu().numpy(), _gather(values, mesh.home).cpu().numpy()
