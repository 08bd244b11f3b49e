"""Serving export of the local-cokriging forward (``torch.export``).

Counterpart of ``cokriging_tpu/utils/export.py``. The JAX package serializes
a jitted function's StableHLO; here the program is an ``nn.Module`` traced
by ``torch.export.export`` and saved by ``torch.export.save`` to bytes: no
Python model code on the serving host, the same program across process
restarts. The local-cokriging forward (prediction + uncertainty) is packaged
that way:

- the data-site coordinates, the lane process ids and the per-process data
  counts are the module's buffers, and the neighborhood widths its static
  ints (weights-in-graph style);
- the flat parameter vector, the per-process observation values and the
  prediction-coordinate batch stay runtime inputs, so one artifact serves
  refreshed monthly fits and any fixed-shape request batch.

An artifact is bound to the device of its example arguments. Exported on
the card, its local systems launch the gathered-pairs kernel
(``csrc/matern_pairs.cu``) through the registered op
``cokriging_tpu_torch::matern_corr_pairs`` (``kernels.cuda_ops``), the
live predictor's own call; exported on the CPU, that op runs its plain
version. K_nu's order recurrence takes a fixed trip count in the artifact,
ceil of the parameter box's upper bound on nu (``cov.params.ParamSpec``),
and the artifact checks at run time that every nu of the flat vector lies
within that bound (a RuntimeError otherwise), so it never cuts the
recurrence short. Shapes are static: pad request batches to the exported
number of locations.
"""

import io
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


class _Program(torch.nn.Module):
    """A plain function as the module ``torch.export`` traces."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_program(fn, example_args, platforms: Optional[Sequence[str]] = None) -> bytes:
    """``torch.export.export`` of ``fn`` (an ``nn.Module`` or a function of
    tensors) at ``example_args``' shapes and dtypes, saved to bytes with
    ``torch.export.save``. The artifact runs on the device of the example
    arguments; ``platforms``, if given, must name that device type ("cuda"
    or "cpu"), else ValueError."""
    devices = sorted({a.device.type for a in example_args if torch.is_tensor(a)})
    if platforms is not None and sorted({str(p).lower() for p in platforms}) != devices:
        raise ValueError(f"export_program: platforms {list(platforms)} do not name the example "
                         f"arguments' device {devices}; an artifact runs where it was exported")
    import torch.fx.config as fx_config

    module = fn if isinstance(fn, torch.nn.Module) else _Program(fn)
    # no Python stack trace per graph node: a quarter of the trace's time for
    # the thousands of nodes of K_nu's unrolled loops, and only debug info
    keep = getattr(fx_config, "do_not_emit_stack_traces", False)
    fx_config.do_not_emit_stack_traces = True
    try:
        with torch.no_grad():
            program = torch.export.export(module, tuple(example_args), strict=False)
    finally:
        fx_config.do_not_emit_stack_traces = keep
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_program(blob: bytes):
    """The callable of a serialized artifact (``torch.export.load``), on the
    device it was exported on. Registers the port's ops first."""
    import cokriging_tpu_torch.kernels.cuda_ops  # noqa: F401  (the registered op)

    return torch.export.load(io.BytesIO(bytes(blob))).module()


def _check_order_bound(nu, nu_hi: float):
    """Every |nu| within ``nu_hi``, checked where it runs: on the live call
    a RuntimeError naming the bound, in an exported program its run-time
    assertion (one host read)."""
    ok = (torch.abs(nu) <= nu_hi).all().to(torch.int64).item()
    torch._check(ok == 1, lambda: f"nu beyond the exported bound {nu_hi}: the artifact's "
                                  "order recurrence would be cut short; re-export")


class LocalPredictionModule(torch.nn.Module):
    """The local-cokriging forward of ``LocalPredictor``'s direct-assembly
    path for process ``i``: ``forward(flat, pcoords, *values)`` -> (pred,
    pred_err, n_neighbors) on the standardized scale, through
    ``predict.local._local_predict_batch`` with no joint covariance."""

    def __init__(self, lp, i: int, k_each, max_dist: float, cv: bool) -> None:
        from cokriging_tpu_torch.predict.local import _lane_procs

        super().__init__()
        self.i, self.k_each, self.max_dist, self.cv = int(i), tuple(k_each), float(max_dist), cv
        self.geodesic = lp.mf.geodesic
        self.spec = lp.mod.params.spec
        self.dtype = lp.dtype
        self.n_procs = len(lp._coords)
        self.nu_hi = float(self.spec.nu_bounds[1])
        # floor(|nu| + 0.5) <= ceil(nu_hi) for every |nu| <= nu_hi
        self.order_steps = math.ceil(self.nu_hi)
        for j, c in enumerate(lp._coords):
            self.register_buffer(f"coords_{j}", c)
        self.register_buffer("n_valid", torch.tensor(lp._n_valid, device=lp.device))
        self.register_buffer("procs", _lane_procs(self.k_each, lp.device))

    def forward(self, flat, pcoords, *values):
        from cokriging_tpu_torch.cov.matern import pair_table
        from cokriging_tpu_torch.cov.params import MaternParams
        from cokriging_tpu_torch.predict.local import _local_predict_batch

        params = MaternParams.from_flat(flat, spec=self.spec)
        _check_order_bound(params.nu, self.nu_hi)
        coords = tuple(getattr(self, f"coords_{j}") for j in range(self.n_procs))
        table = pair_table(params, flat.device, coords[0].dtype, grad=False)
        n_valid = tuple(self.n_valid[j] for j in range(self.n_procs))
        return _local_predict_batch(params, coords, tuple(values), None, pcoords, self.max_dist,
                                    self.i, self.geodesic, self.k_each, n_valid, self.dtype,
                                    table, self.cv, self.procs, self.order_steps)


def make_local_prediction_fn(
    lp,
    i: int,
    pcoords_probe,
    max_dist: float = 1e3,
    cv: bool = False,
) -> Tuple[LocalPredictionModule, tuple]:
    """(module, example_args) for a serving export of ``LocalPredictor``.

    ``module(flat, pcoords, *values) -> (pred, pred_err, n_neighbors)``
    evaluates the reference-convention local cokriging of process ``i`` on
    the standardized scale (the postprocess back to the data scale stays
    outside the artifact: cheap pandas work). The neighborhood widths are
    sized from ``pcoords_probe`` exactly as the live predictor sizes them
    (``LocalPredictor._neighborhood_widths``), so any request batch over
    the same spatial domain is exact; a denser domain needs a re-export.
    ``cv`` withholds the zero-distance lanes of process ``i`` (the LOOCV
    form, for requests at the data sites).

    Uses the direct-assembly covariance path (no n x n joint covariance),
    so the artifact is self-contained given (params, values). The example
    arguments are the predictor's parameters as a flat vector, the probe
    in the predictor's dtype and its padded per-process values, all on its
    device.
    """
    from cokriging_tpu_torch.predict.local import coord_rows

    probe = torch.tensor(np.asarray(coord_rows(pcoords_probe), np.float64), dtype=lp.dtype,
                         device=lp.device)
    with torch.no_grad():
        k_each = lp._neighborhood_widths(probe, max_dist, i, cv)
    module = LocalPredictionModule(lp, i, k_each, max_dist, cv)
    example_args = (lp.params.to_flat().detach(), probe, *lp._values)
    return module, example_args


def export_local_prediction(
    lp,
    i: int,
    pcoords_probe,
    max_dist: float = 1e3,
    cv: bool = False,
    platforms: Optional[Sequence[str]] = None,
) -> bytes:
    """One-call serving export: LocalPredictor -> serialized artifact."""
    module, example_args = make_local_prediction_fn(lp, i, pcoords_probe, max_dist=max_dist,
                                                    cv=cv)
    return export_program(module, example_args, platforms=platforms)
