"""PyTorch/CUDA port of ``cokriging_tpu``: bivariate Matern cokriging on an
NVIDIA Hopper card.

The module layout mirrors ``cokriging_tpu`` one to one (``kernels/``,
``cov/``, ``estimate/``, ``predict/``, ``fields/``, ``data/``, ``utils/``) so
each module has one counterpart to be held against. The package imports
``torch``, numpy and scipy only: never ``jax``, never ``cokriging_tpu``, and
on the main path (variograms -> WLS fit -> local prediction) neither pandas
nor matplotlib.

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``
(see ``utils.config.resolve_device``); they never fall back to the CPU for
want of a card.
"""

from cokriging_tpu_torch.utils.config import EARTH_RADIUS_KM, resolve_device

__all__ = ["EARTH_RADIUS_KM", "resolve_device"]
