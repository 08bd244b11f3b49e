from cokriging_tpu_torch.sim.cofield import (  # noqa: F401
    BivariateRandomField,
    CartesianGrid,
    MultivariateRandomField,
)
from cokriging_tpu_torch.sim.spectral import SpectralRandomField  # noqa: F401
