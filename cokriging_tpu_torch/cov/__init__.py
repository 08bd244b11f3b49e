from cokriging_tpu_torch.cov.params import MaternParams, ParamSpec  # noqa: F401
from cokriging_tpu_torch.cov.spectral import (  # noqa: F401
    matern_spectral_density,
    rho_max,
    params_rho_max,
    project_to_valid,
)
from cokriging_tpu_torch.cov.matern import (  # noqa: F401
    matern_correlation,
    covariance,
    cross_covariance,
    semivariance,
    cross_semivariance,
    MultivariateMatern,
)
