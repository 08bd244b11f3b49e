from cokriging_tpu_torch.estimate.empirical import (  # noqa: F401
    VarioConfig,
    EmpiricalVariogram,
    empirical_variograms,
)
from cokriging_tpu_torch.estimate.wls import (  # noqa: F401
    cauchy_schwarz_check,
    composite_wls_cost,
    fit_wls,
    moment_init,
)
from cokriging_tpu_torch.estimate.nll import (  # noqa: F401
    fit_nll,
    fit_nll_device,
    neg_log_likelihood,
)
from cokriging_tpu_torch.estimate.vecchia import (  # noqa: F401
    VecchiaLikelihood,
    fit_vecchia,
    fit_vecchia_device,
    maxmin_order,
    vecchia_nll,
)
