"""Diagnostic and reporting figures (matplotlib; not imported by the
package's ``__init__``, so the array path never loads matplotlib)."""

from cokriging_tpu_torch.plot.figures import (  # noqa: F401
    plot_da,
    plot_df,
    plot_fields,
    plot_variograms,
    plot_samples,
    plot_sim_pred,
    plot_err_ratio,
    plot_cv_resid,
    raw_climatology,
    resid_climatology,
    qq_plots,
    resid_coord_avg,
    animate_monthly,
)
