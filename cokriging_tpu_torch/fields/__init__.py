from cokriging_tpu_torch.fields.field import (  # noqa: F401
    Field,
    MultiField,
    TrendStats,
    apply_timedelta,
    fit_linear_trend,
    fit_ols,
)
