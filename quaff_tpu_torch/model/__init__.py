from .negbinom import (  # noqa: F401
    fit_negative_binomial,
    log_negative_binomial,
    log_negative_binomial_freq,
    negative_binomial_mean,
    negative_binomial_variance,
)
from .params import (  # noqa: F401
    QuaffParams,
    QuaffNullParams,
    QuaffParamCounts,
    QuaffCounts,
    default_params,
)
