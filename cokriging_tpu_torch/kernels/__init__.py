from cokriging_tpu_torch.kernels.bessel import kv, kv_ratio, kv_exact_grad  # noqa: F401
from cokriging_tpu_torch.kernels.distance import (  # noqa: F401
    haversine_matrix,
    euclidean_matrix,
    distance_matrix,
    vincenty_matrix,
)
