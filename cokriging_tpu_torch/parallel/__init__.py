from cokriging_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    shard_batch,
    replicate,
    sharded_local_predict,
    sharded_wls_grad_step,
    sharded_variogram_pair,
    sharded_vecchia_nll,
)
