from showo_tpu_torch.parallel.mesh import (
    init_distributed,
    make_mesh,
    param_sharding_rules,
    shard_batch,
    shard_params,
)
