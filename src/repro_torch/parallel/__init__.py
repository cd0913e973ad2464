from repro_torch.parallel.sharding import (
    ShardingPolicy, make_param_specs, make_batch_specs, make_cache_specs,
    make_opt_specs, attach, abstract_with_sharding)
