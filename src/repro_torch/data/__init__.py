from repro_torch.data.pipeline import (DataConfig, ShardedDataset, make_batch_iter,
                                       host_shard_assignment)
