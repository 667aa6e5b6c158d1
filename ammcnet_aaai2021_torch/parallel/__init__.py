from .mesh import replicate, shard_batch
from .multihost import (agree_on_run_token, all_reduce_sum,
                        collective_device, consume_shard_dir, host_seed,
                        host_shard, initialize, make_global_batch,
                        merge_record_shards, process_count, process_index,
                        wait_for_merge, wait_for_shards, warm_collectives,
                        write_record_shard)

__all__ = ["replicate", "shard_batch", "agree_on_run_token",
           "all_reduce_sum", "collective_device", "consume_shard_dir",
           "host_seed", "host_shard", "initialize", "make_global_batch",
           "merge_record_shards", "process_count", "process_index",
           "wait_for_merge", "wait_for_shards", "warm_collectives",
           "write_record_shard"]
