"""Multi-device sharding of the seed search.

Port of libmems_tpu/parallel: the canonical seed-key space is partitioned
by content over a mesh of devices, each window is routed to the device
that owns its key range, and seed enumeration then runs on each device's
table with no communication; global counts are sums over the shards.
``Mesh`` lists the devices (one may repeat) and, for a mesh that spans
processes, the process that runs each (``multihost``: torch.distributed
with NCCL between cards, gloo between CPU shards).
"""

from libmems_tpu_torch.parallel.multihost import (KeyTable,
                                                  assert_processes_agree,
                                                  build_owned_smls,
                                                  gather_key_tables,
                                                  global_mesh, initialize,
                                                  multihost_align,
                                                  multihost_find_mums,
                                                  multihost_progressive_align,
                                                  owned_genomes)
from libmems_tpu_torch.parallel.shard import (Mesh, build_position_tiles,
                                              make_mesh, shard_loads,
                                              sharded_find_mums,
                                              sharded_find_mums_tiled,
                                              sharded_find_pairwise_mums,
                                              sharded_mum_seed_count,
                                              sharded_seed_table)

__all__ = ["make_mesh", "sharded_seed_table", "sharded_mum_seed_count",
           "sharded_find_mums", "sharded_find_pairwise_mums", "Mesh",
           "shard_loads", "sharded_find_mums_tiled", "build_position_tiles",
           "initialize", "global_mesh", "owned_genomes", "KeyTable",
           "build_owned_smls", "gather_key_tables", "assert_processes_agree",
           "multihost_align", "multihost_progressive_align",
           "multihost_find_mums"]
