"""Multi-device sharding of the seed search.

Port of libmems_tpu/parallel (single process): the canonical seed-key
space is partitioned by content over a mesh of devices, each window is
routed to the device that owns its key range, and seed enumeration then
runs on each device's table with no communication; global counts are
host sums.  ``Mesh`` lists the devices (one may repeat).
"""

from libmems_tpu_torch.parallel.shard import (Mesh, make_mesh,
                                              sharded_find_mums,
                                              sharded_find_pairwise_mums,
                                              sharded_mum_seed_count,
                                              sharded_seed_table)

__all__ = ["make_mesh", "sharded_seed_table", "sharded_mum_seed_count",
           "sharded_find_mums", "sharded_find_pairwise_mums", "Mesh"]
