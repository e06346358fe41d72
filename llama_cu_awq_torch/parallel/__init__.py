"""Tensor parallelism over torch.distributed, one process per shard.

mesh (TPGroup, make_mesh, the replica layout of `serve --dp N --tp M`,
the TP forward's two collectives and the dp gather) and multihost
(joining the ranks) import no model code; parallel.tp (the shard
functions and the shard forward) imports models.llama, which imports
parallel.mesh, so it is imported by its own name.
"""

from llama_cu_awq_torch.parallel.mesh import (Mesh, TPGroup,
                                              all_gather_batch,
                                              all_gather_last,
                                              all_reduce_sum, local_rows,
                                              make_mesh, make_replica_groups,
                                              replica_ranks)
from llama_cu_awq_torch.parallel.multihost import (init_multihost,
                                                   is_coordinator, pod_mesh,
                                                   replica_shard)

__all__ = ["Mesh", "TPGroup", "all_gather_batch", "all_gather_last",
           "all_reduce_sum", "init_multihost", "is_coordinator",
           "local_rows", "make_mesh", "make_replica_groups", "pod_mesh",
           "replica_ranks", "replica_shard"]
