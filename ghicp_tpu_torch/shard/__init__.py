"""Distribution of the port over ``torch.distributed`` (the JAX package's
``ghicp_tpu.shard``, without ``make_mesh`` and ``AXIS``: a rank is a
process, its device :func:`rank_device`)."""
from ghicp_tpu_torch.registration.ghicp import ghicp_register_batched_sharded
from ghicp_tpu_torch.shard.multihost import (init_distributed,
                                             partition_pairs,
                                             register_graph_distributed)
from ghicp_tpu_torch.shard.spmd import (ghicp_register_ring,
                                        ghicp_register_sharded, rank_device)

__all__ = ["ghicp_register_sharded", "ghicp_register_ring",
           "ghicp_register_batched_sharded", "rank_device",
           "init_distributed", "partition_pairs",
           "register_graph_distributed"]
