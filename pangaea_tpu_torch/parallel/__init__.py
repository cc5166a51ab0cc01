"""Multi-device / multi-process layer over ``torch.distributed``.

Port of pangaea_tpu.parallel: one process per device in a process group
(NCCL on the card, gloo on the CPU) where pangaea_tpu drives a ('data',)
mesh from one process. ``data_group`` and ``world_size`` stand where
pangaea_tpu has ``data_mesh``; its ``data_sharding`` and
``replicated_sharding`` have no counterpart (``parallel.mesh``)."""

from pangaea_tpu_torch.parallel.mesh import (data_group,
                                             initialize_distributed,
                                             world_size)
from pangaea_tpu_torch.parallel.dist import (ShardedFeatureExtractor,
                                             make_sharded_kmer_counter,
                                             make_sharded_sortjoin,
                                             make_sharded_sortjoin_pair,
                                             sharded_train_block,
                                             sharded_unit_chunk,
                                             sharded_lloyd)

__all__ = ["data_group", "world_size", "initialize_distributed",
           "ShardedFeatureExtractor", "make_sharded_kmer_counter",
           "make_sharded_sortjoin", "make_sharded_sortjoin_pair",
           "sharded_train_block", "sharded_unit_chunk", "sharded_lloyd"]
