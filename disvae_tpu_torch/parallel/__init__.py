"""Data and tensor parallelism over torch.distributed
(disvae_tpu/parallel/)."""

from disvae_tpu_torch.parallel.mesh import (create_mesh,
                                            make_sharded_train_step,
                                            make_tp_train_step,
                                            pad_to_multiple, shard_batch,
                                            tp_param_shards)

__all__ = ["create_mesh", "make_sharded_train_step", "make_tp_train_step",
           "pad_to_multiple", "shard_batch", "tp_param_shards"]
