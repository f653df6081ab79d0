"""Data parallelism over torch.distributed (disvae_tpu/parallel/)."""

from disvae_tpu_torch.parallel.mesh import (create_mesh,
                                            make_sharded_train_step,
                                            pad_to_multiple, shard_batch)

__all__ = ["create_mesh", "make_sharded_train_step", "pad_to_multiple",
           "shard_batch"]
