"""Multi-device and multi-process scaling: the ciphertext batch split over
a mesh of devices (and the ranks of a ``torch.distributed`` process
group), the keys replicated (port of ``go_tfhe_tpu/parallel``)."""

from .mesh import (BATCH_AXIS, make_mesh, multihost_initialize,
                   replicate_keys, shard_batch, sharded_bootstrap,
                   sharded_bootstrap_cuda)
