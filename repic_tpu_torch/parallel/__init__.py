"""Batching and the device mesh (the port of ``repic_tpu.parallel``)."""

from repic_tpu_torch.parallel.batching import PaddedBatch, bucket_size, pad_batch
from repic_tpu_torch.parallel.mesh import consensus_mesh, shard_over_micrographs

__all__ = [
    "PaddedBatch",
    "pad_batch",
    "bucket_size",
    "consensus_mesh",
    "shard_over_micrographs",
]
