"""Device "mesh" helpers for splitting work over the micrograph axis
(the port of ``repic_tpu.parallel.mesh``).

In the reference the micrograph axis is the data-parallel axis of a
1-D ``jax.sharding.Mesh`` and XLA runs one SPMD program over it.  Here
a mesh is a tuple of ``torch.device``: per-micrograph problems are
independent, so a chunk runs as one slice per device (contiguous rows,
in device order) and the results are concatenated in micrograph order
(:func:`repic_tpu_torch.pipeline.consensus.run_consensus_batch`).
There is no collective: a slice's results are copied back to the
first device of the mesh.
"""

from __future__ import annotations

from functools import lru_cache

import torch

MICROGRAPH_AXIS = "micrographs"


@lru_cache(maxsize=1)
def _default_mesh() -> tuple:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        return (torch.device("cpu"),)
    return tuple(torch.device("cuda", i) for i in range(n))


def consensus_mesh(devices=None) -> tuple:
    """The devices a chunk is split over: every card of this process
    (memoized, so repeated callers get the same tuple; the CPU when
    there is no card), or the given ``devices`` in their order."""
    if devices is None:
        return _default_mesh()
    return tuple(torch.device(d) for d in devices)


def slice_bounds(rows: int, n_dev: int) -> list[tuple[int, int]]:
    """``(start, stop)`` of each device's contiguous share of ``rows``
    batch rows: ``ceil(rows / n_dev)`` rows each, the last ones short
    or empty (as a sharded axis that the batch padding makes a
    multiple of the mesh would split it)."""
    per = -(-rows // max(n_dev, 1))
    return [(min(i * per, rows), min((i + 1) * per, rows))
            for i in range(n_dev)]


def shard_over_micrographs(mesh, *tensors):
    """Split batch-leading tensors over the mesh: for each tensor a
    tuple of its contiguous row slices, slice ``i`` on ``mesh[i]``."""
    out = []
    for t in tensors:
        t = torch.as_tensor(t)
        out.append(tuple(
            t[a:b].to(dev)
            for (a, b), dev in zip(slice_bounds(t.shape[0], len(mesh)),
                                   mesh)
        ))
    return tuple(out)


def micrograph_pspec() -> tuple:
    """The partition of a batch-leading tensor: its first axis over
    :data:`MICROGRAPH_AXIS` (the reference's ``PartitionSpec``)."""
    return (MICROGRAPH_AXIS,)


def mesh_axis_names() -> tuple:
    """Every mesh axis name this project splits over."""
    return (MICROGRAPH_AXIS,)
