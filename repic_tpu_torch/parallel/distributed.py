"""Multi-process runtime over ``torch.distributed`` (the port of
``repic_tpu.parallel.distributed``).

The reference's backend is XLA's: once ``jax.distributed`` is up,
every jitted program runs SPMD over the global mesh.  Here the process
group is ``torch.distributed``'s, created from torchrun's environment
(``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) or from explicit fields, with ``nccl`` for cards and
``gloo`` for the CPU.  Directory consensus across hosts needs no
collective (:mod:`repic_tpu_torch.runtime.cluster` coordinates through
files): the group gives every process its identity
(:func:`runtime_identity`) and the per-process share of the work
(:func:`shard_for_process`).  The gang
(:mod:`repic_tpu_torch.parallel.gang`) runs its collectives on a group
of its own, one per epoch (:func:`init_gang_group`): a ``TCPStore``
hosted by the epoch's rank 0 (under torchrun, for the launch's epoch,
the agent's store) and a ``gloo`` group over it, whose
all-reduces travel over CPU tensors, so several gang processes can
share one card and no NCCL communicator is created.

Typical launch, one process per card::

    torchrun --nproc-per-node 4 -m repic_tpu_torch consensus ...

    from repic_tpu_torch.parallel import distributed
    distributed.initialize()      # False for a single process
"""

from __future__ import annotations

import os
from typing import NamedTuple

class CollectiveError(RuntimeError):
    """A gang collective that failed: a peer's connection reset or the
    group's timeout ran out.  Gloo fails where XLA's collective hangs,
    so the gang's watchdog reads this as a wedged dispatch."""


#: this process's gang group of the current epoch: ``(group, store,
#: world, rank)``; None outside a multi-process gang
_GANG = None


def _env_int(name: str) -> int | None:
    """Parse an integer launch variable, failing with a one-line error
    naming the variable and the value (a launcher's template bug
    otherwise shows as a bare ``int()`` error on every host)."""
    raw = os.environ.get(name)
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        raise ValueError(
            "repic_tpu_torch.parallel.distributed: invalid launch "
            f"environment: {name}={raw!r} is not an integer"
        ) from None


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() else None


def _active(dist) -> bool:
    return dist is not None and dist.is_initialized()


def _publish_host_gauges() -> None:
    """Per-process identity gauges, so that an aggregator can tell
    the per-host metric snapshots apart.  Set only on multi-process
    paths."""
    try:
        import torch

        from repic_tpu_torch import telemetry

        dist = _dist()
        telemetry.gauge(
            "repic_host_process_id",
            "rank of this process in its process group",
        ).set(dist.get_rank())
        telemetry.gauge(
            "repic_host_process_count",
            "processes in the process group",
        ).set(dist.get_world_size())
        telemetry.gauge(
            "repic_host_local_device_count",
            "cards visible to this process",
        ).set(torch.cuda.device_count() if torch.cuda.is_available()
              else 1)
    except Exception:  # pragma: no cover - telemetry is best-effort
        pass


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> bool:
    """Create the process group (idempotent).

    Returns True when a multi-process group was (or already is)
    active, and False for a single process, which creates no group.
    The fields default from torchrun's environment:
    ``coordinator_address`` from ``MASTER_ADDR:MASTER_PORT``
    (``host:port`` or a ``tcp://`` URL), ``num_processes`` from
    ``WORLD_SIZE`` and ``process_id`` from ``RANK``.
    ``local_device_ids`` (default ``[LOCAL_RANK]``) names the card of
    this process.  The backend is ``nccl`` when there is a card and
    ``gloo`` otherwise.
    """
    dist = _dist()
    if dist is None:
        return False
    if _active(dist):
        _publish_host_gauges()
        return dist.get_world_size() > 1
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if coordinator_address is None:
        addr = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        if addr and port:
            coordinator_address = f"{addr}:{port}"
    # every process of a launch gets the same environment: a single
    # process is a decision of the whole launch, not of one host
    if (num_processes or 1) <= 1:
        return False
    if not coordinator_address:
        raise ValueError(
            "repic_tpu_torch.parallel.distributed: "
            f"{num_processes} processes but no coordinator address "
            "(set MASTER_ADDR and MASTER_PORT, or pass "
            "coordinator_address)"
        )
    if process_id is None:
        raise ValueError(
            "repic_tpu_torch.parallel.distributed: "
            f"{num_processes} processes but no process id (set RANK, "
            "or pass process_id)"
        )
    import torch

    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = local_device_ids
        if local is None:
            local = [_env_int("LOCAL_RANK") or 0]
        torch.cuda.set_device(int(list(local)[0]))
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(
        backend, init_method=url, world_size=int(num_processes),
        rank=int(process_id),
    )
    _publish_host_gauges()
    return True


def runtime_identity() -> "tuple[str, int, int] | None":
    """``(host_id, rank, num_hosts)`` of an initialised process group,
    else of torchrun's ``RANK`` / ``WORLD_SIZE`` when the world has
    more than one process, else None.  Creates no group."""
    dist = _dist()
    if _active(dist):
        rank, world = dist.get_rank(), dist.get_world_size()
        return (f"proc{rank}", int(rank), int(world))
    world = _env_int("WORLD_SIZE")
    rank = _env_int("RANK")
    if world is not None and world > 1 and rank is not None:
        return (f"proc{rank}", rank, world)
    return None


def shutdown() -> bool:
    """Leave the gang group and destroy an active process group
    (idempotent); True when either was there.

    The gang re-formation calls this after a collective fault, with
    the wedged dispatch thread perhaps still inside an all-reduce of
    the old group: that group is dropped, not destroyed (its timeout
    ends the thread's wait), so the call never blocks and a new group
    can form at another world size, rank and port at once."""
    global _GANG
    left = _GANG is not None
    _GANG = None
    dist = _dist()
    if not _active(dist):
        return left
    dist.destroy_process_group()
    return True


def _agent_store_at(host: str, port: int) -> bool:
    """Is ``host:port`` the store of the torchrun agent that launched
    this process?  The agent hosts it itself
    (``TORCHELASTIC_USE_AGENT_STORE``) at the launch's ``MASTER_ADDR``
    and ``MASTER_PORT``, so a worker may only join it as a client."""
    return (os.environ.get("TORCHELASTIC_USE_AGENT_STORE") == "True"
            and os.environ.get("MASTER_ADDR") == host
            and _env_int("MASTER_PORT") == int(port))


def init_gang_group(coordinator: str, world: int, rank: int,
                    timeout_s: float) -> None:
    """Form this epoch's gang group: a ``TCPStore`` at ``coordinator``
    (``host:port``, hosted by ``rank`` 0) and a ``gloo`` group of
    ``world`` processes over it.  Under torchrun the launch's
    coordinator is the agent's own store: every rank joins it as a
    client, under a key prefix of this launch attempt.  Replaces the
    previous epoch's group.  Store and group wait ``timeout_s`` for
    their peers and raise when one never comes; the group's
    collectives time out after as long.  A world of one forms no
    group."""
    global _GANG
    _GANG = None
    if int(world) <= 1:
        return
    import datetime

    import torch.distributed as dist

    host, _, port = str(coordinator).replace("tcp://", "").rpartition(":")
    host = host or "127.0.0.1"
    timeout = datetime.timedelta(seconds=max(float(timeout_s), 1.0))
    if _agent_store_at(host, int(port)):
        store = dist.PrefixStore(
            "repic_gang/"
            + os.environ.get("TORCHELASTIC_RESTART_COUNT", "0") + "/",
            dist.TCPStore(host, int(port), int(world), False,
                          timeout=timeout))
    else:
        store = dist.TCPStore(host, int(port), int(world), int(rank) == 0,
                              timeout=timeout)
    group = dist.ProcessGroupGloo(store, int(rank), int(world), timeout)
    _GANG = (group, store, int(world), int(rank))


def gang_all_reduce_max(values):
    """Elementwise MAX of a small host vector over the gang group, as a
    numpy array (the vector itself without a group).  Travels as a
    float64 CPU tensor: integers up to 2**53 stay exact."""
    import numpy as np
    import torch

    vec = np.asarray(values, np.float64).reshape(-1)
    if _GANG is None:
        return vec
    import torch.distributed as dist

    t = torch.from_numpy(vec.copy())
    try:
        _GANG[0].allreduce([t], dist.ReduceOp.MAX).wait()
    except RuntimeError as e:
        raise CollectiveError(
            f"gang all-reduce failed: {str(e)[:300]}") from e
    return t.numpy()


def _process_index_count() -> tuple[int, int]:
    dist = _dist()
    if _active(dist):
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_for_process(items, process_id=None, process_count=None):
    """This process's contiguous share of a global work list: the same
    list gives disjoint, covering shards on every process."""
    pid, n = _process_index_count()
    pid = pid if process_id is None else process_id
    n = n if process_count is None else process_count
    items = list(items)
    per = -(-len(items) // n)
    return items[pid * per : (pid + 1) * per]


def local_row_quota(shard_len: int, local_devices: int) -> int:
    """Per-process padded row count: the local shard length rounded up
    to the local device count, at least one full device row, so an
    empty shard still takes part with all-padding rows."""
    return max(-(-shard_len // local_devices) * local_devices,
               local_devices)


def pad_rows_to(arrays, rows: int | None):
    """Zero-pad each batch-leading numpy array or tensor to ``rows``
    rows (``None``, or an array already that long, passes through).
    Zeros are all-masked micrographs on every consensus input, so a
    process whose shard ran dry contributes shapes equal to its peers'
    and emits nothing (the padding half of the reference's
    ``assemble_global_batch``)."""
    import numpy as np
    import torch

    out = []
    for a in arrays:
        if rows is None or a.shape[0] >= rows:
            out.append(a)
            continue
        shape = (rows - a.shape[0],) + tuple(a.shape[1:])
        if isinstance(a, torch.Tensor):
            out.append(torch.cat([a, a.new_zeros(shape)], dim=0))
        else:
            a = np.asarray(a)
            out.append(np.concatenate([a, np.zeros(shape, a.dtype)],
                                      axis=0))
    return tuple(out)


class GlobalRows(NamedTuple):
    """Where one process's rows sit in a gang chunk's global batch:
    ``world`` processes of ``rows`` rows each, this one the
    ``rank``-th, rows ``[start, stop)`` of ``global_rows``."""

    rows: int
    world: int
    rank: int

    @property
    def global_rows(self) -> int:
        return self.rows * self.world

    @property
    def start(self) -> int:
        return self.rows * self.rank

    @property
    def stop(self) -> int:
        return self.start + self.rows


def assemble_global_batch(local_arrays, pad_rows_to: int | None = None,
                          *, process_id=None, process_count=None):
    """This process's part of a gang chunk's global batch.

    The reference builds one sharded global array out of every
    process's rows; here every process runs its own rows, so the
    global batch is a layout: the local arrays (this process's
    :func:`shard_for_process` share) zero-padded to ``pad_rows_to``
    rows by :func:`pad_rows_to` -- all-masked micrographs, so a short
    or empty shard takes part with the shapes of its peers and emits
    nothing -- and their :class:`GlobalRows`.  Returns ``(arrays,
    layout)``."""
    pid, n = _process_index_count()
    pid = pid if process_id is None else int(process_id)
    n = n if process_count is None else int(process_count)
    # the reference's keyword shadows the module's function
    arrays = globals()["pad_rows_to"](local_arrays, pad_rows_to)
    rows = max((int(a.shape[0]) for a in arrays), default=0)
    return arrays, GlobalRows(rows=rows, world=n, rank=pid)
