"""Multi-process bootstrap on ``torch.distributed``: the BiocParallel
multi-machine analog.

Counterpart of ``sarlacc_tpu/parallel/distributed.py``.  The reference's
parallel layer accommodates multi-machine backends (SnowParam /
BatchtoolsParam, R/adaptorAlign.R:127-129); here:

1. every process calls :func:`init_distributed` (the coordinator address,
   process count and rank from its arguments or from
   ``SARLACC_COORDINATOR`` / ``SARLACC_NUM_PROCS`` / ``SARLACC_PROC_ID``);
2. each process streams only its byte range of the FASTQ
   (``io.fastq.stream_fastq(..., shard=host_shard())``): rank-ordered
   shard streams tile the file record for record;
3. :func:`global_mesh` gives the process its shard, in a mesh that spans
   the processes, so :func:`..parallel.mesh.sharded_adaptor_scores` sums
   its histograms over the process group instead of over one process;
4. :func:`host_local_batch_to_global` places a process's rows in the global
   batch (their global offset).  It returns a small dataclass,
   :class:`GlobalRows`, not a ``DTensor``: ``DTensor.from_local`` needs a
   ``DeviceMesh`` whose device type is the tensors' own and, on CUDA, one
   card a rank for its default NCCL group, and two ranks sharing one card
   through gloo fall outside that.

The backend is named explicitly (argument, else ``SARLACC_DIST_BACKEND``):
NCCL when each rank has a card of its own, gloo otherwise.  NCCL refuses
two ranks on one card, so ranks that share a card use gloo, with the
collectives' small buffers (histograms, scores, row counts) on the host and
the alignment work on the card.  A backend that fails to initialise raises;
nothing switches backends silently.  Importing this module initialises
nothing.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from .mesh import READS_AXIS, Mesh

__all__ = [
    "GlobalRows",
    "all_gather_rows",
    "all_reduce_sum",
    "common_local_rows",
    "global_mesh",
    "host_local_batch_to_global",
    "host_shard",
    "init_distributed",
    "is_distributed",
]

BACKENDS = ("gloo", "nccl")


def _dist():
    import torch.distributed as dist

    return dist


def _initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def default_backend(num_processes: int) -> str:
    """NCCL when this machine has a card for each of the processes, else gloo."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= num_processes:
        return "nccl"
    return "gloo"


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> tuple[int, int]:
    """Initialise the default process group once; returns (rank, processes).

    Arguments fall back to ``SARLACC_COORDINATOR`` (``host:port``, or any
    ``init_method`` URL such as ``file://...``), ``SARLACC_NUM_PROCS``,
    ``SARLACC_PROC_ID`` and ``SARLACC_DIST_BACKEND``.  With nothing
    configured the call initialises nothing and reports (0, 1).  Under NCCL
    each rank takes card ``rank % device_count``.
    """
    coordinator_address = coordinator_address or os.environ.get("SARLACC_COORDINATOR")
    if num_processes is None and "SARLACC_NUM_PROCS" in os.environ:
        num_processes = int(os.environ["SARLACC_NUM_PROCS"])
    if process_id is None and "SARLACC_PROC_ID" in os.environ:
        process_id = int(os.environ["SARLACC_PROC_ID"])
    if _initialized():
        return host_shard()
    if coordinator_address is None and num_processes is None:
        return 0, 1
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "init_distributed needs a coordinator address, a process count and "
            "a rank (arguments or SARLACC_COORDINATOR / SARLACC_NUM_PROCS / "
            "SARLACC_PROC_ID)"
        )
    backend = backend or os.environ.get("SARLACC_DIST_BACKEND") or default_backend(num_processes)
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs a CUDA device")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    _dist().init_process_group(
        backend=backend, init_method=init, world_size=int(num_processes), rank=int(process_id)
    )
    return int(process_id), int(num_processes)


def is_distributed() -> bool:
    return _initialized() and _dist().get_world_size() > 1


def host_shard() -> tuple[int, int]:
    """(rank, nshards) for host-sharded IO: feed to ``stream_fastq(shard=)``."""
    if not _initialized():
        return 0, 1
    dist = _dist()
    return dist.get_rank(), dist.get_world_size()


def global_mesh(axis: str = READS_AXIS, device=None) -> Mesh:
    """A mesh over every process: this process holds one shard, on its card
    under NCCL (``cuda:rank % device_count``), else on ``device`` (``None``
    means CUDA, ``"cpu"`` for host-only runs)."""
    from ..device import resolve_device

    rank, world = host_shard()
    if _initialized() and _dist().get_backend() == "nccl":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    else:
        dev = resolve_device(device)
    return Mesh((dev,), (axis,), processes=world)


def _collective_device() -> torch.device:
    """Where collective buffers live: the host under gloo, the card under NCCL."""
    if _dist().get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the process group, on ``t``'s device."""
    x = t.to(_collective_device()).clone()
    _dist().all_reduce(x)
    return x.to(t.device)


def _gather_ints(n: int) -> list[int]:
    dist = _dist()
    mine = torch.tensor([int(n)], dtype=torch.int64, device=_collective_device())
    parts = [torch.zeros_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine)
    return [int(p.item()) for p in parts]


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every process's rows of ``t``, in rank order, on ``t``'s device
    (processes may hold different row counts)."""
    dist = _dist()
    sizes = _gather_ints(t.shape[0])
    top = max(sizes)
    x = torch.zeros((top, *t.shape[1:]), dtype=t.dtype, device=_collective_device())
    x[: t.shape[0]] = t.to(x.device)
    parts = [torch.empty_like(x) for _ in sizes]
    dist.all_gather(parts, x)
    return torch.cat([p[:n] for p, n in zip(parts, sizes)]).to(t.device)


def common_local_rows(n_local: int, mesh: Mesh | None = None) -> int:
    """Smallest row count >= every process's local batch that is a
    multiple of the mesh's local shards (1 without a mesh): one all-gather
    of one int, for callers that want equal blocks on every process."""
    n_dev = mesh.size if mesh is not None else 1
    mx = max(_gather_ints(n_local)) if is_distributed() else n_local
    return max(((mx + n_dev - 1) // n_dev) * n_dev, n_dev)


@dataclass
class GlobalRows:
    """A process's rows of a batch that spans the processes."""

    local: torch.Tensor  # this process's rows, on its shard's device
    offset: int  # global index of its first row
    total: int  # rows over every process


def host_local_batch_to_global(mesh: Mesh, *arrays, axis: str = READS_AXIS):
    """Per-process batch-major arrays -> one :class:`GlobalRows` each.

    The processes' rows, in rank order, form one global batch without any
    data moving between processes: only the row counts are exchanged.
    """
    if axis not in mesh.axis_names:
        raise ValueError(f"the mesh has no axis {axis!r}")
    out = []
    for a in arrays:
        t = torch.as_tensor(a).to(mesh.devices[0])
        sizes = _gather_ints(t.shape[0]) if is_distributed() else [int(t.shape[0])]
        rank = host_shard()[0]
        out.append(GlobalRows(t, sum(sizes[:rank]), sum(sizes)))
    return tuple(out)
