"""Active-mesh context: lets the API layer select data parallelism once.

Counterpart of ``sarlacc_tpu/parallel/context.py``.  Every heavy reference
function takes ``BPPARAM`` (R/adaptorAlign.R:8, R/tuneAlignment.R:8,
R/getAdaptorThresholds.R:6, R/barcodeAlign.R:4, R/multiReadAlign.R:7,
R/extractSubseq.R:5); here the analog is a :class:`..parallel.mesh.Mesh`
accepted by each entry point.  The kernels it reaches are batch-parallel,
so sharding is one decision, "split batch-major tensors along the leading
axis over the mesh's shards", made here and consulted by the op layer.
Each shard runs the same kernel the solo path runs, on its own device, and
the results are concatenated in row order; every result equals the solo
run's bit for bit, because every read, pair and group is computed alone.

No active mesh makes every helper a no-op, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import contextvars

import numpy as np
import torch

_ACTIVE_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "sarlacc_torch_active_mesh", default=None
)

__all__ = ["use_mesh", "active_mesh", "mesh_size", "shard_batch", "pad_to_mesh"]


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate ``mesh`` (or no-op when None) for the enclosed block."""
    token = _ACTIVE_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.reset(token)


def active_mesh():
    return _ACTIVE_MESH.get()


def mesh_size(mesh=None) -> int:
    """Shards of ``mesh`` (default: the active one), 1 without a mesh."""
    mesh = mesh if mesh is not None else active_mesh()
    return 1 if mesh is None else mesh.size


def pad_to_mesh(n: int, mesh=None) -> int:
    """Round a batch size up to a multiple of the mesh size.  The port's
    shards split a batch unevenly and need no padding; this keeps the JAX
    package's arithmetic for callers that want equal shards."""
    m = mesh_size(mesh)
    return ((n + m - 1) // m) * m


def shard_bounds(n: int, n_shards: int) -> list[tuple[int, int]]:
    """Row ranges ``[r0, r1)`` splitting ``n`` rows over ``n_shards`` shards
    in order, as evenly as integers allow (shard ``s`` starts at row
    ``n * s // n_shards``); a shard may be empty."""
    cuts = [(n * s) // n_shards for s in range(n_shards + 1)]
    return list(zip(cuts[:-1], cuts[1:]))


def _to_shard(a, r0: int, r1: int, device):
    if torch.is_tensor(a):
        return a[r0:r1].to(device)
    return torch.as_tensor(np.array(a[r0:r1]), device=device)


def shard_batch(*arrays):
    """Split batch-major arrays along the leading axis over the active mesh.

    Each array (a tensor or anything numpy takes) becomes a list of
    per-shard tensors, shard ``s`` on ``mesh.devices[s]``, together its
    rows in order.  No active mesh returns the arrays untouched.  One array
    in, one result out, as in the JAX package.
    """
    mesh = active_mesh()
    if mesh is None:
        return arrays if len(arrays) != 1 else arrays[0]
    out = []
    for a in arrays:
        bounds = shard_bounds(int(a.shape[0]), mesh.size)
        out.append([_to_shard(a, r0, r1, d) for (r0, r1), d in zip(bounds, mesh.devices)])
    out = tuple(out)
    return out if len(out) != 1 else out[0]


def mesh_device(mesh, device=None) -> torch.device:
    """The primary device of a call: the first shard's under a mesh (where
    results are gathered), else :func:`..device.resolve_device`'s.  A
    ``device`` of another type than the mesh's shards raises ``ValueError``."""
    from ..device import resolve_device

    if mesh is None:
        return resolve_device(device)
    first = mesh.devices[0]
    if device is not None and torch.device(device).type != first.type:
        raise ValueError(
            f"device={device!r} names another device type than the mesh's "
            f"shards ({first.type}); with a mesh the devices come from the mesh"
        )
    return first
