"""Shuffle-by-pregroup: co-locate each UMI pre-group on one shard.

Counterpart of ``sarlacc_tpu/parallel/shuffle.py``.  Grouping and MSA are
per-pre-group algorithms (the reference's ``split()`` factor,
R/umiGroup.R:13-19), so before them every pre-group must live wholly on one
shard:

* :func:`assign_pregroups`: deterministic longest-processing-time packing
  of pre-groups onto shards (largest group first, ties to the lower index;
  least-loaded shard, ties to the lower shard id; load ``size**2 + 1``).
* :func:`shuffle_by_pregroup`: the row permutation that realises it, and
  each shard's row block on the shard's device.
* :func:`sharded_umi_group`: the distributed ``umi_group``; each
  pre-group grouped on its shard's device by the solo path's per-group
  routine (``api/umi.py::_group_one``), merged back in the original
  pre-group order, so the output equals the solo run's.
* :func:`sharded_pregroup_msa`: each shard's families through
  ``multi_read_align`` on its device, merged in family order.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "assign_pregroups",
    "shuffle_by_pregroup",
    "sharded_umi_group",
    "sharded_pregroup_msa",
]


def assign_pregroups(sizes, n_shards: int) -> np.ndarray:
    """Deterministic LPT assignment: shard id per pre-group.

    Work per group is dominated by the O(g^2) neighbour search, so the load
    measure is ``size**2``; the order (largest first, ties by index; least
    loaded shard, ties by id) is fully deterministic.
    """
    sizes = np.asarray(sizes, dtype=np.int64)
    order = np.lexsort((np.arange(sizes.size), -sizes))
    load = np.zeros(n_shards, dtype=np.float64)
    shard_of = np.zeros(sizes.size, dtype=np.int32)
    for gi in order:
        s = int(np.argmin(load))  # argmin takes the first (lowest id) tie
        shard_of[gi] = s
        load[s] += float(sizes[gi]) ** 2 + 1.0
    return shard_of


def _plan(by_group, n_shards: int):
    """(perm, counts, local_groups) realising the LPT assignment.

    ``perm`` lists global read indices ordered by (shard, original group
    order, original within-group order); ``counts[s]`` is shard s's rows;
    ``local_groups[s]`` maps each of shard s's pre-groups to (original
    group index, local index array into the shard's block).
    """
    sizes = [g.size for g in by_group]
    shard_of = assign_pregroups(sizes, n_shards)
    perm_parts: list[np.ndarray] = []
    local_groups: list[list[tuple[int, np.ndarray]]] = [[] for _ in range(n_shards)]
    counts = np.zeros(n_shards, dtype=np.int64)
    for s in range(n_shards):
        at = 0
        for gi, g in enumerate(by_group):
            if shard_of[gi] != s:
                continue
            perm_parts.append(np.asarray(g, dtype=np.int64))
            local_groups[s].append((gi, np.arange(at, at + g.size, dtype=np.int64)))
            at += g.size
        counts[s] = at
    perm = np.concatenate(perm_parts) if perm_parts else np.zeros(0, dtype=np.int64)
    return perm, counts, local_groups


def shuffle_by_pregroup(mesh, by_group, *arrays):
    """Move batch-major ``arrays`` so each pre-group lands on one shard.

    Returns ``(sharded_arrays, local_groups, budget)``: ``sharded_arrays[k]``
    is a list of per-shard blocks, block ``s`` a tensor of ``budget`` rows
    on ``mesh.devices[s]``, and ``local_groups[s]`` is the shard's
    pre-group structure from :func:`_plan` (indices into its block).
    Padding rows repeat row 0 and are never addressed.
    """
    perm, counts, local_groups = _plan(by_group, mesh.size)
    budget = max(int(counts.max(initial=0)), 1)
    out = [[] for _ in arrays]
    at = 0
    for s, dev in enumerate(mesh.devices):
        c = int(counts[s])
        rows = np.zeros(budget, dtype=np.int64)
        rows[:c] = perm[at : at + c]
        at += c
        for k, a in enumerate(arrays):
            out[k].append(torch.as_tensor(np.asarray(a)[rows], device=dev))
    return tuple(out), local_groups, budget


def sharded_umi_group(
    mesh,
    b1,
    threshold1: int,
    by_group,
    b2=None,
    threshold2: int | None = None,
):
    """Distributed ``umi_group``: pre-groups placed on shards by
    :func:`assign_pregroups`, per-shard grouping, deterministic merge.

    Each pre-group is grouped on its shard's device by the solo path's own
    per-group routine (``api/umi.py::_group_one``: the neighbour search,
    row-block scan included, and the greedy clusterer).  The cluster list
    comes out in original pre-group order and, within a pre-group, in
    greedy emission order: equal to ``umi_group`` without a mesh.
    """
    from ..api.umi import _group_one

    if threshold2 is None:
        threshold2 = threshold1
    shard_of = assign_pregroups([g.size for g in by_group], mesh.size)
    results: dict[int, list[np.ndarray]] = {}
    for s, dev in enumerate(mesh.devices):
        for gi in np.flatnonzero(shard_of == s):
            g = by_group[gi]
            if g.size == 1:
                results[gi] = [np.asarray(g, dtype=np.int64)]
                continue
            c2 = b2.codes[g].astype(np.int32) if b2 is not None else None
            l2 = b2.lengths[g] if b2 is not None else None
            results[gi] = [
                np.asarray(g, dtype=np.int64)[cl]
                for cl in _group_one(b1.codes[g].astype(np.int32), b1.lengths[g], threshold1,
                                     dev, c2, l2, threshold2)
            ]

    output: list[np.ndarray] = []
    for gi in range(len(by_group)):
        output.extend(results.get(gi, []))
    return output


def sharded_pregroup_msa(mesh, reads, groups, **kwargs):
    """Per-shard MSA over co-located groups, merged in original group order.

    The grouping -> MSA handoff: each shard aligns its own families with
    ``multi_read_align`` on its device, and the per-group alignment lists
    merge back into the global family order, so the result equals the solo
    ``multi_read_align(reads, groups=families)`` call.  A ``device`` among
    ``kwargs`` must be of the shards' type.
    """
    from ..api.msa import multi_read_align
    from ..core.frame import Frame
    from .context import mesh_device

    mesh_device(mesh, kwargs.pop("device", None))
    by_group = [np.asarray(g, dtype=np.int64) for g in groups]
    shard_of = assign_pregroups([g.size for g in by_group], mesh.size)

    alignments: list = [None] * len(by_group)
    qualities: list = [None] * len(by_group)
    has_quals = False
    for s, dev in enumerate(mesh.devices):
        mine = [gi for gi in range(len(by_group)) if shard_of[gi] == s]
        if not mine:
            continue
        sub = multi_read_align(reads, groups=[by_group[gi] for gi in mine], device=dev, **kwargs)
        for k, gi in enumerate(mine):
            alignments[gi] = sub["alignments"][k]
            if "qualities" in sub:
                has_quals = True
                qualities[gi] = sub["qualities"][k]

    out = Frame(nrow=len(by_group))
    out["alignments"] = alignments
    if has_quals:
        out["qualities"] = qualities
    return out
