"""Device meshes and the data-parallel score steps.

Counterpart of ``sarlacc_tpu/parallel/mesh.py``.  The reference's only
parallelism is share-nothing data parallelism over reads through
BiocParallel (R/adaptorAlign.R:126-134); here a :class:`Mesh` is an ordered
tuple of shards, each a ``torch.device``, along one axis (``"reads"``):

* **reads axis**: a batch splits into per-shard row blocks, each runs the
  kernel the solo path runs on its shard's device, and the results come
  back in row order on the first shard's device;
* **collectives**: JAX's ``psum`` becomes a sum of the shards' int32
  histograms, its ``all_gather`` a concatenation; a mesh from
  :func:`..parallel.distributed.global_mesh` spans processes, and then the
  histograms are summed and the UMIs gathered over the process group too.

Several shards may share one card (``make_mesh(4)`` on one H100 gives four
shards on ``cuda:0``, as the JAX tests run eight virtual CPU devices); they
run one after another.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops.cuda_align import fit_scores
from ..ops.levenshtein import _lev2_block
from .context import shard_batch, use_mesh

__all__ = ["Mesh", "make_mesh", "shard_reads", "sharded_adaptor_scores", "sharded_pipeline_step"]

READS_AXIS = "reads"


@dataclass(frozen=True)
class Mesh:
    """Shards along one named axis.

    ``devices``: this process's shards, in order (a device may repeat);
    ``processes``: how many processes the mesh spans (1 unless it comes
    from :func:`..parallel.distributed.global_mesh`).
    """

    devices: tuple
    axis_names: tuple = (READS_AXIS,)
    processes: int = 1

    @property
    def size(self) -> int:
        """This process's shards."""
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: self.size}


def make_mesh(n_devices: int | None = None, axis: str = READS_AXIS, device=None) -> Mesh:
    """``n_devices`` shards placed round-robin over the devices of a type.

    ``device=None`` means CUDA (and raises without a card, as every entry
    point does); ``device="cpu"`` places every shard on the one CPU device,
    which is how the tests run (``make_mesh(8, device="cpu")``).  A device
    with an index (``"cuda:1"``) holds every shard itself.  ``n_devices=None``
    takes one shard a device of the type.
    """
    dev = resolve_device(device)
    if dev.index is not None:
        avail = [dev]
    elif dev.type == "cuda":
        avail = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        avail = [torch.device(dev.type)]
    n = len(avail) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard (n_devices={n_devices})")
    return Mesh(tuple(avail[i % len(avail)] for i in range(n)), (axis,))


def _split(mesh: Mesh, a) -> list:
    """Per-shard tensors of a batch-major array, or ``a`` itself when it is
    already a list of them (from :func:`shard_reads`)."""
    if isinstance(a, (list, tuple)):
        if len(a) != mesh.size:
            raise ValueError(f"{len(a)} shards given for a mesh of {mesh.size}")
        return [torch.as_tensor(x).to(d) for x, d in zip(a, mesh.devices)]
    with use_mesh(mesh):
        return shard_batch(a)


def shard_reads(mesh: Mesh, *arrays):
    """Split batch-major arrays over the mesh: one list of per-shard
    tensors (shard ``s`` on ``mesh.devices[s]``) for each array."""
    return tuple(_split(mesh, a) for a in arrays)


def _four_scores_local(front, back, prep1, prep2, go, ge, device):
    """START/END/RSTART/REND fitting scores for one shard, kernel C on the
    card and the plain score DP on the CPU (float32 [n] each; an empty
    shard launches nothing)."""

    def run(prep, arrays):
        if arrays[2].numel() == 0:
            return torch.zeros(0, dtype=torch.float32, device=device)
        modes, matched, mt, mmt = (t.to(device) for t in prep)
        return fit_scores(*arrays, modes, matched, mt, mmt, go, ge, local=True)

    return run(prep1, front), run(prep2, back), run(prep1, back), run(prep2, front)


def _resolve(s_start, s_end, s_rstart, s_rend):
    """R/adaptorAlign.R:112-122 in float32: (fscore, rscore, reversed)."""
    fscore = torch.clamp(s_start, min=0) + torch.clamp(s_end, min=0)
    rscore = torch.clamp(s_rstart, min=0) + torch.clamp(s_rend, min=0)
    return fscore, rscore, fscore < rscore


def _hist(idx: torch.Tensor, bins: int) -> torch.Tensor:
    return torch.bincount(idx.to(torch.int64), minlength=bins).to(torch.int32)


def _sum_over(mesh: Mesh, parts: list) -> torch.Tensor:
    """JAX's ``psum``: the shards' int32 tensors summed on the first shard's
    device, then over the process group when the mesh spans processes."""
    dev = mesh.devices[0]
    total = torch.zeros_like(parts[0], device=dev)
    for p in parts:
        total += p.to(dev)
    if mesh.processes > 1:
        from .distributed import all_reduce_sum

        total = all_reduce_sum(total)
    return total


def _cat(mesh: Mesh, parts: list) -> torch.Tensor:
    return torch.cat([p.to(mesh.devices[0]) for p in parts])


def sharded_adaptor_scores(
    mesh: Mesh,
    front_arrays,  # (codes, qidx, lengths) for read fronts
    back_arrays,  # (codes, qidx, lengths) for RC'd read backs
    prep1,  # (modes, matched, match_tab, mismatch_tab) adaptor1
    prep2,
    gap_opening: float,
    gap_extension: float,
    hist_bins: int = 64,
    hist_range: tuple[float, float] = (-100.0, 100.0),
):
    """Data-parallel strand-resolved adaptor scores + summed global histograms.

    Returns (score1 [N] f32, score2 [N] f32, reversed [N] bool, hist1
    [bins] int32, hist2 [bins] int32), all on the first shard's device.
    ``score1``/``score2`` are the per-adaptor scores in the resolved
    orientation (what ``get_adaptor_thresholds`` feeds its FDR computation,
    R/getAdaptorThresholds.R:105-128).  A histogram bin is the float32
    ``(s - lo) / (hi - lo) * bins`` truncated toward zero and clipped; rows
    whose ends both have length 0 are left out.  Under a mesh that spans
    processes the histograms cover every process's rows and the scores
    stay this process's own.
    """
    fronts = [_split(mesh, a) for a in front_arrays]
    backs = [_split(mesh, a) for a in back_arrays]
    lo, hi = hist_range
    out = {k: [] for k in ("s1", "s2", "rev", "h1", "h2")}
    for s, dev in enumerate(mesh.devices):
        front = tuple(a[s] for a in fronts)
        back = tuple(a[s] for a in backs)
        s_start, s_end, s_rstart, s_rend = _four_scores_local(
            front, back, prep1, prep2, float(gap_opening), float(gap_extension), dev
        )
        _, _, rev = _resolve(s_start, s_end, s_rstart, s_rend)
        score1 = torch.where(rev, s_rstart, s_start)
        score2 = torch.where(rev, s_rend, s_end)
        valid = (front[2] > 0) | (back[2] > 0)

        def hist_of(x):
            idx = ((x - lo) / (hi - lo) * hist_bins).to(torch.int32).clamp(0, hist_bins - 1)
            return _hist(idx[valid], hist_bins)

        out["s1"].append(score1)
        out["s2"].append(score2)
        out["rev"].append(rev)
        out["h1"].append(hist_of(score1))
        out["h2"].append(hist_of(score2))
    return (
        _cat(mesh, out["s1"]), _cat(mesh, out["s2"]), _cat(mesh, out["rev"]),
        _sum_over(mesh, out["h1"]), _sum_over(mesh, out["h2"]),
    )


def sharded_pipeline_step(
    mesh: Mesh,
    front_arrays,
    back_arrays,
    prep1,
    prep2,
    umi_codes,  # [N, LU] int32 per-read UMI codes
    umi_lengths,  # [N]
    gap_opening: float,
    gap_extension: float,
):
    """One full data-parallel pipeline step, for multi-shard validation.

    Covers every communication pattern the pipeline needs: batch-parallel DP
    (no communication), a summed score histogram, and a gather of every
    shard's UMIs so each shard computes its block of the cross-shard UMI
    distance matrix (each shard's UMIs against all UMIs, the distributed
    ``umi_group`` ingredient).  Returns (final_scores [N] f32, reversed [N],
    hist [64] int32, dist [N, N] int32): the shards' rows in order on the
    first shard's device.  Under a mesh that spans processes the histogram
    and the distance columns cover every process's reads.
    """
    fronts = [_split(mesh, a) for a in front_arrays]
    backs = [_split(mesh, a) for a in back_arrays]
    ucodes = _split(mesh, np.array(umi_codes, np.int32))
    ulens = _split(mesh, np.array(umi_lengths, np.int32))
    all_u = _cat(mesh, ucodes)
    all_l = _cat(mesh, ulens)
    if mesh.processes > 1:
        from .distributed import all_gather_rows

        all_u, all_l = all_gather_rows(all_u), all_gather_rows(all_l)
    bins = 64
    finals, revs, hists, blocks = [], [], [], []
    for s, dev in enumerate(mesh.devices):
        front = tuple(a[s] for a in fronts)
        back = tuple(a[s] for a in backs)
        fscore, rscore, rev = _resolve(*_four_scores_local(
            front, back, prep1, prep2, float(gap_opening), float(gap_extension), dev
        ))
        final = torch.where(rev, rscore, fscore)
        idx = ((final + 100.0) / 200.0 * bins).to(torch.int32).clamp(0, bins - 1)
        finals.append(final)
        revs.append(rev)
        hists.append(_hist(idx, bins))
        cb, lb = all_u.to(dev), all_l.to(dev)
        blocks.append(_lev2_block(ucodes[s], ulens[s], cb, lb))
    return _cat(mesh, finals), _cat(mesh, revs), _sum_over(mesh, hists), _cat(mesh, blocks)
