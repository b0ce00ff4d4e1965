"""One rank of the port's two-process gloo run (tests/test_torch_parallel.py).

Each rank joins the process group through a ``file://`` rendezvous, streams
its byte range of the FASTQ, scores its reads against the adaptor with the
plain score DP, sums a 21-bin score histogram over the group and gathers
every rank's scores, runs ``sharded_pipeline_step`` on the mesh that spans
the ranks (its first eight bases as the UMI), then writes ``rank<r>.json``
into the output directory.  Imports the port only.
"""

import json
import os

import numpy as np
import torch

ADAPTOR = "ACGTACGTAANNNNNTTGCAGCATT"
EDGES = np.linspace(-50.0, 50.0, 21, dtype=np.float32)


def histogram(scores) -> list:
    """21 bins: ``searchsorted`` of the float32 scores into :data:`EDGES`."""
    idx = np.clip(np.searchsorted(EDGES, np.asarray(scores, np.float32)), 0, 20)
    return np.bincount(idx, minlength=21).tolist()


def prep(ad):
    """An adaptor's (modes, matched, match_tab, mismatch_tab)."""
    return ad.modes, ad.matched, ad.match_tab, ad.mismatch_tab


def umis(codes, lengths):
    """Each read's first eight bases as its UMI: (codes int32, lengths)."""
    return codes[:, :8].to(torch.int32), lengths.clamp(max=8)


def run(rank: int, rendezvous: str, fastq: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    from sarlacc_tpu_torch.api.align_internal import prepare_adaptor
    from sarlacc_tpu_torch.core.encode import SeqBatch
    from sarlacc_tpu_torch.io.fastq import stream_fastq
    from sarlacc_tpu_torch.ops.align import prepare_reads
    from sarlacc_tpu_torch.ops.cuda_align import fit_scores
    from sarlacc_tpu_torch.parallel import (
        global_mesh, host_local_batch_to_global, host_shard, init_distributed, is_distributed,
        sharded_pipeline_step,
    )
    from sarlacc_tpu_torch.parallel.distributed import all_gather_rows, all_reduce_sum

    assert init_distributed(rendezvous, 2, rank, backend="gloo") == (rank, 2)
    try:
        assert is_distributed() and host_shard() == (rank, 2)
        mesh = global_mesh(device="cpu")
        batch = SeqBatch.concat(list(stream_fastq(fastq, shard=host_shard(), pad_to=80)))
        ad = prepare_adaptor(ADAPTOR, device="cpu")
        codes, qidx, lengths = prepare_reads(batch, ad.tables)
        (rows,) = host_local_batch_to_global(mesh, lengths)
        scores = fit_scores(codes, qidx, lengths, ad.modes, ad.matched, ad.match_tab,
                            ad.mismatch_tab, 5.0, 1.0)
        hist = all_reduce_sum(torch.tensor(histogram(scores.numpy()), dtype=torch.int64))
        gathered = all_gather_rows(scores)
        final, rev, step_hist, dist = sharded_pipeline_step(
            mesh, (codes, qidx, lengths), (codes, qidx, lengths), prep(ad), prep(ad),
            *umis(codes, lengths), 5.0, 1.0,
        )
        out = {
            "names": list(batch.names or []),
            "n_local": len(batch),
            "offset": rows.offset,
            "total": rows.total,
            "hist": hist.tolist(),
            "scores": gathered.tolist(),
            "step_final": final.tolist(),
            "step_reversed": rev.tolist(),
            "step_hist": step_hist.tolist(),
            "step_dist": dist.tolist(),
        }
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)
    finally:
        torch.distributed.destroy_process_group()


def run_cards(rank: int, rendezvous: str, fastq: str, out_dir: str, nprocs: int) -> None:
    """One rank of a run with a card a rank (the default backend, NCCL):
    scores its byte range's ends through ``sharded_adaptor_scores`` on the
    mesh spanning the ranks; rank 0 holds the gathered scores and summed
    histograms to one process's and writes ``cards.json``."""
    from sarlacc_tpu_torch.api.align_internal import prepare_adaptor
    from sarlacc_tpu_torch.core.encode import SeqBatch
    from sarlacc_tpu_torch.io.fastq import read_fastq, stream_fastq
    from sarlacc_tpu_torch.ops.align import prepare_reads
    from sarlacc_tpu_torch.parallel import (
        global_mesh, host_shard, init_distributed, make_mesh, sharded_adaptor_scores,
    )
    from sarlacc_tpu_torch.parallel.distributed import all_gather_rows

    assert init_distributed(rendezvous, nprocs, rank) == (rank, nprocs)
    try:
        backend = torch.distributed.get_backend()
        mesh = global_mesh()
        dev = mesh.devices[0]
        ad = prepare_adaptor(ADAPTOR, device=dev)

        def scores(m, batch):
            front, back = batch.front_and_back(40)
            return sharded_adaptor_scores(m, prepare_reads(front, ad.tables, device=dev),
                                          prepare_reads(back, ad.tables, device=dev),
                                          prep(ad), prep(ad), 5.0, 1.0)

        s1, s2, rev, h1, h2 = scores(mesh, SeqBatch.concat(list(stream_fastq(fastq, shard=host_shard()))))
        got = [all_gather_rows(x).cpu() for x in (s1, s2, rev)]
        if rank == 0:
            want = scores(make_mesh(1, device=dev), read_fastq(fastq))
            out = {
                "backend": backend,
                "device": str(dev),
                "equal": all(torch.equal(g, w.cpu()) for g, w in zip(got, want))
                and torch.equal(h1.cpu(), want[3].cpu()) and torch.equal(h2.cpu(), want[4].cpu()),
            }
            with open(os.path.join(out_dir, "cards.json"), "w") as fh:
                json.dump(out, fh)
    finally:
        torch.distributed.destroy_process_group()
