"""Measurement entry points of the port, run on the card as

    python -m sarlacc_tpu_torch.tools.<name> [args]

Each is the counterpart of one TPU script in ``scripts/`` and takes its
arguments and defaults:

* :mod:`.profile_demux` (``scripts/profile_demux_tpu.py``): the demux score
  path split into stages (upload, planes, kernel C, readback, barcodes);
* :mod:`.score_ablation` (``scripts/microbench_score_ablation.py``): kernel
  C's own body with its vertical-gap max, its per-cell cost reads or its
  per-row loads ablated;
* :mod:`.op_mix` (``scripts/microbench_op_mix.py``): dependent chains per
  instruction class, and the ALU ceilings of the score DP's cell bodies;
* :mod:`.op_rates` (``scripts/microbench_vpu_ops.py``): independent chains
  for per-class throughput, and a shuffle's cost in add slots.
* :mod:`.msa_scale_mem` (``scripts/probe_msa_scale_mem.py``):
  ``multi_read_align`` on bench-shaped groups in slices, with wall time,
  host RSS, the card's peak allocation and the ``msa.*`` stages a slice;
* :mod:`.bench_500k` (``scripts/run_bench_500k.py``): the correction
  pipeline at ~522 000 reads, each stage printed as it ends, with the
  host's and the card's peak memory;
* :mod:`.profile_msa_scale` (``scripts/profile_msa_scale.py``):
  ``multi_read_align`` at 10 000 groups and its host orchestration share;
* :mod:`.profile_pipeline` (``scripts/profile_pipeline_tpu.py``): the
  pipeline's stage seconds and the stage profiler's report;
* :mod:`.profile_consensus` (``scripts/profile_consensus.py``):
  ``consensus_read_seq``'s encode / pack / dispatch / readback / assemble;
* :mod:`.profile_umi_host` (``scripts/profile_umi_host.py``):
  ``umi_group``'s large-n path stage by stage, and UMIs/s;
* :mod:`.merge_wave` (``scripts/microbench_merge_wave.py``): a merge
  wave's entry decode and sort, and kernel E, on a 20 M-entry wave;
* :mod:`.pair_stage` (``scripts/microbench_pair_stage.py``): kernel B, F's
  walk and identities, and the jmat readback on one bucket;
* :mod:`.scatter_gather` (``scripts/microbench_scatter_gather.py``):
  PyTorch's scatter-add and gather rates (library calls, no kernel of
  ours);
* :mod:`.score_kernel` (``scripts/microbench_score_kernel.py``): kernel C
  at 100 000 reads and kernel A against its plain version, then the tile
  sweeps of :mod:`.score_tiles` and :mod:`.dir_tiles`.

:mod:`.workload` is the port's copy of ``bench.py``'s ``build_workload``
and ``run_pipeline``, which ``bench_500k`` and ``profile_pipeline`` run.

Each function takes ``device=`` (``None`` means CUDA).  On the CPU the
kernels' plain versions run, for rehearsal at small sizes only: times there
are host-clock CPU times and say so.

:mod:`.score_tiles` and :mod:`.dir_tiles` have no TPU counterpart: they
sweep kernels C and D's, and kernel A's, compiled tile widths, lanes a read
(A) and register budgets, so they need the card.  So does
:mod:`.kernel_turns`, which times kernels A and B of several checkouts (say
the parent commit's and this one's) in turns on the same inputs.
"""
