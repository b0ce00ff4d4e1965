"""Measurement entry points of the port, run on the card as

    python -m sarlacc_tpu_torch.tools.<name> [args]

Each is the counterpart of one TPU script in ``scripts/`` and takes its
arguments and defaults:

* :mod:`.profile_demux` (``scripts/profile_demux_tpu.py``): the demux score
  path split into stages (upload, planes, kernel C, readback, barcodes);
* :mod:`.score_ablation` (``scripts/microbench_score_ablation.py``): kernel
  C with its row state, cost-plane reads or vertical-gap max ablated;
* :mod:`.op_mix` (``scripts/microbench_op_mix.py``): dependent chains per
  instruction class, and the ALU ceilings of the score DP's cell bodies;
* :mod:`.op_rates` (``scripts/microbench_vpu_ops.py``): independent chains
  for per-class throughput, and a shuffle's cost in add slots.

Each function takes ``device=`` (``None`` means CUDA).  On the CPU the
kernels' plain versions run, for rehearsal at small sizes only: times there
are host-clock CPU times and say so.

:mod:`.score_tiles` and :mod:`.dir_tiles` have no TPU counterpart: they
sweep kernels C and D's, and kernel A's, compiled tile widths, lanes a read
(A) and register budgets, so they need the card.  So does
:mod:`.kernel_turns`, which times kernels A and B of several checkouts (say
the parent commit's and this one's) in turns on the same inputs.
"""
