"""The plain reference against the program at a small size on the CPU
(the program's plain versions), and the control: the reference in
bfloat16, an MSA made without its consistency step, and an MSA that aligns
nothing, put in the program's place, must fail the check."""

import numpy as np
import pytest

from benchmark import run
from benchmark.generator import make_reads
from benchmark.reference import align as ref_align
from benchmark.trace import Spans

SMALL = {
    "umi_correction.deep_families": {"molecules": 2, "reads_per_molecule": [34, 40],
                                     "insert_length": [300, 400]},
    "barcode_demux.run_chunk": {"molecules": 24, "reads_per_molecule": [3, 6],
                                "insert_length": [300, 500]},
}
SEED = 2**31 + 977


@pytest.fixture(scope="module", params=sorted(SMALL))
def one_pass(request):
    _, config, mix, chain, _, _ = run.load_cell(request.param)
    mix.update(SMALL[request.param])
    if "calibration_reads" in config:
        config = dict(config, calibration_reads=40)
    inp = chain.make_inputs(config, mix, SEED, "cpu")
    out = chain.run_pass(inp, inp.batch, Spans(sync=False))
    return request.param, chain, inp, out


def test_program_meets_the_reference(one_pass):
    _, chain, inp, out = one_pass
    for name, value, limit in chain.check(inp, out, SEED, [out.digest()]):
        assert value <= limit, (name, value, limit)


def test_control_fails(one_pass):
    _, chain, inp, out = one_pass
    limits = inp.config["limits"]
    control = dict(chain.control(inp, out, SEED))
    failed = [n for n, v in control.items() if n in limits and v > limits[n]]
    assert failed, control
    assert control[next(n for n in control if n.endswith("score_gap"))] > 0.1
    if "msa_column_error" in control:  # the MSA without its consistency step aligns worse
        program = dict((n, v) for n, v, _ in chain.check(inp, out, SEED, [out.digest()]))
        assert control["msa_column_error"] > program["msa_column_error"]
        assert control["msa_column_error.unaligned"] > limits["msa_column_error"]


def test_reference_scores_are_the_programs():
    """Kernel C's plain version and the reference give equal float32 scores."""
    from sarlacc_tpu_torch.api.align_internal import align_scores_only, prepare_adaptor
    from sarlacc_tpu_torch.core.encode import SeqBatch

    cfg = {"adaptor1": "ACGTNNNNTTGCAAGGCTTAACCNNNNGG", "adaptor2": "TTTTGGGG"}
    mix = {"molecules": 4, "reads_per_molecule": [3, 5], "insert_length": [40, 80],
           "sub_rate": 0.05, "indel_rate": 0.01, "max_insert": 5, "flip_share": 0.0}
    r = make_reads(cfg, mix, 5, "cpu")
    ad = prepare_adaptor(cfg["adaptor1"])
    got = align_scores_only(ad, SeqBatch(r.codes, r.lengths, r.quals, r.names), 5, 1)
    want = ref_align.fit_scores(cfg["adaptor1"], r.codes, r.lengths, r.quals, 5.0, 1.0)
    assert np.array_equal(got, want)
