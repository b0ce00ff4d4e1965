"""PyTorch port, the whole correction pipeline on the CPU.

The seed-locked golden snapshot of test_golden_pipeline.py, produced by the
JAX package, must come out byte for byte through the port's five entry
points.  The port must import without JAX, and every entry point must
refuse to run when CUDA is asked for (``device=None``) but absent.
"""

import json
import os
import pathlib
import subprocess
import sys
import tempfile

import pytest
import torch

torch.set_num_threads(1)

import sarlacc_tpu_torch as st  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden" / "pipeline_mock.json"
ADAPTOR1 = "ACGCTAGCATCAGTC" + "NNNN" + "CACAGCTACGA" + "NNNNNNNN" + "CGTACGCAT"
ADAPTOR2 = "TGCATCGATCGCAT"


def _golden_batch():
    fp = tempfile.mktemp(suffix=".fastq")
    try:
        st.mock_reads(
            ADAPTOR1, ADAPTOR2, fp, nmolecules=10, nreads_range=(4, 9),
            seqlen_range=(350, 600), seed=20240817,
        )
        return st.read_fastq(fp)
    finally:
        os.remove(fp)


def test_golden_snapshot_through_port():
    batch = _golden_batch()
    dev = "cpu"
    aligned = st.adaptor_align(ADAPTOR1, ADAPTOR2, reads=batch, tolerance=250, device=dev)
    umis = aligned["adaptor1"]["subseq"]["Sub2"]
    groups = st.umi_group(umis, threshold1=2, device=dev)
    filt = [g for g in groups if len(g) >= 2]
    reads = st.realize_reads(aligned, reads=batch, trim=False, device=dev)
    msa = st.multi_read_align(reads, groups=filt, bandwidth=100, device=dev)
    cons = st.consensus_read_seq(msa, device=dev)
    snap = {
        "n_reads": int(len(batch)),
        "adaptor1_score": [round(float(s), 4) for s in aligned["adaptor1"]["score"]],
        "adaptor1_start": [int(x) for x in aligned["adaptor1"]["start"]],
        "adaptor1_end": [int(x) for x in aligned["adaptor1"]["end"]],
        "adaptor2_score": [round(float(s), 4) for s in aligned["adaptor2"]["score"]],
        "adaptor2_start": [int(x) for x in aligned["adaptor2"]["start"]],
        "adaptor2_end": [int(x) for x in aligned["adaptor2"]["end"]],
        "reversed": [bool(r) for r in aligned["reversed"]],
        "umi": umis.seq_strings(),
        "groups": [[int(i) for i in g] for g in groups],
        "alignments": [list(a) for a in msa["alignments"]],
        "consensus_seq": cons.seq_strings(),
        "consensus_qual": cons.qual_strings(),
    }
    want = json.loads(GOLDEN.read_text())
    assert sorted(snap) == sorted(want)
    for key in want:
        assert snap[key] == want[key], f"golden mismatch in {key!r}"


def test_import_pulls_in_no_jax():
    code = (
        "import sys; import sarlacc_tpu_torch; "
        "import sarlacc_tpu_torch.ops.cuda_align, sarlacc_tpu_torch.ops.cuda_msa; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'sarlacc_tpu')); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stdout + out.stderr


def _entry_points(batch):
    aligned_cpu = st.adaptor_align(ADAPTOR1, ADAPTOR2, reads=batch.take(range(6)), device="cpu")
    umis = aligned_cpu["adaptor1"]["subseq"]["Sub2"]
    return [
        lambda: st.adaptor_align(ADAPTOR1, ADAPTOR2, reads=batch),
        lambda: st.umi_group(umis, threshold1=2),
        lambda: st.realize_reads(aligned_cpu, reads=batch.take(range(6)), trim=False),
        lambda: st.multi_read_align(batch.take(range(4))),
        lambda: st.consensus_read_seq([["ACGT", "ACGA"]]),
    ]


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    batch = _golden_batch()
    for call in _entry_points(batch):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert '"ok"' not in out.stdout


def test_native_library_builds_into_package():
    from sarlacc_tpu_torch.native import get_lib
    from sarlacc_tpu_torch.native.build import BUILD_DIR

    lib = get_lib()
    assert os.path.dirname(lib._name) == BUILD_DIR
    assert BUILD_DIR.endswith(os.path.join("sarlacc_tpu_torch", "_build"))
