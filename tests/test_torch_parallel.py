"""PyTorch port, the parallel layer: parity with the JAX package on the CPU.

Every entry point that takes ``mesh=`` runs on an 8-shard CPU mesh
(``make_mesh(8, device="cpu")``) and must equal the port's own solo run bit
for bit, and the JAX package's run on its 8-device virtual CPU mesh
(tests/conftest.py) within the tolerances of tests/test_mesh_apis.py:
scores at rtol 1e-6, coordinates, strands, ids, strings and qualities
exactly.  Then: shuffle-by-pregroup against tests/test_shuffle.py, the
pipeline step against tests/test_parallel.py, the padded consensus layout,
two real processes on gloo (tests/test_distributed.py's counterpart),
kernel B's wide route on the CPU, and the oracles copied into the port.
"""

import json
import os
import pathlib
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import sarlacc_tpu as jst  # noqa: E402
import sarlacc_tpu_torch as pst  # noqa: E402
from sarlacc_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from sarlacc_tpu_torch import parallel  # noqa: E402
from sarlacc_tpu_torch.parallel import shuffle as pshuffle  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ADAPTOR1 = "ACGCTAGCATCAGTC" + "NNNN" + "CACAGCTACGA" + "NNNNNNNN" + "CGTACGCAT"
ADAPTOR2 = "TGCATCGATCGCAT"
CPU = "cpu"


@pytest.fixture(scope="module")
def jmesh():
    return jax_make_mesh(8)


@pytest.fixture(scope="module")
def pmesh():
    return parallel.make_mesh(8, device=CPU)


@pytest.fixture(scope="module")
def workload():
    """tests/test_mesh_apis.py's workload (mock_reads seed 11, 6 molecules),
    read by both packages."""
    from sarlacc_tpu.io.fastq import read_fastq as jax_read

    fp = tempfile.mktemp(suffix=".fastq")
    try:
        pst.mock_reads(ADAPTOR1, ADAPTOR2, fp, nmolecules=6, nreads_range=(3, 6),
                       seqlen_range=(250, 420), seed=11)
        return jax_read(fp), pst.read_fastq(fp)
    finally:
        os.remove(fp)


@pytest.fixture(scope="module")
def aligned(workload):
    jbatch, pbatch = workload
    return (jst.adaptor_align(ADAPTOR1, ADAPTOR2, reads=jbatch, tolerance=120),
            pst.adaptor_align(ADAPTOR1, ADAPTOR2, reads=pbatch, tolerance=120, device=CPU))


def _frames_equal(a, b):
    """Every column of two port frames equal, nested frames and batches too."""
    assert a.colnames == b.colnames
    for c in a.colnames:
        x, y = a[c], b[c]
        if hasattr(x, "colnames"):
            _frames_equal(x, y)
        elif hasattr(x, "seq_strings"):
            assert x.seq_strings() == y.seq_strings() and x.qual_strings() == y.qual_strings()
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_make_mesh_and_context():
    mesh = parallel.make_mesh(8, device=CPU)
    assert mesh.size == 8 and mesh.shape == {"reads": 8}
    assert all(d == torch.device("cpu") for d in mesh.devices)
    assert parallel.mesh_size() == 1 and parallel.active_mesh() is None
    x = np.arange(10)
    assert parallel.shard_batch(x) is x  # no active mesh: a no-op
    with parallel.use_mesh(mesh):
        assert parallel.mesh_size() == 8 and parallel.pad_to_mesh(10) == 16
        parts = parallel.shard_batch(x)
        assert torch.cat(parts).tolist() == list(range(10))
        assert [len(p) for p in parts] == [1, 1, 1, 2, 1, 1, 1, 2]
    assert parallel.active_mesh() is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.make_mesh(2)
    with pytest.raises(ValueError, match="device type"):
        pst.umi_group(["ACGT", "ACGA"], mesh=mesh, device="cuda")


def test_adaptor_align_mesh(workload, aligned, jmesh, pmesh):
    jbatch, pbatch = workload
    jsolo, psolo = aligned
    jm = jst.adaptor_align(ADAPTOR1, ADAPTOR2, reads=jbatch, tolerance=120, mesh=jmesh)
    pm = pst.adaptor_align(ADAPTOR1, ADAPTOR2, reads=pbatch, tolerance=120, mesh=pmesh)
    _frames_equal(pm, psolo)
    for key in ("adaptor1", "adaptor2"):
        np.testing.assert_allclose(pm[key]["score"], jm[key]["score"], rtol=1e-6)
        for col in ("start", "end"):
            np.testing.assert_array_equal(pm[key][col], jm[key][col])
    np.testing.assert_array_equal(pm["reversed"], jm["reversed"])
    assert pm["adaptor1"]["subseq"]["Sub2"].seq_strings() == \
        jsolo["adaptor1"]["subseq"]["Sub2"].seq_strings()


def test_tune_alignment_mesh(workload, jmesh, pmesh):
    jbatch, pbatch = workload
    kw = dict(tolerance=100, gap_op_range=(4, 5), gap_ext_range=(1, 2))
    jm = jst.tune_alignment(ADAPTOR1, ADAPTOR2, reads=jbatch, mesh=jmesh, **kw)
    solo = pst.tune_alignment(ADAPTOR1, ADAPTOR2, reads=pbatch, device=CPU, **kw)
    pm = pst.tune_alignment(ADAPTOR1, ADAPTOR2, reads=pbatch, mesh=pmesh, **kw)
    assert pm["parameters"] == solo["parameters"] == jm["parameters"]
    for key in ("reads", "scrambled"):
        np.testing.assert_array_equal(pm["scores"][key], solo["scores"][key])
        np.testing.assert_allclose(pm["scores"][key], jm["scores"][key], rtol=1e-6)


def test_get_adaptor_thresholds_mesh(workload, aligned, jmesh, pmesh):
    jbatch, pbatch = workload
    jal, pal = aligned
    jm = jst.get_adaptor_thresholds(jal, error=0.1, reads=jbatch, mesh=jmesh)
    solo = pst.get_adaptor_thresholds(pal, error=0.1, reads=pbatch, device=CPU)
    pm = pst.get_adaptor_thresholds(pal, error=0.1, reads=pbatch, mesh=pmesh)
    for key in ("threshold1", "threshold2"):
        assert pm[key] == solo[key]
        assert pm[key] == pytest.approx(jm[key], rel=1e-6)
    for key in ("scores1", "scores2"):
        np.testing.assert_array_equal(pm[key]["scrambled"], solo[key]["scrambled"])
        np.testing.assert_allclose(pm[key]["scrambled"], jm[key]["scrambled"], rtol=1e-6)
    for key in ("histogram1", "histogram2"):
        assert pm[key].dtype == np.int32
        np.testing.assert_array_equal(pm[key], np.asarray(jm[key]).astype(np.int32))
        assert int(pm[key].sum()) == len(pbatch)
    assert "histogram1" not in solo


def _barcode_batch(pkg):
    rng = np.random.default_rng(3)
    barcodes = ["ACGTACGTAC", "TTGACCAGTA", "CAGGTTACCA"]
    seqs, quals = [], []
    for i in range(23):
        base = list(barcodes[i % 3])
        if i % 4 == 0:
            base[2] = "T" if base[2] != "T" else "A"
        seqs.append("".join(base))
        quals.append("".join(chr(int(c)) for c in rng.integers(40, 70, len(base))))
    return pkg.SeqBatch.from_strings(seqs, quals), barcodes


def test_barcode_align_mesh(jmesh, pmesh):
    from sarlacc_tpu.core import encode as jenc
    from sarlacc_tpu_torch.core import encode as penc

    jbatch, barcodes = _barcode_batch(jenc)
    pbatch, _ = _barcode_batch(penc)
    jm = jst.barcode_align(jbatch, barcodes, mesh=jmesh)
    solo = pst.barcode_align(pbatch, barcodes, device=CPU)
    pm = pst.barcode_align(pbatch, barcodes, mesh=pmesh)
    _frames_equal(pm, solo)
    np.testing.assert_array_equal(pm["barcode"], jm["barcode"])
    np.testing.assert_allclose(pm["score"], jm["score"], rtol=1e-6)
    np.testing.assert_allclose(pm["gap"], jm["gap"], rtol=1e-6)


def test_msa_and_consensus_mesh(workload, aligned, jmesh, pmesh):
    jbatch, pbatch = workload
    jal, pal = aligned
    jgroups = [g for g in jst.umi_group(jal["adaptor1"]["subseq"]["Sub2"], threshold1=2)
               if len(g) >= 2]
    umis = pal["adaptor1"]["subseq"]["Sub2"]
    groups = [g for g in pst.umi_group(umis, threshold1=2, device=CPU) if len(g) >= 2]
    mgroups = [g for g in pst.umi_group(umis, threshold1=2, mesh=pmesh) if len(g) >= 2]
    assert [g.tolist() for g in mgroups] == [g.tolist() for g in groups] == \
        [np.asarray(g).tolist() for g in jgroups]
    jreads = jst.realize_reads(jal, reads=jbatch, trim=False)
    preads = pst.realize_reads(pal, reads=pbatch, trim=False, device=CPU)

    jmsa = jst.multi_read_align(jreads, groups=jgroups, bandwidth=100, mesh=jmesh)
    solo = pst.multi_read_align(preads, groups=groups, bandwidth=100, device=CPU)
    pmsa = pst.multi_read_align(preads, groups=groups, bandwidth=100, mesh=pmesh)
    assert list(pmsa["alignments"]) == list(solo["alignments"]) == list(jmsa["alignments"])
    assert list(pmsa["qualities"]) == list(jmsa["qualities"])

    jcons = jst.consensus_read_seq(jmsa, mesh=jmesh)
    csolo = pst.consensus_read_seq(solo, device=CPU)
    pcons = pst.consensus_read_seq(pmsa, mesh=pmesh)
    assert pcons.seq_strings() == csolo.seq_strings() == jcons.seq_strings()
    assert pcons.qual_strings() == csolo.qual_strings() == jcons.qual_strings()


def test_extract_subseq_mesh(workload, aligned, jmesh, pmesh):
    jbatch, pbatch = workload
    jal, pal = aligned
    sections = ([16], [19])  # the first N-stretch of adaptor1
    jm = jst.extract_subseq(jal, subseq1=sections, reads=jbatch, mesh=jmesh)
    solo = pst.extract_subseq(pal, subseq1=sections, reads=pbatch, device=CPU)
    pm = pst.extract_subseq(pal, subseq1=sections, subseq2=([1], [6]), reads=pbatch, mesh=pmesh)
    _frames_equal(pm["adaptor1"], solo["adaptor1"])
    assert pm["adaptor1"]["Sub1"].seq_strings() == jm["adaptor1"]["Sub1"].seq_strings()
    assert pm["adaptor1"]["Sub1"].qual_strings() == jm["adaptor1"]["Sub1"].qual_strings()


def test_jax_frame_feeds_port_mesh(tmp_path, workload, aligned, jmesh, pmesh):
    """A frame JAX made, saved as .npz and loaded by the port, drives the
    port's mesh path to JAX's own mesh result."""
    from sarlacc_tpu.utils.serialize import save_frame as jax_save
    from sarlacc_tpu_torch.utils import load_frame

    jbatch, pbatch = workload
    jal, _ = aligned
    jax_save(jal, str(tmp_path / "aligned.npz"))
    frame = load_frame(str(tmp_path / "aligned.npz"))
    sections = ([31], [38])  # the 8-base UMI stretch
    got = pst.extract_subseq(frame, subseq1=sections, reads=pbatch, mesh=pmesh)
    want = jst.extract_subseq(jal, subseq1=sections, reads=jbatch, mesh=jmesh)
    assert got["adaptor1"]["Sub1"].seq_strings() == want["adaptor1"]["Sub1"].seq_strings()


# -- shuffle-by-pregroup ------------------------------------------------------


def _umis(n, seed, bases=("ACGTACGT", "TTGGCCAA", "GATCGATC", "CCATGGTA")):
    """tests/test_shuffle.py's UMIs."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        u = list(bases[i % len(bases)])
        for _ in range(int(rng.integers(0, 3))):
            u[int(rng.integers(0, len(u)))] = "ACGT"[int(rng.integers(0, 4))]
        out.append("".join(u))
    return out


def test_assign_pregroups_equal_jax():
    from sarlacc_tpu.parallel.shuffle import assign_pregroups as jax_assign

    rng = np.random.default_rng(17)
    for _ in range(50):
        sizes = rng.integers(1, 40, int(rng.integers(1, 30)))
        n_shards = int(rng.integers(1, 9))
        got = pshuffle.assign_pregroups(sizes, n_shards)
        np.testing.assert_array_equal(got, jax_assign(sizes, n_shards))
        assert got.dtype == np.int32 and got.min() >= 0 and got.max() < n_shards


def test_shuffle_by_pregroup_colocates_rows(pmesh):
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, (40, 8)).astype(np.int32)
    by_group = [np.arange(0, 13), np.arange(13, 20), np.arange(20, 40)]
    (blocks,), local_groups, budget = pshuffle.shuffle_by_pregroup(pmesh, by_group, codes)
    assert len(blocks) == pmesh.size and all(b.shape == (budget, 8) for b in blocks)
    seen = set()
    for s, groups_here in enumerate(local_groups):
        assert blocks[s].device == pmesh.devices[s]
        for gi, loc in groups_here:
            np.testing.assert_array_equal(blocks[s].numpy()[loc], codes[by_group[gi]])
            seen.add(gi)
    assert seen == {0, 1, 2}


@pytest.mark.parametrize("dual", [False, True])
def test_sharded_umi_group(pmesh, jmesh, dual):
    n = 96
    u1, u2 = _umis(n, seed=1), (_umis(n, seed=2) if dual else None)
    pre = [i % 5 for i in range(n)]
    kw = dict(threshold1=2, umi2=u2, threshold2=2, groups=pre)
    want = jst.umi_group(u1, mesh=jmesh, **kw)
    solo = pst.umi_group(u1, device=CPU, **kw)
    got = pst.umi_group(u1, mesh=pmesh, **kw)
    assert [g.tolist() for g in got] == [g.tolist() for g in solo] == \
        [np.asarray(g).tolist() for g in want]


def test_sharded_umi_group_rowblock(pmesh):
    """A pre-group of 2 100 30-bp UMIs takes the sparse path, where 30 bp
    is past the native filter's length, so its shard runs the row-block
    scan and clusters on the collapsed unique graph, as the solo run does;
    the small pre-groups beside it take the dense matrix.  Equal to the
    solo run."""
    import sarlacc_tpu_torch.ops.levenshtein as lev

    rng = np.random.default_rng(8)
    centres = rng.integers(0, 4, (300, 30))
    codes = centres[rng.integers(0, 300, 2160)]
    mut = rng.random(2160) < 0.3
    codes[mut, rng.integers(0, 30, 2160)[mut]] = rng.integers(0, 4, 2160)[mut]
    umis = ["".join("ACGT"[c] for c in row) for row in codes]
    pre = np.where(np.arange(2160) < 2100, 0, 1 + np.arange(2160) % 3)
    calls = []
    orig = lev._neighbor_pairs_rowblock

    def counting(*a, **k):
        calls.append(a[0].shape[0])
        return orig(*a, **k)

    lev._neighbor_pairs_rowblock = counting
    try:
        got = pst.umi_group(umis, threshold1=2, groups=pre, mesh=pmesh)
    finally:
        lev._neighbor_pairs_rowblock = orig
    assert calls, "the big pre-group should take the row-block scan"
    solo = pst.umi_group(umis, threshold1=2, groups=pre, device=CPU)
    assert [g.tolist() for g in got] == [g.tolist() for g in solo]


def test_grouping_to_msa_handoff(pmesh):
    from sarlacc_tpu_torch.core.encode import SeqBatch

    n = 48
    rng = np.random.default_rng(3)
    umis = _umis(n, seed=4)
    pre = [i % 3 for i in range(n)]
    fams = [g for g in pst.umi_group(umis, threshold1=2, groups=pre, mesh=pmesh) if g.size >= 2]
    assert fams
    reads = SeqBatch.from_strings(["".join(rng.choice(list("ACGT"), 30)) for _ in range(n)])
    ref = pst.multi_read_align(reads, groups=fams, bandwidth=10, device=CPU)
    out = pshuffle.sharded_pregroup_msa(pmesh, reads, fams, bandwidth=10)
    assert list(out["alignments"]) == list(ref["alignments"])
    assert "qualities" not in out and "qualities" not in ref


# -- the pipeline step ----------------------------------------------------------


@pytest.mark.parametrize("n", [8, 16])
def test_sharded_pipeline_step(entry_inputs, pmesh, jmesh, n):
    from sarlacc_tpu.parallel.mesh import shard_reads as jax_shard, sharded_pipeline_step as jax_step

    front, back, p1, p2, ucodes, ulens = entry_inputs(n)
    jf, jb, ju = jax_shard(jmesh, *front), jax_shard(jmesh, *back), jax_shard(jmesh, ucodes, ulens)
    jfinal, jrev, jhist, jdist = jax_step(jmesh, jf, jb, p1, p2, *ju, 5.0, 1.0)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a).astype(dtype))

    def arrays(x):
        return t(x[0], np.int8), t(x[1], np.int8), t(x[2], np.int32)

    tp1, tp2 = (tuple(t(a, d) for a, d in zip(p, (np.int32, bool, np.float32, np.float32)))
                for p in (p1, p2))
    final, rev, hist, dist = parallel.sharded_pipeline_step(
        pmesh, parallel.shard_reads(pmesh, *arrays(front)), arrays(back), tp1, tp2,
        np.asarray(ucodes), np.asarray(ulens), 5.0, 1.0,
    )
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), rtol=1e-6)
    np.testing.assert_array_equal(rev.numpy(), np.asarray(jrev))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jhist))
    assert hist.dtype == torch.int32 and int(hist.sum()) == n
    np.testing.assert_array_equal(dist.numpy(), np.asarray(jdist))
    assert dist.shape == (n, n) and np.all(np.diag(dist.numpy()) == 0)


@pytest.fixture(scope="module")
def entry_inputs():
    import importlib.util

    spec = importlib.util.spec_from_file_location("_graft_entry", HERE.parent / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def make(n):
        front, p1, p2, ucodes, ulens = mod._example_inputs(n_reads=n, tol=32)
        back, _, _, _, _ = mod._example_inputs(n_reads=n, tol=32, seed=1)
        return front, back, p1, p2, ucodes, ulens

    return make


# -- the padded consensus layout -------------------------------------------------


def _msas(rng, ngroups):
    groups, quals = [], []
    for _ in range(ngroups):
        g, w = int(rng.integers(1, 12)), int(rng.integers(1, 70))
        centre = rng.choice(list("ACGT"), w)
        rows = ["".join(np.where(rng.random(w) < 0.25, rng.choice(list("ACGTN-"), w), centre))
                for _ in range(g)]
        groups.append(rows)
        quals.append(["".join(chr(int(c)) for c in rng.integers(33, 75, len(r.replace("-", ""))))
                      for r in rows])
    return groups, quals


@pytest.mark.parametrize("with_quals", [True, False])
def test_padded_consensus(monkeypatch, pmesh, jmesh, with_quals):
    from sarlacc_tpu_torch.core.quality import errors_to_phred_string, get_encoding
    from sarlacc_tpu_torch.refimpl import consensus_basic, consensus_quality

    rng = np.random.default_rng(90 + with_quals)
    groups, quals = _msas(rng, 40)
    kw = dict(qualities=quals) if with_quals else dict(pseudo_count=0.5, min_coverage=0.3)
    flat = pst.consensus_read_seq(groups, device=CPU, **kw)
    monkeypatch.setenv("SARLACC_CONSENSUS_PADDED", "1")
    padded = pst.consensus_read_seq(groups, device=CPU, **kw)
    jax_padded = jst.consensus_read_seq(groups, **kw)
    on_mesh = pst.consensus_read_seq(groups, mesh=pmesh, **kw)
    for got in (padded, on_mesh):
        assert got.seq_strings() == flat.seq_strings() == jax_padded.seq_strings()
        assert got.qual_strings() == flat.qual_strings() == jax_padded.qual_strings()
    # The float64 anchor: the oracle, group by group.
    enc = get_encoding("phred")
    for i, rows in enumerate(groups):
        if with_quals:
            seq, err = consensus_quality(rows, 0.6, quals[i], enc)
            assert padded.seq_strings()[i] == seq
            assert padded.qual_strings()[i] == errors_to_phred_string(err)
        else:
            seq, _ = consensus_basic(rows, 0.3, 0.5)
            assert padded.seq_strings()[i] == seq


# -- two real processes ------------------------------------------------------------


def _tricky_fastq(path, n=203, seed=23):
    """tests/test_distributed.py's records: quality lines that often start
    with '@' or '+', lengths 1-69."""
    rng = np.random.default_rng(seed)
    seqs, quals, names = [], [], []
    for i in range(n):
        ln = int(rng.integers(1, 70))
        seqs.append("".join(rng.choice(list("ACGTN"), ln)))
        lead = "@" if i % 3 == 0 else ("+" if i % 3 == 1 else "J")
        quals.append(lead + "".join(chr(int(c)) for c in rng.integers(64, 90, ln - 1)) if ln > 1 else lead)
        names.append(f"r{i}")
    from sarlacc_tpu_torch.io.fastq import write_fastq

    write_fastq(path, seqs=seqs, quals=quals, names=names)


def test_two_process_distributed_parity(tmp_path):
    import torch.multiprocessing as mp

    from sarlacc_tpu.api.align_internal import prepare_adaptor as jax_prepare
    from sarlacc_tpu.io.fastq import read_fastq as jax_read
    from sarlacc_tpu.ops.align import dp_align, prepare_reads as jax_reads

    sys.path.insert(0, str(HERE))
    import torch_distributed_worker as worker

    fp = tmp_path / "tricky.fastq"
    _tricky_fastq(str(fp))
    outs = [tmp_path / f"rank{r}.json" for r in range(2)]
    ctx = mp.spawn(worker.run, args=(f"file://{tmp_path / 'rendezvous'}", str(fp), str(tmp_path)),
                   nprocs=2, join=False)
    deadline = time.monotonic() + 240
    while not ctx.join(timeout=5):  # a worker's failure raises here
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the two ranks did not finish within 240 s")
    res = [json.loads(o.read_text()) for o in outs]

    assert res[0]["names"] + res[1]["names"] == [f"r{i}" for i in range(203)]
    assert [r["offset"] for r in res] == [0, res[0]["n_local"]]
    assert res[0]["total"] == res[1]["total"] == 203
    assert res[0]["scores"] == res[1]["scores"] and len(res[0]["scores"]) == 203
    assert res[0]["hist"] == res[1]["hist"]

    # The single-process port and JAX's dp_align on the whole file.
    from sarlacc_tpu_torch.api.align_internal import prepare_adaptor
    from sarlacc_tpu_torch.ops.align import prepare_reads
    from sarlacc_tpu_torch.ops.cuda_align import fit_scores

    ad = prepare_adaptor(worker.ADAPTOR, device=CPU)
    whole = pst.read_fastq(str(fp), pad_to=80)
    solo = fit_scores(*prepare_reads(whole, ad.tables), ad.modes, ad.matched, ad.match_tab,
                      ad.mismatch_tab, 5.0, 1.0).numpy()
    jad = jax_prepare(worker.ADAPTOR)
    jcodes, jqidx, jlens = jax_reads(jax_read(str(fp), pad_to=80), jad.tables)
    want, _ = dp_align(jcodes, jqidx, jlens, jad.modes, jad.matched, jad.match_tab,
                       jad.mismatch_tab, 5.0, 1.0, local=True, need_directions=False)
    got = np.asarray(res[0]["scores"], np.float32)
    np.testing.assert_allclose(got, solo, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(res[0]["hist"]), worker.histogram(solo))

    # The pipeline step on the mesh spanning the ranks: each rank's rows of
    # one process's step, the histogram and the distance columns global.
    codes, qidx, lengths = prepare_reads(whole, ad.tables)
    final, rev, hist, dist = parallel.sharded_pipeline_step(
        parallel.make_mesh(1, device=CPU), (codes, qidx, lengths), (codes, qidx, lengths),
        worker.prep(ad), worker.prep(ad), *worker.umis(codes, lengths), 5.0, 1.0,
    )
    assert res[0]["step_hist"] == res[1]["step_hist"] == hist.tolist()
    for key, full in (("step_final", final), ("step_reversed", rev), ("step_dist", dist)):
        assert res[0][key] + res[1][key] == full.tolist(), key


# -- kernel B's wide route on the CPU -----------------------------------------------


def test_pair_wide_route_widths():
    from sarlacc_tpu_torch.ops import cuda_msa

    assert cuda_msa.pair_route(8192) == cuda_msa.pair_route(65536) == "wide"
    assert cuda_msa.pair_route(4096) == "block"
    args = [torch.zeros((2, 8), dtype=torch.int8)] * 2 + [torch.zeros(2, dtype=torch.int32)] * 4
    for width in (8192, 65536):
        # The width check passes; only the tensor check (CPU tensors) refuses.
        with pytest.raises(ValueError, match="on CUDA"):
            cuda_msa._launch_pair(*args, 0.0, -1.0, 5.0, 1.0, 8, width)
    for width in (12288, 131072):
        with pytest.raises(ValueError, match="power of two"):
            cuda_msa._launch_pair(*args, 0.0, -1.0, 5.0, 1.0, 8, width)


def test_multi_read_align_wide_band_equal_jax():
    """A 200-bp read against a 4.5-kb read: the band, |la - lb| + 2 * 100 +
    1 = 4 501 cells, buckets to 8 192 (kernel B's wide route on the card,
    the plain version here)."""
    from sarlacc_tpu.core.encode import SeqBatch as JaxBatch
    from sarlacc_tpu_torch.core.encode import SeqBatch
    from sarlacc_tpu_torch.ops.msa import _pair_buckets

    rng = np.random.default_rng(12)
    long = "".join(rng.choice(list("ACGT"), 4500))
    short = list(long[2000:2200])
    for p in rng.integers(0, 200, 6):
        short[p] = "ACGT"[(("ACGT".index(short[p])) + 1) % 4]
    seqs = ["".join(short), long]
    _, _, _, widths = _pair_buckets(np.array([200]), np.array([4500]), 100)
    assert widths.tolist() == [8192]
    got = pst.multi_read_align(SeqBatch.from_strings(seqs), groups=[[0, 1]], device=CPU)
    want = jst.multi_read_align(JaxBatch.from_strings(seqs), groups=[[0, 1]])
    assert list(got["alignments"]) == list(want["alignments"])
    assert got["alignments"][0][0].replace("-", "") == seqs[0]


# -- the oracles copied into the port --------------------------------------------------


def _oracle_cases():
    from sarlacc_tpu.core.quality import get_encoding as jenc
    from sarlacc_tpu_torch.core.quality import get_encoding as penc

    rng = np.random.default_rng(31)
    groups, quals = _msas(rng, 6)
    umis = _umis(30, seed=9) + ["ACGTNACG", "ACG", ""]
    return {
        "consensus_basic": lambda m: [m.consensus_basic(g, 0.6, 1.0) for g in groups],
        "consensus_quality": lambda m: [
            m.consensus_quality(g, 0.6, q, (jenc if m.__name__.startswith("sarlacc_tpu.") else penc)("phred"))
            for g, q in zip(groups, quals)
        ],
        "log1pexp": lambda m: [m.log1pexp(x) for x in (-50.0, -37.0, -1.0, 0.0, 18.0, 20.0, 33.3, 40.0)],
        "find_neighbors": lambda m: m.find_neighbors(umis, 2),
        "lev2_int": lambda m: [m.lev2_int(a, b) for a in umis[:8] for b in umis[-11:]],
        "lev_masked_condensed": lambda m: m.lev_masked_condensed(umis[:12] + umis[-3:]),
        "trie_dfs_order": lambda m: m.trie_dfs_order(umis),
    }


@pytest.mark.parametrize("name", list(_oracle_cases()))
def test_oracles_equal_jax_package(name):
    import importlib

    mod = "consensus" if name in ("consensus_basic", "consensus_quality", "log1pexp") else "levenshtein"
    case = _oracle_cases()[name]
    got = case(importlib.import_module(f"sarlacc_tpu_torch.refimpl.{mod}"))
    want = case(importlib.import_module(f"sarlacc_tpu.refimpl.{mod}"))
    assert repr(got) == repr(want)
    assert getattr(importlib.import_module("sarlacc_tpu_torch.refimpl"), name) is not None
