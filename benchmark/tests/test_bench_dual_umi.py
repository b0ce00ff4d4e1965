"""The ``dual_umi_amplicon`` configuration on the CPU at a small size: the
program's dual-UMI grouping past ``SPARSE_MIN`` (lowered), on the plain
row-block route at 18-nt UMIs, equals the plain reference's; a grouping
that ignores the second UMI, leaves every read alone or splits one group is
not correct; the reads carry both UMIs by their pattern; the reference runs
with nothing of the program or of JAX loaded; kernel I's bound is the
larger of its two terms."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark import run
from benchmark.configs import dual_umi_amplicon as dual
from benchmark.lev2_roofline import scan_bound_s
from benchmark.reference import dual_cluster
from benchmark.roofline import PEAK_BYTES, PEAK_F32
from benchmark.trace import Spans

CELL = "dual_umi_amplicon.one_locus"
SMALL = {"molecules": 12, "reads_per_molecule": [8, 20], "insert_length": [300, 400],
         "warm_every": 5}
SEED = 2**31 + 6007
#: Below the reads of SMALL's pass and of its warm-up slice: both take the
#: sparse path.
SPARSE_MIN = 16
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def sparse(monkeypatch):
    from sarlacc_tpu_torch.api import umi

    monkeypatch.setattr(umi, "SPARSE_MIN", SPARSE_MIN)


@pytest.fixture(scope="module")
def one_pass():
    """Inputs and one pass of the program with its stage profiler's counters."""
    from sarlacc_tpu_torch.api import umi
    from sarlacc_tpu_torch.utils import profiling

    _, config, mix, chain, _, _ = run.load_cell(CELL)
    mix.update(SMALL)
    inp = chain.make_inputs(config, mix, SEED, "cpu")
    saved_min, saved_prof = umi.SPARSE_MIN, profiling.get_profiler()
    prof = profiling.PipelineProfiler()
    umi.SPARSE_MIN = SPARSE_MIN
    profiling.set_profiler(prof)
    try:
        out = chain.run_pass(inp, inp.batch, Spans(sync=False))
    finally:
        umi.SPARSE_MIN = saved_min
        profiling.set_profiler(saved_prof)
    return chain, inp, out, prof.counters


def test_program_equals_the_reference(one_pass):
    """Group for group, in emission order, on the row-block route."""
    _, inp, out, counters = one_pass
    u1, u2 = inp.batch
    assert len(inp.reads) > 4 * SPARSE_MIN
    assert counters["umi.route.rowblock"] == 2 and "umi.route.dense" not in counters
    assert int(u1.lengths.max()) >= 18 and int(u2.lengths.max()) >= 18
    want = dual_cluster.dual_groups(u1.codes, u1.lengths, u2.codes, u2.lengths, 3, 3)
    got = [frozenset(int(i) for i in g) for g in out.groups]
    assert got == want
    assert sum(len(g) > 1 for g in want) >= 8  # families, not singletons


def test_check_passes_and_control_fails(one_pass):
    chain, inp, out, _ = one_pass
    numbers = chain.check(inp, out, SEED, [out.digest()])
    assert [n for n, _, _ in numbers] == ["missing_outputs", "passes_differing",
                                          "umi_seed_violations", "umi_truth_error"]
    for name, value, limit in numbers:
        assert value <= limit, (name, value, limit)
    control = dict(chain.control(inp, out, SEED))
    assert control["umi_truth_error"] > inp.config["limits"]["umi_truth_error"]
    assert control["umi_seed_violations.umi1_only"] > 0


def _umi1_only(orig):
    def fault(umi1, threshold1=3, umi2=None, threshold2=None, **kw):
        return orig(umi1, threshold1=threshold1, **kw)
    return fault


def _singletons(orig):
    def fault(umi1, *a, **kw):
        return [np.array([i], np.int64) for i in range(len(umi1))]
    return fault


def _split_largest(orig):
    def fault(*a, **kw):
        out = list(orig(*a, **kw))
        k = int(np.argmax([len(g) for g in out]))
        g = out[k]
        return out[:k] + [g[:-1], g[-1:]] + out[k + 1:]
    return fault


FAULTS = [_umi1_only, _singletons, _split_largest]


@pytest.mark.parametrize("make", FAULTS, ids=[m.__name__.strip("_") for m in FAULTS])
def test_broken_grouping_is_not_correct(make, sparse, monkeypatch):
    from sarlacc_tpu_torch import api

    monkeypatch.setattr(api, "umi_group", make(api.umi_group))
    result = run.run_cell(CELL, SEED, 0.0, False, device="cpu", mix_update=SMALL)
    assert result["correct"] is False
    assert result["check"]["umi_seed_violations"]["value"] > 0


def test_sound_path_is_correct(sparse):
    result = run.run_cell(CELL, SEED, 0.0, False, device="cpu", mix_update=SMALL)
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {"reads_per_s.demux", "setup_s"}
    assert list(result)[-1] == "check"


def test_reads_carry_both_umis_by_the_pattern():
    """With no errors and no flips, every read holds its molecule's two
    UMIs where adaptor1's second N stretch and revcomp(adaptor2)'s stretch
    lie; each UMI keeps to NNNYRNNNYRNNNYRNNN, and the same seed gives the
    same reads."""
    _, config, mix, _, _, _ = run.load_cell(CELL)
    mix.update(SMALL, sub_rate=0.0, indel_rate=0.0, flip_share=0.0)
    r = dual.make_dual_reads(config, mix, SEED, "cpu")
    again = dual.make_dual_reads(config, mix, SEED, "cpu")
    assert np.array_equal(r.codes, again.codes) and np.array_equal(r.templates, again.templates)
    pattern = np.frombuffer(config["umi_pattern"].encode(), np.uint8)
    a1, a2 = config["adaptor1"], config["adaptor2"]
    u0 = a1.index("N" * 18)
    v0 = len(a2) - a2.index("N" * 18) - 18  # the stretch's start in revcomp(adaptor2)
    seen = []
    for i in range(len(r)):
        n = int(r.lengths[i])
        read = r.codes[i, :n]
        assert np.array_equal(read, r.template(int(r.molecule[i])))
        umi1 = read[u0:u0 + 18]
        umi2 = (3 - read[n - len(a2) + v0:n - len(a2) + v0 + 18])[::-1]
        for u in (umi1, umi2):
            assert set(u[pattern == ord("Y")].tolist()) <= {1, 3}
            assert set(u[pattern == ord("R")].tolist()) <= {0, 2}
            assert set(u.tolist()) <= {0, 1, 2, 3}
        seen.append((int(r.molecule[i]), umi1.tobytes(), umi2.tobytes()))
    per_mol = {}
    for m, x, y in seen:
        per_mol.setdefault(m, set()).add((x, y))
    assert all(len(v) == 1 for v in per_mol.values())  # constant per molecule
    firsts = {next(iter(v))[0] for v in per_mol.values()}
    seconds = {next(iter(v))[1] for v in per_mol.values()}
    assert len(firsts) == len(seconds) == len(per_mol)  # drawn apart per molecule
    assert firsts.isdisjoint(seconds)


def test_reference_loads_neither_jax_nor_the_program():
    """The reference groups in a process where nothing of the program or of
    JAX is loaded, before or after."""
    code = (
        "import sys, json, numpy as np\n"
        "from benchmark.reference import dual_cluster\n"
        "rng = np.random.default_rng(1)\n"
        "c = rng.integers(0, 4, (40, 18)); l = np.full(40, 18)\n"
        "c[20:] = c[:20]; c[20:, 3] = (c[20:, 3] + 1) % 4\n"
        "g = dual_cluster.dual_groups(c, l, c, l, 1, 1)\n"
        "mods = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps({'groups': len(g), 'mods': mods}))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["groups"] == 20
    assert not set(got["mods"]) & {"jax", "jaxlib", "flax", "sarlacc_tpu", "sarlacc_tpu_torch"}


def test_kernel_i_bound_and_readers():
    """The bound is the larger of operations and bytes; the readers leave
    their metrics out where the program keeps no counters or stages."""
    assert scan_bound_s(1e12, 0, 0) == pytest.approx(6e12 / PEAK_F32)
    assert scan_bound_s(0, 3.35e9, 0) == pytest.approx(3.35e9 / PEAK_BYTES)
    assert scan_bound_s(1, 0, 1e9) == pytest.approx(8e9 / PEAK_BYTES)
    obs = {"reads": 1000, "stages": {}, "trace": None}
    for name in ("umi.scan_s_per_kread.amplicon", "host.umi_steps_s_per_kread.amplicon",
                 "kernel_i_roofline.amplicon"):
        assert run.reader(name)(obs) is None
    obs["stages"] = {"umi.scan": 2.0, "umi.csr": 0.5, "umi.cluster": 0.25}
    assert run.reader("umi.scan_s_per_kread.amplicon")(obs) == 2.0
    assert run.reader("host.umi_steps_s_per_kread.amplicon")(obs) == 0.75
