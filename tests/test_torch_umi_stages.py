"""PyTorch port, ``umi_group``'s own stages and route counters on the CPU.

``umi_group`` times its masking, duplicate collapse, neighbour search,
neighbour lists, two-UMI intersection and clusterer as stages inside its
own wall, and counts the route each neighbour search takes: the dense
matrix below ``SPARSE_MIN`` strings, the native filter for short UMIs,
the row-block scan (kernel I's thresholded form on the card, its plain
version here) where the filter declines.
"""

import contextlib
import time

import numpy as np
import pytest

from sarlacc_tpu_torch.api import umi
from sarlacc_tpu_torch.core.encode import SeqBatch
from sarlacc_tpu_torch.utils import profiling
from sarlacc_tpu_torch.utils.profiling import PipelineProfiler

STEPS = ("umi.mask", "umi.unique", "umi.scan", "umi.csr", "umi.intersect", "umi.cluster")


class _Recorder(PipelineProfiler):
    """A stage profiler that also keeps every stage's interval."""

    def __init__(self):
        super().__init__()
        self.intervals = []

    @contextlib.contextmanager
    def stage(self, name, items=0, cells=0):
        t0 = time.perf_counter_ns()
        with super().stage(name, items=items, cells=cells) as st:
            yield st
        self.intervals.append((name, t0, time.perf_counter_ns()))


def _families(n_mol, reads, L, seed):
    """Two UMIs of ``L`` bases a molecule, each read's copies with a few
    substitutions and indels: (umi1, umi2) SeqBatches of ``n_mol * reads``
    rows."""
    rng = np.random.default_rng(seed)

    def copy(s):
        s = list(s)
        for _ in range(rng.integers(0, 3)):
            op, at = rng.integers(3), int(rng.integers(len(s)))
            if op == 0:
                s[at] = "ACGT"[rng.integers(4)]
            elif op == 1:
                s.insert(at, "ACGT"[rng.integers(4)])
            else:
                del s[at]
        return "".join(s)

    out = []
    for _ in range(2):
        centres = ["".join(rng.choice(list("ACGT"), L)) for _ in range(n_mol)]
        seqs = [copy(c) for c in centres for _ in range(reads)]
        out.append(SeqBatch.from_strings(seqs, ["I" * len(s) for s in seqs]))
    return out


@pytest.fixture
def fresh(monkeypatch):
    prof = _Recorder()
    monkeypatch.setattr(profiling, "_GLOBAL", prof)
    return prof


def test_dual_umi_stages_nest_and_sum(fresh, monkeypatch):
    """Two 18-base UMIs past ``SPARSE_MIN``: every step runs once a UMI
    (the intersection and the clusterer once), each inside ``umi_group``'s
    interval, and their seconds sum to no more than its."""
    monkeypatch.setattr(umi, "SPARSE_MIN", 16)
    u1, u2 = _families(12, 6, 18, 4)
    groups = umi.umi_group(u1, threshold1=3, umi2=u2, threshold2=3, device="cpu")
    assert sorted(int(i) for g in groups for i in g) == list(range(len(u1)))
    st = fresh.stages
    assert {k: st[k].calls for k in STEPS} == {"umi.mask": 1, "umi.unique": 2, "umi.scan": 2,
                                               "umi.csr": 2, "umi.intersect": 1,
                                               "umi.cluster": 1}
    n = len(u1)
    assert st["umi.mask"].items == 2 * n and st["umi.unique"].items == 2 * n
    assert st["umi.intersect"].items == st["umi.cluster"].items == n
    assert sum(st[k].seconds for k in STEPS) <= st["umi_group"].seconds
    (_, g0, g1), = [iv for iv in fresh.intervals if iv[0] == "umi_group"]
    inner = [iv for iv in fresh.intervals if iv[0] in STEPS]
    assert len(inner) == 9 and all(g0 <= t0 <= t1 <= g1 for _, t0, t1 in inner)


def test_single_umi_scale_path_stages(fresh, monkeypatch):
    """One UMI past ``SPARSE_MIN`` takes the unique-level clusterer: its
    collapse, search, lists and clusterer each run once."""
    monkeypatch.setattr(umi, "SPARSE_MIN", 16)
    u1, _ = _families(10, 5, 18, 5)
    umi.umi_group(u1, threshold1=3, device="cpu")
    st = fresh.stages
    assert {k for k in STEPS if k in st} == set(STEPS) - {"umi.intersect"}
    assert all(st[k].calls == 1 for k in STEPS if k in st)
    assert st["umi.cluster"].items == len(u1)


@pytest.mark.parametrize("L,threshold,sparse_min,route", [
    (18, 3, 16, "umi.route.rowblock"),  # C(18, <=3) = 988 deletion variants > 512
    (8, 1, 16, "umi.route.filter"),     # 9 variants: the native filter
    (18, 3, 4096, "umi.route.dense"),   # fewer strings than SPARSE_MIN
])
def test_route_counters(fresh, monkeypatch, L, threshold, sparse_min, route):
    """Each neighbour search counts its route, once a UMI; the sparse
    searches count the unique strings they scanned."""
    monkeypatch.setattr(umi, "SPARSE_MIN", sparse_min)
    u1, u2 = _families(10, 4, L, L + threshold)
    umi.umi_group(u1, threshold1=threshold, umi2=u2, threshold2=threshold, device="cpu")
    c = fresh.counters
    assert c[route] == 2
    assert not {k for k in c if k.startswith("umi.route.")} - {route}
    if route == "umi.route.dense":
        assert "umi.unique_strings" not in c and "umi.unique" not in fresh.stages
    else:
        want = sum(len(set(b.seq_strings())) for b in (u1, u2))
        assert c["umi.unique_strings"] == want
    assert not {k for k in c if k.startswith("lev2.")}  # kernel I's counters: the card's alone


@pytest.mark.parametrize("sparse_min,packed", [(16, 2), (4096, 0)])
def test_unique_rows_counters(fresh, monkeypatch, sparse_min, packed):
    """Two 30-base UMIs (rows wider than one base-6 word): the sparse path
    collapses each UMI's duplicates on the packed route, once a UMI, and
    never falls back to ``np.unique(axis=0)``; the dense route collapses
    nothing."""
    monkeypatch.setattr(umi, "SPARSE_MIN", sparse_min)
    u1, u2 = _families(10, 4, 30, 7)
    assert u1.codes.shape[1] > 24 and u2.codes.shape[1] > 24
    umi.umi_group(u1, threshold1=3, umi2=u2, threshold2=3, device="cpu")
    c = fresh.counters
    assert c.get("unique_rows.packed", 0) == packed
    assert "unique_rows.fallback" not in c
