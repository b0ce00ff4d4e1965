"""The benchmark's vectorised mockReads: the same seed gives the same
reads, two seeds ask the same work, and the error model's rates hold."""

import numpy as np
import pytest

from benchmark.generator import decode, make_reads, revcomp_codes, stratified

CONFIG = {"adaptor1": "ACGCTAGCATCAGTCNNNNCACAGCTACGANNNNNNNNNNNNCGTACGCAT",
          "adaptor2": "TGCATCGATCGCAT"}
MIX = {"molecules": 12, "reads_per_molecule": [10, 50], "insert_length": [500, 5000],
       "sub_rate": 0.05, "indel_rate": 0.01, "max_insert": 5, "flip_share": 0.5}


def test_same_seed_same_reads():
    a = make_reads(CONFIG, MIX, 2**31 + 12345, "cpu")
    b = make_reads(CONFIG, MIX, 2**31 + 12345, "cpu")
    assert np.array_equal(a.codes, b.codes) and np.array_equal(a.quals, b.quals)
    assert np.array_equal(a.lengths, b.lengths) and a.names == b.names
    assert np.array_equal(a.templates, b.templates)


def test_two_seeds_equal_work():
    a = make_reads(CONFIG, MIX, 7, "cpu")
    b = make_reads(CONFIG, MIX, 8, "cpu")
    assert not np.array_equal(a.templates, b.templates)
    assert np.array_equal(np.bincount(a.molecule), np.bincount(b.molecule))
    assert np.array_equal(np.diff(a.template_off), np.diff(b.template_off))
    # read lengths differ only by the indels: within a percent in total
    assert abs(int(a.lengths.sum()) - int(b.lengths.sum())) < 0.01 * a.lengths.sum()


def test_stratified_covers_the_range():
    v = stratified(10, 50, 400, salt=1)
    assert v.min() == 10 and v.max() == 49
    assert np.array_equal(np.bincount(v)[10:], np.full(40, 10))


def _reads(sub, indel, seed=3):
    mix = dict(MIX, molecules=6, insert_length=[2000, 3000], sub_rate=sub, indel_rate=indel)
    return make_reads(CONFIG, mix, seed, "cpu")


def _forward(r, i):
    c = r.codes[i, :r.lengths[i]]
    return revcomp_codes(c) if r.flipped[i] else c


def test_substitution_rate():
    r = _reads(0.05, 0.0)
    diff = total = 0
    for i in range(len(r)):
        t = r.template(int(r.molecule[i]))
        c = _forward(r, i)
        assert c.size == t.size
        diff += int((c != t).sum())
        total += t.size
    # a substituted base is drawn from ACGT, so 3/4 of draws change it
    assert diff / total == pytest.approx(0.05 * 0.75, rel=0.08)


def test_indel_rate():
    r = _reads(0.0, 0.01)
    tl = sum(r.template(int(m)).size for m in r.molecule)
    # each chosen base becomes 0, 2, 3, 4 or 5 copies: 1.8 more on average
    assert r.lengths.sum() / tl == pytest.approx(1 + 0.01 * 1.8, abs=0.002)


def test_qualities_and_flips():
    r = _reads(0.05, 0.01)
    q = np.concatenate([r.quals[i, :r.lengths[i]] for i in range(len(r))]).astype(int) - 33
    # errors uniform on [0, 0.06): Phred >= 12, and half of them <= 15
    assert q.min() >= 12 and np.median(q) == pytest.approx(15, abs=1)
    assert 0.3 < r.flipped.mean() < 0.7
    s = decode(r.codes[0, :r.lengths[0]])
    assert set(s) <= set("ACGT")
