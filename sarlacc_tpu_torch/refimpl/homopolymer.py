"""Homopolymer finding/matching over (gapped) sequences (src/homopolymer.cpp).

Host-side RLE walks; this module is both the oracle and the production
implementation.  All coordinates mirror the reference:

* ``find_homopolymers``: runs of length >= 2 with de-gapped 1-based start,
  length and base (homopolymer.cpp:85-135);
* ``match_homopolymers``: for each reference homopolymer in a pairwise
  alignment, the longest same-base read run overlapping the (gap-extended)
  window (homopolymer.cpp:142-210).

Copied unchanged from ``sarlacc_tpu/refimpl/homopolymer.py`` (numpy only, no JAX).
"""

from __future__ import annotations

__all__ = ["find_homopolymers", "match_homopolymers"]


class _RleWalker:
    """Run-length iterator tracking gapped and de-gapped coordinates
    (homopolymer.cpp:6-79)."""

    def __init__(self, s: str, start: int = 0, length: int | None = None):
        self.s = s
        self.off = start
        self.len = length if length is not None else len(s) - start
        self.last_pos = 0
        self.cur_pos = 0
        self.nonbases = 0
        self.last_base = ""
        self.next_base = ""
        self.true_last_pos = 0
        while self.cur_pos < self.len:
            self.next_base = s[self.off + self.cur_pos]
            if self.next_base != "-":
                break
            self.nonbases += 1
            self.cur_pos += 1

    def advance(self):
        self.last_pos = self.cur_pos
        self.true_last_pos = self.last_pos - self.nonbases
        self.last_base = self.next_base
        self.cur_pos += 1
        while self.cur_pos < self.len:
            self.next_base = self.s[self.off + self.cur_pos]
            if self.next_base != "-" and self.next_base != self.last_base:
                break
            self.cur_pos += 1
            if self.next_base == "-":
                self.nonbases += 1

    def is_finished(self) -> bool:
        return self.cur_pos == self.len

    def get_start(self) -> int:
        return self.true_last_pos

    def get_length(self) -> int:
        return (self.cur_pos - self.nonbases) - self.true_last_pos

    def get_base(self) -> str:
        return self.last_base

    def get_run_start(self) -> int:
        return self.last_pos

    def get_run_start_with_gaps(self) -> int:
        pos = self.last_pos
        while pos > 0:
            pos -= 1
            if self.s[self.off + pos] != "-":
                pos += 1
                break
        return pos

    def get_run_end(self) -> int:
        pos = self.cur_pos
        while pos > self.last_pos:
            pos -= 1
            if self.s[self.off + pos] != "-":
                pos += 1
                break
        return pos

    def get_run_end_with_gaps(self) -> int:
        return self.cur_pos


def find_homopolymers(seqs: list[str]):
    """Returns (index, pos (1-based, de-gapped), size, base) parallel lists."""
    idx, pos, size, base = [], [], [], []
    for i, s in enumerate(seqs):
        w = _RleWalker(s)
        while not w.is_finished():
            w.advance()
            homolen = w.get_length()
            if homolen == 1:
                continue
            idx.append(i)
            pos.append(w.get_start() + 1)
            size.append(homolen)
            base.append(w.get_base())
    return idx, pos, size, base


def match_homopolymers(ref_align: list[str], read_align: list[str]):
    """Returns (index, pos, observed-length) parallel lists."""
    if len(ref_align) != len(read_align):
        raise ValueError("lengths of alignment vectors should match up")
    idx, pos, rlen = [], [], []
    for i, (refstr, readstr) in enumerate(zip(ref_align, read_align)):
        if len(refstr) != len(readstr):
            raise ValueError("read and reference alignment strings should have equal length")
        if not refstr:
            continue
        ref_w = _RleWalker(refstr)
        while not ref_w.is_finished():
            ref_w.advance()
            homolen = ref_w.get_length()
            if homolen == 1:
                continue
            idx.append(i)
            pos.append(ref_w.get_start() + 1)
            curbase = ref_w.get_base()
            farleft = ref_w.get_run_start_with_gaps()
            farright = ref_w.get_run_end_with_gaps()
            left = ref_w.get_run_start()
            right = ref_w.get_run_end()

            read_w = _RleWalker(readstr, farleft, farright - farleft)
            maxlen = 0
            while not read_w.is_finished():
                read_w.advance()
                if (
                    right > read_w.get_run_start() + farleft
                    and left < read_w.get_run_end() + farleft
                ):
                    curlen = read_w.get_length()
                    if curlen > maxlen and read_w.get_base() == curbase:
                        maxlen = curlen
            rlen.append(maxlen)
    return idx, pos, rlen
