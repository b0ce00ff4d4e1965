"""Reference (oracle) implementation of the quality-aware affine-gap aligner.

This is a faithful, slow NumPy/Python transcription of the semantics of
``src/reference_align.cpp`` in the reference package — including its exact
tie-breaking rules, run-length direction encoding, float64 evaluation order
(repeated subtraction for gap extensions) and the IUPAC quirks.  It anchors
property tests for the TPU kernels and serves as the bit-parity oracle.

Key semantics (cited into the reference):

* ``gap_open`` is stored as ``go + ge`` (reference_align.cpp:8).
* Fitting ("local") mode zeroes the first column and removes vertical gap
  penalties in the last column (reference_align.cpp:65-67, 88-90, 120-121).
* Direction tie-breaks: the diagonal wins only when *strictly* greater than
  both gaps; the horizontal gap wins only when strictly greater than the
  vertical gap; otherwise the vertical gap wins
  (reference_align.cpp:164-174).
* Gap "jump" bookkeeping: an extended earlier-opened gap is preferred only if
  *strictly* better than the gap derived from the immediately preceding cell
  (reference_align.cpp:129-155); directions record run lengths.
* ``compute_cost`` quirks: 2-fold IUPAC codes always score as mismatches and
  3-fold codes always as matches because the C++ compares the reference char
  itself against the constituents (reference_align.cpp:184-212).

Copied unchanged from ``sarlacc_tpu/refimpl/align.py`` (numpy only, no JAX).
"""

from __future__ import annotations

import numpy as np

from ..core.encode import IUPACReference, encode_seq, iupac_reference
from ..core.scoring import ScoreTables, build_score_tables

__all__ = ["ReferenceAlign", "QueryMap"]

NEG_INF = float("-inf")


class QueryMap:
    """Maps reference positions to query ranges (reference_align.cpp:280-351)."""

    def __init__(self, mapping: list, nrows: int):
        # mapping[i] = (is_match: bool, dp_row: int) for i in 0..rlen.
        self.mapping = mapping
        self.nrows = nrows

    def __call__(self, ref_start: int, ref_end: int, include_gaps: bool = False):
        """0-based [ref_start, ref_end) -> 0-based query DP positions.

        Mirrors ``querymap::operator()`` exactly, including both coordinate
        conventions (reference_align.cpp:307-351).
        """
        mapping = self.mapping
        if len(mapping) <= 1:
            return (0, 0)

        if not include_gaps:
            curstart = mapping[ref_start + 1][1]
            end_is_match, curend = mapping[ref_end]
            if end_is_match:
                curend += 1
            return (curstart - 1, curend - 1)

        if ref_start == 0:
            curstart = 1
        else:
            start_is_match, curstart = mapping[ref_start]
            if start_is_match:
                curstart += 1

        ref_end = ref_end + 1
        if ref_end == len(mapping):
            curend = self.nrows
        else:
            curend = mapping[ref_end][1]
        return (curstart - 1, curend - 1)


class ReferenceAlign:
    """One fixed reference vs many queries, exactly as ``reference_align``."""

    def __init__(
        self,
        refseq: str,
        gap_open: float,
        gap_ext: float,
        qual_type: str = "phred",
        tables: ScoreTables | None = None,
    ):
        self.ref: IUPACReference = iupac_reference(refseq)
        self.rlen = len(self.ref)
        self.gap_open = float(gap_open) + float(gap_ext)  # reference_align.cpp:8
        self.gap_ext = float(gap_ext)
        self.tables = tables if tables is not None else build_score_tables(qual_type)
        self._aligned = False

    # -- cost ---------------------------------------------------------------
    def compute_cost(self, pos: int, obs_code: int, qual_code: int) -> float:
        mode = int(self.ref.modes[pos])
        matched = bool(self.ref.matched[pos, obs_code])
        return self.tables.cost(mode, matched, qual_code)

    # -- DP -----------------------------------------------------------------
    def align(self, seq, qual, local: bool = True) -> float:
        """Align one query; ``seq`` is a string or int8 codes, ``qual`` raw chars.

        Stores the run-length direction matrix for subsequent backtracking,
        mirroring reference_align.cpp:54-181.
        """
        if isinstance(seq, str):
            seq = encode_seq(seq)
        if isinstance(qual, str):
            qual = np.frombuffer(qual.encode(), dtype=np.uint8)
        seq = np.asarray(seq)
        qual = np.asarray(qual)
        if seq.size != qual.size:
            raise ValueError("sequence and quality strings should have the same length")

        length = int(seq.size)
        nrows = length + 1
        rlen = self.rlen
        go, ge = self.gap_open, self.gap_ext

        # directions, column-major: dirs[col][row]
        dirs = [np.zeros(nrows, dtype=np.int64) for _ in range(rlen + 1)]
        dirs[0][:] = -1
        scores = np.zeros(nrows, dtype=np.float64)
        if not local:
            for i in range(1, nrows):
                scores[i] = -go - ge * (i - 1)

        left_jump_scores = np.full(nrows, NEG_INF)
        left_jump_points = np.zeros(nrows, dtype=np.int64)

        qidx = self.tables.qual_index(qual)
        match_tab = self.tables.match
        mismatch_tab = self.tables.mismatch
        modes = self.ref.modes
        matched = self.ref.matched

        for col in range(1, rlen + 1):
            pos = col - 1
            last = local and (col == rlen)
            last_dir = dirs[col - 1]
            cur_dir = dirs[col]

            lagging_last = scores[0]
            scores[0] -= ge if last_dir[0] > 0 else go
            cur_dir[0] = 1

            vgo = 0.0 if last else go
            vge = 0.0 if last else ge
            up_jump_score = NEG_INF
            up_jump_point = 0

            for i in range(1, length + 1):
                # Horizontal gap (reference_align.cpp:126-140).
                horiz_gap = scores[i] - (ge if last_dir[i] > 0 else go)
                left_jump_scores[i] -= ge
                left_step = 1
                if left_jump_scores[i] > horiz_gap:
                    left_step = 1 + pos - left_jump_points[i]
                    horiz_gap = left_jump_scores[i]
                else:
                    left_jump_scores[i] = horiz_gap
                    left_jump_points[i] = pos

                # Vertical gap (reference_align.cpp:142-155).
                vert_gap = scores[i - 1] - (vge if cur_dir[i - 1] < 0 else vgo)
                up_jump_score -= vge
                up_step = 1
                if up_jump_score > vert_gap:
                    up_step = 1 + i - up_jump_point
                    vert_gap = up_jump_score
                else:
                    up_jump_score = vert_gap
                    up_jump_point = i

                # (Mis)match (reference_align.cpp:157-160).
                oc = int(seq[i - 1])
                tab = match_tab if matched[pos, oc] else mismatch_tab
                match = lagging_last + tab[modes[pos] - 1, qidx[i - 1]]
                lagging_last = scores[i]

                # Choice + tie-breaks (reference_align.cpp:162-174).
                if match > horiz_gap and match > vert_gap:
                    cur_dir[i] = 0
                    scores[i] = match
                elif horiz_gap > vert_gap:
                    scores[i] = horiz_gap
                    cur_dir[i] = left_step
                else:
                    scores[i] = vert_gap
                    cur_dir[i] = -up_step

        self._dirs = dirs
        self._nrows = nrows
        self._aligned = True
        self._seq = seq
        return float(scores[length])

    # -- backtrack (reference_align.cpp:231-278) ------------------------------
    def _backtrack(self, move_up, move_diag, move_left):
        if not self._aligned:
            raise RuntimeError("cannot backtrack without alignment")
        dirs = self._dirs
        col = self.rlen
        currow = self._nrows - 1

        i = self.rlen
        while i > 0:
            while currow > 0:
                curdir = dirs[col][currow]
                if curdir >= 0:
                    break
                while curdir < 0:
                    move_up(i, currow)
                    currow -= 1
                    curdir += 1

            curdir = dirs[col][currow]
            if curdir == 0:
                move_diag(i, currow)
                currow -= 1
                col -= 1
                i -= 1
            else:
                move_left(i, currow)
                col -= 1
                curdir -= 1
                while curdir > 0:
                    i -= 1
                    move_left(i, currow)
                    col -= 1
                    curdir -= 1
                i -= 1

        while currow > 0:
            move_up(0, currow)
            currow -= 1

    def fill_map(self) -> QueryMap:
        mapping = [(False, 0)] * (self.rlen + 1)

        def move_up(i, currow):
            pass

        def move_diag(i, currow):
            mapping[i] = (True, currow)

        def move_left(i, currow):
            mapping[i] = (False, currow + 1)

        self._backtrack(move_up, move_diag, move_left)
        return QueryMap(mapping, self._nrows)

    def fill_strings(self, qseq: str):
        """Gapped (reference, query) alignment strings (reference_align.cpp:353-389)."""
        rwork: list[str] = []
        qwork: list[str] = []
        rseq = self.ref.seq

        def move_up(i, currow):
            rwork.append("-")
            qwork.append(qseq[currow - 1])

        def move_left(i, currow):
            rwork.append(rseq[i - 1])
            qwork.append("-")

        def move_diag(i, currow):
            rwork.append(rseq[i - 1])
            qwork.append(qseq[currow - 1])

        self._backtrack(move_up, move_diag, move_left)
        return "".join(reversed(rwork)), "".join(reversed(qwork))
