"""Plain reference of the error-profiling chain of MarioniLab/sarlacc v1.0.0
(``vignettes/profiling.Rmd``): reads aligned globally to their reference
(``R/qualityAlign.R``), then ``errorFinder`` and ``homopolymerMatcher``.

* :func:`align`: the float32 DP of ``reference/align.py::align_batch`` in
  global mode, and a walk of its run-length directions per read in
  ``src/general_align.cpp``'s order: from the last column and the read's
  last row, an up cell emits its run of read bases against reference gaps,
  a diagonal cell one pair, a left cell its run of reference bases against
  read gaps; in column 0 the read's remaining bases.  The gapped strings
  and the edits (columns that differ, gaps included) follow.  Blocks of
  reads run in spawned worker processes.
* :func:`error_profile` (``src/find_errors.cpp``) and
  :func:`homopolymer_table` (``src/homopolymer.cpp``): whole-array torch
  over [N, W] byte planes of the gapped strings, in column coordinates.
  The de-gapped reference is the first alignment's.  For each reference
  homopolymer (two bases or more) in each alignment, the window runs from
  just after the previous reference base to the next reference base (the
  run's bases and the insertions on both sides), the span from the run's
  first base to its last; the read's runs inside the window are its runs
  of equal bases (gaps skipped) cut at the window's edges, and the observed
  length is the longest such run of the homopolymer's base whose first and
  last bases' columns overlap the span.
* :func:`homopolymer_rows`: the same answer alignment by alignment, by a
  walk over each one's columns in plain Python, as ``src/homopolymer.cpp``
  walks them; the check holds the program on a sample of reads to it.

Nothing of the program under test is imported.
"""

from __future__ import annotations

import multiprocessing

import numpy as np

from benchmark.reference import align as ref_align

__all__ = ["align", "error_profile", "homopolymer_rows", "homopolymer_table", "string_plane"]

#: Window positions one block of :func:`homopolymer_table` holds at most.
_BLOCK = 1 << 24
_GAP = ord("-")


def _walk(dirs, R: int, n: int):
    """(reference positions, read positions) of one read's alignment,
    front to back, 1-based, 0 for a gap; ``dirs`` [R + 1, L + 1] as
    ``align_batch`` gives them for the read."""
    col, row = R, n
    ref_at, read_at = [], []
    while col > 0 or row > 0:
        if col == 0:
            ref_at.append(0)
            read_at.append(row)
            row -= 1
            continue
        d = int(dirs[col, row])
        if row > 0 and d < 0:
            for _ in range(-d):
                ref_at.append(0)
                read_at.append(row)
                row -= 1
        elif d == 0:
            ref_at.append(col)
            read_at.append(row)
            col -= 1
            row -= 1
        else:
            for _ in range(d):
                ref_at.append(col)
                read_at.append(0)
                col -= 1
    return ref_at[::-1], read_at[::-1]


def _align_block(template: str, codes, lengths, quals, go: float, ge: float, bf16: bool):
    scores, dirs = ref_align.align_batch(template, codes, lengths, quals, go, ge, local=False,
                                         rnd=ref_align.round_bf16 if bf16 else None)
    ref_bytes = np.frombuffer(("-" + template).encode(), np.uint8)
    read_bytes = np.frombuffer(b"ACGTN-", np.uint8)
    refs, queries, edits = [], [], []
    for s in range(codes.shape[0]):
        ra, qa = _walk(dirs[:, :, s], len(template), int(lengths[s]))
        rr = ref_bytes[np.asarray(ra, np.int64)]
        qq = np.where(np.asarray(qa) > 0,
                      read_bytes[codes[s, np.maximum(np.asarray(qa, np.int64) - 1, 0)]],
                      _GAP).astype(np.uint8)
        refs.append(rr.tobytes().decode())
        queries.append(qq.tobytes().decode())
        edits.append(int((rr != qq).sum()))
    return scores, refs, queries, np.asarray(edits, np.int64)


def align(template: str, codes, lengths, quals, go: float, ge: float, bf16=False,
          workers: int = 1, block: int = 16):
    """Global alignment of every read (``codes`` int8 [S, L], pad 5;
    ``quals`` Phred+33) to ``template``: (scores float64 [S], gapped
    reference strings, gapped read strings, edits int64 [S]).  ``bf16``
    rounds every DP result to bfloat16 (the control); ``workers`` > 1 runs
    blocks of ``block`` reads in that many spawned processes."""
    codes = np.asarray(codes)
    lengths = np.asarray(lengths)
    quals = np.asarray(quals)
    S = codes.shape[0]
    jobs = []
    for s0 in range(0, S, block):
        s1 = min(s0 + block, S)
        w = max(int(lengths[s0:s1].max(initial=0)), 1)
        jobs.append((template, codes[s0:s1, :w], lengths[s0:s1], quals[s0:s1, :w], float(go),
                     float(ge), bool(bf16)))
    if workers > 1 and len(jobs) > 1:
        with multiprocessing.get_context("spawn").Pool(min(workers, len(jobs))) as pool:
            parts = pool.starmap(_align_block, jobs)
    else:
        parts = [_align_block(*j) for j in jobs]
    if not parts:
        return np.zeros(0), [], [], np.zeros(0, np.int64)
    return (np.concatenate([p[0] for p in parts]), [r for p in parts for r in p[1]],
            [q for p in parts for q in p[2]], np.concatenate([p[3] for p in parts]))


def string_plane(strings, device):
    """The strings' bytes as a uint8 [N, W] plane on ``device`` (pad 0) and
    their lengths int64 [N]."""
    import torch

    lens = np.fromiter((len(s) for s in strings), np.int64, len(strings))
    W = int(lens.max(initial=0))
    plane = np.zeros((len(strings), W), np.uint8)
    if lens.sum():
        flat = np.frombuffer("".join(strings).encode(), np.uint8)
        rows = np.repeat(np.arange(len(strings)), lens)
        cols = np.arange(flat.size) - np.repeat(np.cumsum(lens) - lens, lens)
        plane[rows, cols] = flat
    return torch.as_tensor(plane, device=device), torch.as_tensor(lens, device=device)


def error_profile(refs, queries, device="cpu"):
    """``errorFinder``'s answer: (bases of the de-gapped reference, counts
    int64 [R + 1, 5] of A, C, G, T and deletions with the one-past-the-end
    row, each row's insertion lengths in the order the reads and their
    columns give them, the 4 x 4 transition matrix)."""
    import torch

    ref = refs[0].replace("-", "") if refs else ""
    R = len(ref)
    rp, lens = string_plane(refs, device)
    qp, _ = string_plane(queries, device)
    N, W = rp.shape
    live = torch.arange(W, device=rp.device)[None, :] < lens[:, None]
    base_col = live & (rp != _GAP)
    true_pos = torch.cumsum(base_col, dim=1) - 1
    kind = torch.full_like(qp, 5, dtype=torch.int64)
    for k, c in enumerate(b"ACGT-"):
        kind[qp == c] = k
    if bool((base_col & (kind == 5)).any()):
        raise ValueError("a read base other than A, C, G, T or a gap faces a reference base")
    counts = torch.zeros((R + 1) * 5, dtype=torch.int64, device=rp.device)
    counts.index_add_(0, (true_pos * 5 + kind)[base_col],
                      torch.ones(int(base_col.sum()), dtype=torch.int64, device=rp.device))
    counts = counts.reshape(R + 1, 5).cpu().numpy()

    gap = live & (rp == _GAP)
    prev = torch.zeros_like(gap)
    prev[:, 1:] = gap[:, :-1]
    nxt = torch.zeros_like(gap)
    nxt[:, :-1] = gap[:, 1:]
    s = (gap & ~prev).nonzero()
    e = (gap & ~nxt).nonzero()
    at = (true_pos + 1)[s[:, 0], s[:, 1]].cpu().numpy()  # reference bases before the run
    ln = (e[:, 1] - s[:, 1] + 1).cpu().numpy()
    flat = ln[np.argsort(at, kind="stable")].tolist()
    ends = np.cumsum(np.bincount(at, minlength=R + 1)).tolist()
    insertions = [flat[a:b] for a, b in zip([0] + ends[:-1], ends)]
    trans = np.zeros((4, 4), np.int64)
    for r, b in enumerate("ACGT"):
        rows = np.fromiter((c == b for c in ref), bool, R)
        trans[r] = counts[:R][rows, :4].sum(axis=0)
    return list(ref), counts, insertions, trans


def homopolymer_table(refs, queries, device="cpu"):
    """``homopolymerMatcher``'s answer: (1-based starts int64 [H], widths
    [H], bases [H], observed int64 [H, N], each row sorted)."""
    import torch

    ref = refs[0].replace("-", "") if refs else ""
    R = len(ref)
    rb = np.frombuffer(ref.encode(), np.uint8)
    if R:
        first = np.flatnonzero(np.concatenate([[True], rb[1:] != rb[:-1]]))
        width = np.diff(np.append(first, R))
        keep = width >= 2
        hs, hw = first[keep], width[keep]
    else:
        hs = hw = np.zeros(0, np.int64)
    H, N = hs.size, len(refs)
    if H == 0 or N == 0:
        return hs + 1, hw, [chr(c) for c in rb[hs]], np.zeros((H, N), np.int64)
    rp, lens = string_plane(refs, device)
    qp, _ = string_plane(queries, device)
    dev = rp.device
    W = rp.shape[1]
    col = torch.arange(W, device=dev).expand(N, W)
    live = col < lens[:, None]
    ref_col = col[live & (rp != _GAP)].reshape(N, R)  # column of each reference base
    is_q = live & (qp != _GAP)
    nq = is_q.sum(dim=1)
    Lq = int(nq.max())
    big = W + 1
    qcol = torch.full((N, Lq + 1), big, dtype=torch.int64, device=dev)
    qch = torch.zeros((N, Lq + 1), dtype=torch.int64, device=dev)
    r_, c_ = is_q.nonzero(as_tuple=True)
    k_ = (torch.cumsum(is_q, dim=1) - 1)[r_, c_]
    qcol[r_, k_] = c_
    qch[r_, k_] = qp[r_, c_].to(torch.int64)
    # The read's runs of equal bases: first and one-past-last position.
    pos = torch.arange(Lq + 1, device=dev).expand(N, Lq + 1)
    head = torch.ones_like(qch, dtype=torch.bool)
    head[:, 1:] = qch[:, 1:] != qch[:, :-1]
    tail = torch.ones_like(head)
    tail[:, :-1] = head[:, 1:]
    run_s = torch.cummax(torch.where(head, pos, 0), dim=1).values
    run_e = torch.where(tail, pos + 1, Lq + 1).flip(1).cummin(dim=1).values.flip(1)

    s = torch.as_tensor(hs, device=dev)
    w = torch.as_tensor(hw, device=dev)
    far_l = torch.where(s > 0, ref_col[:, (s - 1).clamp(min=0)] + 1, 0)
    far_r = torch.where(s + w < R, ref_col[:, (s + w).clamp(max=R - 1)], lens[:, None])
    left = ref_col[:, s]
    right = ref_col[:, s + w - 1] + 1
    p0 = torch.searchsorted(qcol, far_l.contiguous())
    p1 = torch.searchsorted(qcol, far_r.contiguous())
    cnt = (p1 - p0).clamp(min=0)
    want = torch.as_tensor(rb[hs].astype(np.int64), device=dev)

    observed = torch.zeros(N * H, dtype=torch.int64, device=dev)
    per_read = cnt.sum(dim=1).cpu().numpy()
    ends = np.cumsum(per_read)
    r0 = 0
    while r0 < N:
        r1 = max(int(np.searchsorted(ends, (ends[r0 - 1] if r0 else 0) + _BLOCK, "right")),
                 r0 + 1)
        c = cnt[r0:r1].reshape(-1)
        pair = torch.repeat_interleave(torch.arange(c.numel(), device=dev), c)
        if pair.numel():
            i = pair // H + r0
            h = pair % H
            g = pair + r0 * H
            q = (p0.reshape(-1)[g] + torch.arange(pair.numel(), device=dev)
                 - (torch.cumsum(c, 0) - c)[pair])
            x0 = torch.maximum(run_s[i, q], p0.reshape(-1)[g])
            x1 = torch.minimum(run_e[i, q], p1.reshape(-1)[g])
            overlaps = (right[i, h] > qcol[i, x0]) & (left[i, h] < qcol[i, x1 - 1] + 1)
            val = torch.where((qch[i, q] == want[h]) & overlaps, x1 - x0, 0)
            observed.scatter_reduce_(0, g, val, "amax")
        r0 = r1
    observed = observed.reshape(N, H).T.sort(dim=1).values.cpu().numpy()
    return hs + 1, hw, [chr(c) for c in rb[hs]], observed


def _base_runs(s: str, a: int, b: int) -> list:
    """The runs of equal bases in columns ``[a, b)`` of the gapped string
    ``s``, gaps skipped: [first base's column, last base's column + 1,
    base, bases] each."""
    runs = []
    for c in range(a, b):
        ch = s[c]
        if ch == "-":
            continue
        if runs and runs[-1][2] == ch:
            runs[-1][1] = c + 1
            runs[-1][3] += 1
        else:
            runs.append([c, c + 1, ch, 1])
    return runs


def homopolymer_rows(refs, queries) -> list:
    """Per alignment, [(1-based start, width, base, observed length)] for each
    run of two bases or more in its own reference.  The window reaches from
    the column after the previous reference base to the next run's first
    base; the observed length is the most bases of a read run of the same
    base inside the window whose columns overlap the reference run's."""
    out = []
    for r, q in zip(refs, queries):
        rows = []
        runs = _base_runs(r, 0, len(r))
        before = 0
        for k, (first, end, ch, n) in enumerate(runs):
            if n >= 2:
                far_l = runs[k - 1][1] if k else 0
                far_r = runs[k + 1][0] if k + 1 < len(runs) else len(r)
                best = 0
                for q_first, q_end, q_ch, q_n in _base_runs(q, far_l, far_r):
                    if q_ch == ch and q_first < end and first < q_end:
                        best = max(best, q_n)
                rows.append((before + 1, n, ch, best))
            before += n
        out.append(rows)
    return out
