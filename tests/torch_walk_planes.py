"""Direction planes built to hit kernel G's schedule at its edges.

Shared by ``test_torch_backtrack_walks.py`` (the CPU proof of the
schedule) and ``test_torch_cuda.py`` (the kernel on the card); numpy only.
Each plane function returns (dirs int16 [R, l1, n_pad], lengths int32 [n]).
"""

import numpy as np


def cap(limit):
    """Steps the plain loop runs at most: whole blocks of 8 below ``limit``."""
    return -(-limit // 8) * 8 if limit > 0 else 0


def _climb_plane(R, l1, n_pad, n, seed):
    """Mostly diagonal columns with some left and up runs; the fitting
    column (plane column R - 1) chains of up jumps of 1-5 rows that end at
    a diagonal or a left run.  Lengths of 0 and l1 - 1 among the reads;
    lanes past ``n`` walk from row 0."""
    rng = np.random.default_rng(seed)
    dirs = rng.choice([0] * 8 + [1, 2, -1, -2], (R, l1, n_pad))
    last = rng.integers(-5, 0, (l1, n_pad))
    stop = rng.random((l1, n_pad)) < 0.06
    last[stop] = rng.choice([0, 0, 1, 3], int(stop.sum()))
    dirs[R - 1] = last
    lengths = rng.integers(1, l1, n)
    lengths[:4] = [0, l1 - 1, l1 - 1, 0]
    return dirs.astype(np.int16), lengths.astype(np.int32)


#: The diagonal runs' middle length in the ``runs`` plane.
RUN = 8


def _runs_plane(R, l1, n_pad, seed):
    """Each read's own path painted on a random plane: diagonal runs of
    RUN - 1, RUN and RUN + 1 cells, each ended by a left run of 1-2
    or an up step of 1.  Even lanes start low (their runs pass row 0 and
    go on through the aliased and clamped cells), odd ones high (runs to
    col 0).  A path's flat indices fall strictly, so no cell is painted
    twice."""
    rng = np.random.default_rng(seed)
    dirs = rng.integers(-3, 4, (R, l1, n_pad)).astype(np.int16)
    flat = dirs.reshape(R * l1, n_pad)
    lengths = np.zeros(n_pad, np.int32)
    for n in range(n_pad):
        row = int(rng.integers(2, 6)) if n % 2 == 0 else int(rng.integers(l1 - 8, l1))
        col = R
        lengths[n] = row
        while col > 0:
            for _ in range(int(rng.choice([RUN - 1, RUN, RUN + 1]))):
                idx = (col - 1) * l1 + row
                if col == 0 or idx < 0:
                    break
                flat[idx, n] = 0
                col, row = col - 1, row - 1
            idx = (col - 1) * l1 + row
            if col == 0 or idx < 0:
                break
            d = -1 if row > 1 and rng.random() < 0.4 else int(rng.integers(1, 3))
            flat[idx, n] = d
            row, col = (row + d, col) if d < 0 else (row, col - d)
    return dirs, lengths


def _clamped_plane(R, l1, n_pad, n, seed):
    """Random directions and lengths up to 2 l1: fetches past the plane's
    last cell and before its first clamp."""
    rng = np.random.default_rng(seed)
    dirs = rng.integers(-4, 3, (R, l1, n_pad)).astype(np.int16)
    return dirs, rng.integers(0, 2 * l1, n).astype(np.int32)


def _all_up_plane(R, l1, n_pad):
    """Every cell -1: a read longer than l1 + the step cap climbs the
    clamped last cell until the cap, inside the slab climb; one of l1 + 3
    climbs into the column; every read ends stuck at row 0 (d < 0 moves
    nothing), to the cap."""
    steps = cap(R + l1 + 4)
    dirs = np.full((R, l1, n_pad), -1, np.int16)
    return dirs, np.asarray([l1 + steps + 5, l1 + 3, 0, l1 - 1, 1], np.int32)


def adversarial_plane(kind):
    """The plane of ``kind``: ``climb``, ``runs``, ``clamped``,
    ``clamped_R1`` or ``all_up``."""
    if kind == "climb":
        return _climb_plane(6, 100, 40, 37, 21)
    if kind == "runs":
        return _runs_plane(30, 48, 40, 22)
    if kind == "clamped":
        return _clamped_plane(5, 12, 36, 30, 23)
    if kind == "clamped_R1":
        return _clamped_plane(1, 9, 33, 33, 24)
    if kind == "all_up":
        return _all_up_plane(3, 40, 40)
    raise ValueError(kind)
