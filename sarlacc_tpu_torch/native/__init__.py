"""Native host library: first-use g++ build + ctypes bindings.

Compiles the port's own ``sarlacc_tpu_torch/native/msa_host.cpp`` (a copy of
the JAX package's host library, built with the same flags) into
``sarlacc_tpu_torch/_build/``.  Unlike the JAX
loader there is no Python fallback: a missing compiler or a failed build
raises, and every binding always returns a result.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .build import build_library

__all__ = [
    "get_lib", "greedy_cluster_native", "greedy_cluster_csr",
    "greedy_cluster_weighted_csr", "triplet_extend_native",
    "accumulate_cost_native", "candidate_pairs_native",
    "candidate_verify_native", "sym_delete_verify_native",
    "verify_pairs_native", "ABORTED", "HOST_SOURCE",
]

HOST_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "msa_host.cpp")
_CXX = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread"]
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def get_lib() -> ctypes.CDLL:
    """The loaded host library, built on first use; raises if it cannot be."""
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                so = build_library("sarlacc_host", [HOST_SOURCE], _CXX + [HOST_SOURCE])
                lib = ctypes.CDLL(so)
                _declare(lib)
                _LIB = lib
    return _LIB


def _declare(lib: ctypes.CDLL) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.greedy_cluster.restype = ctypes.c_int64
    lib.greedy_cluster.argtypes = [i32p, i64p, ctypes.c_int64, i32p, i64p]
    lib.triplet_extend.restype = ctypes.c_int64
    lib.triplet_extend.argtypes = [
        ctypes.c_int32, i32p, i32p, ctypes.c_int64, i64p, i32p, i32p, f32p,
        i32p, i32p, i64p, i32p, i32p, f32p, ctypes.c_int64,
    ]
    lib.accumulate_cost.restype = None
    lib.accumulate_cost.argtypes = [
        i32p, i32p, f32p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, f32p,
    ]
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.candidate_pairs.restype = ctypes.c_int64
    lib.candidate_pairs.argtypes = [u64p, i32p, ctypes.c_int64, u64p, ctypes.c_int64]
    i8p = ctypes.POINTER(ctypes.c_int8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.verify_pairs_lev2.restype = None
    lib.verify_pairs_lev2.argtypes = [
        i8p, i32p, ctypes.c_int32, i64p, i64p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, u8p,
    ]
    lib.candidate_verify_pairs.restype = ctypes.c_int64
    lib.candidate_verify_pairs.argtypes = [
        u64p, i32p, ctypes.c_int64, i8p, i32p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, u64p, ctypes.c_int64, ctypes.c_int64,
    ]
    lib.greedy_cluster_weighted.restype = ctypes.c_int64
    lib.greedy_cluster_weighted.argtypes = [
        i32p, i64p, ctypes.c_int64, i64p, i64p, i32p, i64p,
    ]
    lib.sym_delete_verify.restype = ctypes.c_int64
    lib.sym_delete_verify.argtypes = [
        i8p, i32p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, u64p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32,
    ]


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def greedy_cluster_native(storage: list) -> list[list[int]]:
    """C++ greedy clustering over list-of-lists neighbour sets."""
    n = len(storage)
    offsets = np.zeros(n + 1, dtype=np.int64)
    for i, s in enumerate(storage):
        offsets[i + 1] = offsets[i] + len(s)
    flat = np.asarray([int(v) for s in storage for v in s], dtype=np.int32)
    return greedy_cluster_csr(flat, offsets)


def greedy_cluster_csr(flat: np.ndarray, offsets: np.ndarray) -> list[list[int]]:
    """C++ greedy clustering on CSR neighbour lists."""
    lib = get_lib()
    n = offsets.size - 1
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    flat = np.ascontiguousarray(flat, dtype=np.int32)
    if flat.size == 0 and n > 0:
        flat = np.zeros(1, dtype=np.int32)
    out_members = np.zeros(max(n, 1), dtype=np.int32)
    out_offsets = np.zeros(n + 1, dtype=np.int64)
    ncl = lib.greedy_cluster(
        _ptr(flat, ctypes.c_int32),
        _ptr(offsets, ctypes.c_int64),
        n,
        _ptr(out_members, ctypes.c_int32),
        _ptr(out_offsets, ctypes.c_int64),
    )
    if ncl == -1:
        raise ValueError("zero length read group")
    if ncl == -2:
        raise ValueError("single-read groups should contain only the read itself")
    return [
        out_members[out_offsets[c] : out_offsets[c + 1]].tolist()
        for c in range(int(ncl))
    ]


def triplet_extend_native(g: int, lib_entries: dict) -> dict:
    """C++ triplet extension; lib_entries[(x, y)] = (pa, pb, w) arrays."""
    clib = get_lib()
    pairs = sorted(lib_entries)
    npairs = len(pairs)
    if npairs == 0:
        return {}
    px = np.asarray([p[0] for p in pairs], np.int32)
    py = np.asarray([p[1] for p in pairs], np.int32)
    off = np.zeros(npairs + 1, np.int64)
    for i, p in enumerate(pairs):
        off[i + 1] = off[i] + lib_entries[p][0].size
    total = int(off[-1])
    pa = np.concatenate([lib_entries[p][0] for p in pairs]).astype(np.int32) if total else np.zeros(1, np.int32)
    pb = np.concatenate([lib_entries[p][1] for p in pairs]).astype(np.int32) if total else np.zeros(1, np.int32)
    w = np.concatenate([lib_entries[p][2] for p in pairs]).astype(np.float32) if total else np.zeros(1, np.float32)

    cap = total * 4 + 1024
    while True:
        out_px = np.zeros(g * g, np.int32)
        out_py = np.zeros(g * g, np.int32)
        out_off = np.zeros(g * g + 1, np.int64)
        out_pa = np.zeros(cap, np.int32)
        out_pb = np.zeros(cap, np.int32)
        out_w = np.zeros(cap, np.float32)
        rv = clib.triplet_extend(
            g,
            _ptr(px, ctypes.c_int32), _ptr(py, ctypes.c_int32), npairs,
            _ptr(off, ctypes.c_int64), _ptr(pa, ctypes.c_int32),
            _ptr(pb, ctypes.c_int32), _ptr(w, ctypes.c_float),
            _ptr(out_px, ctypes.c_int32), _ptr(out_py, ctypes.c_int32),
            _ptr(out_off, ctypes.c_int64), _ptr(out_pa, ctypes.c_int32),
            _ptr(out_pb, ctypes.c_int32), _ptr(out_w, ctypes.c_float), cap,
        )
        if rv < 0:
            cap = int(-rv) + 1024
            continue
        pr = int(rv >> 40)
        out = {}
        for r in range(pr):
            s, e = int(out_off[r]), int(out_off[r + 1])
            out[(int(out_px[r]), int(out_py[r]))] = (
                out_pa[s:e].copy(),
                out_pb[s:e].copy(),
                out_w[s:e].copy(),
            )
        return out


def candidate_pairs_native(
    h: np.ndarray, owner: np.ndarray, cap_hint: int, pair_cap: int
) -> np.ndarray | None:
    """Unique unordered candidate pairs as packed (lo<<32)|hi uint64 keys;
    None when the raw pair count blows past ``pair_cap``."""
    lib = get_lib()
    h = np.ascontiguousarray(h, np.uint64)
    owner = np.ascontiguousarray(owner, np.int32)
    cap = int(max(cap_hint, 1024))
    while True:
        out = np.empty(cap, np.uint64)
        m = lib.candidate_pairs(
            _ptr(h, ctypes.c_uint64), _ptr(owner, ctypes.c_int32),
            h.size, _ptr(out, ctypes.c_uint64), cap,
        )
        if m >= 0:
            return out[:m].copy()
        needed = int(-m)
        if needed > pair_cap:
            return None
        cap = needed + 1024


#: Returned when the raw candidate volume blew past ``raw_cap``
#: (low-complexity pathology) — the caller must take another path.
ABORTED = object()


def candidate_verify_native(
    h: np.ndarray, owner: np.ndarray, codes: np.ndarray, lengths: np.ndarray,
    limit: int, thr: int, raw_cap: int,
):
    """Fused candidate generation + banded verification in one C++ pass.

    Returns uint64 keys ((lo<<32)|hi, sorted unique) of surviving pairs, or
    :data:`ABORTED` if the raw candidate volume exceeded ``raw_cap``.
    """
    lib = get_lib()
    h = np.ascontiguousarray(h, np.uint64)
    owner = np.ascontiguousarray(owner, np.int32)
    codes = np.ascontiguousarray(codes, np.int8)
    lengths = np.ascontiguousarray(lengths, np.int32)
    cap = int(max(4 * h.size, 1 << 20))
    while True:
        out = np.empty(cap, np.uint64)
        m = lib.candidate_verify_pairs(
            _ptr(h, ctypes.c_uint64), _ptr(owner, ctypes.c_int32), h.size,
            _ptr(codes, ctypes.c_int8), _ptr(lengths, ctypes.c_int32),
            codes.shape[1], int(limit), int(thr),
            _ptr(out, ctypes.c_uint64), cap, int(raw_cap),
        )
        if m == -(2 ** 63):
            return ABORTED
        if m >= 0:
            return out[:m].copy()
        cap = int(-m) + 1024


def greedy_cluster_weighted_csr(
    flat: np.ndarray, offsets: np.ndarray, wt: np.ndarray, maxidx: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Unique-string-level greedy clustering (read-level semantics on the
    collapsed multigraph — see msa_host.cpp::greedy_cluster_weighted).

    Returns (members, offsets) over UNIQUE ids.
    """
    lib = get_lib()
    m = offsets.size - 1
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    flat = np.ascontiguousarray(flat, dtype=np.int32)
    wt = np.ascontiguousarray(wt, dtype=np.int64)
    maxidx = np.ascontiguousarray(maxidx, dtype=np.int64)
    if flat.size == 0 and m > 0:
        flat = np.zeros(1, dtype=np.int32)
    out_members = np.zeros(max(m, 1), dtype=np.int32)
    out_offsets = np.zeros(m + 1, dtype=np.int64)
    ncl = lib.greedy_cluster_weighted(
        _ptr(flat, ctypes.c_int32), _ptr(offsets, ctypes.c_int64), m,
        _ptr(wt, ctypes.c_int64), _ptr(maxidx, ctypes.c_int64),
        _ptr(out_members, ctypes.c_int32), _ptr(out_offsets, ctypes.c_int64),
    )
    if ncl == -1:
        raise ValueError("zero length read group")
    if ncl == -2:
        raise ValueError("single-read groups should contain only the read itself")
    return out_members[: int(out_offsets[int(ncl)])], out_offsets[: int(ncl) + 1]


def sym_delete_verify_native(
    codes: np.ndarray, lengths: np.ndarray, k: int, limit: int, thr: int,
    raw_cap: int, nthreads: int = 0,
):
    """Fully-fused symmetric-delete neighbour search (hashing + bucketed
    sort + run walk + memoized banded verify), all native, all cores.

    Returns uint64 keys ((lo<<32)|hi, sorted unique) of surviving pairs, or
    :data:`ABORTED` if the raw candidate volume exceeded ``raw_cap``.
    """
    lib = get_lib()
    codes = np.ascontiguousarray(codes, np.int8)
    lengths = np.ascontiguousarray(lengths, np.int32)
    n = codes.shape[0]
    # An undersized cap re-runs the whole search; clustered UMI workloads
    # reach ~20 surviving pairs per string, so start comfortably above.
    cap = int(max(32 * n, 1 << 22))
    while True:
        out = np.empty(cap, np.uint64)
        m = lib.sym_delete_verify(
            _ptr(codes, ctypes.c_int8), _ptr(lengths, ctypes.c_int32),
            codes.shape[1], n, int(k), int(limit), int(thr),
            _ptr(out, ctypes.c_uint64), cap, int(raw_cap), int(nthreads),
        )
        if m == -(2 ** 63):
            return ABORTED
        if m >= 0:
            return out[:m].copy()
        cap = int(-m) + 1024


def verify_pairs_native(
    codes: np.ndarray, lengths: np.ndarray, ua: np.ndarray, ub: np.ndarray,
    limit: int, thr: int,
) -> np.ndarray:
    """Banded exact d2 <= thr verdicts for candidate pairs."""
    lib = get_lib()
    codes = np.ascontiguousarray(codes, np.int8)
    lengths = np.ascontiguousarray(lengths, np.int32)
    ua = np.ascontiguousarray(ua, np.int64)
    ub = np.ascontiguousarray(ub, np.int64)
    out = np.zeros(ua.size, np.uint8)
    if ua.size:
        lib.verify_pairs_lev2(
            _ptr(codes, ctypes.c_int8), _ptr(lengths, ctypes.c_int32),
            codes.shape[1], _ptr(ua, ctypes.c_int64), _ptr(ub, ctypes.c_int64),
            ua.size, int(limit), int(thr), _ptr(out, ctypes.c_uint8),
        )
    return out.astype(bool)


def accumulate_cost_native(ci, cj, w, lo, la, width, cost) -> None:
    """Library-sum column scores for one profile merge, added into ``cost``."""
    lib = get_lib()
    ci = np.ascontiguousarray(ci, np.int32)
    cj = np.ascontiguousarray(cj, np.int32)
    w = np.ascontiguousarray(w, np.float32)
    lib.accumulate_cost(
        _ptr(ci, ctypes.c_int32), _ptr(cj, ctypes.c_int32),
        _ptr(w, ctypes.c_float), ci.size,
        int(lo), int(la), int(width), _ptr(cost, ctypes.c_float),
    )
