"""Lightweight column-frame results with attached metadata.

The reference returns S4Vectors ``DataFrame``s with nested DataFrames and a
``metadata()`` list that carries configuration downstream
(R/adaptorAlign.R:62-76).  :class:`Frame` reproduces that contract: an
ordered mapping of equal-length columns — NumPy arrays, Python lists, or
nested ``Frame``s — plus a ``metadata`` dict and optional row names.

Copied unchanged from ``sarlacc_tpu/core/frame.py`` (numpy only, no JAX).
"""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np

__all__ = ["Frame"]


def _col_len(col) -> int:
    if isinstance(col, Frame):
        return len(col)
    return len(col)


class Frame:
    def __init__(
        self,
        columns: Mapping[str, object] | None = None,
        metadata: dict | None = None,
        rownames: list[str] | None = None,
        nrow: int | None = None,
        **kw,
    ):
        self.columns: dict[str, object] = dict(columns or {})
        self.columns.update(kw)
        self.metadata: dict = dict(metadata or {})
        self.rownames = list(rownames) if rownames is not None else None
        n = nrow
        for name, col in self.columns.items():
            cn = _col_len(col)
            if n is None:
                n = cn
            elif cn != n:
                raise ValueError(
                    f"column {name!r} has length {cn}, expected {n}"
                )
        self._nrow = n if n is not None else 0
        if self.rownames is not None and len(self.rownames) != self._nrow:
            raise ValueError("rownames length does not match column length")

    # -- basic protocol -----------------------------------------------------
    def __len__(self) -> int:
        return self._nrow

    @property
    def colnames(self) -> list[str]:
        return list(self.columns)

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.columns[key]
        return self.take(key)

    def __setitem__(self, name: str, col) -> None:
        if (self.columns or self._nrow) and _col_len(col) != self._nrow:
            raise ValueError("column length mismatch")
        self.columns[name] = col
        self._nrow = _col_len(col)

    def get(self, name: str, default=None):
        return self.columns.get(name, default)

    # -- row selection ------------------------------------------------------
    def take(self, idx) -> "Frame":
        """Row subset/reorder by integer indices or boolean mask."""
        idx = np.asarray(idx)
        if idx.dtype == bool:
            idx = np.flatnonzero(idx)
        cols = {}
        for name, col in self.columns.items():
            if isinstance(col, Frame):
                cols[name] = col.take(idx)
            elif isinstance(col, np.ndarray):
                cols[name] = col[idx]
            elif hasattr(col, "take"):  # e.g. SeqBatch
                cols[name] = col.take(idx)
            else:
                cols[name] = [col[int(i)] for i in idx]
        names = (
            [self.rownames[int(i)] for i in idx] if self.rownames is not None else None
        )
        return Frame(cols, metadata=dict(self.metadata), rownames=names, nrow=len(idx))

    @staticmethod
    def rbind(frames: Iterable["Frame"]) -> "Frame":
        frames = [f for f in frames if f is not None]
        if not frames:
            return Frame()
        first = frames[0]
        cols = {}
        for name in first.columns:
            parts = [f.columns[name] for f in frames]
            if isinstance(first.columns[name], Frame):
                cols[name] = Frame.rbind(parts)
            elif isinstance(first.columns[name], np.ndarray):
                cols[name] = np.concatenate(parts)
            elif hasattr(type(first.columns[name]), "concat"):
                cols[name] = type(first.columns[name]).concat(parts)
            else:
                merged: list = []
                for p in parts:
                    merged.extend(p)
                cols[name] = merged
        names = None
        if first.rownames is not None:
            names = []
            for f in frames:
                names.extend(f.rownames or [""] * len(f))
        return Frame(
            cols,
            metadata=dict(first.metadata),
            rownames=names,
            nrow=sum(len(f) for f in frames),
        )

    def __repr__(self) -> str:
        inner = ", ".join(
            f"{k}=<Frame[{len(v)}]>" if isinstance(v, Frame) else k
            for k, v in self.columns.items()
        )
        return f"Frame({self._nrow} rows: {inner})"
