"""Greedy UMI clustering, mirroring ``src/cluster_umis.cpp`` exactly.

The algorithm is inherently sequential and tiny per pre-group, so it runs on
the host in the production pipeline as well; this module *is* the production
implementation (a C++ fast path may shadow it later).

Semantics (cluster_umis.cpp:7-112):

* singleton nodes (neighbour list == [self]) are emitted first, in index
  order; a singleton whose sole neighbour is not itself raises, as does an
  empty neighbour list;
* repeatedly pick the live node with the most *initially recorded* neighbours
  adjusted by prior removals (``remaining``), ties broken towards the highest
  node index (cluster_umis.cpp:62-69);
* emit its still-live neighbours in neighbour-list order, kill them, and
  decrement ``remaining`` of each killed node's neighbours.

Copied unchanged from ``sarlacc_tpu/refimpl/cluster.py`` (numpy only, no JAX).
"""

from __future__ import annotations

from typing import Sequence

__all__ = ["cluster_umis"]


def cluster_umis(storage: Sequence[Sequence[int]]) -> list[list[int]]:
    n = len(storage)
    remaining = [len(s) for s in storage]
    output: list[list[int]] = []
    candidates: list[int] = []

    for a in range(n):
        size = remaining[a]
        if size > 1:
            candidates.append(a)
        elif size == 1:
            if storage[a][0] != a:
                raise ValueError("single-read groups should contain only the read itself")
            output.append([a])
        else:
            raise ValueError("zero length read group")

    while candidates:
        candidates = [c for c in candidates if remaining[c] > 0]
        if not candidates:
            break

        # max by (remaining, index): ties go to the highest index.
        best = max(candidates, key=lambda c: (remaining[c], c))
        candidates.remove(best)

        cluster: list[int] = []
        for neighbor in storage[best]:
            if remaining[neighbor] == 0:
                continue
            cluster.append(neighbor)
            remaining[neighbor] = 0
            for nxt in storage[neighbor]:
                if remaining[nxt] > 0:
                    remaining[nxt] -= 1
        output.append(cluster)

    return output
