"""Treelet (two-level) decomposition of the flat BVH for dense traversal.

Instead of per-ray pointer chasing, the binned tracers (accel/binned.py)
test rays against ALL treelet AABBs densely (a (B, NT) slab matrix), then
fetch whole fixed-size triangle blocks of the overlapped treelets and
intersect them densely (SURVEY.md section 2.2).

A treelet is a BVH subtree whose primitives span a contiguous range of <=
TREELET_SIZE triangles in BVH order (subtree ranges are contiguous by
construction of the preorder build).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .build import FlatBVH

TREELET_SIZE = 64


class Treelets(NamedTuple):
    """Host-side treelet arrays (numpy); converted to device arrays by the
    scene assembler."""

    bmin: np.ndarray      # (NT, 3)
    bmax: np.ndarray      # (NT, 3)
    tri_index: np.ndarray  # (NT, K) BVH-order triangle id (pad slot = T_pad)
    v0: np.ndarray        # (NT, K, 3)
    e1: np.ndarray        # (NT, K, 3)
    e2: np.ndarray        # (NT, K, 3)

    @property
    def n_treelets(self):
        return self.bmin.shape[0]


def build_treelets(bvh: FlatBVH, v0r: np.ndarray, e1: np.ndarray,
                   e2: np.ndarray, k: int = TREELET_SIZE) -> Treelets:
    """Cut the flat BVH into treelets of <= k contiguous triangles.

    v0r/e1/e2 are the BVH-ordered triangle arrays (unpadded, length T).
    The pad triangle id is T (callers pad their triangle tables by at least
    one degenerate triangle).
    """
    n = bvh.n_nodes
    t = len(v0r)
    # Subtree primitive count: prefix sums of leaf counts over the preorder
    # interval [i, miss[i]).
    s = np.zeros(n + 1, np.int64)
    np.cumsum(bvh.count, out=s[1:])
    sub_count = s[bvh.miss] - s[np.arange(n)]

    cuts = []
    i = 0
    while i < n:
        if sub_count[i] <= k or bvh.count[i] > 0:
            cuts.append(i)
            i = int(bvh.miss[i])
        else:
            i += 1

    nt = len(cuts)
    bmin = bvh.bmin[cuts].copy()
    bmax = bvh.bmax[cuts].copy()
    tri_index = np.full((nt, k), t, np.int32)
    tv0 = np.zeros((nt, k, 3), np.float32)
    te1 = np.zeros((nt, k, 3), np.float32)
    te2 = np.zeros((nt, k, 3), np.float32)

    # Subtree primitive start: the first leaf's start within the subtree.
    for j, node in enumerate(cuts):
        lo = int(bvh.miss[node])  # only to bound the search below
        # Find the subtree's leaves: nodes in [node, miss[node]) with
        # count > 0; their (start, count) ranges are contiguous.
        leaves = np.arange(node, lo)
        leaves = leaves[bvh.count[leaves] > 0]
        if len(leaves) == 0:
            continue
        starts = bvh.start[leaves]
        counts = bvh.count[leaves]
        lo_p = int(starts.min())
        hi_p = int((starts + counts).max())
        cnt = hi_p - lo_p
        assert cnt <= k, (cnt, k)
        idx = np.arange(lo_p, hi_p, dtype=np.int32)
        tri_index[j, :cnt] = idx
        tv0[j, :cnt] = v0r[lo_p:hi_p]
        te1[j, :cnt] = e1[lo_p:hi_p]
        te2[j, :cnt] = e2[lo_p:hi_p]

    return Treelets(bmin=bmin, bmax=bmax, tri_index=tri_index,
                    v0=tv0, e1=te1, e2=te2)
