"""Host-side BVH builder producing flat, array-encoded nodes for batched traversal.

Design (SURVEY.md section 2.2): a binary BVH with midpoint
splits on the longest centroid-extent axis and leaf size 4, matching the
behavior of the reference's vendored Fast-BVH (reference: externals/bvh.h:
121, 149-241) -- but emitted as a *threaded* (skip-link) flat array so that
batched SIMD traversal needs no per-ray stack at all:

  * nodes are stored in DFS preorder; an inner node's "hit" successor is
    simply `i + 1` (its first child);
  * every node stores a `miss` link = the next node in preorder after its
    whole subtree, used both on AABB miss and after a leaf is processed;
  * leaf primitives are reordered to be contiguous, so a leaf visit is a
    fixed-width masked gather of <= LEAF_SIZE triangles.

The triangle data itself is pre-gathered into SoA arrays (v0, e1, e2) by the
scene loader so traversal never chases index indirection per test (unlike
reference src/core/accel.h:27-52, which re-fetches vertices through tinyobj
indices on every intersection test).
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np

LEAF_SIZE = 4  # matches Fast-BVH (reference: externals/bvh.h:121)
SAH_BINS = 16  # binned-SAH resolution (build method "sah")


@dataclasses.dataclass
class FlatBVH:
    """Flat threaded BVH. All numpy host arrays."""

    bmin: np.ndarray        # (N, 3) f32
    bmax: np.ndarray        # (N, 3) f32
    miss: np.ndarray        # (N,) i32 skip link (== N past the last subtree)
    start: np.ndarray       # (N,) i32 leaf primitive start (0 for inner)
    count: np.ndarray       # (N,) i32 leaf primitive count (0 for inner)
    prim_order: np.ndarray  # (T,) i32: new_index -> original triangle index

    @property
    def n_nodes(self) -> int:
        return self.bmin.shape[0]


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
              use_native: bool = True, method: str = "midpoint") -> FlatBVH:
    """Build over triangles given by (T, 3) vertex arrays.

    method: "midpoint" reproduces Fast-BVH's split behavior (the
    reference's builder); "sah" is the binned surface-area-heuristic
    build -- identical intersection RESULTS (hit semantics are
    structure-independent) but tighter boxes, which lowers per-ray
    treelet overlap counts and therefore the binned tracers' iteration
    counts.

    Uses the native C++ builder (bpt_tpu/native, compiled from source at
    first use) -- it produces an identical FlatBVH; without a C++ compiler
    the numpy preorder
    recursive construction below (per-node work vectorized over the node's
    primitive slice, O(T log T) total).
    """
    if use_native and method == "midpoint":
        from ..native.native import build_bvh_native

        native = build_bvh_native(v0, v1, v2)
        if native is not None:
            return native
    t = v0.shape[0]
    lo = np.minimum(np.minimum(v0, v1), v2).astype(np.float64)
    hi = np.maximum(np.maximum(v0, v1), v2).astype(np.float64)
    centroid = (v0.astype(np.float64) + v1 + v2) / 3.0

    order = np.arange(t, dtype=np.int64)
    bmin_l: list = []
    bmax_l: list = []
    miss_l: list = []
    start_l: list = []
    count_l: list = []

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000 + 2 * t))

    sah = method == "sah"

    def _sah_split(sl, c, cmin, cmax):
        """Binned SAH over all 3 axes (SAH_BINS bins); returns a boolean
        left mask or None when no useful split exists."""
        ext = cmax - cmin
        best_cost = np.inf
        best = None
        for axis in range(3):
            if ext[axis] <= 0.0:
                continue
            # Bin ids in [0, SAH_BINS)
            f = (c[:, axis] - cmin[axis]) * (SAH_BINS / ext[axis])
            b = np.minimum(f.astype(np.int64), SAH_BINS - 1)
            # Per-bin counts and AABBs
            counts = np.bincount(b, minlength=SAH_BINS)
            blo = np.full((SAH_BINS, 3), np.inf)
            bhi = np.full((SAH_BINS, 3), -np.inf)
            np.minimum.at(blo, b, lo[sl])
            np.maximum.at(bhi, b, hi[sl])
            # Prefix/suffix sweeps
            plo = np.minimum.accumulate(blo, axis=0)
            phi = np.maximum.accumulate(bhi, axis=0)
            slo = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
            shi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
            nl = np.cumsum(counts)[:-1]
            nr = counts.sum() - nl

            def area(mn, mx):
                d = np.maximum(mx - mn, 0.0)
                return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] \
                    + d[:, 2] * d[:, 0]

            cost = (area(plo[:-1], phi[:-1]) * nl
                    + area(slo[1:], shi[1:]) * nr)
            cost[(nl == 0) | (nr == 0)] = np.inf
            i = int(np.argmin(cost))
            if cost[i] < best_cost:
                best_cost = cost[i]
                best = (axis, i, ext[axis])
        if best is None:
            return None
        axis, i, e = best
        f = (c[:, axis] - cmin[axis]) * (SAH_BINS / e)
        b = np.minimum(f.astype(np.int64), SAH_BINS - 1)
        return b <= i

    def rec(lo_r: int, hi_r: int) -> None:
        node = len(bmin_l)
        sl = order[lo_r:hi_r]
        bmin_l.append(lo[sl].min(axis=0))
        bmax_l.append(hi[sl].max(axis=0))
        miss_l.append(0)
        start_l.append(0)
        count_l.append(0)
        n = hi_r - lo_r
        leaf = n <= LEAF_SIZE
        if not leaf:
            c = centroid[sl]
            cmin = c.min(axis=0)
            cmax = c.max(axis=0)
            left_mask = None
            if sah:
                left_mask = _sah_split(sl, c, cmin, cmax)
            if left_mask is None:
                # Midpoint split on the longest centroid axis (Fast-BVH
                # behavior, bvh.h:210-228); also the SAH fallback when
                # centroids are degenerate.
                axis = int(np.argmax(cmax - cmin))
                split = 0.5 * (cmin[axis] + cmax[axis])
                left_mask = c[:, axis] < split
            n_left = int(left_mask.sum())
            if n_left == 0 or n_left == n:
                # Degenerate centroid split -> leaf (Fast-BVH falls back to
                # a mid split / leaf similarly, bvh.h:210-228).
                leaf = True
            else:
                order[lo_r:hi_r] = np.concatenate(
                    [sl[left_mask], sl[~left_mask]]
                )
                rec(lo_r, lo_r + n_left)
                rec(lo_r + n_left, hi_r)
        if leaf:
            start_l[node] = lo_r
            count_l[node] = n
        miss_l[node] = len(bmin_l)  # next preorder node after this subtree

    if t > 0:
        rec(0, t)
    sys.setrecursionlimit(old_limit)

    return FlatBVH(
        bmin=np.asarray(bmin_l, np.float32).reshape(-1, 3),
        bmax=np.asarray(bmax_l, np.float32).reshape(-1, 3),
        miss=np.asarray(miss_l, np.int32),
        start=np.asarray(start_l, np.int32),
        count=np.asarray(count_l, np.int32),
        prim_order=order.astype(np.int32),
    )
