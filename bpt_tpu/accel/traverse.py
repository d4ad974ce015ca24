"""Batched, stackless BVH traversal in pure JAX (lax.while_loop + gathers).

Every ray in the (B,)-batch walks the threaded BVH (see accel/build.py) in
lockstep iterations of a single `lax.while_loop`; per-ray state is just the
current node cursor plus the best-hit record -- no stacks, no dynamic shapes.
Lanes that finish idle until the whole batch is done (SIMD semantics).

Intersection semantics replicate the reference exactly:
  * Moeller-Trumbore with |det| < 1e-8 rejection
    (reference: src/core/core.h:379-400);
  * hits with t <= 1e-3 rejected (reference: src/core/accel.h:43);
  * valid hits clamped to [ray.min_t, ray.max_t]
    (reference: externals/bvh.h:261-277 as modified by the author);
  * any-hit mode for visibility queries (reference: bdpt.h:498-514).

This is the correctness/reference path; the binned tracers in
accel/binned.py implement the same semantics over treelet blocks.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.math import EPSILON, T_MIN_HIT

LEAF_SIZE = 4


class TraceGeom(NamedTuple):
    """Device arrays needed for traversal (triangles in BVH order, padded by
    LEAF_SIZE degenerate triangles at the end)."""

    v0: jnp.ndarray         # (T+pad, 3)
    e1: jnp.ndarray         # (T+pad, 3)  v1 - v0
    e2: jnp.ndarray         # (T+pad, 3)  v2 - v0
    node_bmin: jnp.ndarray  # (N, 3)
    node_bmax: jnp.ndarray  # (N, 3)
    node_miss: jnp.ndarray  # (N,)
    node_start: jnp.ndarray  # (N,)
    node_count: jnp.ndarray  # (N,)


class Hit(NamedTuple):
    """Closest-hit record, (B,) leading dim. `tri` indexes the BVH-ordered
    triangle arrays; -1 / valid=False on miss."""

    t: jnp.ndarray
    tri: jnp.ndarray
    u: jnp.ndarray
    v: jnp.ndarray
    valid: jnp.ndarray


def _safe_inv(d):
    """1/d with +-1e-20 floor so slab tests stay NaN-free."""
    tiny = 1e-20
    mag = jnp.maximum(jnp.abs(d), tiny)
    return jnp.where(d < 0, -1.0, 1.0) / mag


def _slab_hit(bmin, bmax, o, inv_d, t_lo, t_hi):
    """AABB slab test against interval [t_lo, t_hi]."""
    t1 = (bmin - o) * inv_d
    t2 = (bmax - o) * inv_d
    tnear = jnp.max(jnp.minimum(t1, t2), axis=-1)
    tfar = jnp.min(jnp.maximum(t1, t2), axis=-1)
    return (tfar >= tnear) & (tnear <= t_hi) & (tfar >= t_lo)


def _leaf_tris(geom: TraceGeom, start, count):
    """Gather the (B, LEAF_SIZE) leaf triangles (masked)."""
    slots = jnp.arange(LEAF_SIZE, dtype=jnp.int32)
    idx = start[:, None] + slots[None, :]
    valid = slots[None, :] < count[:, None]
    v0 = geom.v0[idx]
    e1 = geom.e1[idx]
    e2 = geom.e2[idx]
    return idx, valid, v0, e1, e2


def _moeller_trumbore(o, d, v0, e1, e2):
    """(B, K) Moeller-Trumbore. o, d are (B, 3); v0/e1/e2 are (B, K, 3).
    Returns (ok_geom, t, u, v) each (B, K); ok_geom excludes range checks."""
    ob = o[:, None, :]
    db = d[:, None, :]
    pvec = jnp.cross(db, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    ok = jnp.abs(det) >= EPSILON
    inv_det = 1.0 / jnp.where(ok, det, 1.0)
    tvec = ob - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    ok &= (u >= 0.0) & (u <= 1.0)
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(db * qvec, axis=-1) * inv_det
    ok &= (v >= 0.0) & (u + v <= 1.0)
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    ok &= t > T_MIN_HIT
    return ok, t, u, v


def trace_closest(geom: TraceGeom, o, d, min_t, max_t) -> Hit:
    """Closest hit for a batch of rays. min_t/max_t broadcast to (B,)."""
    b = o.shape[0]
    n_nodes = geom.node_bmin.shape[0]
    inv_d = _safe_inv(d)
    min_t = jnp.broadcast_to(jnp.asarray(min_t, jnp.float32), (b,))
    max_t = jnp.broadcast_to(jnp.asarray(max_t, jnp.float32), (b,))

    init = (
        jnp.zeros((b,), jnp.int32),                  # cur
        jnp.full((b,), jnp.inf, jnp.float32),        # t_best
        jnp.full((b,), -1, jnp.int32),               # tri_best
        jnp.zeros((b,), jnp.float32),                # u
        jnp.zeros((b,), jnp.float32),                # v
    )

    def cond(state):
        cur = state[0]
        return jnp.any(cur < n_nodes)

    def body(state):
        cur, t_best, tri_best, u_best, v_best = state
        active = cur < n_nodes
        safe = jnp.minimum(cur, n_nodes - 1)
        bmin = geom.node_bmin[safe]
        bmax = geom.node_bmax[safe]
        miss = geom.node_miss[safe]
        start = geom.node_start[safe]
        count = geom.node_count[safe]

        t_hi = jnp.minimum(t_best, max_t)
        box_hit = _slab_hit(bmin, bmax, o, inv_d, min_t, t_hi) & active
        is_leaf = count > 0
        leaf_active = box_hit & is_leaf

        idx, slot_ok, lv0, le1, le2 = _leaf_tris(geom, start, count)
        ok, t, u, v = _moeller_trumbore(o, d, lv0, le1, le2)
        ok &= slot_ok & leaf_active[:, None]
        ok &= (t >= min_t[:, None]) & (t <= t_hi[:, None])
        t_masked = jnp.where(ok, t, jnp.inf)
        k = jnp.argmin(t_masked, axis=-1)
        t_new = jnp.take_along_axis(t_masked, k[:, None], axis=-1)[:, 0]
        improved = t_new < t_best
        sel = lambda arr: jnp.take_along_axis(arr, k[:, None], axis=-1)[:, 0]
        t_best = jnp.where(improved, t_new, t_best)
        tri_best = jnp.where(improved, sel(idx).astype(jnp.int32), tri_best)
        u_best = jnp.where(improved, sel(u), u_best)
        v_best = jnp.where(improved, sel(v), v_best)

        descend = box_hit & ~is_leaf
        nxt = jnp.where(descend, cur + 1, miss)
        cur = jnp.where(active, nxt, cur)
        return cur, t_best, tri_best, u_best, v_best

    _, t_best, tri_best, u_best, v_best = jax.lax.while_loop(cond, body, init)
    valid = tri_best >= 0
    return Hit(t=t_best, tri=tri_best, u=u_best, v=v_best, valid=valid)


def trace_any(geom: TraceGeom, o, d, min_t, max_t) -> jnp.ndarray:
    """Occlusion query: True where *any* hit exists with
    t in [min_t, max_t] (and t > 1e-3). Early-outs per lane."""
    b = o.shape[0]
    n_nodes = geom.node_bmin.shape[0]
    inv_d = _safe_inv(d)
    min_t = jnp.broadcast_to(jnp.asarray(min_t, jnp.float32), (b,))
    max_t = jnp.broadcast_to(jnp.asarray(max_t, jnp.float32), (b,))

    init = (
        jnp.zeros((b,), jnp.int32),
        jnp.zeros((b,), bool),
    )

    def cond(state):
        cur, _ = state
        return jnp.any(cur < n_nodes)

    def body(state):
        cur, occ = state
        active = cur < n_nodes
        safe = jnp.minimum(cur, n_nodes - 1)
        bmin = geom.node_bmin[safe]
        bmax = geom.node_bmax[safe]
        miss = geom.node_miss[safe]
        start = geom.node_start[safe]
        count = geom.node_count[safe]

        box_hit = _slab_hit(bmin, bmax, o, inv_d, min_t, max_t) & active
        is_leaf = count > 0
        leaf_active = box_hit & is_leaf

        _, slot_ok, lv0, le1, le2 = _leaf_tris(geom, start, count)
        ok, t, _, _ = _moeller_trumbore(o, d, lv0, le1, le2)
        ok &= slot_ok & leaf_active[:, None]
        ok &= (t >= min_t[:, None]) & (t <= max_t[:, None])
        occ = occ | jnp.any(ok, axis=-1)

        descend = box_hit & ~is_leaf
        nxt = jnp.where(descend, cur + 1, miss)
        nxt = jnp.where(occ, n_nodes, nxt)  # early-out occluded lanes
        cur = jnp.where(active, nxt, cur)
        return cur, occ

    _, occ = jax.lax.while_loop(cond, body, init)
    return occ
