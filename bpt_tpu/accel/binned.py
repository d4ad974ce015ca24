"""Binned BVH traversal in plain XLA: the routed tracers.

The flat BVH is cut into treelets of <= K triangles (accel/treelets.py).
Each query first tests every ray against every treelet AABB (a dense
(B, NT) slab matrix), then intersects whole treelet blocks densely:

  * any hit (`trace_any_binned`): rays are processed in tiles; each tile
    sweeps the union of treelets its rays overlap, J list entries per
    loop iteration, in SoA layout (minor dimension = tile lanes);
  * closest hit (`trace_closest_slots`): each ray walks its own overlap
    list front to back, one treelet block per iteration, and stops once
    its best hit is nearer than every remaining entry.

Intersection semantics identical to accel/traverse.py (Moeller-Trumbore,
|det| >= 1e-8, t > 1e-3, t in [min_t, max_t]; reference:
src/core/core.h:379-400, accel.h:43).  Every fetch is an exact gather:
no geometry or triangle id passes through a matrix product.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.math import EPSILON, T_MIN_HIT
from .traverse import Hit

DEFAULT_TILE = 128


class TreeletGeom(NamedTuple):
    """Device treelet arrays (see accel/treelets.py).  Triangle blocks are
    packed into ONE (NT, 9, K) array so each sweep step issues a single
    gather (XLA gathers carry a large fixed cost per op)."""

    bmin: jnp.ndarray       # (NT, 3)
    bmax: jnp.ndarray       # (NT, 3)
    tri_index: jnp.ndarray  # (NT, K)
    block: jnp.ndarray      # (NT, 9, K): v0xyz, e1xyz, e2xyz


def make_treelet_geom(tl) -> TreeletGeom:
    """Convert host Treelets (accel/treelets.py) to packed device arrays."""
    import numpy as np

    block = np.stack(
        [tl.v0[..., 0], tl.v0[..., 1], tl.v0[..., 2],
         tl.e1[..., 0], tl.e1[..., 1], tl.e1[..., 2],
         tl.e2[..., 0], tl.e2[..., 1], tl.e2[..., 2]],
        axis=1,
    ).astype(np.float32)  # (NT, 9, K)
    return TreeletGeom(
        bmin=jnp.asarray(tl.bmin),
        bmax=jnp.asarray(tl.bmax),
        tri_index=jnp.asarray(tl.tri_index),
        block=jnp.asarray(block),
    )


def _pad_rays(o, d, min_t, max_t, tile):
    b = o.shape[0]
    pad = (-b) % tile
    if pad:
        o = jnp.concatenate(
            [o, jnp.full((pad, 3), 1e9, o.dtype)], axis=0)
        d = jnp.concatenate(
            [d, jnp.tile(jnp.asarray([[1.0, 0.0, 0.0]], d.dtype),
                         (pad, 1))], axis=0)
        min_t = jnp.concatenate([min_t, jnp.zeros((pad,), min_t.dtype)])
        max_t = jnp.concatenate([max_t, jnp.full((pad,), -1.0,
                                                 max_t.dtype)])
    return o, d, min_t, max_t, b


def _treelet_mask(tg: TreeletGeom, o, d, min_t, max_t):
    """(B, NT) slab-overlap matrix (dense, SoA over components)."""
    return _treelet_entry(tg, o, d, min_t, max_t)[0]


def _treelet_entry(tg: TreeletGeom, o, d, min_t, max_t):
    """(B, NT) slab-overlap matrix + entry distances.

    entry is max(tnear, 0) for overlapped entries and +inf elsewhere —
    the carried quantity for front-to-back pruning."""
    tiny = 1e-20
    inv_d = jnp.where(d < 0, -1.0, 1.0) / jnp.maximum(jnp.abs(d), tiny)
    tnear = jnp.full((o.shape[0], tg.bmin.shape[0]), -jnp.inf, jnp.float32)
    tfar = jnp.full((o.shape[0], tg.bmin.shape[0]), jnp.inf, jnp.float32)
    for k in range(3):
        t1 = (tg.bmin[None, :, k] - o[:, None, k]) * inv_d[:, None, k]
        t2 = (tg.bmax[None, :, k] - o[:, None, k]) * inv_d[:, None, k]
        tnear = jnp.maximum(tnear, jnp.minimum(t1, t2))
        tfar = jnp.minimum(tfar, jnp.maximum(t1, t2))
    mask = (
        (tfar >= tnear)
        & (tnear <= max_t[:, None])
        & (tfar >= min_t[:, None])
    )
    entry = jnp.where(mask, jnp.maximum(tnear, 0.0), jnp.inf)
    return mask, entry


def _tile_lists(mask, n_tiles, tile):
    """Per-tile treelet work lists from the (B, NT) overlap mask."""
    tile_any = jnp.any(mask.reshape(n_tiles, tile, -1), axis=1)
    counts = jnp.sum(tile_any, axis=-1)
    lists = jnp.argsort(~tile_any, axis=-1, stable=True).astype(jnp.int32)
    return lists, counts


def _mt_block_soa(rx, tb):
    """Dense SoA Moeller-Trumbore.

    rx: ray components, each (n_tiles, 1, S).
    tb: triangle block components, each (n_tiles, K, 1).
    Returns (ok, t, u, v) each (n_tiles, K, S)."""
    ox, oy, oz, dx, dy, dz = rx
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tb
    # pvec = d x e2
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = jnp.abs(det) >= EPSILON
    inv_det = 1.0 / jnp.where(ok, det, 1.0)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    ok &= (u >= 0.0) & (u <= 1.0)
    # qvec = tvec x e1
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    ok &= (v >= 0.0) & (u + v <= 1.0)
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok &= t > T_MIN_HIT
    return ok, t, u, v


def _prep(tg, o, d, min_t, max_t, tile):
    b_in = o.shape[0]
    tile = min(tile, max(b_in, 1))
    min_t = jnp.broadcast_to(jnp.asarray(min_t, jnp.float32), (b_in,))
    max_t = jnp.broadcast_to(jnp.asarray(max_t, jnp.float32), (b_in,))
    o, d, min_t, max_t, _ = _pad_rays(o, d, min_t, max_t, tile)
    b = o.shape[0]
    n_tiles = b // tile

    mask = _treelet_mask(tg, o, d, min_t, max_t)
    lists, counts = _tile_lists(mask, n_tiles, tile)

    rx = tuple(
        a.reshape(n_tiles, 1, tile)
        for a in (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])
    )
    return (b_in, b, tile, n_tiles, rx, lists, counts,
            min_t.reshape(n_tiles, 1, tile),
            max_t.reshape(n_tiles, 1, tile))


def trace_any_binned(tg: TreeletGeom, o, d, min_t, max_t,
                     tile: int = DEFAULT_TILE, j: int = 4) -> jnp.ndarray:
    """Tile-sweep occlusion query.

    j: list entries processed per loop iteration.  The per-iteration fixed
    costs (row gather, small fused ops, loop plumbing) dominate over the
    triangle tests themselves, so batching J entries cuts wall time nearly
    J-fold until the MT test matrix saturates the VPU."""
    (b_in, b, tile, n_tiles, rx, lists, counts, mint, maxt) = _prep(
        tg, o, d, min_t, max_t, tile)
    max_count = jnp.max(counts)
    nt, _, k = tg.block.shape
    # Pad so the j-wide dynamic_slice never clamps at the tail (clamping
    # would misalign entries against the `active` position mask).
    lists = jnp.concatenate(
        [lists, jnp.zeros((n_tiles, j), lists.dtype)], axis=1)

    def cond(state):
        m, occ = state
        return (m < max_count) & ~jnp.all(occ)

    def body(state):
        m, occ = state
        tau = jax.lax.dynamic_slice(lists, (0, m), (n_tiles, j))
        active = (m + jnp.arange(j)) < counts[:, None]  # (n_tiles, j)
        blk = tg.block[tau]  # (n_tiles, j, 9, K)
        tb = tuple(
            blk[:, :, c, :].reshape(n_tiles, j * k)[..., None]
            for c in range(9)
        )
        ok, t, _, _ = _mt_block_soa(rx, tb)  # (n_tiles, j*K, S)
        ok &= (t >= mint) & (t <= maxt)
        ok &= jnp.repeat(active, k, axis=1)[..., None]
        occ = occ | jnp.any(ok, axis=1)
        return m + j, occ

    init = (jnp.int32(0), jnp.zeros((n_tiles, tile), bool))
    _, occ = jax.lax.while_loop(cond, body, init)
    return occ.reshape(b)[:b_in]


# ---------------------------------------------------------------------------
# Per-ray slot tracer: closest hit, one gathered treelet block per step
# ---------------------------------------------------------------------------
#
# For incoherent rays the per-ray treelet overlap count is small while
# tile unions are large, so a tile sweep would waste most of its tests.
# Here each ray walks its OWN overlap list: each iteration takes every
# ray's nearest remaining overlapped treelet (argmin over the entry row),
# gathers that treelet's packed triangle block and triangle ids, and
# intersects densely.  The loop runs at most max-per-ray-count times and
# usually exits earlier through the front-to-back prune.


def trace_closest_slots(tg: TreeletGeom, o, d, min_t, max_t) -> Hit:
    """Per-ray slot closest hit: ordered front-to-back walk of each
    lane's own overlap list, carrying entry distances so a lane stops as
    soon as its best hit beats every remaining entry.

    Blocks and triangle ids are fetched by gather, so both stay exact
    (f32 geometry, int32 ids) on every backend.  Exhausted lanes read the
    out-of-range row NT, which fills with zeros: a degenerate block that
    no ray hits."""
    b = o.shape[0]
    nt, _, k = tg.block.shape
    min_t = jnp.broadcast_to(jnp.asarray(min_t, jnp.float32), (b,))
    max_t = jnp.broadcast_to(jnp.asarray(max_t, jnp.float32), (b,))
    _, entry = _treelet_entry(tg, o, d, min_t, max_t)

    rx = tuple(a[:, None] for a in (o[:, 0], o[:, 1], o[:, 2],
                                    d[:, 0], d[:, 1], d[:, 2]))
    iota = jax.lax.broadcasted_iota(jnp.int32, (1, nt), 1)

    def body(state):
        entry_rem, t_best, tri_best, u_best, v_best = state
        nearest = jnp.min(entry_rem, axis=1)
        has = nearest < t_best       # front-to-back prune, per lane
        first = jnp.argmin(entry_rem, axis=1).astype(jnp.int32)
        slot = jnp.where(has, first, nt)
        comp = tg.block.at[slot].get(mode="fill", fill_value=0.0)
        trib = tg.tri_index.at[slot].get(mode="fill", fill_value=-1)
        tb = tuple(comp[:, c, :] for c in range(9))
        ok, t, u, v = _mt_block_soa(rx, tb)  # (B, K)
        t_hi = jnp.minimum(t_best, max_t)
        ok &= (t >= min_t[:, None]) & (t <= t_hi[:, None])
        ok &= has[:, None]
        t_m = jnp.where(ok, t, jnp.inf)
        kk = jnp.argmin(t_m, axis=1)

        def sel(arr):
            return jnp.take_along_axis(arr, kk[:, None], axis=1)[:, 0]

        t_new = sel(t_m)
        improved = t_new < t_best
        t_best = jnp.where(improved, t_new, t_best)
        tri_best = jnp.where(improved, sel(trib), tri_best)
        u_best = jnp.where(improved, sel(u), u_best)
        v_best = jnp.where(improved, sel(v), v_best)
        entry_rem = jnp.where((iota == first[:, None]) & has[:, None],
                              jnp.inf, entry_rem)
        return entry_rem, t_best, tri_best, u_best, v_best

    init = (
        entry,
        jnp.full((b,), jnp.inf, jnp.float32),
        jnp.full((b,), -1, jnp.int32),
        jnp.zeros((b,), jnp.float32),
        jnp.zeros((b,), jnp.float32),
    )
    _, t_best, tri_best, u_best, v_best = jax.lax.while_loop(
        lambda st: jnp.any(jnp.min(st[0], axis=1) < st[1]), body, init)
    return Hit(t=t_best, tri=tri_best, u=u_best, v=v_best,
               valid=tri_best >= 0)
