"""Scene assembly: OBJ/MTL -> flat device arrays + BVH.

Replaces the reference's Scene::load pipeline (reference:
src/core/renderer.cpp:235-315) with a pre-gathered SoA representation:
triangles are flattened across all shapes, vertices/normals are gathered up
front (no index chasing at trace time), the BVH is built on the host and
threaded for stackless traversal, and emitters get padded per-face area CDFs
for O(log F) device-side sampling (reference: renderer.cpp:279-305,317-339).

The MTL `illum` -> BSDF map matches renderer.cpp:258-271:
  7 -> diffuse, 3 -> mirror, 6 -> glass, 8 -> mixture, else -> phong
  (illum 5 gets no BSDF in the reference; we map it to phong and warn).
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from ..accel.binned import TreeletGeom, make_treelet_geom
from ..accel.build import LEAF_SIZE, build_bvh
from ..accel.traverse import TraceGeom
from ..accel.treelets import build_treelets
from ..bsdf.bsdf import DIFFUSE, GLASS, MIRROR, MIXTURE, PHONG, MaterialTable
from .obj import ObjData, load_obj
from .textures import build_atlas, load_texture


class EmitterTable(NamedTuple):
    """Area emitters (E,) with padded per-face CDFs.

    face_cdf rows are normalized CDFs with a leading 0 (reference
    Distribution1D, src/core/math.h:81-112), padded with 1.0 so
    searchsorted never lands on padding."""

    radiance: jnp.ndarray   # (E, 3)
    area: jnp.ndarray       # (E,)
    shape_id: jnp.ndarray   # (E,)
    mat_id: jnp.ndarray     # (E,) material providing Ke (for param rebind)
    face_cdf: jnp.ndarray   # (E, Fmax + 1)
    face_tri: jnp.ndarray   # (E, Fmax) BVH-order triangle index


class SceneData(NamedTuple):
    """Everything jitted code needs, as one pytree of device arrays.

    Triangle arrays are in BVH order and padded by LEAF_SIZE degenerate
    triangles (index T..T+LEAF_SIZE-1) so leaf gathers are always in
    bounds."""

    geom: TraceGeom
    n0: jnp.ndarray         # (T+pad, 3) per-corner shading normals
    n1: jnp.ndarray
    n2: jnp.ndarray
    ng: jnp.ndarray         # (T+pad, 3) geometric normal (normalized)
    mat_id: jnp.ndarray     # (T+pad,)
    shape_id: jnp.ndarray   # (T+pad,)
    shape_emitter: jnp.ndarray  # (S,) emitter id per shape or -1
    mat: MaterialTable
    emitters: EmitterTable
    treelets: TreeletGeom       # dense two-level structure (closest-hit)
    treelets_any: TreeletGeom   # table for any-hit (currently == treelets)
    # Bitmap textures (reference: core.h:405-640); empty atlas = none.
    uv0: jnp.ndarray            # (T+pad, 2) per-corner texcoords
    uv1: jnp.ndarray
    uv2: jnp.ndarray
    mat_tex: jnp.ndarray        # (M,) texture index or -1
    tex_atlas: jnp.ndarray      # (NTex, Hmax, Wmax, 3)
    tex_size: jnp.ndarray       # (NTex, 2) (h, w)


@dataclasses.dataclass
class SceneMeta:
    """Host-side metadata (names, counts, per-shape stats) that jitted code
    never touches."""

    n_triangles: int
    n_materials: int
    n_emitters: int
    n_shapes: int
    shape_names: List[str]
    shapes_center: np.ndarray  # (S, 3) (reference: renderer.cpp:294-304)
    shapes_aabb_min: np.ndarray
    shapes_aabb_max: np.ndarray
    material_names: List[str]
    bvh_nodes: int


_ILLUM_TO_KIND = {7: DIFFUSE, 3: MIRROR, 6: GLASS, 8: MIXTURE}


def _material_table(obj: ObjData) -> MaterialTable:
    m = len(obj.materials)
    kind = np.full(m, PHONG, np.int32)
    diffuse = np.zeros((m, 3), np.float32)
    specular = np.zeros((m, 3), np.float32)
    emission = np.zeros((m, 3), np.float32)
    shininess = np.ones(m, np.float32)
    ior = np.ones(m, np.float32)
    transmittance = np.zeros((m, 3), np.float32)
    for i, mt in enumerate(obj.materials):
        kind[i] = _ILLUM_TO_KIND.get(mt.illum, PHONG)
        diffuse[i] = mt.diffuse
        specular[i] = mt.specular
        emission[i] = mt.emission
        shininess[i] = mt.shininess
        ior[i] = mt.ior
        transmittance[i] = mt.transmittance
    return MaterialTable(
        kind=jnp.asarray(kind),
        diffuse=jnp.asarray(diffuse),
        specular=jnp.asarray(specular),
        emission=jnp.asarray(emission),
        shininess=jnp.asarray(shininess),
        ior=jnp.asarray(ior),
        transmittance=jnp.asarray(transmittance),
    )


def build_scene(obj: ObjData, tex_dir: str = "") -> tuple[SceneData, SceneMeta]:
    """Flatten an ObjData into (SceneData, SceneMeta)."""
    # --- flatten triangles across shapes (original order) -----------------
    v_idx = np.concatenate([s.v_idx for s in obj.shapes], axis=0)
    n_idx = np.concatenate([s.n_idx for s in obj.shapes], axis=0)
    t_idx = np.concatenate([s.t_idx for s in obj.shapes], axis=0)
    mat_id = np.concatenate([s.mat_ids for s in obj.shapes], axis=0)
    shape_id = np.concatenate(
        [np.full(len(s.v_idx), i, np.int64) for i, s in enumerate(obj.shapes)]
    )
    t = len(v_idx)

    v0 = obj.vertices[v_idx[:, 0]]
    v1 = obj.vertices[v_idx[:, 1]]
    v2 = obj.vertices[v_idx[:, 2]]
    gn = np.cross(v1 - v0, v2 - v0)
    gn = gn / np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
    if obj.normals.size > 0:
        # Per-corner shading normals with geometric-normal fallback where a
        # face has no normal index.
        nmax = len(obj.normals) - 1

        def corner(col):
            ok = col >= 0
            vals = obj.normals[np.clip(col, 0, nmax)]
            return np.where(ok[:, None], vals, gn)

        n0 = corner(n_idx[:, 0])
        n1 = corner(n_idx[:, 1])
        n2 = corner(n_idx[:, 2])
    else:
        n0 = n1 = n2 = gn

    # --- BVH ---------------------------------------------------------------
    import os as _os

    # "midpoint" (default) matches Fast-BVH and uses the native C++
    # builder; "sah" is available via BPT_BVH=sah — measured neutral on
    # the cbox scenes (axis-aligned geometry is midpoint-friendly) but
    # expected to win on irregular scenes.
    bvh = build_bvh(v0, v1, v2,
                    method=_os.environ.get("BPT_BVH", "midpoint"))
    perm = bvh.prim_order  # new -> old
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(t, dtype=np.int32)

    def reorder(a):
        return a[perm]

    v0r, v1r, v2r = reorder(v0), reorder(v1), reorder(v2)
    n0r, n1r, n2r = reorder(n0), reorder(n1), reorder(n2)
    mat_r = reorder(mat_id).astype(np.int32)
    shape_r = reorder(shape_id).astype(np.int32)

    # Per-corner texcoords (zeros when absent).
    if obj.texcoords.size > 0:
        tmax = len(obj.texcoords) - 1

        def tc(col):
            ok = col >= 0
            vals = obj.texcoords[np.clip(col, 0, tmax)]
            return np.where(ok[:, None], vals, 0.0).astype(np.float32)

        uv0 = tc(t_idx[:, 0])[perm]
        uv1 = tc(t_idx[:, 1])[perm]
        uv2 = tc(t_idx[:, 2])[perm]
    else:
        uv0 = uv1 = uv2 = np.zeros((t, 2), np.float32)

    # Diffuse bitmap textures (map_Kd), reference illum factory attaches
    # them to Diffuse/Phong/Mixture materials (diffuse.h:23-26).
    images = []
    mat_tex = np.full(len(obj.materials), -1, np.int32)
    for i, mt in enumerate(obj.materials):
        if mt.diffuse_texname:
            path = mt.diffuse_texname
            if tex_dir and not os.path.isabs(path):
                path = os.path.join(tex_dir, path)
            img = load_texture(path)
            if img is not None:
                mat_tex[i] = len(images)
                images.append(img)
    atlas, tex_sizes = build_atlas(images)

    e1 = v1r - v0r
    e2 = v2r - v0r
    ng = np.cross(e1, e2)
    ng = ng / np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)

    # --- pad with degenerate triangles so leaf gathers stay in bounds ------
    pad3 = np.zeros((LEAF_SIZE, 3), np.float32)
    padi = np.zeros(LEAF_SIZE, np.int32)

    def padded(a, p):
        return np.concatenate([a.astype(p.dtype if p.ndim else a.dtype), p])

    # K=128 treelets, both tables.  Larger K means fewer treelets (a
    # smaller (B, NT) slab matrix and fewer closest-hit iterations) but
    # more triangle tests per fetched block.  K=128 is carried over from
    # an earlier accelerator and has not been measured on the H100.
    tl = build_treelets(bvh, v0r.astype(np.float32),
                        e1.astype(np.float32), e2.astype(np.float32),
                        k=128)
    treelets = make_treelet_geom(tl)
    # Any-hit table: BPT_ANY_K builds a separate treelet cut for the
    # occlusion sweeps (smaller K = tighter boxes = fewer triangle tests
    # per union entry, at more slab columns).  Default: share the
    # closest-hit table.
    any_k = int(os.environ.get("BPT_ANY_K", "128"))
    if any_k != 128:
        tl_any = build_treelets(bvh, v0r.astype(np.float32),
                                e1.astype(np.float32),
                                e2.astype(np.float32), k=any_k)
        treelets_any = make_treelet_geom(tl_any)
    else:
        treelets_any = treelets

    geom = TraceGeom(
        v0=jnp.asarray(np.concatenate([v0r, pad3]).astype(np.float32)),
        e1=jnp.asarray(np.concatenate([e1, pad3]).astype(np.float32)),
        e2=jnp.asarray(np.concatenate([e2, pad3]).astype(np.float32)),
        node_bmin=jnp.asarray(bvh.bmin),
        node_bmax=jnp.asarray(bvh.bmax),
        node_miss=jnp.asarray(bvh.miss),
        node_start=jnp.asarray(bvh.start),
        node_count=jnp.asarray(bvh.count),
    )

    # --- emitters ----------------------------------------------------------
    # Emissive shapes discovered by their first face's material
    # (reference: renderer.cpp:281-289).
    em_shapes = []
    for i, s in enumerate(obj.shapes):
        first_mat = int(s.mat_ids[0])
        if first_mat >= 0:
            ke = obj.materials[first_mat].emission
            if float(np.dot(ke, ke)) > 0.0:
                em_shapes.append((i, ke, first_mat))

    e = len(em_shapes)
    fmax = 1
    per_emitter = []
    for i, ke, first_mat in em_shapes:
        tri_sel = np.nonzero(shape_id == i)[0]  # original order
        va, vb, vc = v0[tri_sel], v1[tri_sel], v2[tri_sel]
        cr = np.cross(vb - va, vc - va)
        areas = 0.5 * np.sqrt(np.sum(cr * cr, axis=-1))
        total = float(areas.sum())
        cdf = np.concatenate([[0.0], np.cumsum(areas)]) / max(total, 1e-30)
        per_emitter.append((i, ke, first_mat, total, cdf,
                            inv_perm[tri_sel]))
        fmax = max(fmax, len(tri_sel))

    em_radiance = np.zeros((max(e, 1), 3), np.float32)
    em_area = np.ones(max(e, 1), np.float32)
    em_shape = np.full(max(e, 1), -1, np.int32)
    em_mat = np.zeros(max(e, 1), np.int32)
    em_cdf = np.ones((max(e, 1), fmax + 1), np.float32)
    em_tri = np.zeros((max(e, 1), fmax), np.int32)
    shape_emitter = np.full(len(obj.shapes), -1, np.int32)
    for eid, (sid, ke, mid, total, cdf, tris) in enumerate(per_emitter):
        em_radiance[eid] = ke
        em_area[eid] = total
        em_shape[eid] = sid
        em_mat[eid] = mid
        em_cdf[eid, : len(cdf)] = cdf
        em_cdf[eid, len(cdf):] = 1.0 + 1e-6  # padding strictly above 1
        em_tri[eid, : len(tris)] = tris
        shape_emitter[sid] = eid

    emitters = EmitterTable(
        radiance=jnp.asarray(em_radiance),
        area=jnp.asarray(em_area),
        shape_id=jnp.asarray(em_shape),
        mat_id=jnp.asarray(em_mat),
        face_cdf=jnp.asarray(em_cdf),
        face_tri=jnp.asarray(em_tri),
    )

    scene = SceneData(
        geom=geom,
        n0=jnp.asarray(np.concatenate([n0r, pad3]).astype(np.float32)),
        n1=jnp.asarray(np.concatenate([n1r, pad3]).astype(np.float32)),
        n2=jnp.asarray(np.concatenate([n2r, pad3]).astype(np.float32)),
        ng=jnp.asarray(np.concatenate([ng, pad3]).astype(np.float32)),
        mat_id=jnp.asarray(padded(mat_r, padi)),
        shape_id=jnp.asarray(padded(shape_r, padi)),
        shape_emitter=jnp.asarray(shape_emitter),
        mat=_material_table(obj),
        emitters=emitters,
        treelets=treelets,
        treelets_any=treelets_any,
        uv0=jnp.asarray(np.concatenate([uv0, pad3[:, :2]])),
        uv1=jnp.asarray(np.concatenate([uv1, pad3[:, :2]])),
        uv2=jnp.asarray(np.concatenate([uv2, pad3[:, :2]])),
        mat_tex=jnp.asarray(mat_tex),
        tex_atlas=jnp.asarray(atlas),
        tex_size=jnp.asarray(tex_sizes),
    )

    # --- host metadata -----------------------------------------------------
    centers = np.zeros((len(obj.shapes), 3), np.float32)
    ab_min = np.full((len(obj.shapes), 3), np.inf, np.float32)
    ab_max = np.full((len(obj.shapes), 3), -np.inf, np.float32)
    for i, s in enumerate(obj.shapes):
        # Reference averages over *all* face-vertex references, repeats
        # included (renderer.cpp:295-304).
        pts = obj.vertices[s.v_idx.reshape(-1)]
        centers[i] = pts.mean(axis=0)
        ab_min[i] = pts.min(axis=0)
        ab_max[i] = pts.max(axis=0)

    meta = SceneMeta(
        n_triangles=t,
        n_materials=len(obj.materials),
        n_emitters=e,
        n_shapes=len(obj.shapes),
        shape_names=[s.name for s in obj.shapes],
        shapes_center=centers,
        shapes_aabb_min=ab_min,
        shapes_aabb_max=ab_max,
        material_names=[m.name for m in obj.materials],
        bvh_nodes=bvh.n_nodes,
    )
    return scene, meta


def load_scene(obj_path: str) -> tuple[SceneData, SceneMeta]:
    import os as _os

    return build_scene(load_obj(obj_path),
                       tex_dir=_os.path.dirname(_os.path.abspath(obj_path)))
