"""Bidirectional path tracer with VCM-style recursive MIS weights.

Wavefront reformulation of the reference BDPT (reference:
src/integrators/bdpt.h).  The recursive eye/light random walks become
`lax.scan`s over a fixed depth bound with masked lanes; the per-pixel-mutex
framebuffer splats (bdpt.h:360-370) become scatter-adds merged by `psum`
across devices; the all-pairs eye x light vertex connections run as an inner
scan over stored light-vertex slots.

MIS bookkeeping follows Georgiev's "Implementing VCM" tech report exactly as
the reference implements it, including its deliberate quirks (SURVEY.md
"quirks register"):
  * uniform-hemisphere emission direction (bdpt.h:165-166);
  * pure-specular eye paths skip the s=0 MIS weight (bdpt.h:95-100);
  * t=1 weights use 1/(W*H) light-path counting (bdpt.h:330-351);
  * s=0 technique uses emitterPositionPdf_a = 1/(area*emitterPdf)
    (bdpt.h:87 -- equivalent to the usual form only when there is a single
    emitter; replicated verbatim for parity);
  * NO_RR mode: rrDepth acts as a hard depth bound (bdpt.h:18,68,188);
  * RR mode: continuation probability 1.0 unless luminance(throughput) <
    0.01, then 0.5 (bdpt.h:129,201);
  * `rrProb` is parsed from the TOML into the config but never read by
    the estimator — exactly like the reference, which parses it for the
    BDPT block (main.cpp:105-106) into settings bdpt.h never uses.  Kept
    so the reference TOML schema round-trips; see BDPTConfig.rr_prob.

The compile-time ablation switches LIGHT_TRACING / PATH_TRACING
(bdpt.h:16-17) are runtime-static `mode` flags here: 'bdpt',
'light_trace', 'path_trace'.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..accel.api import trace_any, trace_closest
from ..bsdf import bsdf
from ..core import rng
from ..core.camera import generate_rays, splat_to_image_plane
from ..core.math import (
    EPSILON,
    INV_TWOPI,
    VIS_SHORTEN,
    frame_to_local,
    frame_to_world,
    is_zero_rgb,
    length,
    length2,
    luminance,
    make_frame,
    normalize,
)
from ..scene.scene import SceneData
from . import mis as mis_fn
from ..accel.traverse import Hit
from .common import (
    emission_at,
    make_interaction,
    sample_emitter_position,
    textured_kd,
)


@dataclasses.dataclass(frozen=True)
class BDPTConfig:
    """Static render configuration (hashable: used as a jit-static arg)."""

    width: int
    height: int
    spp: int
    rr_depth: int = 5
    rr_prob: float = 0.95          # parsed but unused, like the reference
    mode: str = "bdpt"             # bdpt | light_trace | path_trace
    no_rr: bool = True             # reference ships NO_RR=1 (bdpt.h:18)
    max_bounces: int = 32          # RR-mode hard cap (the reference has
                                   # none and can loop forever, bdpt.h:66-67)
    near: float = 1.0
    far: float = 1000.0
    # Per-technique toggles (default: all on = full BDPT).  Used by the
    # bench for exact telescoping stage attribution (disable one phase,
    # time the identical remaining pipeline) and as estimator ablations.
    connect_t1: bool = True        # light-vertex -> camera splats
    connect_s1: bool = True        # next-event estimation
    connect_s2: bool = True        # all-pairs vertex connections
    # Profiling-only ablation: False skips every occlusion trace (all
    # segments treated as visible).  The image is WRONG (light leaks);
    # the flag exists so the bench can split trace cost from
    # shading/MIS cost inside the identical pipeline.
    trace_vis: bool = True
    # Pooled light transport (SURVEY §5 "long-context analog" row): 0 =
    # reference semantics (one light subpath per pixel-sample, paired
    # per pixel, bdpt.h:219-241).  N > 0 = a GLOBAL pool of N light
    # subpaths per sample shared by every pixel: each eye vertex
    # connects against every pool subpath with 1/N averaging (unbiased
    # by linearity; VCM-style light-path counting with n_light = N in
    # every MIS weight), and t=1 splats come from the pool paths with
    # the same 1/N normalization.  This is the estimator whose connect
    # phase scales independently of pixel sharding — the pool shards
    # across the 'dp' mesh axis and ring-rotates via ppermute
    # (parallel/mesh.py render_chunk_pool_ring).
    light_pool: int = 0

    @property
    def n_steps(self) -> int:
        """Walk iterations: depth runs 1..rr_depth-1 in NO_RR mode
        (bdpt.h:68,188: `while depth < rrDepth`)."""
        if self.no_rr:
            return max(self.rr_depth - 1, 0)
        return self.max_bounces


class LightVertexSlots(NamedTuple):
    """Light subpath vertices, stacked (L, B, ...) by walk depth."""

    p: jnp.ndarray        # (L, B, 3)
    ns: jnp.ndarray       # (L, B, 3) shading normal
    wo: jnp.ndarray       # (L, B, 3) local
    throughput: jnp.ndarray  # (L, B, 3)
    vcm: jnp.ndarray      # (L, B)
    vc: jnp.ndarray       # (L, B)
    rr: jnp.ndarray       # (L, B)
    mat_id: jnp.ndarray   # (L, B)
    tri: jnp.ndarray      # (L, B) for texture UV lookups
    u: jnp.ndarray        # (L, B)
    v: jnp.ndarray        # (L, B)
    valid: jnp.ndarray    # (L, B)


# Lanes per dead-tile-clustering sort group in the s>=2 connect phase.
# One group == one 16x16 screen block of _blocked_pixel_order (256 lanes,
# a multiple of the 128-lane sweep tile), so the sort never mixes pixels
# from different blocks into one tile and the blocked spatial coherence
# that bounds per-tile treelet unions is preserved.
_CONNECT_SORT_G = 256

# Light-vertex slot layout for the s>=2 connect phase:
#   plain  slot-major flatten, slots in depth order (default)
#   pack   + stable front-pack of valid slots/pixel
#   sort   + grouped dead-tile clustering
# pack and sort spend a per-sample argsort + slot-pytree gather (pack)
# and per-depth eye-array gathers through the permutation (sort) to make
# whole tiles dead.  They are kept behind BPT_CONNECT_LAYOUT until they
# are measured on the H100 (not measured there yet).
import os as _os

_CONNECT_LAYOUT = _os.environ.get("BPT_CONNECT_LAYOUT", "plain")
assert _CONNECT_LAYOUT in ("plain", "pack", "sort")

# Mega-connect: resolve ALL of a sample's connection segments (NEE +
# camera + the full L x L all-pairs grid) in ONE any-hit
# launch per sample (_mega_connect) instead of 3 launches per eye depth.
# BPT_MEGA=0 restores the per-depth path for A/Bs; the lane budget caps
# the L*L*B pair grid (deep RR walks fall back automatically).  The 8M-lane
# default was sized for a 16 GB device and has not been measured on the
# H100.
_MEGA = _os.environ.get("BPT_MEGA", "1") == "1"
_MEGA_MAX_LANES = int(_os.environ.get("BPT_MEGA_MAX_LANES",
                                      str(8 * 1024 * 1024)))


def _front_pack_slots(slots: LightVertexSlots) -> LightVertexSlots:
    """Stable per-pixel partition of valid light-vertex slots to the front
    of the L axis.  Row l afterwards holds each pixel's l-th *valid* slot
    (original depth order preserved), so a pixel with k valid vertices has
    rows k..L-1 all-dead — the precondition for the dead-tile clustering
    sort in eye_subpath_walk."""
    order = jnp.argsort(~slots.valid, axis=0, stable=True)  # (L, B)

    def pack(a):
        idx = order.reshape(order.shape + (1,) * (a.ndim - 2))
        return jnp.take_along_axis(a, jnp.broadcast_to(idx, a.shape),
                                   axis=0)

    return jax.tree_util.tree_map(pack, slots)


def _rr_probability(cfg: BDPTConfig, depth, throughput):
    """Continuation probability for the *next* bounce
    (reference: bdpt.h:129-132, 201-204)."""
    if cfg.no_rr:
        return jnp.ones(throughput.shape[:-1], jnp.float32)
    lum_low = jax.lax.stop_gradient(luminance(throughput)) < 0.01
    rr = jnp.where(lum_low, 0.5, 1.0)
    return jnp.where(depth + 1 < cfg.rr_depth, 1.0, rr)


def _continue_walk(scene, lkeys, it, lane, rr_prob, throughput, vc, vcm,
                   alive):
    """ContinuePathRandomWalk (reference: bdpt.h:243-291).

    `lane` is the pre-gathered LaneMaterial at `it` (textured Kd folded
    in).  Returns (new_ray_o, new_ray_d, throughput, vc, vcm, alive,
    wi_local).
    """
    thr_in, vc_in, vcm_in = throughput, vc, vcm
    u2 = rng.uniform2(rng.lane_fold(lkeys, rng.BSDF_SAMPLE))
    s = bsdf.sample_lane(lane, it.wo, u2)
    pdf_w = s.pdf * rr_prob
    abs_cos_out = jnp.abs(s.wi[..., 2])
    dead = is_zero_rgb(s.value) | (pdf_w <= 0.0)
    safe_pdf = jnp.where(dead, 1.0, pdf_w)
    throughput = throughput * s.value / safe_pdf[..., None]

    # Reverse pdf: probability of generating the *previous* edge given the
    # new one; delta BSDFs reuse the forward pdf (bdpt.h:269-272).
    rev_pdf = bsdf.pdf_lane(lane, s.wi, it.wo) * rr_prob
    prev_rev_pdf = jnp.where(s.delta, pdf_w, rev_pdf)

    # vc/vcm recursion; delta case is Eqs. 53-54 (bdpt.h:274-285).
    vc, vcm = mis_fn.bounce_update(vc, vcm, abs_cos_out, safe_pdf,
                                   prev_rev_pdf, s.delta)

    d_world = frame_to_world(it.frame_ns, s.wi)
    alive_out = alive & ~dead
    # Freeze state on lanes that terminate here (or were already dead).
    throughput = jnp.where(alive_out[..., None], throughput, thr_in)
    vc = jnp.where(alive_out, vc, vc_in)
    vcm = jnp.where(alive_out, vcm, vcm_in)
    return it.p, d_world, throughput, vc, vcm, alive_out, s.wi


def _visible(scene, start, end, needed=None, trace_vis=True):
    """visibilityQuery: True when the segment is *occluded*
    (reference: bdpt.h:498-514).  Ray [Epsilon, dist - 1e-5].

    needed: optional (B,) mask; lanes already known dead are traced as
    degenerate segments (max_t < min_t), which empties their treelet
    overlap lists so occlusion tiles with many dead lanes sweep fewer
    blocks."""
    if not trace_vis:  # profiling ablation (BDPTConfig.trace_vis)
        return jnp.zeros(start.shape[:-1], bool)
    seg = end - start
    dist = length(seg)
    d = seg / jnp.maximum(dist, 1e-20)[..., None]
    max_t = dist - VIS_SHORTEN
    if needed is not None:
        max_t = jnp.where(needed, max_t, -1.0)
    return trace_any(scene, start, d, EPSILON, max_t)


def _connect_to_camera(scene, cam_consts, cfg: BDPTConfig, it, lane,
                       throughput, vcm, vc, rr_prob, active,
                       n_light=None):
    """t=1 technique: splat a light vertex onto the image plane
    (reference: bdpt.h:295-371, VCM Eqs. 46-47).

    n_light: light-path count for normalization + MIS (default W*H, the
    reference's one-subpath-per-pixel counting, bdpt.h:330-351; pooled
    mode passes cfg.light_pool).

    Visibility is DEFERRED (see _connect_to_light): returns
    (pixel (B,), rgb (B,3), ok (B,)) with rgb fully weighted but NOT
    occlusion-masked; the caller traces the [camera -> it.p] segments
    (batched with other segments where possible) and must zero rgb /
    drop pixel for occluded lanes.  pixel == W*H for pre-vis-dropped
    lanes."""
    w, h = cfg.width, cfg.height
    cam_o = cam_consts["o"]
    eye_to_lv = it.p - cam_o
    inv_d2 = 1.0 / jnp.maximum(length2(eye_to_lv), 1e-20)
    dirn = eye_to_lv * jnp.sqrt(inv_d2)[..., None]

    x_pix, y_pix, in_bounds = splat_to_image_plane(cam_consts, w, h, it.p)
    ok = active & in_bounds

    cos_cam = jnp.sum(cam_consts["forward"] * dirn, axis=-1)
    ok &= cos_cam > 0.0

    wi_local = frame_to_local(it.frame_ns, -dirn)
    f, _, prev_rev = bsdf.eval_pdfs_lane(lane, it.wo, wi_local)
    ok &= ~is_zero_rgb(f) & (wi_local[..., 2] > 0.0)

    # Safe-masked denominators: rejected lanes must stay finite all the way
    # through, or their NaN/inf would poison gradients via jnp.where.
    vnpd = cam_consts["vnpd"]
    cos_safe = jnp.where(ok, cos_cam, 1.0)
    img_pt_dist = vnpd / cos_safe
    image_area_to_solid = img_pt_dist * img_pt_dist / cos_safe
    cam_solid_to_area = wi_local[..., 2] * inv_d2
    image_to_surf = image_area_to_solid * cam_solid_to_area

    if n_light is None:
        n_light = float(w * h)
    safe_z = jnp.where(ok, jnp.maximum(wi_local[..., 2], 1e-20), 1.0)
    radiance = (
        throughput
        * f
        * (1.0 / safe_z)[..., None]
        * image_to_surf[..., None]
        * (1.0 / (n_light * cfg.spp))
    )

    # MIS weight (Eqs. 46-47): reverse pdf of the camera sampling the
    # vertex, in surface-area measure, over the light-path count.
    reverse_pdf_a = image_to_surf
    prev_rev_pdf = prev_rev * rr_prob
    mis = jax.lax.stop_gradient(
        mis_fn.weight_t1(reverse_pdf_a, n_light, prev_rev_pdf, vc, vcm))
    if cfg.mode == "bdpt":
        radiance = radiance * mis[..., None]

    pixel = y_pix * w + x_pix
    pixel = jnp.where(ok, pixel, w * h)
    radiance = jnp.where(ok[..., None], radiance, 0.0)
    return pixel, radiance, ok


def light_subpath_walk(scene, cam_consts, cfg: BDPTConfig, lkeys, b,
                       primary_alive, n_light=None, defer_t1=False):
    """Light walk (reference: bdpt.h:158-217).  `lkeys` is the per-lane key
    array for this sample.

    n_light: light-path count for the t=1 splats (see _connect_to_camera);
    pooled mode passes cfg.light_pool and b == pool-shard size.

    defer_t1=False: the t=1 occlusion is traced per depth in-scan and the
    returned splats are final.  defer_t1=True: NO t=1 traces happen here;
    the caller gets (slots, splat_pix, splat_rgb, nrays, t1_ok) with
    splat_rgb pre-visibility and t1_ok (L,B) the lanes whose
    [camera -> slots.p] segment still needs an occlusion test (the
    mega-connect batch in render_sample resolves them all in one
    launch).

    Returns (slots: LightVertexSlots, splat_pixels (L,B), splat_rgb (L,B,3),
    ray_count[, t1_ok])."""
    l = cfg.n_steps
    lk, init = _light_walk_init(scene, lkeys, b, primary_alive)

    if l == 0:
        zero3 = jnp.zeros((0, b, 3), jnp.float32)
        zero1 = jnp.zeros((0, b), jnp.float32)
        slots = LightVertexSlots(
            p=zero3, ns=zero3, wo=zero3, throughput=zero3, vcm=zero1,
            vc=zero1, rr=zero1, mat_id=jnp.zeros((0, b), jnp.int32),
            tri=jnp.zeros((0, b), jnp.int32), u=zero1, v=zero1,
            valid=jnp.zeros((0, b), bool),
        )
        if defer_t1:
            return (slots, jnp.zeros((0, b), jnp.int32), zero3,
                    jnp.int32(0), jnp.zeros((0, b), bool))
        return (slots, jnp.zeros((0, b), jnp.int32), zero3,
                jnp.int32(0))

    def step(carry, depth):
        carry, (ro, rd, rmn, rmx) = _light_pre(cfg, lk, carry, depth)
        hit = trace_closest(scene, ro, rd, rmn, rmx)
        return _light_post(scene, cam_consts, cfg, lk, n_light, defer_t1,
                           b, carry, depth, hit)

    depths = jnp.arange(1, l + 1)
    (carry, (slots, pix, rgb, t1_ok)) = jax.lax.scan(step, init, depths)
    if defer_t1:
        return slots, pix, rgb, carry[-1], t1_ok
    return slots, pix, rgb, carry[-1]


def _light_walk_init(scene, lkeys, b, primary_alive):
    """Light-walk setup (reference: bdpt.h:160-182): emitter position +
    direction sampling, initial throughput and MIS state.  Returns
    (lk, init_carry)."""
    lk = rng.lane_fold(lkeys, rng.LIGHT_WALK)
    es = sample_emitter_position(scene, lk)
    u_dir = rng.uniform2(rng.lane_fold(lk, rng.EMITTER_DIRECTION))
    from ..core import warp as _warp

    dir_local = _warp.square_to_uniform_hemisphere(u_dir)
    cos_out = dir_local[..., 2]
    emitter_pdf = es.select_pdf
    emission_pdf = INV_TWOPI * es.pos_pdf * emitter_pdf  # bdpt.h:166,168
    area_pdf = es.pos_pdf * emitter_pdf                  # bdpt.h:167

    light_frame = make_frame(es.normal)
    d = frame_to_world(light_frame, dir_local)

    safe_emission_pdf = jnp.maximum(emission_pdf, 1e-30)
    throughput = (
        cos_out[..., None] * es.radiance / safe_emission_pdf[..., None]
    )  # bdpt.h:173
    vc, vcm = mis_fn.light_walk_init(cos_out, safe_emission_pdf,
                                     area_pdf)  # bdpt.h:175-177
    alive = primary_alive & (cos_out > 0.0)               # bdpt.h:179-182
    init = (es.pos, d, throughput, vc, vcm, alive,
            jnp.ones((b,), jnp.float32), jnp.int32(0))
    return lk, init


def _light_pre(cfg: BDPTConfig, lk, carry, depth):
    """Light-walk step, ray-build half: RR termination + the bounce ray.
    Dead lanes trace degenerate rays (max_t < min_t -> empty treelet
    masks), so terminated walks stop paying traversal cost."""
    o, d, throughput, vc, vcm, alive, rr_prev, nrays = carry
    if not cfg.no_rr:
        kd = rng.lane_fold(lk, depth)
        u_rr = rng.uniform1(rng.lane_fold(kd, rng.RR))
        alive = alive & ((depth < cfg.rr_depth) | (u_rr < rr_prev))
    nrays = nrays + jnp.sum(alive)
    carry = (o, d, throughput, vc, vcm, alive, rr_prev, nrays)
    return carry, (o, d, EPSILON, jnp.where(alive, jnp.inf, -1.0))


def _light_post(scene, cam_consts, cfg: BDPTConfig, lk, n_light,
                defer_t1, b, carry, depth, hit):
    """Light-walk step, hit-consume half (reference: bdpt.h:186-215)."""
    o, d, throughput, vc, vcm, alive, rr_prev, nrays = carry
    kd = rng.lane_fold(lk, depth)

    alive = alive & hit.valid
    it = make_interaction(scene, d, hit)

    dist2 = hit.t * hit.t
    abs_cos_in = jnp.maximum(jnp.abs(it.wo[..., 2]), 1e-20)
    # Freeze dead lanes' MIS state: letting it keep updating can
    # overflow to inf across scan steps and poison gradients via
    # 0*inf in downstream weights.
    vc_u, vcm_u = mis_fn.measure_update(vc, vcm, dist2,
                                        abs_cos_in)  # bdpt.h:196-197
    vcm = jnp.where(alive, vcm_u, vcm)
    vc = jnp.where(alive, vc_u, vc)

    rr_prob = _rr_probability(cfg, depth, throughput)
    lane = bsdf.gather_lane(scene.mat, it.mat_id,
                            textured_kd(scene, it))
    delta = bsdf.is_delta(lane)

    if cfg.connect_t1:
        pix, rgb, okc = _connect_to_camera(
            scene, cam_consts, cfg, it, lane, throughput, vcm, vc,
            rr_prob, alive & ~delta, n_light=n_light,
        )
        if not defer_t1:
            occ = _visible(
                scene, jnp.broadcast_to(cam_consts["o"], it.p.shape),
                it.p, needed=okc, trace_vis=cfg.trace_vis)
            if cfg.trace_vis:
                nrays = nrays + jnp.sum(okc)
            okc &= ~occ
            pix = jnp.where(okc, pix, cfg.width * cfg.height)
            rgb = jnp.where(okc[..., None], rgb, 0.0)
    else:  # bench ablation: keep walk + vertex storage identical
        pix = jnp.full((b,), cfg.width * cfg.height, jnp.int32)
        rgb = jnp.zeros((b, 3), jnp.float32)
        okc = jnp.zeros((b,), bool)

    o2, d2, thr2, vc2, vcm2, alive2, wi = _continue_walk(
        scene, kd, it, lane, rr_prob, throughput, vc, vcm, alive
    )
    vertex_valid = alive & ~delta & alive2  # push-after-continue,
    # reference bdpt.h:211-215

    vertex = LightVertexSlots(
        p=it.p,
        ns=it.frame_ns[..., 2, :],
        wo=it.wo,
        throughput=throughput,
        vcm=vcm,
        vc=vc,
        rr=rr_prob,
        mat_id=it.mat_id,
        tri=it.tri,
        u=it.u,
        v=it.v,
        valid=vertex_valid,
    )
    return (o2, d2, thr2, vc2, vcm2, alive2, rr_prob, nrays), (
        vertex, pix, rgb, okc if defer_t1 else None)


def _connect_to_light(scene, cfg: BDPTConfig, lkeys, it, lane, throughput,
                      vcm, vc, rr_prob, active):
    """s=1 next-event estimation (reference: bdpt.h:374-430,
    VCM Eqs. 44-45).

    Visibility is DEFERRED: returns (li (B,3), ok (B,), end (B,3)) with
    li fully weighted but NOT occlusion-masked; the caller batches the
    [it.p -> end] segments with the s>=2 segments into one trace launch
    per eye depth (one launch's fixed cost instead of two)."""
    es = sample_emitter_position(scene, rng.lane_fold(lkeys, rng.NEE_WALK))

    l2e = it.p - es.pos
    dist2 = jnp.maximum(length2(l2e), 1e-20)
    dirn = l2e / jnp.sqrt(dist2)[..., None]

    wi_local = frame_to_local(it.frame_ns, -dirn)
    cos_at_light = jnp.sum(es.normal * dirn, axis=-1)
    cos_at_eye = wi_local[..., 2]
    ok = active & (cos_at_light > 0.0) & (cos_at_eye > 0.0)

    connect_pdf_a = es.select_pdf * es.pos_pdf
    # Safe-masked denominator (rejected lanes must stay finite for AD).
    cos_safe = jnp.where(ok, jnp.maximum(cos_at_light, 1e-20), 1.0)
    connect_pdf_w = connect_pdf_a * dist2 / cos_safe
    dir_pdf_w = INV_TWOPI  # squareToUniformHemispherePdf

    f, pdf_f, pdf_r = bsdf.eval_pdfs_lane(lane, it.wo, wi_local)
    li = (
        f * throughput * es.radiance
        / jnp.maximum(connect_pdf_w, 1e-30)[..., None]
    )
    ok &= ~is_zero_rgb(li)

    light_rev_pdf_w = pdf_f * rr_prob
    eye_prev_rev_pdf_w = pdf_r * rr_prob
    eye_cur_rev_pdf_a = cos_at_eye / dist2 * dir_pdf_w
    mis = jax.lax.stop_gradient(mis_fn.weight_s1(
        light_rev_pdf_w, jnp.maximum(connect_pdf_w, 1e-30),
        eye_cur_rev_pdf_a, eye_prev_rev_pdf_w, vc, vcm))
    if cfg.mode == "bdpt":
        li = li * mis[..., None]
    return jnp.where(ok[..., None], li, 0.0), ok, es.pos


def _connect_vertices(scene, lv_p, lv_frame, lv_wo, lv_thr, lv_vcm, lv_vc,
                      lv_rr, lv_lane, lv_valid, eye_p, eye_frame, eye_wo,
                      eye_lane, throughput, vcm, vc, rr_prob, active):
    """s>=2, t>=2 technique: deterministic connection of one light-vertex
    slot to the current eye vertex (reference: bdpt.h:434-483,
    VCM Eqs. 40-41).

    Visibility is DEFERRED (see _connect_to_light): returns
    (li (B,3), ok (B,)) with li fully weighted but NOT occlusion-masked;
    the caller traces the [eye_p -> lv_p] segments, batched with
    whatever other segments exist at the same program point.

    lv_frame / lv_lane are precomputed per light vertex (hoisted out of
    the eye-depth scan by the caller — they are loop-invariant)."""
    l2e = eye_p - lv_p
    inv_d2 = 1.0 / jnp.maximum(length2(l2e), 1e-20)
    dirn = l2e * jnp.sqrt(inv_d2)[..., None]

    wi_light = frame_to_local(lv_frame, dirn)
    wi_eye = frame_to_local(eye_frame, -dirn)
    cos_l = wi_light[..., 2]
    cos_e = wi_eye[..., 2]
    ok = active & lv_valid & (cos_l > 0.0) & (cos_e > 0.0)

    # Fused eval + forward/reverse pdfs (bsdf.eval_pdfs_lane): one
    # phong-lobe transcendental per side instead of five, for the MIS
    # reverse pdfs of bdpt.h:458-479.
    f_l, pdf_l_f, pdf_l_r = bsdf.eval_pdfs_lane(lv_lane, lv_wo, wi_light)
    f_e, pdf_e_f, pdf_e_r = bsdf.eval_pdfs_lane(eye_lane, eye_wo, wi_eye)
    li = f_l * f_e * lv_thr * throughput * inv_d2[..., None]

    pdf_l2e = pdf_l_f * lv_rr
    pdf_l_prev = pdf_l_r * lv_rr
    pdf_e2l = pdf_e_f * rr_prob
    pdf_e_prev = pdf_e_r * rr_prob

    light_rev_a = pdf_e2l * cos_l * inv_d2
    eye_rev_a = pdf_l2e * cos_e * inv_d2
    mis = jax.lax.stop_gradient(mis_fn.weight_connect(
        light_rev_a, pdf_l_prev, lv_vc, lv_vcm,
        eye_rev_a, pdf_e_prev, vc, vcm))

    li = li * mis[..., None]
    return jnp.where(ok[..., None], li, 0.0), ok


def eye_subpath_walk(scene, cam_consts, cfg: BDPTConfig, lkeys, primary_d,
                     slots: LightVertexSlots, n_light=None,
                     collect=False, defer_connect=False):
    """Eye walk (reference: bdpt.h:46-155).

    slots: per-pixel light-vertex slots for the in-walk s>=2 connections
    (None skips them — pooled mode connects outside the walk).
    n_light: MIS light-path count (default W*H; pooled mode passes the
    pool size).  collect: additionally return the eye-vertex slots
    (L, B, ...) for external connection phases.

    defer_connect: NO connection traces happen in the walk at all — NEE
    shading/MIS still runs per depth (same RNG streams), but its
    occlusion segments are returned for the caller's mega-connect batch,
    and the s>=2 phase is skipped entirely (the caller owns it, pairing
    the collected eye slots against the light slots).  Implies collect.
    Returns (li_s0 (B,3), ray_count, eye_slots,
    (nee_li (L,B,3), nee_ok (L,B), nee_end (L,B,3))).

    Returns (Li (B,3), ray_count) — plus eye slots when collect."""
    b = primary_d.shape[0]
    l = cfg.n_steps
    li = jnp.zeros((b, 3), jnp.float32)
    if defer_connect:
        collect = True
    if n_light is None:
        n_light = float(cfg.width * cfg.height)
    if l == 0:
        if defer_connect:
            zero3 = jnp.zeros((0, b, 3), jnp.float32)
            return li, jnp.int32(0), None, (
                zero3, jnp.zeros((0, b), bool), zero3)
        if collect:
            return li, jnp.int32(0), None
        return li, jnp.int32(0)

    # t=1 pdf machinery (bdpt.h:49-62).
    cos_cam = jnp.sum(cam_consts["forward"] * primary_d, axis=-1)
    vnpd = cam_consts["vnpd"]
    img_pt_dist = vnpd / jnp.maximum(cos_cam, 1e-20)
    image_to_solid = img_pt_dist * img_pt_dist / jnp.maximum(cos_cam, 1e-20)
    t1_pdf = image_to_solid

    throughput = jnp.ones((b, 3), jnp.float32)
    vc, vcm = mis_fn.eye_walk_init(n_light, t1_pdf)

    o0 = jnp.broadcast_to(cam_consts["o"], primary_d.shape)

    n_emitters = scene.emitters.radiance.shape[0]

    # ---- loop-invariant light-vertex data for the s>=2 connections ----
    # Slots are flattened SLOT-MAJOR (row l = every pixel's depth-l slot);
    # lane materials/frames gathered ONCE — not per eye depth; the
    # per-depth regather at (L*B,) width was a measured hotspot.
    #
    # Layout variants (front-packing, dead-tile clustering sort) are kept
    # behind BPT_CONNECT_LAYOUT for re-measurement; both LOSE on the
    # caustic bench — see the _CONNECT_LAYOUT table above.
    lv = None
    perm = inv_perm = None
    if (cfg.mode == "bdpt" and cfg.connect_s2 and l > 0
            and slots is not None and not defer_connect):
        from ..scene.textures import albedo_at

        lb = l * b
        if _CONNECT_LAYOUT in ("pack", "sort"):
            slots = _front_pack_slots(slots)
        if _CONNECT_LAYOUT == "sort":
            v_p = jnp.sum(slots.valid.astype(jnp.int32), axis=0)  # (B,)
            # Composite key (lane group, valid count): sorting by v_p
            # alone measured WORSE — a count class draws pixels from the
            # whole image, so live tiles lost the blocked spatial
            # coherence that bounds treelet unions.  Grouped sort keeps
            # each tile inside one lane group (= pixel blocks) and still
            # makes row l's dead lanes a contiguous prefix per group.
            grp = jnp.arange(b, dtype=jnp.int32) // _CONNECT_SORT_G
            perm = jnp.argsort(grp * jnp.int32(l + 1) + v_p, stable=True)
            inv_perm = jnp.argsort(perm)
            slots = jax.tree_util.tree_map(
                lambda a: jnp.take(a, perm, axis=1), slots)

        def flat(a):  # (L, B, ...) -> (L*B, ...) slot-major
            return a.reshape((lb,) + a.shape[2:])

        lv_kd = albedo_at(scene, flat(slots.tri), flat(slots.u),
                          flat(slots.v))
        lv = dict(
            p=flat(slots.p),
            frame=make_frame(flat(slots.ns)),
            wo=flat(slots.wo),
            thr=flat(slots.throughput),
            vcm=flat(slots.vcm),
            vc=flat(slots.vc),
            rr=flat(slots.rr),
            valid=flat(slots.valid),
            lane=bsdf.gather_lane(scene.mat, flat(slots.mat_id), lv_kd),
        )

    lk_eye = rng.lane_fold(lkeys, rng.EYE_WALK)  # loop-invariant

    def step(carry, depth):
        carry, (ro, rd, rmn, rmx) = _eye_pre(cfg, lk_eye, carry, depth)
        hit = trace_closest(scene, ro, rd, rmn, rmx)
        return _eye_post(scene, cam_consts, cfg, lk_eye, n_light, lv,
                         perm, inv_perm, l, b, collect, defer_connect,
                         carry, depth, hit)

    init = (o0, primary_d, throughput, vc, vcm,
            jnp.ones((b,), bool), jnp.ones((b,), jnp.float32),
            jnp.ones((b,), bool), li, jnp.int32(0))
    depths = jnp.arange(1, l + 1)
    carry, ys = jax.lax.scan(step, init, depths)
    if defer_connect:
        eye_slots, nee_pack = ys
        return carry[-2], carry[-1], eye_slots, nee_pack
    if collect:
        return carry[-2], carry[-1], ys
    return carry[-2], carry[-1]


def _eye_pre(cfg: BDPTConfig, lk_eye, carry, depth):
    """Eye-walk step, ray-build half: RR termination + the bounce ray.
    Primary rays carry the reference's [near, far] window
    (renderer.cpp:177,192); bounce rays are unbounded; dead lanes trace
    degenerate rays (empty treelet masks)."""
    (o, d, throughput, vc, vcm, alive, rr_prev, pure_spec, li,
     nrays) = carry
    if not cfg.no_rr:
        kd = rng.lane_fold(lk_eye, depth)
        u_rr = rng.uniform1(rng.lane_fold(kd, rng.RR))
        alive = alive & ((depth < cfg.rr_depth) | (u_rr < rr_prev))
    nrays = nrays + jnp.sum(alive)
    min_t = jnp.where(depth == 1, cfg.near, EPSILON)
    max_t = jnp.where(depth == 1, cfg.far, jnp.inf)
    carry = (o, d, throughput, vc, vcm, alive, rr_prev, pure_spec, li,
             nrays)
    return carry, (o, d, min_t, jnp.where(alive, max_t, -1.0))


def _eye_post(scene, cam_consts, cfg: BDPTConfig, lk_eye, n_light, lv,
              perm, inv_perm, l, b, collect, defer_connect, carry, depth,
              hit):
    """Eye-walk step, hit-consume half (reference: bdpt.h:68-152)."""
    (o, d, throughput, vc, vcm, alive, rr_prev, pure_spec, li,
     nrays) = carry
    kd = rng.lane_fold(lk_eye, depth)
    n_emitters = scene.emitters.radiance.shape[0]
    alive = alive & hit.valid
    it = make_interaction(scene, d, hit)

    if True:  # original scan-body indentation preserved below
        dist2 = hit.t * hit.t
        abs_cos_in = jnp.maximum(jnp.abs(it.wo[..., 2]), 1e-20)
        vc_u, vcm_u = mis_fn.measure_update(vc, vcm, dist2, abs_cos_in)
        vcm = jnp.where(alive, vcm_u, vcm)
        vc = jnp.where(alive, vc_u, vc)

        # ---- s=0: the eye path hit an emitter (bdpt.h:79-125) ----
        le = emission_at(scene, it.mat_id)
        hit_emitter = alive & ~is_zero_rgb(le)
        em_id = jnp.maximum(scene.shape_emitter[it.shape_id], 0)
        em_area = scene.emitters.area[em_id]
        emitter_pdf = 1.0 / n_emitters
        # Replicated verbatim: 1/(area*emitterPdf) (bdpt.h:87).
        pos_pdf_a = 1.0 / (em_area * emitter_pdf)
        dir_pdf_w = INV_TWOPI
        mis_s0 = jax.lax.stop_gradient(
            mis_fn.weight_s0(pos_pdf_a, dir_pdf_w, vc, vcm))

        contrib = scene.emitters.radiance[em_id] * throughput
        if cfg.mode == "bdpt":
            contrib = contrib * jnp.where(pure_spec, 1.0, mis_s0)[..., None]
            add_deep = hit_emitter & (depth > 1)
        elif cfg.mode == "path_trace":
            add_deep = hit_emitter & (depth > 1) & pure_spec
        else:  # light_trace: eye walk not used
            add_deep = jnp.zeros_like(hit_emitter)
        li = li + jnp.where(add_deep[..., None], contrib, 0.0)
        li = li + jnp.where(
            (hit_emitter & (depth == 1))[..., None], le, 0.0)
        alive = alive & ~hit_emitter  # break (bdpt.h:124)

        rr_prob = _rr_probability(cfg, depth, throughput)
        lane = bsdf.gather_lane(scene.mat, it.mat_id,
                                textured_kd(scene, it))
        delta = bsdf.is_delta(lane)
        connectable = alive & ~delta
        pure_spec = pure_spec & ~connectable  # bdpt.h:139

        # ---- s=1 NEE (bdpt.h:142) + s>=2 all-pairs (bdpt.h:145-149) ----
        # Both techniques' shading/MIS run with visibility DEFERRED, then
        # ALL their segments — (B,) NEE + (L*B,) slot-major all-pairs —
        # resolve in ONE trace launch per eye depth, so per-launch fixed
        # costs are paid once for both phases.
        nee_li = nee_ok = nee_end = None
        if cfg.connect_s1:
            nee_li, nee_ok, nee_end = _connect_to_light(
                scene, cfg, kd, it, lane, throughput, vcm, vc, rr_prob,
                connectable,
            )
        c_li = c_ok = None
        eye_p_t = None
        if lv is not None:
            def tile_eye(a):  # (B, ...) -> (L*B, ...): L copies of the
                # eye-lane arrays, gathered through the slot permutation so
                # lane l*b+j pairs pixel perm[j]'s eye vertex with pixel
                # perm[j]'s light subpath (same pixel-sample, bdpt.h:145-149
                # semantics; the permutation is layout-only).
                if perm is not None:
                    a = jnp.take(a, perm, axis=0)
                return jnp.broadcast_to(
                    a[None], (l,) + a.shape).reshape((l * b,) + a.shape[1:])

            lane_t = jax.tree_util.tree_map(tile_eye, lane)
            eye_p_t = tile_eye(it.p)
            c_li, c_ok = _connect_vertices(
                scene,
                lv["p"], lv["frame"], lv["wo"], lv["thr"], lv["vcm"],
                lv["vc"], lv["rr"], lv["lane"], lv["valid"],
                eye_p_t, tile_eye(it.frame_ns), tile_eye(it.wo),
                lane_t, tile_eye(throughput), tile_eye(vcm),
                tile_eye(vc), tile_eye(rr_prob), tile_eye(connectable),
            )

        if not defer_connect and (nee_li is not None or c_li is not None):
            starts, ends, oks = [], [], []
            if nee_li is not None:
                starts.append(it.p)
                ends.append(nee_end)
                oks.append(nee_ok)
            if c_li is not None:
                starts.append(eye_p_t)
                ends.append(lv["p"])
                oks.append(c_ok)
            ok_all = jnp.concatenate(oks)
            occ = _visible(scene, jnp.concatenate(starts),
                           jnp.concatenate(ends), needed=ok_all,
                           trace_vis=cfg.trace_vis)
            vis = ~occ
            if cfg.trace_vis:
                nrays = nrays + jnp.sum(ok_all)
            off = 0
            if nee_li is not None:
                li = li + jnp.where(vis[:b, None], nee_li, 0.0)
                off = b
            if c_li is not None:
                c = jnp.where(vis[off:, None], c_li, 0.0)
                # c is slot-major ((L, B) flattened) in *permuted* pixel
                # order: fold over slots, map back to original lane order.
                summed = jnp.sum(c.reshape(l, b, 3), axis=0)
                if inv_perm is not None:
                    summed = jnp.take(summed, inv_perm, axis=0)
                li = li + summed

        o2, d2, thr2, vc2, vcm2, alive2, _ = _continue_walk(
            scene, kd, it, lane, rr_prob, throughput, vc, vcm, alive
        )
        ys = None
        if collect:
            # The eye vertex as used by the s>=2 connection at THIS depth
            # (pre-continue state; reference connects the current vertex
            # before walking on, bdpt.h:142-152).
            ys = LightVertexSlots(
                p=it.p, ns=it.frame_ns[..., 2, :], wo=it.wo,
                throughput=throughput, vcm=vcm, vc=vc, rr=rr_prob,
                mat_id=it.mat_id, tri=it.tri, u=it.u, v=it.v,
                valid=connectable,
            )
        if defer_connect:
            if nee_li is None:  # connect_s1 ablation: empty NEE rows
                nee_li = jnp.zeros((b, 3), jnp.float32)
                nee_ok = jnp.zeros((b,), bool)
                nee_end = jnp.zeros((b, 3), jnp.float32)
            ys = (ys, (nee_li, nee_ok, nee_end))
        return (o2, d2, thr2, vc2, vcm2, alive2, rr_prob, pure_spec, li,
                nrays), ys


# Fused walks (BPT_FUSED_WALKS=0 restores separate scans for A/Bs): the
# mega-connect path runs BOTH subpath walks in ONE scan, so each depth
# issues a single 2B-lane closest-hit launch (eye bounce rays ++ light
# bounce rays) instead of two B-lane launches, halving per-launch fixed
# costs.
_FUSED_WALKS = _os.environ.get("BPT_FUSED_WALKS", "1") == "1"


def fused_subpath_walks(scene, cam_consts, cfg: BDPTConfig, lkeys, b,
                        primary_d, primary_alive, n_light=None):
    """Both subpath walks in one scan, visibility fully deferred (the
    defer_t1 / defer_connect variants of the solo walks, same RNG
    streams and identical per-step math — this is launch batching only).

    Returns (light_slots, t1_pix, t1_rgb, t1_ok, li_s0, eye_slots,
    nee_pack, nrays)."""
    l = cfg.n_steps
    if n_light is None:
        n_light = float(cfg.width * cfg.height)
    lk_l, init_l = _light_walk_init(scene, lkeys, b, primary_alive)
    lk_e = rng.lane_fold(lkeys, rng.EYE_WALK)

    cos_cam = jnp.sum(cam_consts["forward"] * primary_d, axis=-1)
    img_pt_dist = cam_consts["vnpd"] / jnp.maximum(cos_cam, 1e-20)
    t1_pdf = img_pt_dist * img_pt_dist / jnp.maximum(cos_cam, 1e-20)
    vc_e, vcm_e = mis_fn.eye_walk_init(n_light, t1_pdf)
    o0 = jnp.broadcast_to(cam_consts["o"], primary_d.shape)
    init_e = (o0, primary_d, jnp.ones((b, 3), jnp.float32), vc_e, vcm_e,
              jnp.ones((b,), bool), jnp.ones((b,), jnp.float32),
              jnp.ones((b,), bool), jnp.zeros((b, 3), jnp.float32),
              jnp.int32(0))

    def step(carry, depth):
        ec, lc = carry
        ec, (eo, ed, emn, emx) = _eye_pre(cfg, lk_e, ec, depth)
        lc, (lo, ld, lmn, lmx) = _light_pre(cfg, lk_l, lc, depth)
        o = jnp.concatenate([eo, lo])
        d = jnp.concatenate([ed, ld])
        mn = jnp.concatenate([jnp.broadcast_to(emn, (b,)),
                              jnp.broadcast_to(lmn, (b,))])
        mx = jnp.concatenate([emx, lmx])
        hit = trace_closest(scene, o, d, mn, mx)
        split = lambda a: (a[:b], a[b:])
        et, lt = split(hit.t)
        etri, ltri = split(hit.tri)
        eu, lu = split(hit.u)
        ev, lv_ = split(hit.v)
        eva, lva = split(hit.valid)
        ec, eys = _eye_post(
            scene, cam_consts, cfg, lk_e, n_light, None, None, None, l,
            b, True, True, ec, depth,
            Hit(t=et, tri=etri, u=eu, v=ev, valid=eva))
        lc, lys = _light_post(
            scene, cam_consts, cfg, lk_l, n_light, True, b, lc, depth,
            Hit(t=lt, tri=ltri, u=lu, v=lv_, valid=lva))
        return (ec, lc), (eys, lys)

    depths = jnp.arange(1, l + 1)
    (ec, lc), (eys, lys) = jax.lax.scan(step, (init_e, init_l), depths)
    eye_slots, nee_pack = eys
    light_slots, t1_pix, t1_rgb, t1_ok = lys
    li_s0 = ec[-2]
    nrays = ec[-1] + lc[-1]
    return (light_slots, t1_pix, t1_rgb, t1_ok, li_s0, eye_slots,
            nee_pack, nrays)


def render_sample(scene: SceneData, cam_consts, cfg: BDPTConfig, key,
                  pixel_idx, lkeys=None):
    """One pixel-sample per lane -> framebuffer contribution.

    Mirrors BDPTIntegrator::render (reference: bdpt.h:219-241) plus the
    driver's per-pixel accumulation (renderer.cpp:183-207), returning a
    dense (W*H, 3) framebuffer increment (eye contributions at their own
    pixel + light-tracing splats anywhere).

    lkeys: optional pre-built (B,) lane keys; callers batching several
    samples in one dispatch pass tiled pixel ids with per-(pixel, sample)
    keys (key is then unused).
    """
    b = pixel_idx.shape[0]
    w, h = cfg.width, cfg.height

    if lkeys is None:
        lkeys = rng.lane_keys(key, pixel_idx)
    jitter = None
    if cfg.spp > 1:
        jitter = rng.uniform2(rng.lane_fold(lkeys, rng.PIXEL_JITTER))
    o, d = generate_rays(cam_consts, w, h, pixel_idx, jitter)

    primary_hit = trace_closest(scene, o, d, cfg.near, cfg.far)
    primary_alive = primary_hit.valid
    nrays = jnp.int32(b)

    # Mega-connect path (default on bdpt mode): ALL connection segments
    # of the sample resolve in ONE any-hit launch (see
    # _mega_connect); when the pair grid exceeds the lane budget (deep
    # RR walks) it runs chunked over eye-depth rows instead — the
    # per-depth fallback only remains for BPT_MEGA=0 A/Bs.
    l = cfg.n_steps
    if cfg.mode == "bdpt" and l > 0 and _MEGA:
        if _FUSED_WALKS:
            (slots, t1_pix, t1_rgb, t1_ok, li, eye_slots,
             (nee_li, nee_ok, nee_end), nr_w) = fused_subpath_walks(
                scene, cam_consts, cfg, lkeys, b, d, primary_alive)
            nrays = nrays + nr_w
        else:
            slots, t1_pix, t1_rgb, nr_l, t1_ok = light_subpath_walk(
                scene, cam_consts, cfg, lkeys, b, primary_alive,
                defer_t1=True)
            nrays = nrays + nr_l
            (li, nr_e, eye_slots,
             (nee_li, nee_ok, nee_end)) = eye_subpath_walk(
                scene, cam_consts, cfg, lkeys, d, None,
                defer_connect=True)
            nrays = nrays + nr_e
        li_c, splat_pix_f, splat_rgb_f, nr_c = _mega_connect(
            scene, cam_consts, cfg, eye_slots, slots,
            nee_li, nee_ok, nee_end, t1_pix, t1_rgb,
            t1_ok if cfg.connect_t1 else None)
        nrays = nrays + nr_c
        li = jnp.where(primary_alive[..., None], li + li_c, 0.0)

        fb = jnp.zeros((w * h + 1, 3), jnp.float32)
        fb = fb.at[pixel_idx].add(li / cfg.spp)
        fb = fb.at[splat_pix_f].add(splat_rgb_f)
        return fb[: w * h], nrays

    if cfg.mode in ("bdpt", "light_trace"):
        slots, splat_pix, splat_rgb, nr_l = light_subpath_walk(
            scene, cam_consts, cfg, lkeys, b, primary_alive
        )
        nrays = nrays + nr_l
    else:
        l = cfg.n_steps
        zero3 = jnp.zeros((l, b, 3), jnp.float32)
        zero1 = jnp.zeros((l, b), jnp.float32)
        slots = LightVertexSlots(
            p=zero3, ns=zero3, wo=zero3, throughput=zero3, vcm=zero1,
            vc=zero1, rr=zero1, mat_id=jnp.zeros((l, b), jnp.int32),
            tri=jnp.zeros((l, b), jnp.int32), u=zero1, v=zero1,
            valid=jnp.zeros((l, b), bool),
        )
        splat_pix = jnp.zeros((0, b), jnp.int32)
        splat_rgb = jnp.zeros((0, b, 3), jnp.float32)

    if cfg.mode == "light_trace":
        le = emission_at(
            scene, make_interaction(scene, d, primary_hit).mat_id
        )
        li = jnp.where(primary_alive[..., None], le, 0.0)
        nr_e = jnp.int32(0)
    else:
        li, nr_e = eye_subpath_walk(
            scene, cam_consts, cfg, lkeys, d, slots
        )
        li = jnp.where(primary_alive[..., None], li, 0.0)
    nrays = nrays + nr_e

    fb = jnp.zeros((w * h + 1, 3), jnp.float32)
    fb = fb.at[pixel_idx].add(li / cfg.spp)
    if splat_pix.shape[0] > 0:
        fb = fb.at[splat_pix.reshape(-1)].add(
            splat_rgb.reshape(-1, 3))
    return fb[: w * h], nrays


def _mega_connect(scene, cam_consts, cfg: BDPTConfig,
                  eye_slots: LightVertexSlots,
                  light_slots: LightVertexSlots,
                  nee_li, nee_ok, nee_end, t1_pix, t1_rgb, t1_ok):
    """Resolve EVERY connection segment of one sample in ONE
    visibility launch: s=1 NEE (L*B), t=1 camera splats (L*B), and the
    full s>=2 all-pairs grid (L*L*B per-pixel eye-depth x light-slot
    pairs, the reference's nested loop bdpt.h:145-149).

    The walks run with visibility deferred (eye_subpath_walk
    defer_connect / light_subpath_walk defer_t1), so the whole sample
    does exactly ONE any-hit launch over ~L(L+2)B lanes instead of 3L
    launches each over mostly-dead lanes.

    When the full L*L*B pair grid exceeds the lane budget (deep RR
    walks: L = max_bounces), the grid is processed in CHUNKS of
    eye-depth rows via lax.scan — ceil(L/C) launches of C*L*B pair
    lanes each (C = budget // (L*B)) plus one NEE+t1 launch — instead
    of the r4 behavior of abandoning mega-connect entirely for the
    3-launches-per-depth path (VERDICT r4 weak #5: the hardlight/RR
    estimator was stuck on the slow path).

    Pair lanes are built by BROADCAST (dense writes), never gather:
    eye arrays repeat along the light-slot axis, light arrays along the
    eye-depth axis.

    Returns (li_connect (B,3), splat_pix (L*B,), splat_rgb (L*B,3),
    n_vis_rays)."""
    from ..scene.textures import albedo_at

    l, b = eye_slots.valid.shape
    lb = l * b
    cam_o = cam_consts["o"]

    starts, ends, oks = [], [], []
    n_nee = n_t1 = n_pair = 0

    if cfg.connect_s1:
        starts.append(eye_slots.p.reshape(lb, 3))
        ends.append(nee_end.reshape(lb, 3))
        oks.append(nee_ok.reshape(lb))
        n_nee = lb
    if cfg.connect_t1 and t1_ok is not None:
        starts.append(jnp.broadcast_to(cam_o, (lb, 3)))
        ends.append(light_slots.p.reshape(lb, 3))
        oks.append(t1_ok.reshape(lb))
        n_t1 = lb

    # Chunked pair grid when L*L*B exceeds the lane budget (RR mode).
    chunked = cfg.connect_s2 and l * l * b > _MEGA_MAX_LANES

    c_li = None
    if cfg.connect_s2 and not chunked:
        llb = l * l * b

        def eye_pair(a):   # (L, B, ...) -> (L_t, L_s, B, ...) flat
            return jnp.broadcast_to(
                a[:, None], (l, l, b) + a.shape[2:]).reshape(
                    (llb,) + a.shape[2:])

        def light_pair(a):  # (L, B, ...) -> repeat along the t axis
            return jnp.broadcast_to(
                a[None], (l, l, b) + a.shape[2:]).reshape(
                    (llb,) + a.shape[2:])

        lv_kd = albedo_at(scene, light_slots.tri.reshape(lb),
                          light_slots.u.reshape(lb),
                          light_slots.v.reshape(lb))
        lv_lane = bsdf.gather_lane(
            scene.mat, light_slots.mat_id.reshape(lb), lv_kd)
        lv_lane = jax.tree_util.tree_map(
            lambda a: light_pair(a.reshape((l, b) + a.shape[1:])),
            lv_lane)
        lv_frame = light_pair(make_frame(light_slots.ns))

        eye_kd = albedo_at(scene, eye_slots.tri.reshape(lb),
                           eye_slots.u.reshape(lb),
                           eye_slots.v.reshape(lb))
        eye_lane = bsdf.gather_lane(
            scene.mat, eye_slots.mat_id.reshape(lb), eye_kd)
        eye_lane = jax.tree_util.tree_map(
            lambda a: eye_pair(a.reshape((l, b) + a.shape[1:])),
            eye_lane)
        eye_frame = eye_pair(make_frame(eye_slots.ns))

        eye_p = eye_pair(eye_slots.p)
        lv_p = light_pair(light_slots.p)
        c_li, c_ok = _connect_vertices(
            scene,
            lv_p, lv_frame, light_pair(light_slots.wo),
            light_pair(light_slots.throughput),
            light_pair(light_slots.vcm), light_pair(light_slots.vc),
            light_pair(light_slots.rr), lv_lane,
            light_pair(light_slots.valid),
            eye_p, eye_frame, eye_pair(eye_slots.wo), eye_lane,
            eye_pair(eye_slots.throughput), eye_pair(eye_slots.vcm),
            eye_pair(eye_slots.vc), eye_pair(eye_slots.rr),
            eye_pair(eye_slots.valid),
        )
        starts.append(eye_p)
        ends.append(lv_p)
        oks.append(c_ok)
        n_pair = llb

    li = jnp.zeros((b, 3), jnp.float32)
    if t1_ok is None:
        t1_pix = jnp.full((lb,), cfg.width * cfg.height, jnp.int32)
        t1_rgb = jnp.zeros((lb, 3), jnp.float32)
    else:
        t1_pix = t1_pix.reshape(lb)
        t1_rgb = t1_rgb.reshape(lb, 3)
    if not starts:
        return li, t1_pix, t1_rgb, jnp.int32(0)

    ok_all = jnp.concatenate(oks)
    occ = _visible(scene, jnp.concatenate(starts), jnp.concatenate(ends),
                   needed=ok_all, trace_vis=cfg.trace_vis)
    vis = ~occ
    nrays = jnp.sum(ok_all) if cfg.trace_vis else jnp.int32(0)

    off = 0
    if n_nee:
        v = vis[:n_nee].reshape(l, b)
        li = li + jnp.sum(
            jnp.where(v[..., None], nee_li, 0.0), axis=0)
        off = n_nee
    if n_t1:
        ok2 = t1_ok.reshape(lb) & vis[off:off + n_t1]
        t1_pix = jnp.where(ok2, t1_pix, cfg.width * cfg.height)
        t1_rgb = jnp.where(ok2[..., None], t1_rgb, 0.0)
        off += n_t1
    if n_pair:
        c = jnp.where(vis[off:, None], c_li, 0.0)
        li = li + jnp.sum(c.reshape(l, l, b, 3), axis=(0, 1))
    if chunked:
        li_p, nr_p = _pair_connect_chunked(scene, cfg, eye_slots,
                                           light_slots)
        li = li + li_p
        nrays = nrays + nr_p
    return li, t1_pix, t1_rgb, nrays


def _pair_connect_chunked(scene, cfg: BDPTConfig,
                          eye_slots: LightVertexSlots,
                          light_slots: LightVertexSlots):
    """s>=2 all-pairs connect, chunked over eye-depth rows.

    Used when the full L*L*B pair grid exceeds _MEGA_MAX_LANES (deep RR
    walks).  Each lax.scan step owns C eye-depth rows: it shades and
    traces the C*L*B pair lanes of those rows in one any-hit
    launch.  Light-vertex lane data is gathered once outside the scan
    (loop-invariant).  Returns (li (B,3), n_vis_rays)."""
    from ..scene.textures import albedo_at

    l, b = eye_slots.valid.shape
    lb = l * b
    c = max(1, min(l, _MEGA_MAX_LANES // (l * b)))
    n_ch = -(-l // c)
    pad = n_ch * c - l

    def pad_rows(a):
        if pad == 0:
            return a
        return jnp.concatenate(
            [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)])

    # (n_ch, C, B, ...) eye rows; padded rows are invalid (valid=False).
    eye_ch = jax.tree_util.tree_map(
        lambda a: pad_rows(a).reshape((n_ch, c) + a.shape[1:]), eye_slots)

    # Loop-invariant light-side pair data, (L, B, ...) leaves.
    lv_kd = albedo_at(scene, light_slots.tri.reshape(lb),
                      light_slots.u.reshape(lb),
                      light_slots.v.reshape(lb))
    lv_lane = bsdf.gather_lane(
        scene.mat, light_slots.mat_id.reshape(lb), lv_kd)
    lv_lane = jax.tree_util.tree_map(
        lambda a: a.reshape((l, b) + a.shape[1:]), lv_lane)
    lv_frame = make_frame(light_slots.ns)            # (L, B, 3, 3)

    clb = c * l * b

    def eye_pair(a):   # (C, B, ...) -> (C, L, B, ...) flat
        return jnp.broadcast_to(
            a[:, None], (c, l, b) + a.shape[2:]).reshape(
                (clb,) + a.shape[2:])

    def light_pair(a):  # (L, B, ...) -> repeat along the C axis
        return jnp.broadcast_to(
            a[None], (c, l, b) + a.shape[2:]).reshape(
                (clb,) + a.shape[2:])

    def body(carry, ec):
        li_a, nr_a = carry
        eye_kd = albedo_at(scene, ec.tri.reshape(c * b),
                           ec.u.reshape(c * b), ec.v.reshape(c * b))
        eye_lane = bsdf.gather_lane(
            scene.mat, ec.mat_id.reshape(c * b), eye_kd)
        eye_lane = jax.tree_util.tree_map(
            lambda a: eye_pair(a.reshape((c, b) + a.shape[1:])),
            eye_lane)
        eye_p = eye_pair(ec.p)
        lv_p = light_pair(light_slots.p)
        c_li, c_ok = _connect_vertices(
            scene,
            lv_p, light_pair(lv_frame), light_pair(light_slots.wo),
            light_pair(light_slots.throughput),
            light_pair(light_slots.vcm), light_pair(light_slots.vc),
            light_pair(light_slots.rr),
            jax.tree_util.tree_map(light_pair, lv_lane),
            light_pair(light_slots.valid),
            eye_p, eye_pair(make_frame(ec.ns)), eye_pair(ec.wo),
            eye_lane, eye_pair(ec.throughput), eye_pair(ec.vcm),
            eye_pair(ec.vc), eye_pair(ec.rr), eye_pair(ec.valid),
        )
        occ = _visible(scene, eye_p, lv_p, needed=c_ok,
                       trace_vis=cfg.trace_vis)
        v = jnp.where((~occ)[..., None], c_li, 0.0)
        li_a = li_a + jnp.sum(v.reshape(c, l, b, 3), axis=(0, 1))
        nr = jnp.sum(c_ok) if cfg.trace_vis else jnp.int32(0)
        return (li_a, nr_a + nr), None

    (li, nrays), _ = jax.lax.scan(
        body, (jnp.zeros((b, 3), jnp.float32), jnp.int32(0)), eye_ch)
    return li, nrays


def connect_pool(scene, cfg: BDPTConfig, eye_slots: LightVertexSlots,
                 pool_slots: LightVertexSlots, n_pool: int,
                 chunk: int = None):
    """All-pairs connection of every eye vertex against every pool light
    vertex, averaged by the pool path count (pooled mode's s>=2 phase).

    eye_slots: (L_e, B, ...) from eye_subpath_walk(collect=True).
    pool_slots: (L_p, P_shard, ...) — ONE shard of the global pool (the
    ring driver calls this once per shard rotation).
    n_pool: TOTAL pool path count (the 1/N averaging + MIS n_light).

    The quadratic pair set is swept in chunks of pool vertices so each
    visibility trace stays near the tuned batch width.  Returns
    (li (B, 3), n_rays)."""
    from ..scene.textures import albedo_at

    l_e, b = eye_slots.valid.shape
    l_p, p = pool_slots.valid.shape
    e = l_e * b
    lp = l_p * p
    if e == 0 or lp == 0:
        return jnp.zeros((b, 3), jnp.float32), jnp.int32(0)
    if chunk is None:
        chunk = max(1, min(lp, 458752 // max(e, 1)))
    n_chunks = -(-lp // chunk)
    pad = n_chunks * chunk - lp

    def flat_pad(a):  # (L_p, P, ...) -> (n_chunks, chunk, ...)
        a = a.reshape((lp,) + a.shape[2:])
        if pad:
            a = jnp.concatenate(
                [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)])
        return a.reshape((n_chunks, chunk) + a.shape[1:])

    pv_kd = albedo_at(
        scene, pool_slots.tri.reshape(lp), pool_slots.u.reshape(lp),
        pool_slots.v.reshape(lp))
    pool_lane = bsdf.gather_lane(
        scene.mat, pool_slots.mat_id.reshape(lp), pv_kd)
    pool_lane = jax.tree_util.tree_map(
        lambda a: flat_pad(a.reshape((l_p, p) + a.shape[1:])), pool_lane)
    lv = dict(
        p=flat_pad(pool_slots.p),
        frame=flat_pad(make_frame(pool_slots.ns)),
        wo=flat_pad(pool_slots.wo),
        thr=flat_pad(pool_slots.throughput),
        vcm=flat_pad(pool_slots.vcm),
        vc=flat_pad(pool_slots.vc),
        rr=flat_pad(pool_slots.rr),
        valid=flat_pad(pool_slots.valid),
        lane=pool_lane,
    )

    # Eye side, flattened to (E,) and lane-materials gathered once.
    def eflat(a):
        return a.reshape((e,) + a.shape[2:])

    eye_kd = albedo_at(scene, eflat(eye_slots.tri), eflat(eye_slots.u),
                       eflat(eye_slots.v))
    eye = dict(
        p=eflat(eye_slots.p),
        frame=make_frame(eflat(eye_slots.ns)),
        wo=eflat(eye_slots.wo),
        thr=eflat(eye_slots.throughput),
        vcm=eflat(eye_slots.vcm),
        vc=eflat(eye_slots.vc),
        rr=eflat(eye_slots.rr),
        valid=eflat(eye_slots.valid),
        lane=bsdf.gather_lane(scene.mat, eflat(eye_slots.mat_id), eye_kd),
    )

    def tile_eye(a):  # (E, ...) -> (chunk*E, ...)
        return jnp.broadcast_to(
            a[None], (chunk,) + a.shape).reshape(
                (chunk * e,) + a.shape[1:])

    eye_t = {k: jax.tree_util.tree_map(tile_eye, v)
             for k, v in eye.items()}

    def rep_pool(a):  # (chunk, ...) -> (chunk*E, ...): each pool vertex
        return jnp.repeat(a, e, axis=0)       # against every eye lane

    def body(carry, lv_c):
        li, nrays = carry
        lv_p = rep_pool(lv_c["p"])
        c_li, c_ok = _connect_vertices(
            scene,
            lv_p, rep_pool(lv_c["frame"]),
            rep_pool(lv_c["wo"]), rep_pool(lv_c["thr"]),
            rep_pool(lv_c["vcm"]), rep_pool(lv_c["vc"]),
            rep_pool(lv_c["rr"]),
            jax.tree_util.tree_map(rep_pool, lv_c["lane"]),
            rep_pool(lv_c["valid"]),
            eye_t["p"], eye_t["frame"], eye_t["wo"], eye_t["lane"],
            eye_t["thr"], eye_t["vcm"], eye_t["vc"], eye_t["rr"],
            eye_t["valid"],
        )
        occ = _visible(scene, eye_t["p"], lv_p, needed=c_ok,
                       trace_vis=cfg.trace_vis)
        c = jnp.where((~occ)[:, None], c_li, 0.0)
        nv = jnp.sum(c_ok) if cfg.trace_vis else jnp.int32(0)
        # (chunk*E, 3) -> fold pool chunk AND eye depth -> (B, 3)
        li = li + jnp.sum(c.reshape(chunk, l_e, b, 3), axis=(0, 1))
        return (li, nrays + nv), None

    (li, nrays), _ = jax.lax.scan(
        body, (jnp.zeros((b, 3), jnp.float32), jnp.int32(0)), lv)
    return li / float(n_pool), nrays


def render_sample_pool(scene: SceneData, cam_consts, cfg: BDPTConfig, key,
                       pixel_idx, pool_ids, rotate_fn=None, n_ring=1,
                       lkeys=None):
    """One pooled-light-transport sample (cfg.light_pool > 0).

    Estimator: a global pool of cfg.light_pool light subpaths per sample,
    shared by every pixel; each eye vertex connects against every pool
    subpath with 1/N averaging, t=1 splats come from the pool with the
    same path counting, s=0/s=1 stay per-eye-vertex.  Unbiased (each pool
    path is an i.i.d. light subpath) and equal in expectation to the
    per-pixel pairing at light_pool == 1-per-pixel counting.

    pool_ids: (P_shard,) GLOBAL pool indices owned by this shard — RNG is
    keyed by pool identity, so the estimate is invariant to sharding.
    rotate_fn/n_ring: ring driver hooks (parallel/mesh.py): after each
    connect_pool pass the pool shard is rotated to the next device;
    n_ring = number of shards = ppermute steps.  Defaults run the whole
    pool locally in one pass.

    Returns (framebuffer (W*H, 3), n_rays)."""
    b = pixel_idx.shape[0]
    w, h = cfg.width, cfg.height
    n_pool = cfg.light_pool

    if lkeys is None:
        lkeys = rng.lane_keys(key, pixel_idx)
    jitter = None
    if cfg.spp > 1:
        jitter = rng.uniform2(rng.lane_fold(lkeys, rng.PIXEL_JITTER))
    o, d = generate_rays(cam_consts, w, h, pixel_idx, jitter)

    primary_hit = trace_closest(scene, o, d, cfg.near, cfg.far)
    primary_alive = primary_hit.valid
    nrays = jnp.int32(b)

    # Pool light walk: keys by GLOBAL pool id (sharding-invariant).
    pkeys = rng.lane_keys(rng.stream(key, rng.POOL_WALK), pool_ids)
    pool_slots, splat_pix, splat_rgb, nr_l = light_subpath_walk(
        scene, cam_consts, cfg, pkeys, pool_ids.shape[0],
        jnp.ones((pool_ids.shape[0],), bool), n_light=float(n_pool),
    )
    nrays = nrays + nr_l

    # Eye walk: s=0 + s=1 only; slots collected for the pool phase.
    li, nr_e, eye_slots = eye_subpath_walk(
        scene, cam_consts, cfg, lkeys, d, None,
        n_light=float(n_pool), collect=True,
    )
    nrays = nrays + nr_e

    # s>=2 via the pool, one pass per ring shard.
    if cfg.connect_s2 and eye_slots is not None:
        cur = pool_slots
        for r in range(n_ring):
            li_c, nv = connect_pool(scene, cfg, eye_slots, cur, n_pool)
            li = li + li_c
            nrays = nrays + nv
            if rotate_fn is not None and r + 1 < n_ring:
                cur = rotate_fn(cur)

    li = jnp.where(primary_alive[..., None], li, 0.0)

    fb = jnp.zeros((w * h + 1, 3), jnp.float32)
    fb = fb.at[pixel_idx].add(li / cfg.spp)
    if splat_pix.shape[0] > 0:
        fb = fb.at[splat_pix.reshape(-1)].add(splat_rgb.reshape(-1, 3))
    return fb[: w * h], nrays


def _blocked_pixel_order(w: int, h: int, bs: int = 16):
    """Pixel ids ordered by bs x bs screen blocks (Z-ish order).

    Lane order is arbitrary for correctness (RNG is keyed by pixel id and
    the framebuffer is scatter-added by pixel id), but the tracers tile
    consecutive lanes — square blocks keep a tile's rays, its bounce rays,
    and its shadow-connection segments spatially coherent, which shrinks
    the per-tile treelet unions the sweep kernels iterate over."""
    if w % bs or h % bs:
        return jnp.arange(w * h, dtype=jnp.int32)
    idx = jnp.arange(w * h, dtype=jnp.int32).reshape(h, w)
    idx = idx.reshape(h // bs, bs, w // bs, bs)
    return jnp.transpose(idx, (0, 2, 1, 3)).reshape(-1)


@partial(jax.jit, static_argnames=("cfg", "spp_chunk", "samples_per_batch"))
def render_chunk(scene: SceneData, cam_consts, cfg: BDPTConfig, key,
                 spp_chunk: int = 1, sample_offset=0,
                 samples_per_batch: int = 1):
    """Render `spp_chunk` full-image samples, accumulating a framebuffer.

    Sample s gets key fold_in(key, sample_offset + s), so the estimate is
    invariant to chunking, to device sharding, AND to samples_per_batch
    (randomness is keyed by (pixel, sample) identity, never array
    position).  The returned buffer is already divided by cfg.spp (total),
    so summing all chunks yields the final image (reference accumulation:
    renderer.cpp:183-207).

    samples_per_batch: samples fused into one wavefront dispatch (lanes =
    sb * W * H), at the cost of proportional path-state memory.  Must
    divide spp_chunk.  The library default stays 1 (smallest memory at
    any resolution); bench.py uses sb=2, a value not yet measured on the
    H100."""
    w, h = cfg.width, cfg.height
    sb = samples_per_batch
    if spp_chunk % sb != 0:
        raise ValueError(f"spp_chunk={spp_chunk} not divisible by "
                         f"samples_per_batch={sb}")
    pixel_idx = _blocked_pixel_order(w, h)
    # Pixel-major interleave (p0s0, p0s1, ..., p1s0, ...): the sb samples
    # of one pixel sit in the same trace tile, and their shadow rays are
    # highly coherent, which keeps the tile-sweep treelet unions small.
    pixel_idx_t = jnp.repeat(pixel_idx, sb)

    def body(carry, bi):
        fb, nrays = carry
        sids = sample_offset + bi * sb + jnp.arange(sb)
        skeys = jax.vmap(lambda s: jax.random.fold_in(key, s))(sids)
        lkeys = jax.vmap(
            lambda sk: rng.lane_keys(sk, pixel_idx))(skeys)  # (sb, wh)
        lkeys = lkeys.T.reshape((sb * w * h,))               # pixel-major
        fb_s, nr = render_sample(
            scene, cam_consts, cfg, key, pixel_idx_t, lkeys=lkeys
        )
        return (fb + fb_s, nrays + nr), None

    (fb, nrays), _ = jax.lax.scan(
        body,
        (jnp.zeros((w * h, 3), jnp.float32), jnp.int32(0)),
        jnp.arange(spp_chunk // sb),
    )
    return fb, nrays


def render_image(scene: SceneData, camera, cfg: BDPTConfig, seed: int = 0,
                 spp_chunk: int = 4, samples_per_batch: int = 1):
    """Host-side driver: loop spp in chunks, return (H, W, 3) image and
    total ray count."""
    cam_consts = camera.device_constants()
    fb = jnp.zeros((cfg.width * cfg.height, 3), jnp.float32)
    total_rays = 0
    key = jax.random.key(seed)
    done = 0
    while done < cfg.spp:
        n = min(spp_chunk, cfg.spp - done)
        sb = samples_per_batch if n % samples_per_batch == 0 else 1
        fb_c, nr = render_chunk(
            scene, cam_consts, cfg, key, n, sample_offset=done,
            samples_per_batch=sb,
        )
        fb = fb + fb_c
        total_rays += int(nr)
        done += n
    img = fb.reshape(cfg.height, cfg.width, 3)
    return img, total_rays
