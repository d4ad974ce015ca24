"""Vectorized BSDF layer: diffuse, perfect mirror, glass, Phong, mixture.

The reference dispatches through virtual calls on per-material BSDF objects
(reference: src/core/core.h:256-318, src/bsdfs/*.h).  Here all five models
are evaluated as branch-free vector math over a (B,)-batch of shading points
and the result is selected by the per-lane material `kind` -- the wavefront
"expert routing" for materials (SURVEY.md section 2.7, EP row).  The extra
arithmetic for non-selected lobes is negligible next to BVH traversal.

Conventions match the reference exactly (core.h:104-110 of SURVEY.md):
directions live in the local shading frame (+z = shading normal); `eval`
returns f * cos(theta_i); delta BSDFs return 0 from eval/pdf and do all work
in `sample`; `sample` returns the importance weight f*cos/pdf (with the
delta Jacobians folded to 1).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import warp
from ..core.math import (
    INV_PI,
    INV_TWOPI,
    fresnel_dielectric,
    frame_to_local,
    frame_to_world,
    luminance,
    make_frame,
    reflect_local,
)

# Material kinds (scene loader maps MTL illum codes to these;
# reference: src/core/renderer.cpp:258-271).
DIFFUSE = 0   # illum 7
MIRROR = 1    # illum 3
GLASS = 2     # illum 6
PHONG = 3     # default
MIXTURE = 4   # illum 8


class MaterialTable(NamedTuple):
    """Per-material parameters, (M,)-leading device arrays.  The raw MTL
    quantities are stored; Phong/Mixture's energy-conservation scale and
    specular sampling weight (reference: src/bsdfs/phong.h:40-47) are
    derived in-graph so gradients flow to Kd/Ks."""

    kind: jnp.ndarray           # (M,) i32
    diffuse: jnp.ndarray        # (M, 3) Kd
    specular: jnp.ndarray       # (M, 3) Ks
    emission: jnp.ndarray       # (M, 3) Ke
    shininess: jnp.ndarray      # (M,)  Ns
    ior: jnp.ndarray            # (M,)  Ni
    transmittance: jnp.ndarray  # (M, 3) Tf


class LaneMaterial(NamedTuple):
    """Per-lane gathered material parameters + derived quantities."""

    kind: jnp.ndarray
    kd: jnp.ndarray
    ks: jnp.ndarray
    shininess: jnp.ndarray
    ior: jnp.ndarray
    transmittance: jnp.ndarray
    scale: jnp.ndarray        # energy-conservation scale (phong.h:40-43)
    spec_weight: jnp.ndarray  # specular sampling weight (phong.h:45-47)


def gather_lane(mat: MaterialTable, mid, kd_override=None) -> LaneMaterial:
    """kd_override: per-lane textured diffuse (scene/textures.py) replacing
    the constant Kd (reference BitmapTexture3f, diffuse.h:23-26)."""
    kd = mat.diffuse[mid] if kd_override is None else kd_override
    ks = mat.specular[mid]
    max_v = jnp.max(kd + ks, axis=-1)
    scale = jnp.where(max_v > 1.0, 0.99 / jnp.maximum(max_v, 1e-12), 1.0)
    d_avg = luminance(kd * scale[..., None])
    s_avg = luminance(ks * scale[..., None])
    spec_weight = s_avg / jnp.maximum(d_avg + s_avg, 1e-12)
    return LaneMaterial(
        kind=mat.kind[mid],
        kd=kd,
        ks=ks,
        shininess=mat.shininess[mid],
        ior=mat.ior[mid],
        transmittance=mat.transmittance[mid],
        scale=scale,
        spec_weight=spec_weight,
    )


def is_delta(lane: LaneMaterial):
    """EDelta lobe membership (reference: core.h:295, used at bdpt.h:137,
    208, 247)."""
    return (lane.kind == MIRROR) | (lane.kind == GLASS)


def emission(mat: MaterialTable, mid):
    """getEmission by material id (reference: src/core/integrator.cpp:41-44)."""
    return mat.emission[mid]


# ---------------------------------------------------------------------------
# eval / pdf
# ---------------------------------------------------------------------------

def _diffuse_eval(lane, wo, wi):
    """(reference: src/bsdfs/diffuse.h:35-43)"""
    gate = (wi[..., 2] >= 0.0) & (wo[..., 2] >= 0.0)
    val = lane.kd * INV_PI * wi[..., 2:3]
    return jnp.where(gate[..., None], val, 0.0)


def _phong_like_eval(lane, wo, wi):
    """Shared by Phong and Mixture (reference: phong.h:61-76,
    mixture.h:60-76)."""
    gate = (wi[..., 2] >= 0.0) & (wo[..., 2] >= 0.0)
    refl = reflect_local(wo)
    cos_alpha = jnp.clip(jnp.sum(wi * refl, axis=-1), 0.0, 1.0)
    n = lane.shininess
    spec = lane.ks * ((n + 2.0) * INV_TWOPI * jnp.power(cos_alpha, n))[..., None]
    val = (lane.kd * INV_PI + spec) * (lane.scale * wi[..., 2])[..., None]
    return jnp.where(gate[..., None], val, 0.0)


def _phong_pdf(lane, wo, wi):
    """Phong-lobe pdf of wi around reflect(wo) (reference: phong.h:78-88).

    The reference transforms wi into a frame around reflect(wo) and reads
    the z component — which is exactly dot(wi, reflect(wo)), so the frame
    construction is skipped (measured hotspot at all-pairs width: the
    old make_frame + frame_to_local pair ran 8x per connect pair).

    This dot is SYMMETRIC in (wo, wi): reflect about +z negates x,y, so
    dot(reflect(a), b) == dot(a, reflect(b)) — the phong-lobe density of
    the forward and reverse directions is the same number, which
    eval_pdfs_lane exploits."""
    cos_a = jnp.sum(wi * reflect_local(wo), axis=-1)
    n = lane.shininess
    return jnp.where(
        cos_a >= 0.0,
        (n + 2.0) * INV_TWOPI * jnp.power(jnp.maximum(cos_a, 0.0), n),
        0.0,
    )


def _mixture_pdf(lane, wo, wi, p_phong=None):
    """(reference: mixture.h:78-100).  p_phong: optional precomputed
    phong-lobe pdf (callers that also need it for the PHONG kind pass it
    in so the transcendental runs once)."""
    if p_phong is None:
        p_phong = _phong_pdf(lane, wo, wi)
    p_diff = warp.square_to_cosine_hemisphere_pdf(wi)
    w = lane.spec_weight
    return p_phong * w + p_diff * (1.0 - w)


def eval_lane(lane: LaneMaterial, wo, wi):
    """f * cos(theta_i) from pre-gathered lane materials; zero for delta
    BSDFs (reference: perfectmirror.h:33-39, glass.h:55-59).

    The lane-level entry points exist so hot paths gather the material
    table once per shading point and reuse it across the several
    eval/pdf calls a BDPT connection makes (6 per vertex pair) — the
    per-call gathers were a measured hotspot at all-pairs width."""
    d = _diffuse_eval(lane, wo, wi)
    p = _phong_like_eval(lane, wo, wi)
    k = lane.kind[..., None]
    out = jnp.where(k == DIFFUSE, d, 0.0)
    out = jnp.where((k == PHONG) | (k == MIXTURE), p, out)
    return out


def pdf_lane(lane: LaneMaterial, wo, wi):
    """Solid-angle pdf from pre-gathered lane materials; zero for delta
    BSDFs (reference: perfectmirror.h:41-46, glass.h:61-65)."""
    d = warp.square_to_cosine_hemisphere_pdf(wi)
    ph = _phong_pdf(lane, wo, wi)
    mx = _mixture_pdf(lane, wo, wi, p_phong=ph)
    k = lane.kind
    out = jnp.where(k == DIFFUSE, d, 0.0)
    out = jnp.where(k == PHONG, ph, out)
    out = jnp.where(k == MIXTURE, mx, out)
    return out


def eval_pdfs_lane(lane: LaneMaterial, wo, wi):
    """Fused eval + forward pdf + reverse pdf for one direction pair:
    returns (f*cos (B,3), pdf(wo->wi) (B,), pdf(wi->wo) (B,)), equal to
    (eval_lane(lane, wo, wi), pdf_lane(lane, wo, wi),
    pdf_lane(lane, wi, wo)).

    A BDPT connection needs all three per vertex (reference:
    bdpt.h:455-472 evaluates f once and four reverse pdfs per pair);
    the fused form computes the shared phong-lobe power — symmetric in
    (wo, wi), see _phong_pdf — ONCE, where the separate calls ran ten
    transcendentals and eight frame constructions per pair.  This is
    the all-pairs connect phase's shading kernel (measured ~45% of the
    stage's wall time before fusion, benchmarks/prof_connect.py)."""
    k = lane.kind
    woz = wo[..., 2]
    wiz = wi[..., 2]
    gate = (wiz >= 0.0) & (woz >= 0.0)
    cos_a = jnp.sum(wi * reflect_local(wo), axis=-1)   # symmetric
    n = lane.shininess
    # One transcendental, two gating conventions: eval uses the ungated
    # clipped power (_phong_like_eval), the pdf gates on cos >= 0
    # (warp.square_to_phong_lobe_pdf) — they differ only at n == 0.
    lobe = (n + 2.0) * INV_TWOPI * jnp.power(
        jnp.clip(cos_a, 0.0, 1.0), n)
    p_phong = jnp.where(cos_a >= 0.0, lobe, 0.0)

    # eval: diffuse + phong-like share the lobe factor with the pdfs.
    d_val = lane.kd * INV_PI * wi[..., 2:3]
    spec = lane.ks * lobe[..., None]
    p_val = (lane.kd * INV_PI + spec) * (lane.scale * wiz)[..., None]
    k3 = k[..., None]
    f = jnp.where(k3 == DIFFUSE, d_val, 0.0)
    f = jnp.where((k3 == PHONG) | (k3 == MIXTURE), p_val, f)
    f = jnp.where(gate[..., None], f, 0.0)

    d_fwd = warp.square_to_cosine_hemisphere_pdf(wi)
    d_rev = warp.square_to_cosine_hemisphere_pdf(wo)
    w = lane.spec_weight

    def pick(d_pdf):
        out = jnp.where(k == DIFFUSE, d_pdf, 0.0)
        out = jnp.where(k == PHONG, p_phong, out)
        out = jnp.where(
            k == MIXTURE, p_phong * w + d_pdf * (1.0 - w), out)
        return out

    return f, pick(d_fwd), pick(d_rev)


def eval_bsdf(mat: MaterialTable, mid, wo, wi, kd_override=None):
    """Gathering wrapper around eval_lane."""
    return eval_lane(gather_lane(mat, mid, kd_override), wo, wi)


def pdf_bsdf(mat: MaterialTable, mid, wo, wi, kd_override=None):
    """Gathering wrapper around pdf_lane."""
    return pdf_lane(gather_lane(mat, mid, kd_override), wo, wi)


# ---------------------------------------------------------------------------
# sample
# ---------------------------------------------------------------------------

class BsdfSample(NamedTuple):
    wi: jnp.ndarray      # (B, 3) local
    value: jnp.ndarray   # (B, 3) f*cos/appropriate weight
    pdf: jnp.ndarray     # (B,)
    delta: jnp.ndarray   # (B,) bool: lane has a delta BSDF


def _glass_sample(lane, wo, u):
    """(reference: src/bsdfs/glass.h:67-108)"""
    woz = wo[..., 2]
    entering = woz > 0.0
    eta_i = jnp.where(entering, 1.0, lane.ior)
    eta_t = jnp.where(entering, lane.ior, 1.0)
    eta = eta_i / eta_t
    sin2_i = jnp.maximum(0.0, 1.0 - woz * woz)
    sin2_t = eta * eta * sin2_i
    cos_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_t))
    cos_t = jnp.where(entering, -cos_t, cos_t)
    fr = fresnel_dielectric(eta_i, eta_t, jnp.abs(woz), jnp.abs(cos_t))
    reflect = u[..., 0] < fr
    wi_r = reflect_local(wo)
    wi_t = jnp.stack(
        [eta * -wo[..., 0], eta * -wo[..., 1], cos_t], axis=-1
    )
    wi = jnp.where(reflect[..., None], wi_r, wi_t)
    val = jnp.where(
        reflect[..., None], jnp.ones_like(lane.transmittance),
        lane.transmittance,
    )
    return wi, val, jnp.ones_like(fr)


def sample_bsdf(mat: MaterialTable, mid, wo, u2,
                kd_override=None) -> BsdfSample:
    """Gathering wrapper around sample_lane."""
    return sample_lane(gather_lane(mat, mid, kd_override), wo, u2)


def sample_lane(lane: LaneMaterial, wo, u2) -> BsdfSample:
    """Sample an outgoing direction for every lane.

    One shared 2D uniform `u2` per lane feeds whichever lobe the lane's
    material selects (streams are independent across lanes/depths via the
    RNG key discipline).
    """
    k = lane.kind
    sg = jax.lax.stop_gradient

    # Diffuse (reference: diffuse.h:52-61).
    wi_d = sg(warp.square_to_cosine_hemisphere(u2))
    pdf_d = warp.square_to_cosine_hemisphere_pdf(wi_d)
    val_d = _diffuse_eval(lane, wo, wi_d)

    # Mirror (reference: perfectmirror.h:49-59).
    wi_m = reflect_local(wo)
    val_m = jnp.ones_like(wo)
    pdf_m = jnp.ones_like(pdf_d)

    # Glass.
    wi_g, val_g, pdf_g = _glass_sample(lane, wo, u2)

    # Phong (reference: phong.h:90-105): sample only the specular lobe.
    # Sampled directions are detached at the point of construction
    # (detached-sampling estimator): parameter-dependent warps (exponent,
    # spec_weight) must not leak gradients through val/pdf, and their
    # clamped-sqrt corners would produce NaN partials on unselected lanes.
    refl_frame = make_frame(reflect_local(wo))
    lobe = sg(warp.square_to_phong_lobe(u2, lane.shininess))
    pdf_p = warp.square_to_phong_lobe_pdf(lobe, sg(lane.shininess))
    wi_p = frame_to_world(refl_frame, lobe)
    val_p = _phong_like_eval(lane, wo, wi_p)

    # Mixture (reference: mixture.h:102-151): pick lobe by spec_weight with
    # sample reuse/rescale; pdf is the full mixture pdf.
    w = lane.spec_weight
    pick_spec = u2[..., 0] < sg(w)
    ux_spec = jnp.clip(u2[..., 0] / jnp.maximum(sg(w), 1e-12), 0.0, 1.0)
    ux_diff = jnp.clip(
        (u2[..., 0] - sg(w)) / jnp.maximum(1.0 - sg(w), 1e-12), 0.0, 1.0
    )
    u_spec = jnp.stack([ux_spec, u2[..., 1]], axis=-1)
    u_diff = jnp.stack([ux_diff, u2[..., 1]], axis=-1)
    lobe_mx = sg(warp.square_to_phong_lobe(u_spec, lane.shininess))
    wi_mx_spec = frame_to_world(refl_frame, lobe_mx)
    wi_mx_diff = sg(warp.square_to_cosine_hemisphere(u_diff))
    wi_mx = jnp.where(pick_spec[..., None], wi_mx_spec, wi_mx_diff)
    pdf_mx = _mixture_pdf(lane, wo, wi_mx)
    val_mx = _phong_like_eval(lane, wo, wi_mx)

    def sel3(cond, a, b):
        return jnp.where(cond[..., None], a, b)

    wi = sel3(k == DIFFUSE, wi_d, wi_p)
    wi = sel3(k == MIRROR, wi_m, wi)
    wi = sel3(k == GLASS, wi_g, wi)
    wi = sel3(k == MIXTURE, wi_mx, wi)

    val = sel3(k == DIFFUSE, val_d, val_p)
    val = sel3(k == MIRROR, val_m, val)
    val = sel3(k == GLASS, val_g, val)
    val = sel3(k == MIXTURE, val_mx, val)

    pdf = jnp.where(k == DIFFUSE, pdf_d, pdf_p)
    pdf = jnp.where(k == MIRROR, pdf_m, pdf)
    pdf = jnp.where(k == GLASS, pdf_g, pdf)
    pdf = jnp.where(k == MIXTURE, pdf_mx, pdf)

    # Detached-sampling gradients (SURVEY.md section 7): the sampled
    # direction and its pdf are stopped so parameter gradients flow only
    # through the integrand (value); this keeps BVH traversal outside the
    # differentiation graph and the estimator unbiased for the detached
    # estimator family.
    wi = jax.lax.stop_gradient(wi)
    pdf = jax.lax.stop_gradient(pdf)

    return BsdfSample(wi=wi, value=val, pdf=pdf, delta=is_delta(lane))
