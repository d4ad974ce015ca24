"""Core vector math for the wavefront bidirectional path tracer.

Everything here is batched, functional jnp code: vectors are arrays of shape
(..., 3) and all helpers broadcast over leading batch dimensions.  The
semantics mirror the reference renderer's math layer (reference:
src/core/math.h, src/core/core.h:148-167, src/core/platform.h:51-57) but the
implementation is JAX-first: no scalar structs, no branches that would block
XLA fusion.
"""
from __future__ import annotations

import jax.numpy as jnp

# Constants (reference: src/core/platform.h:51-57).
PI = 3.14159265358979323846
INV_PI = 1.0 / PI
INV_TWOPI = 1.0 / (2.0 * PI)
INV_FOURPI = 1.0 / (4.0 * PI)
DEG2RAD = PI / 180.0
# Ray min-t / Moeller-Trumbore determinant cutoff (reference: platform.h:57).
EPSILON = 1e-8
# The de-facto self-intersection cutoff: the reference BVH primitive test
# rejects hits with t <= 1e-3 (reference: src/core/accel.h:43).
T_MIN_HIT = 1e-3
# Visibility rays stop just short of the target point
# (reference: src/integrators/bdpt.h:504).
VIS_SHORTEN = 1e-5
INF = jnp.inf

# Rec.709 luminance weights (reference: src/core/math.h:56-58).
_LUMA = jnp.array([0.212671, 0.715160, 0.072169], dtype=jnp.float32)


def dot(a, b):
    """Batched 3-vector dot product -> (...,)."""
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    return jnp.cross(a, b)


def length(v):
    return jnp.sqrt(jnp.sum(v * v, axis=-1))


def length2(v):
    return jnp.sum(v * v, axis=-1)


def normalize(v):
    return v / jnp.maximum(length(v), 1e-20)[..., None]


def luminance(rgb):
    """Rec.709 luminance (reference: src/core/math.h:56-58)."""
    return jnp.sum(rgb * _LUMA, axis=-1)


def safe_sqrt(v):
    """sqrt(max(v, 0)) (reference: src/core/math.h:12-14)."""
    return jnp.sqrt(jnp.maximum(v, 0.0))


def barycentric(a, b, c, u, v):
    """Barycentric interpolation a*(1-u-v) + b*u + c*v
    (reference: src/core/math.h:19-22). u, v are (...,) scalars; a,b,c
    (..., k)."""
    u = u[..., None]
    v = v[..., None]
    return a * (1.0 - u - v) + b * u + c * v


def coordinate_system(n):
    """Build tangent/bitangent for a normal, replicating the reference's
    branchy construction exactly (reference: src/core/math.h:42-51).

    Returns (s, t) such that Frame(n) == (s, t, n) with
    c := t_ref, b := s_ref:  given |a.x| > |a.y|:
        c = (a.z, 0, -a.x)/len, else c = (0, a.z, -a.y)/len; b = cross(c, a).
    Reference stores (b, c) as (s, t); toLocal dots with (s, t, n).
    """
    ax, ay, az = n[..., 0], n[..., 1], n[..., 2]
    use_x = jnp.abs(ax) > jnp.abs(ay)
    inv_len_x = 1.0 / jnp.sqrt(jnp.maximum(ax * ax + az * az, 1e-30))
    inv_len_y = 1.0 / jnp.sqrt(jnp.maximum(ay * ay + az * az, 1e-30))
    cx = jnp.where(use_x, az * inv_len_x, 0.0)
    cy = jnp.where(use_x, 0.0, az * inv_len_y)
    cz = jnp.where(use_x, -ax * inv_len_x, -ay * inv_len_y)
    c = jnp.stack([cx, cy, cz], axis=-1)
    b = jnp.cross(c, n)
    return b, c


def make_frame(n):
    """Shading frame from a (unit) normal: returns (s, t, n) stacked as
    (..., 3, 3) with rows s, t, n (reference: src/core/core.h:152-167)."""
    s, t = coordinate_system(n)
    return jnp.stack([s, t, n], axis=-2)


def mat_vec(m, v):
    """m @ v over the last axes, (..., n, k) x (..., k) -> (..., n), as
    elementwise products and sums.  Not a dot_general: a GPU may run an
    f32 matrix product in TF32 (10-bit mantissa), which would move ray
    directions and frames by ~1e-3 relative."""
    out = m[..., 0] * v[..., :1]
    for j in range(1, v.shape[-1]):
        out = out + m[..., j] * v[..., j:j + 1]
    return out


def frame_to_local(frame, v):
    """World -> local: (dot(v,s), dot(v,t), dot(v,n))
    (reference: core.h:158-160). frame is (..., 3, 3) rows (s,t,n)."""
    return mat_vec(frame, v)


def frame_to_world(frame, v):
    """Local -> world: s*x + t*y + n*z (reference: core.h:161-163)."""
    return mat_vec(jnp.swapaxes(frame, -1, -2), v)


def frame_n(frame):
    """The normal row of a frame."""
    return frame[..., 2, :]


def reflect_local(d):
    """Mirror reflection about +z in the local shading frame
    (reference: src/bsdfs/perfectmirror.h:29-31)."""
    return jnp.stack([-d[..., 0], -d[..., 1], d[..., 2]], axis=-1)


def is_zero_rgb(v):
    """Exact all-channels-zero test used by the reference for termination
    (reference: bdpt.h:254, path.h:107)."""
    return jnp.all(v == 0.0, axis=-1)


def fresnel_dielectric(eta_i, eta_t, cos_i, cos_t):
    """Exact dielectric Fresnel with TIR (reference: src/bsdfs/glass.h:40-53).

    cos_i, cos_t must be non-negative magnitudes. Returns reflectance in
    [0, 1]; total internal reflection returns 1.
    """
    eta = eta_i / eta_t
    sin2_t = eta * eta * jnp.maximum(0.0, 1.0 - cos_i * cos_i)
    # Guard the grazing + TIR corner (cos_i == cos_t == 0) where both
    # denominators vanish; the result is overridden to 1 below anyway, but
    # a NaN here would poison autodiff through jnp.where.
    d_par = (eta_t * cos_i) + (eta_i * cos_t)
    d_perp = (eta_i * cos_i) + (eta_t * cos_t)
    d_par = jnp.where(jnp.abs(d_par) < 1e-12, 1.0, d_par)
    d_perp = jnp.where(jnp.abs(d_perp) < 1e-12, 1.0, d_perp)
    r_par = ((eta_t * cos_i) - (eta_i * cos_t)) / d_par
    r_perp = ((eta_i * cos_i) - (eta_t * cos_t)) / d_perp
    fr = 0.5 * (r_par * r_par + r_perp * r_perp)
    return jnp.where(sin2_t >= 1.0, 1.0, fr)
