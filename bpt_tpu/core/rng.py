"""Counter-based RNG key discipline.

The reference shares one Mersenne-Twister across all threads (with an
acknowledged data race; reference: src/core/renderer.cpp:155-160,
src/core/math.h:63-76).  This renderer replaces it with JAX's counter-based
threefry keys with one key chain per *lane identity*: every
(pixel, sample, depth, purpose) tuple gets its own stream.  Randomness is a
function of pixel identity -- NOT of array position -- so renders are
bit-identical regardless of batch slicing or device count
(SURVEY.md section 2.7, determinism row).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# Stable purpose tags so streams never collide across call sites.
EMITTER_SELECT = 1
EMITTER_POSITION = 2
EMITTER_FACE = 3
EMITTER_DIRECTION = 4
BSDF_SAMPLE = 5
RR = 6
PIXEL_JITTER = 7
NEE_SELECT = 8
NEE_POSITION = 9
NEE_FACE = 10
LIGHT_WALK = 100
NEE_WALK = 200
EYE_WALK = 300
# Pooled light-transport mode: light subpaths keyed by POOL INDEX, not
# pixel — the pool is a global set shared by every pixel and every
# device shard, so the estimate is invariant to how the pool is sharded
# (integrators/bdpt.py render_sample_pool, parallel/mesh.py ring mode).
POOL_WALK = 400


def stream(key, *ids):
    """Derive a sub-key from a scalar key by folding in integer tags."""
    for i in ids:
        key = jax.random.fold_in(key, i)
    return key


def lane_keys(key, lane_ids):
    """(B,) keys: one per lane identity (e.g. pixel index)."""
    return jax.vmap(lambda i: jax.random.fold_in(key, i))(lane_ids)


def lane_fold(keys, tag):
    """Fold a (traced or static) scalar tag into a (B,) key array."""
    return jax.vmap(lambda k: jax.random.fold_in(k, tag))(keys)


def uniform1(keys):
    """One U[0,1) float per lane key -> (B,)."""
    return jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float32))(keys)


def uniform2(keys):
    """U[0,1)^2 per lane key -> (B, 2)."""
    return jax.vmap(lambda k: jax.random.uniform(k, (2,), jnp.float32))(keys)
