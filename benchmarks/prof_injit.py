"""In-jit stage timing: scan N repeated traces inside one jit to amortize
dispatch overhead, giving the true per-trace cost inside render_chunk."""
from __future__ import annotations

import json
import os
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

N_REP = 8


def timed(label, fn, *args):
    out = fn(*args)
    _ = float(jax.tree_util.tree_leaves(out)[0].sum())
    t0 = time.time()
    out = fn(*args)
    _ = float(jax.tree_util.tree_leaves(out)[0].sum())
    dt = (time.time() - t0) / N_REP
    print(json.dumps({"stage": label, "per_trace_s": round(dt, 5)}))
    return dt


def rep_closest(trace, scene, o, d, mn, mx):
    def body(c, _):
        h = trace(scene, o + c * 1e-6, d, mn, mx)
        return c + h.t.sum() * 0.0, None
    return jax.lax.scan(body, jnp.float32(0), None, length=N_REP)[0]


def rep_any(trace, scene, o, d, mn, mx):
    def body(c, _):
        occ = trace(scene, o + c * 1e-6, d, mn, mx)
        return c + occ.sum() * 0.0, None
    return jax.lax.scan(body, jnp.float32(0), None, length=N_REP)[0]


def main():
    from bench import _load_scene
    from bpt_tpu.accel import binned
    from bpt_tpu.accel.api import trace_any, trace_closest
    from bpt_tpu.core.camera import generate_rays

    scene, cam, label = _load_scene()
    w = h = 256
    cam_consts = cam.device_constants()
    pixel_idx = jnp.arange(w * h, dtype=jnp.int32)
    o, d = generate_rays(cam_consts, w, h, pixel_idx, None)
    b = o.shape[0]

    # incoherent bounce-like rays
    hit = jax.jit(lambda o, d: trace_closest(scene, o, d, 1.0, jnp.inf))(o, d)
    p = o + d * jnp.where(jnp.isfinite(hit.t), hit.t, 1.0)[:, None]
    di = jax.random.normal(jax.random.key(1), (b, 3))
    di = di / jnp.linalg.norm(di, axis=-1, keepdims=True)

    inf = jnp.inf
    f = jax.jit(lambda o, d: rep_closest(trace_closest, scene, o, d, 1e-8,
                                         inf))
    timed("closest_coherent_65k", f, o, d)
    timed("closest_incoherent_65k", f, p, di)

    # shadow-like segments
    tgt = jnp.asarray([[0.0, 1.5, 0.0]], jnp.float32)
    seg = tgt - p
    dist = jnp.linalg.norm(seg, axis=-1)
    dn = seg / dist[:, None]
    fa = jax.jit(lambda o, d, mt: rep_any(trace_any, scene, o, d, 1e-8, mt))
    timed("any_binned_65k", fa, p, dn, dist - 1e-5)

    lmul = 7
    pl_ = jnp.repeat(p, lmul, axis=0)
    dl = jnp.repeat(dn, lmul, axis=0)
    distl = jnp.repeat(dist, lmul, axis=0)
    timed("any_binned_458k", fa, pl_, dl, distl - 1e-5)


if __name__ == "__main__":
    main()
