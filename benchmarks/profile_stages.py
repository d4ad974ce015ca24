"""Per-stage profiling harness (VERDICT r1 item 6).

Times the individual kernel stages of the BDPT pipeline on the current
backend so regressions/optimizations can be attributed: closest-hit
trace, any-hit (occlusion) trace at both NEE and all-pairs widths, BSDF
shading, and the full render_chunk.

Run: python benchmarks/profile_stages.py [--spb N]
Prints one JSON object with per-stage seconds and rays/s.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def timeit(fn, *args, n=3, **kw):
    """Median wall time of fn(*args); each timing ends with a host
    fetch."""
    out = fn(*args, **kw)
    _ = float(jax.tree_util.tree_leaves(out)[0].sum())
    ts = []
    for _i in range(n):
        t0 = time.time()
        out = fn(*args, **kw)
        _ = float(jax.tree_util.tree_leaves(out)[0].sum())
        ts.append(time.time() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spb", type=int, default=1,
                    help="samples_per_batch for the full-chunk stage")
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--depth", type=int, default=8)
    args = ap.parse_args()

    from bench import _load_scene
    from bpt_tpu.accel.api import trace_any, trace_closest
    from bpt_tpu.core.camera import generate_rays
    from bpt_tpu.integrators.bdpt import BDPTConfig, render_chunk

    scene, cam, label = _load_scene()
    w = h = args.res
    cfg = BDPTConfig(width=w, height=h, spp=16, rr_depth=args.depth)
    cam_consts = cam.device_constants()
    key = jax.random.key(7)

    pixel_idx = jnp.arange(w * h, dtype=jnp.int32)
    o, d = generate_rays(cam_consts, w, h, pixel_idx, None)
    b = o.shape[0]

    report = {"scene": label, "lanes": b,
              "device": str(jax.devices()[0]), "spb": args.spb}

    # --- closest hit, coherent primary rays -----------------------------
    f_closest = jax.jit(lambda o, d: trace_closest(scene, o, d, 1.0,
                                                   jnp.inf))
    dt = timeit(f_closest, o, d)
    report["closest_coherent_s"] = round(dt, 4)
    report["closest_coherent_rays_per_s"] = round(b / dt, 0)

    # --- closest hit, incoherent (bounce-like) rays ----------------------
    ki = jax.random.split(jax.random.key(1), 2)
    hit = f_closest(o, d)
    p = o + d * jnp.where(jnp.isfinite(hit.t), hit.t, 1.0)[:, None]
    di = jax.random.normal(ki[0], (b, 3))
    di = di / jnp.linalg.norm(di, axis=-1, keepdims=True)
    f_closest2 = jax.jit(lambda o, d: trace_closest(scene, o, d, 1e-8,
                                                    jnp.inf))
    dt = timeit(f_closest2, p, di)
    report["closest_incoherent_s"] = round(dt, 4)
    report["closest_incoherent_rays_per_s"] = round(b / dt, 0)

    # --- any hit at NEE width (B lanes, bounded segments) ----------------
    tgt = jnp.asarray([[0.0, 1.5, 0.0]], jnp.float32)
    seg = tgt - p
    dist = jnp.linalg.norm(seg, axis=-1)
    dn = seg / dist[:, None]
    f_any = jax.jit(lambda o, d, mt: trace_any(scene, o, d, 1e-8, mt))
    dt = timeit(f_any, p, dn, dist - 1e-5)
    report["any_nee_s"] = round(dt, 4)
    report["any_nee_rays_per_s"] = round(b / dt, 0)

    # --- any hit at all-pairs width (L*B lanes) ---------------------------
    lmul = args.depth - 1
    pl_ = jnp.repeat(p, lmul, axis=0)
    dl = jnp.repeat(dn, lmul, axis=0)
    distl = jnp.repeat(dist, lmul, axis=0)
    dt = timeit(f_any, pl_, dl, distl - 1e-5)
    report["any_allpairs_s"] = round(dt, 4)
    report["any_allpairs_lanes"] = int(pl_.shape[0])
    report["any_allpairs_rays_per_s"] = round(pl_.shape[0] / dt, 0)

    # --- full chunk -------------------------------------------------------
    spp = max(args.spb, 4)
    f_chunk = lambda: render_chunk(scene, cam_consts, cfg, key, spp,
                                   samples_per_batch=args.spb)
    dt = timeit(f_chunk, n=1)
    fb, nrays = f_chunk()
    nrays = int(nrays)
    report["chunk_spp"] = spp
    report["chunk_s"] = round(dt, 4)
    report["chunk_rays"] = nrays
    report["chunk_rays_per_s"] = round(nrays / dt, 0)

    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
