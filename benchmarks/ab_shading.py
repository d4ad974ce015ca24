"""EP-analog A/B (VERDICT r2 item 7, SURVEY §2.7 EP row): is material
binning worth anything on the GPU, or is the branch-free BSDF switch right?

The branch-free switch (bsdf.sample_lane / eval_lane / pdf_lane)
computes every BSDF family's arithmetic on every lane and selects by
material id — the worst case for an expert-parallel analog.  Material
binning could AT BEST reduce the switch to single-family cost (it cannot
reduce trace cost, and on static-shape XLA it additionally needs a
sort + padded per-family segments).  So the A/B reduces to two numbers:

  1. mixed-material switch cost vs single-family cost at BDPT batch
     widths (the maximum binning could recover), and
  2. that recoverable cost as a fraction of one closest-hit trace at the
     same width (what the walk actually spends its time on).

If (1)'s delta is a small fraction of (2), binning cannot pay for its
sort/padding no matter how it is implemented, and the branch-free
switch is the right design.

Run: python benchmarks/ab_shading.py  (GPU or CPU)
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np


def timeit(f, *a, n=5):
    out = f(*a)
    float(jax.tree_util.tree_leaves(out)[0].sum())
    ts = []
    for _ in range(n):
        t0 = time.time()
        out = f(*a)
        float(jax.tree_util.tree_leaves(out)[0].sum())
        ts.append(time.time() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def main():
    from bench import _load_scene
    from bpt_tpu.accel.api import trace_closest
    from bpt_tpu.bsdf import bsdf

    scene, cam, label = _load_scene()
    b = 65536
    rs = np.random.RandomState(0)

    n_mat = scene.mat.kd.shape[0]
    mid_mixed = jnp.asarray(rs.randint(0, n_mat, b), jnp.int32)
    mid_single = jnp.zeros((b,), jnp.int32)  # one diffuse family
    wo = jnp.asarray(rs.normal(size=(b, 3)), jnp.float32)
    wo = wo / jnp.linalg.norm(wo, axis=-1, keepdims=True)
    wo = wo.at[:, 2].set(jnp.abs(wo[:, 2]))
    u2 = jnp.asarray(rs.rand(b, 2), jnp.float32)

    def shade(mid):
        lane = bsdf.gather_lane(scene.mat, mid)
        s = bsdf.sample_lane(lane, wo, u2)
        f = bsdf.eval_lane(lane, wo, s.wi)
        p = bsdf.pdf_lane(lane, wo, s.wi)
        return s.value + f + p[..., None]

    f_mixed = jax.jit(lambda: shade(mid_mixed))
    f_single = jax.jit(lambda: shade(mid_single))
    t_mixed = timeit(f_mixed)
    t_single = timeit(f_single)

    o = jnp.asarray(rs.uniform([-1, 0.1, -1], [1, 1.9, 1], (b, 3)),
                    jnp.float32)
    d = jnp.asarray(rs.normal(size=(b, 3)), jnp.float32)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    f_trace = jax.jit(lambda: trace_closest(scene, o, d, 1e-4, jnp.inf))
    t_trace = timeit(f_trace)

    recoverable = max(t_mixed - t_single, 0.0)
    print(json.dumps({
        "scene": label, "lanes": b,
        "device": str(jax.devices()[0]),
        "shade_mixed_s": round(t_mixed, 5),
        "shade_single_family_s": round(t_single, 5),
        "binning_max_recoverable_s": round(recoverable, 5),
        "closest_trace_s": round(t_trace, 5),
        "recoverable_vs_trace": round(recoverable / t_trace, 4),
    }))


if __name__ == "__main__":
    main()
