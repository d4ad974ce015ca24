"""Workload statistics: intercept every trace call of a real BDPT sample
(eager, small res) and report lane liveness + treelet overlap/union stats.
Informs tracer design (tile size, K, value of live-lane compaction)."""
from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp


def main():
    from bench import _load_scene
    from bpt_tpu.accel import api, binned
    from bpt_tpu.core.camera import Camera
    from bpt_tpu.integrators import bdpt as bd

    scene, cam, label = _load_scene()
    w = h = 64
    # rebuild camera at this res
    cfg = bd.BDPTConfig(width=w, height=h, spp=4, rr_depth=8)

    calls = []

    orig_closest = api.trace_closest
    orig_any = api.trace_any

    def stats(kind, scene_, o, d, mn, mx, tg):
        o = np.asarray(o); d = np.asarray(d)
        mn = np.broadcast_to(np.asarray(mn, np.float32), o.shape[:1])
        mx = np.broadcast_to(np.asarray(mx, np.float32), o.shape[:1])
        live = mx >= mn
        mask = np.asarray(binned._treelet_mask(
            tg, jnp.asarray(o), jnp.asarray(d), jnp.asarray(mn),
            jnp.asarray(mx)))
        per_ray = mask.sum(1)
        rec = {
            "kind": kind, "lanes": o.shape[0],
            "live_frac": float(live.mean()),
            "overlap_mean": float(per_ray[live].mean()) if live.any() else 0,
            "overlap_max": int(per_ray.max()),
        }
        for tile in (128, 256, 1024):
            b = o.shape[0]
            pad = (-b) % tile
            m = np.concatenate([mask, np.zeros((pad, mask.shape[1]), bool)])
            tu = m.reshape(-1, tile, mask.shape[1]).any(1).sum(1)
            rec[f"union{tile}_mean"] = float(tu.mean())
            rec[f"union{tile}_max"] = int(tu.max())
        # Compacted layout (live lanes stably packed to the front): the
        # per-128-tile union over the live prefix + the all-dead-tile
        # count — what a tracer that skips dead tiles would pay for.
        m_live = mask[live]
        pad = (-len(m_live)) % 128
        m_live = np.concatenate(
            [m_live, np.zeros((pad, mask.shape[1]), bool)])
        tu = m_live.reshape(-1, 128, mask.shape[1]).any(1).sum(1)
        rec["union128_compact_mean"] = (float(tu.mean()) if len(tu)
                                        else 0.0)
        total_tiles = (o.shape[0] + 127) // 128
        rec["tiles_skipped_frac"] = round(
            1.0 - len(tu) / max(total_tiles, 1), 3)
        calls.append(rec)

    def closest_shim(scene_, o, d, mn, mx):
        stats("closest", scene_, o, d, mn, mx, scene_.treelets)
        return orig_closest(scene_, o, d, mn, mx)

    def any_shim(scene_, o, d, mn, mx):
        tg = getattr(scene_, "treelets_any", None) or scene_.treelets
        stats("any", scene_, o, d, mn, mx, tg)
        return orig_any(scene_, o, d, mn, mx)

    bd.trace_closest = closest_shim
    bd.trace_any = any_shim

    cam2 = Camera.make(o=tuple(np.asarray(cam.o)), at=tuple(np.asarray(cam.at)),
                       up=tuple(np.asarray(cam.up)), fov=cam.fov,
                       width=w, height=h) if hasattr(cam, 'o') else cam
    cam_consts = cam2.device_constants()
    key = jax.random.key(0)
    pixel_idx = jnp.arange(w * h, dtype=jnp.int32)
    with jax.disable_jit():
        bd.render_sample(scene, cam_consts, cfg, key, pixel_idx)

    import json
    for c in calls:
        print(json.dumps(c))


if __name__ == "__main__":
    main()
