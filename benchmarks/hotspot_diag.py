"""Diagnose the cbox_full golden hot spot (VERDICT r2 item 2).

PARITY_IMAGES r2 found a 0.35-1.48 block-relative-error cluster at grid
rows 6-8, cols 6-7 (10x10 grid) in the RR-mode cbox render vs
`cbox_bdpt_final.exr`, while the global mean ratio is 1.016.  The
cluster blocks are the DARKEST in the image (golden block luminance
0.004-0.021), and all five shipped reference artifacts agree there to
2-4%, so the excess is ours.

This script renders the same view and decomposes the hot blocks:

  * per-seed block means (is it variance or stable bias?)
  * per-pixel max within the block (fireflies?)
  * exact per-technique contributions via the BDPTConfig.connect_*
    toggles (s>=2 / s=1 / t=1 deltas at a fixed seed share all RNG keys,
    so the differences isolate each connection family exactly)
  * an independent estimate from the explicit path tracer.

Run on the GPU: python benchmarks/hotspot_diag.py [--spp 32]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

REF = "/root/reference/data/a5/bonus_bdpt/tinyrender"
TOML = f"{REF}/cbox_bdpt.toml"
GOLD = f"{REF}/cbox_bdpt_final.exr"

W, H = 200, 152
BLOCKS = [(6, 6), (6, 7), (8, 6), (7, 7), (3, 3), (5, 5)]  # last two: controls


def block_px(r, c):
    return slice(r * (H // 10), (r + 1) * (H // 10)), \
        slice(c * (W // 10), (c + 1) * (W // 10))


def luma(a):
    return a @ np.array([0.2126, 0.7152, 0.0722])


def bstats(img):
    out = {}
    for (r, c) in BLOCKS:
        ys, xs = block_px(r, c)
        b = luma(img[ys, xs])
        out[f"r{r}c{c}"] = (round(float(b.mean()), 5),
                            round(float(b.max()), 4))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args()

    from bpt_tpu.core.camera import Camera
    from bpt_tpu.integrators.bdpt import BDPTConfig, render_image
    from bpt_tpu.integrators.path import PathConfig, render_image_path
    from bpt_tpu.io.exr import read_exr
    from bpt_tpu.scene.scene import load_scene
    from bpt_tpu.scene.toml_config import load_toml

    cfg_t = load_toml(TOML)
    scene, meta = load_scene(cfg_t.obj_file)
    cam = Camera.make(o=cfg_t.camera.o, at=cfg_t.camera.at,
                      up=cfg_t.camera.up, fov=cfg_t.camera.fov,
                      width=W, height=H)

    ref = np.asarray(read_exr(GOLD))
    # Downsample the 800x600 golden to 200x152-compatible blocks.
    print(json.dumps({"which": "golden(mean,blockmax)",
                      "blocks": bstats_ref(ref)}), flush=True)

    cfg = BDPTConfig(width=W, height=H, spp=args.spp, rr_depth=2,
                     no_rr=False, max_bounces=12)

    # ---- per-seed variance of the full estimator --------------------
    imgs = {}
    for seed in range(args.seeds):
        img, _ = render_image(scene, cam, cfg, seed=seed,
                              spp_chunk=min(args.spp, 16))
        imgs[seed] = np.asarray(img)
        print(json.dumps({"which": f"full seed={seed}",
                          "blocks": bstats(imgs[seed])}), flush=True)

    # ---- exact per-technique decomposition at seed 0 -----------------
    base = imgs[0]
    for name, kw in (("no_s2", dict(connect_s2=False)),
                     ("no_s1", dict(connect_s1=False)),
                     ("no_t1", dict(connect_t1=False))):
        cfg_a = dataclasses.replace(cfg, **kw)
        img_a, _ = render_image(scene, cam, cfg_a, seed=0,
                                spp_chunk=min(args.spp, 16))
        delta = base - np.asarray(img_a)
        print(json.dumps({"which": f"technique {name[3:]} (delta)",
                          "blocks": bstats(delta)}), flush=True)

    # ---- independent estimator: explicit path tracing ----------------
    pcfg = PathConfig(width=W, height=H, spp=args.spp * 2,
                      is_explicit=True, max_depth=12, rr_depth=2,
                      rr_prob=0.95)
    pimg, _ = render_image_path(scene, cam, pcfg, seed=11,
                                spp_chunk=min(args.spp, 16))
    print(json.dumps({"which": "path tracer (independent)",
                      "blocks": bstats(np.asarray(pimg))}), flush=True)


def bstats_ref(ref):
    """Golden block stats on ITS native grid (same 10x10 fractions)."""
    h, w, _ = ref.shape
    out = {}
    for (r, c) in BLOCKS:
        ys = slice(r * (h // 10), (r + 1) * (h // 10))
        xs = slice(c * (w // 10), (c + 1) * (w // 10))
        b = luma(ref[ys, xs])
        out[f"r{r}c{c}"] = (round(float(b.mean()), 5),
                            round(float(b.max()), 4))
    return out


if __name__ == "__main__":
    main()
