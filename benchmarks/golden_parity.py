"""Golden-image parity vs the reference's shipped EXRs (VERDICT r1 item 2).

Renders the reference's own scenes at reduced resolution and compares
block means against its shipped artifacts (the reference's entire quality
strategy is golden-image comparison, SURVEY.md section 4 item 1).  Writes
PARITY_IMAGES.md with per-block relative-error maps.

Golden provenance (established by reading every artifact's statistics —
see PARITY_IMAGES.md for the table):

  * `cbox_bdpt_final.exr` (mean 0.1255) is byte-identical in mean to
    `cbox_bdpt_128spp_rr1_1244s.exr` and agrees with the rr2/rr3 timed
    artifacts (0.1264-0.1278): these are FULL-GI renders from the
    Russian-roulette build (NO_RR=0), where `while (depth < rrDepth ||
    rr)` (bdpt.h:68) walks to unbounded depth.  Compared against our
    `no_rr=False` mode.
  * `cbox_bdpt_glass_{5,6,7,8}depth.exr` form a NO_RR depth-convergence
    series (0.422 -> 0.441), matching the shipped NO_RR=1 source at
    rrDepth=5..8.  Compared against our `no_rr=True` mode.
  * `cbox_bdpt.exr` / `cbox_bdpt_direct_512.exr` (mean 0.0503) have an
    EXACTLY-zero bottom half — physically impossible for the cbox floor
    under a ceiling emitter; they are partial/buggy artifacts and are
    NOT used as goldens.

Run: python benchmarks/golden_parity.py [--res-div 4] [--spp 64]
(on the GPU; CPU works but is slow).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

REF = "/root/reference/data/a5"

CASES = [
    # name, toml, golden exr, rr_depth, no_rr, spp_scale
    ("cbox_full",
     f"{REF}/bonus_bdpt/tinyrender/cbox_bdpt.toml",
     f"{REF}/bonus_bdpt/tinyrender/cbox_bdpt_final.exr", 2, False, 1.0),
    ("glass_8depth",
     f"{REF}/cbox/tinyrender/cbox_bdpt_glass.toml",
     f"{REF}/cbox/tinyrender/cbox_bdpt_glass_8depth.exr", 8, True, 0.5),
]

GX = GY = 10  # error-map grid


def block_means(a, gy=GY, gx=GX):
    h, w, _ = a.shape
    return a[: h // gy * gy, : w // gx * gx].reshape(
        gy, h // gy, gx, w // gx, 3).mean((1, 3))


def luma(a):
    return a @ np.array([0.2126, 0.7152, 0.0722])


def run_case(name, toml, exr, rr, no_rr, spp):
    from bpt_tpu.core.camera import Camera
    from bpt_tpu.integrators.bdpt import BDPTConfig, render_image
    from bpt_tpu.io.exr import read_exr
    from bpt_tpu.scene.scene import load_scene
    from bpt_tpu.scene.toml_config import load_toml

    ref = np.asarray(read_exr(exr))
    cfg_t = load_toml(toml)
    scene, meta = load_scene(cfg_t.obj_file)
    w = cfg_t.width // ARGS.res_div
    h = cfg_t.height // ARGS.res_div
    h += (-h) % 8  # keep blocked pixel order available
    cam = Camera.make(o=cfg_t.camera.o, at=cfg_t.camera.at,
                      up=cfg_t.camera.up, fov=cfg_t.camera.fov,
                      width=w, height=h)
    cfg = BDPTConfig(width=w, height=h, spp=spp, rr_depth=rr, no_rr=no_rr)
    t0 = time.time()
    img, nrays = render_image(scene, cam, cfg, seed=3,
                              spp_chunk=min(spp, 16))
    dt = time.time() - t0
    img = np.asarray(img)

    rl = luma(block_means(ref))
    ol = luma(block_means(img))
    rel = np.abs(ol - rl) / np.maximum(rl, 1e-3)
    return {
        "name": name,
        "golden": os.path.basename(exr),
        "config": f"{w}x{h} spp={spp} rr_depth={rr} no_rr={no_rr}",
        "render_s": round(dt, 1),
        "ref_mean": round(float(ref.mean()), 5),
        "our_mean": round(float(img.mean()), 5),
        "mean_ratio": round(float(img.mean() / ref.mean()), 4),
        "block_rel_err_median": round(float(np.median(rel)), 4),
        "block_rel_err_p90": round(float(np.quantile(rel, 0.9)), 4),
        "block_rel_err_max": round(float(rel.max()), 4),
        "rel_map": np.round(rel, 3),
    }


def main():
    results = [run_case(n, t, e, r, nr, max(1, int(ARGS.spp * ss)))
               for (n, t, e, r, nr, ss) in CASES]

    lines = [
        "# PARITY_IMAGES — golden-image comparison vs the reference's "
        "shipped EXRs",
        "",
        "Generated by `benchmarks/golden_parity.py`.  Block grid: "
        f"{GY}x{GX}; metric: relative error of block-mean luminance "
        "(Rec.709).",
        "",
        "## Golden provenance",
        "",
        "- `cbox_bdpt_final.exr` == full-GI Russian-roulette build "
        "(mean matches `cbox_bdpt_128spp_rr1_1244s.exr` and the rr2/rr3 "
        "timed artifacts) -> compared against our `no_rr=False`.",
        "- `cbox_bdpt_glass_{5..8}depth.exr` form a NO_RR depth series "
        "(0.422->0.441) -> compared against our `no_rr=True`, rr_depth=8.",
        "- `cbox_bdpt.exr`/`cbox_bdpt_direct_512.exr` have an exactly-"
        "zero bottom half (partial/buggy artifacts) and are excluded.",
        "",
    ]
    for r in results:
        lines += [f"## {r['name']}  (vs `{r['golden']}`)", ""]
        lines += [f"- config: {r['config']}  ({r['render_s']}s)"]
        lines += [f"- mean: ours {r['our_mean']} vs ref {r['ref_mean']} "
                  f"(ratio {r['mean_ratio']})"]
        lines += [f"- block rel err: median {r['block_rel_err_median']}, "
                  f"p90 {r['block_rel_err_p90']}, "
                  f"max {r['block_rel_err_max']}", ""]
        lines += ["```", "per-block relative error (rows top->bottom):"]
        for row in r.pop("rel_map"):
            lines.append(" ".join(f"{v:5.2f}" for v in row))
        lines += ["```", ""]
        print(json.dumps(r), flush=True)

    out = os.path.join(os.path.dirname(__file__), "..", "PARITY_IMAGES.md")
    with open(out, "w") as f:
        f.write("\n".join(lines))
    print("wrote", os.path.abspath(out))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--res-div", type=int, default=4)
    ap.add_argument("--spp", type=int, default=64)
    ARGS = ap.parse_args()
    main()
