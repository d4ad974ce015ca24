"""BASELINE configs #1 and #2: the small CPU-anchor configs, run
end-to-end and cross-checked, so `BASELINE.json.published` can carry
all five configs (VERDICT r4 missing #1 / item 2).

  #1  Cornell-box diffuse scene, unidirectional PT, 64x64 @ 16spp
  #2  Same scene + perfect mirror BSDF, NEE, 128x128

Each config renders with the named estimator AND a cross-estimator
(BDPT), and reports the mean-image agreement — the reference's own
quality strategy (SURVEY.md §4 item 2: paired path/BDPT configs must
converge to the same image).

Run (chip or CPU): python benchmarks/baseline_small.py
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

import numpy as np


def run_config(name, scene, cam, w, h, spp, modes, rr_depth, spp_extra=1):
    from bpt_tpu.integrators.bdpt import BDPTConfig, render_image

    out = {"which": name, "resolution": f"{w}x{h}", "spp": spp,
           "device": str(jax.devices()[0])}
    imgs = {}
    for mode in modes:
        cfg = BDPTConfig(w, h, spp=spp * (spp_extra if mode != modes[0]
                                          else 1),
                         rr_depth=rr_depth, mode=mode)
        t0 = time.time()
        img, nrays = render_image(scene, cam, cfg, seed=2, spp_chunk=spp)
        img = np.asarray(img)
        dt = time.time() - t0
        imgs[mode] = img
        out[mode] = {
            "mean": round(float(img.mean()), 5),
            "wall_s_with_compile": round(dt, 1),
            "rays": int(nrays),
        }
        assert np.isfinite(img).all(), (name, mode)
    a, b = (imgs[m] for m in modes[:2])
    out["cross_estimator_mean_ratio"] = round(
        float(a.mean() / max(b.mean(), 1e-12)), 4)
    return out


def main():
    from bpt_tpu.scene.procedural import cornell_box_scene

    reports = []

    # #1: diffuse box, unidirectional PT (explicit NEE+MIS), 64x64@16spp
    w = h = 64
    scene, meta, cam = cornell_box_scene(w, h)
    reports.append(run_config(
        "config#1 diffuse PT 64x64@16spp", scene, cam, w, h, 16,
        ("path_trace", "bdpt"), rr_depth=5))

    # #2: + perfect mirror, NEE, 128x128
    w = h = 128
    scene, meta, cam = cornell_box_scene(w, h,
                                         right_object="mirror_sphere")
    reports.append(run_config(
        "config#2 mirror NEE 128x128", scene, cam, w, h, 16,
        ("path_trace", "bdpt"), rr_depth=6))

    for r in reports:
        print(json.dumps(r))
    ratios = [r["cross_estimator_mean_ratio"] for r in reports]
    assert all(0.9 < x < 1.1 for x in ratios), ratios
    print(json.dumps({"all_cross_checks_within_10pct": True,
                      "ratios": ratios}))


if __name__ == "__main__":
    main()
