"""Benchmark: rays/sec per GPU on the BDPT caustic scene.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...},
with the card's name, device kind and power limit beside the number.
Fails when JAX finds no GPU: a CPU timing is never reported.

Baseline (BASELINE.md): the reference CPU renderer sustains ~124k
pixel-samples/s on the 800x600 cbox at 256spp (990s best case), which is
~1.0e6 rays/s counting subpath + shadow rays (BASELINE.md "derived
throughput" row).  vs_baseline = our rays/s / 1.0e6.

Scene: the procedural glass-sphere (caustic) Cornell box, full BDPT with
MIS at 256x256 (BASELINE.json config #3).

Stage attribution: telescoping phase ablation — the IDENTICAL pipeline
is re-timed with one connection technique disabled at a time
(BDPTConfig.connect_{s2,s1,t1}), so each stage cost is the delta of two
runs that differ only in that phase, and the stages sum exactly to the
full wall time.

Sharded mode: BPT_BENCH_MESH=DPxSP (e.g. "2x2" on four cards) times
render_chunk_sharded over a ('dp','sp') mesh and records rays/s per card.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

import jax
import jax.numpy as jnp

from bpt_tpu.compile_cache import enable_compile_cache
from bpt_tpu.device import card_info, require_gpu

MESH_ENV = os.environ.get("BPT_BENCH_MESH", "")
BASELINE_RAYS_PER_SEC = 1.0e6

WIDTH = HEIGHT = 256
SPP = 16           # timed samples (after warmup)
RR_DEPTH = 8       # the reference caustic config (cbox_bdpt_glass.toml)
# Samples fused per wavefront dispatch.  sb=2 was chosen on an earlier
# accelerator; it has not been measured on the H100.
SB = int(os.environ.get("BPT_BENCH_SB", "2"))


def _load_scene():
    from bpt_tpu.scene.procedural import cornell_box_scene

    scene, meta, cam = cornell_box_scene(
        WIDTH, HEIGHT, right_object="glass_sphere", sphere_subdiv=3
    )
    return scene, cam, "procedural glass cbox"


N_REPS = int(os.environ.get("BPT_BENCH_REPS", "3"))


def _timed_chunk(render_chunk, scene, cam_consts, cfg, key, spp,
                 reps=N_REPS):
    """Compile (warmup at the SAME scan length), then time `reps` chunks
    and report the MEDIAN wall time (+ min/max for the spread bar).
    Each timing ends with a host fetch of the framebuffer."""
    fb, nr = render_chunk(scene, cam_consts, cfg, key, spp)
    float(fb.sum())
    times = []
    nrays = 0
    for _ in range(reps):
        t0 = time.time()
        fb, nr = render_chunk(scene, cam_consts, cfg, key, spp)
        nrays = int(nr)
        _ = float(fb.sum())
        times.append(time.time() - t0)
    times.sort()
    return times[len(times) // 2], nrays, times[0], times[-1]


def _sharded_detail(scene, cam, cfg, mesh_spec):
    """Time render_chunk_sharded on a DPxSP mesh; rays/s per card."""
    from functools import partial

    from bpt_tpu.parallel.mesh import make_mesh, render_chunk_sharded

    dp, sp = (int(x) for x in mesh_spec.lower().split("x"))
    n_dev = dp * sp
    avail = len(jax.devices())
    if avail < n_dev:
        return {"error": f"need {n_dev} devices, have {avail}"}
    mesh = make_mesh(n_dp=dp, n_sp=sp)
    spp_chunk = max(SPP // sp, 1)
    cfg_m = dataclasses.replace(cfg, spp=spp_chunk * sp)
    cam_consts = cam.device_constants()
    key = jax.random.key(7)
    fn = jax.jit(partial(render_chunk_sharded, cfg=cfg_m, mesh=mesh,
                         spp_chunk=spp_chunk, fb_mode="reduce_scatter"))
    fb, nr = fn(scene, cam_consts, key=key)
    float(jnp.asarray(fb).sum())
    t0 = time.time()
    fb, nr = fn(scene, cam_consts, key=key)
    nrays = int(nr)
    float(jnp.asarray(fb).sum())
    dt = time.time() - t0
    return {
        "mesh": f"{dp}x{sp} (dp x sp)",
        "devices": n_dev,
        "spp": spp_chunk * sp,
        "wall_s": round(dt, 3),
        "rays": nrays,
        "rays_per_sec_per_card": round(nrays / dt / n_dev, 1),
    }


def main():
    from functools import partial as _partial

    devs = require_gpu()
    card = card_info()
    enable_compile_cache()

    from bpt_tpu.integrators.bdpt import BDPTConfig
    from bpt_tpu.integrators.bdpt import render_chunk as _render_chunk

    render_chunk = _partial(_render_chunk, samples_per_batch=SB)

    scene, cam, label = _load_scene()
    cfg = BDPTConfig(width=WIDTH, height=HEIGHT, spp=SPP, rr_depth=RR_DEPTH)
    cam_consts = cam.device_constants()
    key = jax.random.key(7)

    dt, nrays, dt_min, dt_max = _timed_chunk(
        render_chunk, scene, cam_consts, cfg, key, SPP)

    # Per-kernel profiler capture (SURVEY §5 "JAX profiler traces"):
    # BPT_PROFILE=<dir> wraps one post-warmup chunk in jax.profiler.trace
    # — the dump under <dir> attributes wall time to individual XLA
    # kernels (view with tensorboard or benchmarks/trace_summary.py).
    prof_dir = os.environ.get("BPT_PROFILE", "")
    if prof_dir:
        with jax.profiler.trace(prof_dir):
            fb, nr = render_chunk(scene, cam_consts, cfg, key, SPP)
            float(fb.sum())

    # Telescoping stage attribution: disable one phase at a time; each
    # stage cost is the delta between two otherwise-identical pipelines,
    # and walks_s is the fully-stripped remainder (closest-hit traces +
    # BSDF sampling + MIS updates of both walks).
    times = {"full": dt}
    for name, kw in (
        ("no_s2", dict(connect_s2=False)),
        ("no_s2_s1", dict(connect_s2=False, connect_s1=False)),
        ("walks", dict(connect_s2=False, connect_s1=False,
                       connect_t1=False)),
    ):
        cfg_a = dataclasses.replace(cfg, **kw)
        t_a, _, _, _ = _timed_chunk(render_chunk, scene, cam_consts,
                                    cfg_a, key, SPP)
        times[name] = t_a
    stages = {
        "all_pairs_connect_s": round(times["full"] - times["no_s2"], 3),
        "nee_s": round(times["no_s2"] - times["no_s2_s1"], 3),
        "camera_connect_s": round(times["no_s2_s1"] - times["walks"], 3),
        "walks_s": round(times["walks"], 3),
    }

    rays_per_sec = float(nrays) / dt
    result = {
        "metric": "rays/sec per GPU (BDPT, caustic scene)",
        "value": round(rays_per_sec, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_sec / BASELINE_RAYS_PER_SEC, 3),
        "spread_pct": round(100.0 * (dt_max - dt_min) / dt, 1),
        "detail": {
            "scene": label,
            "resolution": f"{WIDTH}x{HEIGHT}",
            "spp_timed": SPP,
            "rr_depth": RR_DEPTH,
            "reps": N_REPS,
            "wall_s": round(dt, 3),
            "wall_s_min": round(dt_min, 3),
            "wall_s_max": round(dt_max, 3),
            "rays": int(nrays),
            "platform": devs[0].platform,
            "device_kind": devs[0].device_kind,
            "device_count": len(devs),
            "card": card,
            "pixel_samples_per_sec": round(WIDTH * HEIGHT * SPP / dt, 1),
            "stages": stages,
        },
    }
    if MESH_ENV:
        result["detail"]["sharded"] = _sharded_detail(
            scene, cam, cfg, MESH_ENV)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
