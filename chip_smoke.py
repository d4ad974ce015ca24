"""Smoke run of the BDPT render path on NVIDIA GPUs, checked against the
repository's plain references.

    python chip_smoke.py               # one card: phases 1-5
    python chip_smoke.py --four-cards  # four cards: phase 6 only

Phases (one card), all in this one process, which holds the card:

  1. device: JAX's default devices must be GPUs (no CPU fallback);
  2. tracers: `accel.api.trace_closest` / `trace_any` (the binned XLA
     route) against the skip-link reference (`accel/traverse.py`) on
     2^20 rays over the 20,504-triangle glass Cornell box;
  3. main path: the scene exported to TOML+OBJ and rendered by
     `bpt_tpu.cli.main` at 800x600, rrDepth 8, NO_RR, BDPT; the image is
     checked against a `--mode path_trace` render of the same scene;
  4. GPU against CPU: one full 64x64 render on both, same process;
  5. gradient: one `diff.grad.loss_and_grad` step at 128x128.

The reference setting is 256 spp; this smoke run renders 16 spp
(`--spp-chunk 4`) to fit its time.  Any failed phase raises, so the
script exits non-zero; the last line of a passing run is one JSON object
naming the device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from bpt_tpu.compile_cache import enable_compile_cache
from bpt_tpu.device import card_info, require_gpu

SCENE = dict(right_object="glass_sphere", sphere_subdiv=5)  # 20,504 tris
W, H, SPP, SPP_CHUNK, RR_DEPTH = 800, 600, 16, 4, 8
N_RAYS = 1 << 20
Z_GATE = 4.0  # as tests/test_bdpt.py: |z| >= 4 has p < 1e-4 under the null


def log(**kw):
    print(json.dumps(kw, default=str), flush=True)


def check_device():
    """Phase 1: (GPUs JAX found, nvidia-smi name and power limit), or
    RuntimeError when there are no GPUs."""
    import jax

    devs = require_gpu()
    card = card_info()
    log(phase="device", platform=devs[0].platform,
        kind=devs[0].device_kind, count=len(devs), jax=jax.__version__,
        card=card, compile_cache=enable_compile_cache())
    return devs, card


# ---------------------------------------------------------------- phase 2
def make_rays(cam, w, h, n, seed=42):
    """Half jittered camera rays, half rays from random points inside the
    box in random directions; about a quarter of the lanes dead."""
    import jax
    import jax.numpy as jnp

    from bpt_tpu.core.camera import generate_rays

    k_o, k_d, k_dead, k_jit = jax.random.split(jax.random.key(seed), 4)
    half = n // 2
    pix = jnp.arange(half, dtype=jnp.int32) % (w * h)
    o1, d1 = generate_rays(cam.device_constants(), w, h, pix,
                           jax.random.uniform(k_jit, (half, 2)))
    o2 = jax.random.uniform(k_o, (n - half, 3),
                            minval=jnp.asarray([-1.0, 0.05, -1.0]),
                            maxval=jnp.asarray([1.0, 1.95, 1.0]))
    d2 = jax.random.normal(k_d, (n - half, 3))
    d2 = d2 / jnp.linalg.norm(d2, axis=-1, keepdims=True)
    dead = jax.random.uniform(k_dead, (n,)) < 0.25
    return jnp.concatenate([o1, o2]), jnp.concatenate([d1, d2]), dead


def tracer_mismatches(scene, o, d, dead):
    """Compare the routed tracers with the skip-link reference; returns a
    dict of mismatch fractions and the worst relative t error."""
    import jax
    import jax.numpy as jnp

    from bpt_tpu.accel import api, traverse

    max_t = jnp.where(dead, -1.0, jnp.inf)
    seg_t = jnp.where(dead, -1.0, 2.0)
    got = jax.jit(lambda o, d, m: api.trace_closest(scene, o, d, 1e-4, m))
    ref = jax.jit(lambda o, d, m: traverse.trace_closest(
        scene.geom, o, d, 1e-4, m))
    got_any = jax.jit(lambda o, d, m: api.trace_any(scene, o, d, 1e-4, m))
    ref_any = jax.jit(lambda o, d, m: traverse.trace_any(
        scene.geom, o, d, 1e-4, m))
    hg, hr = got(o, d, max_t), ref(o, d, max_t)
    vg, vr = np.asarray(hg.valid), np.asarray(hr.valid)
    both = vg & vr
    tg, tr = np.asarray(hg.t)[both], np.asarray(hr.t)[both]
    rel = np.abs(tg - tr) / np.maximum(np.abs(tr), 1e-30)
    return {
        "valid": float((vg != vr).mean()),
        "tri": float((np.asarray(hg.tri) != np.asarray(hr.tri)).mean()),
        "t_over_1e-5": float((rel > 1e-5).mean()) if rel.size else 0.0,
        "t_max_rel": float(rel.max()) if rel.size else 0.0,
        "occluded": float((np.asarray(got_any(o, d, seg_t))
                           != np.asarray(ref_any(o, d, seg_t))).mean()),
        "hit_frac": float(vr.mean()),
    }


def check_tracers(scene, cam, w=W, h=H, n=N_RAYS):
    """Phase 2.  valid/tri/occlusion may differ on at most 1e-4 of lanes
    (ulp ties at shared triangle edges); t to rtol 1e-5 on the lanes both
    tracers hit.  Runs at the program's default matmul precision."""
    o, d, dead = make_rays(cam, w, h, n)
    m = tracer_mismatches(scene, o, d, dead)
    log(phase="tracers", rays=n, **m)
    bad = {k: m[k] for k in ("valid", "tri", "occluded", "t_over_1e-5")
           if m[k] > 1e-4}
    if bad:
        raise AssertionError(f"tracers disagree with traverse.py: {bad}")


# ---------------------------------------------------------------- phase 3
def paired_z(a, b, tiles=8):
    """z statistic of mean(a - b) for two independent renders of one
    scene, with the standard error taken from the spread of the
    difference over tiles x tiles image tiles (each tile mean is an
    independent zero-mean estimate under the null)."""
    diff = (np.asarray(a, np.float64) - np.asarray(b, np.float64)).mean(-1)
    h, w = diff.shape
    th, tw = h // tiles, w // tiles
    m = diff[: th * tiles, : tw * tiles].reshape(
        tiles, th, tiles, tw).mean(axis=(1, 3)).ravel()
    se = m.std(ddof=1) / np.sqrt(m.size)
    return float(abs(m.mean()) / max(se, 1e-30))


def _cli_render(toml, out, mode):
    from bpt_tpu import cli
    from bpt_tpu.io.exr import read_exr

    rc = cli.main([toml, "--out", out, "--spp-chunk", str(SPP_CHUNK),
                   "--no-rr", "--mode", mode, "--seed",
                   "1" if mode == "bdpt" else "2"])
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc} for mode {mode}")
    with open(out + ".meta.json") as f:
        meta = json.load(f)
    return read_exr(out), meta


def check_main_path(card, w=W, h=H, spp=SPP, rr_depth=RR_DEPTH):
    """Phase 3: export, render through the CLI, check the EXR."""
    import jax

    from bpt_tpu.native import native
    from bpt_tpu.scene.export import export_cornell_box

    builder = "native" if native.available() else "numpy"
    with tempfile.TemporaryDirectory() as tmp:
        toml = export_cornell_box(tmp, width=w, height=h, spp=spp,
                                  integrator="bdpt", rr_depth=rr_depth,
                                  **SCENE)
        img, meta = _cli_render(toml, os.path.join(tmp, "bdpt.exr"), "bdpt")
        ref, meta_pt = _cli_render(toml, os.path.join(tmp, "pt.exr"),
                                   "path_trace")
    if img.shape != (h, w, 3):
        raise AssertionError(f"EXR shape {img.shape}, expected {(h, w, 3)}")
    if not np.isfinite(img).all() or (img < 0).any():
        raise AssertionError("EXR has non-finite or negative pixels")
    z = paired_z(img, ref)
    chunks, chunk_rays = meta["chunk_wall_s"], meta["chunk_rays"]
    steady_s, steady_rays = sum(chunks[1:]), sum(chunk_rays[1:])
    stats = jax.devices()[0].memory_stats() or {}
    log(phase="main_path", resolution=f"{w}x{h}", spp=spp,
        rr_depth=rr_depth, no_rr=True, bvh_builder=builder,
        wall_s=meta["wall_s"], first_chunk_s=chunks[0],
        setup_compile_s=chunks[0] - float(np.median(chunks[1:])),
        steady_chunk_s=chunks[1:], rays=meta["rays"],
        rays_per_s=steady_rays / steady_s,
        peak_bytes_in_use=stats.get("peak_bytes_in_use"),
        mean=float(img.mean()), path_trace_mean=float(ref.mean()),
        path_trace_wall_s=meta_pt["wall_s"], z=z, card=card)
    if z >= Z_GATE:
        raise AssertionError(f"BDPT mean differs from path_trace: z={z:.2f}")


# ---------------------------------------------------------------- phase 4
def pixels_off(got, ref):
    """Share of pixels off by more than 0.1% relative."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-3)
    return float((rel > 1e-3).mean())


def compare_images(got, ref, rays_got, rays_ref):
    """Failures of render `got` against reference render `ref` of the
    same seed.  At most 2% of pixels off by more than 0.1% relative (an
    ulp tie at a shared edge reroutes a whole path); image means within
    1e-3 relative; ray counts within 1e-3 relative (the scatter-add order
    is not fixed).  A render whose camera or frames ran in TF32 puts ~10%
    of pixels off while its mean and ray count stay within bounds."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    fails = []
    off = pixels_off(got, ref)
    if off > 0.02:
        fails.append(f"{off:.2%} of pixels off by more than 0.1%")
    mean_rel = abs(got.mean() - ref.mean()) / max(abs(ref.mean()), 1e-9)
    if mean_rel > 1e-3:
        fails.append(f"image means differ by {mean_rel:.2e} relative")
    rays_rel = abs(rays_got - rays_ref) / max(rays_ref, 1)
    if rays_rel > 1e-3:
        fails.append(f"ray counts {rays_got} vs {rays_ref}")
    return fails


def check_gpu_vs_cpu(scene_kw=SCENE, w=64, h=64, spp=4, rr_depth=5):
    """Phase 4: one render on the GPU and on the CPU (the reference)."""
    import jax

    from bpt_tpu.integrators.bdpt import BDPTConfig, render_image
    from bpt_tpu.scene.procedural import cornell_box_scene

    scene, _, cam = cornell_box_scene(w, h, **scene_kw)
    cfg = BDPTConfig(w, h, spp=spp, rr_depth=rr_depth)
    out = {}
    for name, dev in (("gpu", jax.devices()[0]),
                      ("cpu", jax.devices("cpu")[0])):
        with jax.default_device(dev):
            img, nr = render_image(jax.device_put(scene, dev), cam, cfg,
                                   seed=9, spp_chunk=spp)
            out[name] = (np.asarray(img), nr)
    (gpu, rays_gpu), (cpu, rays_cpu) = out["gpu"], out["cpu"]
    fails = compare_images(gpu, cpu, rays_gpu, rays_cpu)
    log(phase="gpu_vs_cpu", resolution=f"{w}x{h}", spp=spp,
        rays_gpu=rays_gpu, rays_cpu=rays_cpu, mean_gpu=float(gpu.mean()),
        mean_cpu=float(cpu.mean()),
        pixels_off_over_0p1pct=pixels_off(gpu, cpu),
        max_abs_diff=float(np.abs(gpu - cpu).max()), failures=fails)
    if fails:
        raise AssertionError(f"GPU render differs from CPU: {fails}")


# ---------------------------------------------------------------- phase 5
def check_gradient(w=128, h=128, spp=4):
    """Phase 5: one loss_and_grad step; loss and gradients finite."""
    import jax
    import jax.numpy as jnp

    from bpt_tpu.diff.grad import extract_params, loss_and_grad
    from bpt_tpu.integrators.bdpt import BDPTConfig
    from bpt_tpu.scene.procedural import cornell_box_scene

    scene, _, cam = cornell_box_scene(w, h, **SCENE)
    cfg = BDPTConfig(w, h, spp=spp, rr_depth=RR_DEPTH)
    target = jnp.full((w * h, 3), 0.1, jnp.float32)
    t0 = time.perf_counter()
    loss, grads = loss_and_grad(extract_params(scene), scene,
                                cam.device_constants(), cfg,
                                jax.random.key(3), spp, target)
    loss = float(loss)
    grads = {k: np.asarray(v) for k, v in grads.items()}
    finite = np.isfinite(loss) and all(np.isfinite(g).all()
                                       for g in grads.values())
    log(phase="gradient", resolution=f"{w}x{h}", spp=spp, loss=loss,
        wall_s=time.perf_counter() - t0,
        grad_abs_sum={k: float(np.abs(g).sum()) for k, g in grads.items()})
    if not finite:
        raise AssertionError("loss or gradient not finite")


# ---------------------------------------------------------------- phase 6
def _timed(fn):
    """Compile + warm up, then one timed run; returns (out, seconds)."""
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def check_four_cards(card, n_cards=4, w=512, h=512, spp=8,
                     rr_depth=RR_DEPTH, pool_res=128, pool_spp=2):
    """Phase 6: sharded renders on four cards against the same render on
    one card.  Images to rtol 1e-4 / atol 1e-5 (NCCL's reduction order
    differs from one card's), ray counts exactly."""
    import dataclasses
    from functools import partial

    import jax
    import jax.numpy as jnp

    from bpt_tpu.integrators import bdpt as bd
    from bpt_tpu.parallel.mesh import (
        make_mesh,
        render_chunk_pool_ring,
        render_chunk_sharded,
    )
    from bpt_tpu.scene.procedural import cornell_box_scene

    devs = jax.devices()
    if len(devs) < n_cards:
        raise RuntimeError(f"need {n_cards} cards, JAX found {len(devs)}")
    scene, _, cam = cornell_box_scene(w, h, **SCENE)
    cc = cam.device_constants()
    key = jax.random.key(0)
    cfg = bd.BDPTConfig(w, h, spp=spp, rr_depth=rr_depth)
    # One card: render_chunk over all samples (sb=1), as render_image does.
    (fb1, nr1), t1 = _timed(jax.jit(
        lambda: bd.render_chunk(scene, cc, cfg, key, spp)))
    fb1, nr1 = np.asarray(fb1), int(nr1)
    log(phase="one_card", resolution=f"{w}x{h}", spp=spp, wall_s=t1,
        rays=nr1, rays_per_s=nr1 / t1, card=card)
    fails = []
    for n_dp, n_sp in ((n_cards, 1), (2, n_cards // 2)):
        mesh = make_mesh(n_dp=n_dp, n_sp=n_sp, devices=devs[:n_cards])
        for fb_mode in ("psum", "reduce_scatter"):
            fn = jax.jit(partial(render_chunk_sharded, scene, cc, cfg, mesh,
                                 key, spp // n_sp, fb_mode=fb_mode))
            (fb, nr), t = _timed(fn)
            fb, nr = np.asarray(jax.device_get(fb)), int(nr)
            ok = np.allclose(fb, fb1, rtol=1e-4, atol=1e-5) and nr == nr1
            log(phase="sharded", mesh=f"{n_dp}x{n_sp}", fb_mode=fb_mode,
                wall_s=t, rays=nr, max_abs_diff=float(np.abs(fb - fb1).max()),
                rays_per_s_per_card=nr / t / n_cards,
                scaling_efficiency=t1 / (n_cards * t), ok=ok, card=card)
            if not ok:
                fails.append(f"render_chunk_sharded {n_dp}x{n_sp} {fb_mode}")

    # Pooled light transport, pool shards ring-rotated over 'dp'.
    pw = ph = pool_res
    pscene, _, pcam = cornell_box_scene(pw, ph, **SCENE)
    pcc = pcam.device_constants()
    pcfg = dataclasses.replace(bd.BDPTConfig(pw, ph, spp=pool_spp,
                                             rr_depth=rr_depth),
                               light_pool=4 * n_cards)
    pix = jnp.arange(pw * ph, dtype=jnp.int32)
    pool_ids = jnp.arange(pcfg.light_pool, dtype=jnp.int32)

    def single_pool():
        fb = jnp.zeros((pw * ph, 3), jnp.float32)
        nr = jnp.int32(0)
        for s in range(pool_spp):
            fb_s, nr_s = bd.render_sample_pool(
                pscene, pcc, pcfg, jax.random.fold_in(key, s), pix,
                pool_ids)
            fb, nr = fb + fb_s, nr + nr_s
        return fb, nr

    (pfb1, pnr1), pt1 = _timed(jax.jit(single_pool))
    mesh = make_mesh(n_dp=n_cards, n_sp=1, devices=devs[:n_cards])
    (pfb, pnr), pt = _timed(jax.jit(partial(
        render_chunk_pool_ring, pscene, pcc, pcfg, mesh, key, pool_spp)))
    pfb, pfb1 = np.asarray(pfb), np.asarray(pfb1)
    ok = (np.allclose(pfb, pfb1, rtol=1e-4, atol=1e-5)
          and int(pnr) == int(pnr1))
    log(phase="pool_ring", mesh=f"{n_cards}x1", light_pool=pcfg.light_pool,
        resolution=f"{pw}x{ph}", spp=pool_spp, wall_s=pt, one_card_s=pt1,
        rays=int(pnr), one_card_rays=int(pnr1),
        max_abs_diff=float(np.abs(pfb - pfb1).max()),
        rays_per_s_per_card=int(pnr) / pt / n_cards,
        scaling_efficiency=pt1 / (n_cards * pt), ok=ok, card=card)
    if not ok:
        fails.append("render_chunk_pool_ring")
    if fails:
        raise AssertionError(f"sharded renders differ from one card: {fails}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)

    # Phase 4 renders its reference on the CPU backend, in this process.
    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    devs, card = check_device()
    if args.four_cards:
        check_four_cards(card)
    else:
        from bpt_tpu.scene.procedural import cornell_box_scene

        scene, _, cam = cornell_box_scene(W, H, **SCENE)
        check_tracers(scene, cam)
        check_main_path(card)
        check_gpu_vs_cpu()
        check_gradient()
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
