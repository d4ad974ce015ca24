"""Realtime-mode analog: progressive refinement frame loop.

The reference's realtime mode is an SDL/OpenGL rasterizer with four
passes — normal, simple (direct), SSAO, and vertex-baked GI (reference:
src/core/renderpass.{h,cpp}, src/renderpasses/*) — that saves its FIRST
frame to EXR (renderpass.cpp:65-80) and then redraws in a window loop.
This renderer has no rasterizer; its equivalent is a
progressive MONTE-CARLO frame loop over the same pass semantics:

  * each "frame" renders a low-spp estimate on-device and accumulates
    into the running image (progressive refinement instead of redraw);
  * frame 1 is written to `<scene>.exr` exactly like the reference's
    first-frame save; later frames refresh the same file;
  * per-frame wall time / FPS is printed in place of the GL swap loop.

Render-pass mapping (reference ERenderPass, core.h:47-54 — note the
fork's pass draw bodies are TODO-stubbed course scaffolding, SURVEY.md
section 2.5, so the offline integrators implement the intended
semantics):

  | TOML type | reference pass              | integrator here          |
  |-----------|-----------------------------|--------------------------|
  | normal    | NormalPass (normal.h)       | `normal` (shading normal)|
  | simple    | SimplePass (simple.h)       | `simple` (direct Phong)  |
  | ssao      | SSAOPass (ssao.h)           | `ao` (true AO, not SS)   |
  | gi        | GIPass (gi.h, baked PT)     | `path` explicit PT       |
"""
from __future__ import annotations

import time

import numpy as np

PASS_TO_INTEGRATOR = {
    "normal": "normal",
    "simple": "simple",
    "ssao": "ao",
    "gi": "path",
}


def run_realtime(scene, meta, cfg_t, out_path, seed=0, frames=None,
                 spp_per_frame=1, write_exr=None):
    """Progressive frame loop.  Returns (final image, frames rendered).

    frames: frame budget (default: ceil(spp / spp_per_frame), so the
    total sample count matches the TOML's spp)."""
    from .integrators.misc import MiscConfig, render_image_misc
    from .integrators.path import PathConfig, render_image_path

    if write_exr is None:
        from .io.exr import write_exr

    pass_type = PASS_TO_INTEGRATOR.get(cfg_t.integrator, cfg_t.integrator)
    if pass_type not in ("normal", "simple", "ao", "path"):
        raise ValueError(
            f"realtime mode supports normal/simple/ssao/gi passes only "
            f"(reference ERenderPass, core.h:47-54); got "
            f"{cfg_t.integrator!r}")
    if frames is None:
        frames = max((cfg_t.spp + spp_per_frame - 1) // spp_per_frame, 1)

    acc = np.zeros((cfg_t.height, cfg_t.width, 3), np.float32)
    done = 0
    n_rays = 0
    for f in range(frames):
        t0 = time.time()
        if pass_type == "path":
            cfg = PathConfig(
                width=cfg_t.width, height=cfg_t.height, spp=spp_per_frame,
                is_explicit=True, max_depth=cfg_t.max_depth,
                rr_depth=cfg_t.rr_depth, rr_prob=cfg_t.rr_prob,
            )
            img, nr = render_image_path(scene, cfg_t.camera, cfg,
                                        seed=seed + f,
                                        spp_chunk=spp_per_frame)
        else:
            cfg = MiscConfig(
                width=cfg_t.width, height=cfg_t.height, spp=spp_per_frame,
                integrator=pass_type, exponent=cfg_t.exponent,
            )
            img, nr = render_image_misc(scene, meta, cfg_t.camera, cfg,
                                        seed=seed + f)
        acc += np.asarray(img)
        n_rays += int(nr)
        done += 1
        frame = acc / done
        # First frame saved like the reference (renderpass.cpp:65-80);
        # later frames progressively refresh the same file.
        write_exr(out_path, frame)
        dt = time.time() - t0
        print(f"frame {f + 1}/{frames}: {dt * 1e3:.0f} ms "
              f"({1.0 / max(dt, 1e-9):.1f} fps)", flush=True)
    return acc / max(done, 1), done, n_rays


def run_interactive(scene, meta, cfg_t, out_path, commands, seed=0,
                    spp_per_frame=1, write_exr=None):
    """Free-fly interactive frame loop (the reference's WASD camera,
    renderpass.cpp:419-449 + camera.h CameraRT — see core/flycam.py).

    commands: a fly-command string (core.flycam.parse_commands grammar;
    '.' = one frame) or an iterable of (event, value) pairs.  Each frame
    integrates pending camera motion; when the pose changed, progressive
    accumulation RESETS (the path-tracing equivalent of a rasterizer
    redraw) and refinement restarts at the new pose.

    Returns (final image, poses: list of (frames_accumulated, camera)).
    """
    import dataclasses as _dc

    import numpy as np

    from .core.flycam import FlyCamera, parse_commands

    if write_exr is None:
        from .io.exr import write_exr
    if isinstance(commands, str):
        commands = parse_commands(commands)

    fly = FlyCamera.from_lookat(
        o=np.asarray(cfg_t.camera.o), at=np.asarray(cfg_t.camera.at),
        up=np.asarray(cfg_t.camera.up), fov=cfg_t.camera.fov)

    acc = np.zeros((cfg_t.height, cfg_t.width, 3), np.float32)
    done = 0
    frame_no = 0
    poses = []
    cam = fly.camera(cfg_t.width, cfg_t.height)

    def render_one(cam, f):
        cfg_f = _dc.replace(cfg_t, camera=cam)
        img, done_f, nr = run_realtime(
            scene, meta, cfg_f, out_path, seed=seed + f, frames=1,
            spp_per_frame=spp_per_frame, write_exr=lambda *_a, **_k: None)
        return np.asarray(img)

    for ev, val in commands:
        if ev == ".":
            if fly.update():          # pose changed -> reset refinement
                poses.append((done, cam))
                cam = fly.camera(cfg_t.width, cfg_t.height)
                acc[:] = 0.0
                done = 0
            acc += render_one(cam, frame_no)
            done += 1
            frame_no += 1
            write_exr(out_path, acc / done)
        elif ev in "wasd":
            fly.move(ev)
        elif ev == "P":
            fly.pitch(val)
        elif ev == "H":
            fly.heading(val)
    poses.append((done, cam))
    return (acc / max(done, 1)), poses
