"""Pinhole camera: ray generation and image-plane splatting.

Replicates the reference's camera model exactly so images match:
  * primary rays via inverse-lookAt + tan(fov/2)-scaled image plane at
    near=1, far=1000, fov measured vertically
    (reference: src/core/renderer.cpp:140-192);
  * light-vertex splats via lookAt + glm::perspective + NDC->screen, with
    C-style truncation toward zero when snapping to pixels
    (reference: src/integrators/bdpt.h:485-496);
  * the reference's spp>1 jitter divides the +-0.5 offset by width/height
    (covering half an NDC pixel) - replicated as-is
    (reference: renderer.cpp:183-192);
  * the t=1 "virtual near plane" pdf machinery
    (reference: bdpt.h:49-62, 321-328).

Unlike the reference, the matrices are computed once on the host and shared
by ray generation and splatting (the reference rebuilds them per splat,
bdpt.h:485-496).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from .math import DEG2RAD, mat_vec


def look_at(eye, center, up):
    """glm::lookAt (right-handed): world->camera 4x4 (row-vector math,
    applied as M @ [p, 1])."""
    eye = np.asarray(eye, np.float64)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, np.asarray(up, np.float64))
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def perspective(fovy_rad, aspect, near, far):
    """glm::perspective (right-handed, NDC z in [-1,1])."""
    t = np.tan(fovy_rad / 2.0)
    m = np.zeros((4, 4))
    m[0, 0] = 1.0 / (aspect * t)
    m[1, 1] = 1.0 / t
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -(2.0 * far * near) / (far - near)
    m[3, 2] = -1.0
    return m


@dataclasses.dataclass(frozen=True)
class Camera:
    """Static camera description + precomputed matrices (host-side)."""

    o: np.ndarray          # eye position (3,)
    at: np.ndarray
    up: np.ndarray
    fov: float             # vertical, degrees
    width: int
    height: int
    near: float = 1.0
    far: float = 1000.0

    @staticmethod
    def make(o, at, up, fov, width, height):
        return Camera(
            o=np.asarray(o, np.float32),
            at=np.asarray(at, np.float32),
            up=np.asarray(up, np.float32),
            fov=float(fov),
            width=int(width),
            height=int(height),
        )

    @property
    def aspect(self):
        return float(self.width) / float(self.height)

    @property
    def angle(self):
        """tan(fov/2) image-plane half-height (renderer.cpp:149)."""
        return float(np.tan(DEG2RAD * self.fov * 0.5))

    @property
    def forward(self):
        f = self.at.astype(np.float64) - self.o.astype(np.float64)
        return (f / np.linalg.norm(f)).astype(np.float32)

    @property
    def world_to_camera(self):
        return look_at(self.o, self.at, self.up)

    @property
    def cam_rotation_t(self):
        """Columns (s, u, -f): camera->world rotation (inverse lookAt
        restricted to directions)."""
        return self.world_to_camera[:3, :3].T

    @property
    def view_proj(self):
        """perspective @ lookAt, used by splatting (bdpt.h:487-492)."""
        p = perspective(DEG2RAD * self.fov, self.aspect, self.near, self.far)
        return (p @ self.world_to_camera).astype(np.float32)

    @property
    def virtual_near_plane_distance(self):
        """Distance at which one pixel has unit area (bdpt.h:52)."""
        return (1.0 / self.angle) * self.height * 0.5

    def device_constants(self):
        """Bundle of jnp constants for use inside jitted code."""
        return {
            "o": jnp.asarray(self.o),
            "forward": jnp.asarray(self.forward),
            "rot_t": jnp.asarray(self.cam_rotation_t.astype(np.float32)),
            "view_proj": jnp.asarray(self.view_proj),
            "angle": jnp.float32(self.angle),
            "aspect": jnp.float32(self.aspect),
            "vnpd": jnp.float32(self.virtual_near_plane_distance),
        }


def generate_rays(cam_consts, width, height, pixel_idx, jitter=None):
    """Primary ray origins/directions for flat pixel indices.

    pixel_idx: (B,) int32 flat indices (row-major, y*W + x).
    jitter: optional (B, 2) U[0,1)^2; when given, applies the reference's
    spp>1 jitter (renderer.cpp:183-192); when None, rays go through pixel
    centers (the reference's spp==1 path, renderer.cpp:169-180).

    Returns (o (B,3), d (B,3)) with implied min_t=near, max_t=far.
    """
    j = (pixel_idx % width).astype(jnp.float32)   # x
    i = (pixel_idx // width).astype(jnp.float32)  # y
    inv_w = 1.0 / width
    inv_h = 1.0 / height
    y = (1.0 - (i + 0.5) * inv_h) * 2.0 - 1.0
    x = ((j + 0.5) * inv_w) * 2.0 - 1.0
    if jitter is not None:
        rx = (jitter[..., 0] - 0.5) * inv_w
        ry = (jitter[..., 1] - 0.5) * inv_h
        x = x + rx
        y = y + ry
    angle = cam_consts["angle"]
    aspect = cam_consts["aspect"]
    # imagePlanePoint = (x*angle*aspect, y*angle, -near) rotated to world.
    local = jnp.stack(
        [x * angle * aspect, y * angle, -jnp.ones_like(x)], axis=-1
    )
    d = mat_vec(cam_consts["rot_t"], local)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.broadcast_to(cam_consts["o"], d.shape)
    return o, d


def splat_to_image_plane(cam_consts, width, height, p):
    """Project world point p (B,3) -> integer pixel coords, replicating
    bdpt.h:485-496 (including trunc-toward-zero pixel snapping).

    Returns (x_pixel (B,) int32, y_pixel (B,) int32, in_bounds (B,) bool).
    """
    vp = cam_consts["view_proj"]
    ph = jnp.concatenate([p, jnp.ones_like(p[..., :1])], axis=-1)
    clip = mat_vec(vp, ph)
    ndc = clip[..., :3] / clip[..., 3:4]
    fx = width * (ndc[..., 0] + 1.0) * 0.5
    fy = height * (1.0 - ndc[..., 1]) * 0.5
    # static_cast<int> truncates toward zero (bdpt.h:494-495).
    x_pix = jnp.trunc(fx).astype(jnp.int32)
    y_pix = jnp.trunc(fy).astype(jnp.int32)
    in_bounds = (
        (x_pix >= 0) & (y_pix >= 0) & (x_pix < width) & (y_pix < height)
    )
    return x_pix, y_pix, in_bounds
