"""Multi-device rendering: pixel-tile + sample sharding over a device mesh.

Replaces the reference's single-node std::thread fan-out with a per-pixel
mutex framebuffer (reference: src/core/parallelfor.h:25-66,
src/main.cpp:137-143) by the SPMD scheme from SURVEY.md section 2.7:

  * mesh axes ('dp', 'sp'): 'dp' shards pixel-sample lanes, 'sp' shards
    spp chunks;
  * every device scatter-adds into a *local* framebuffer copy (light-subpath
    splats can land on any pixel, bdpt.h:295-371), then one `psum` over both
    axes merges them -- the lock-free equivalent of the reference's
    g_FrameBufferLocks;
  * RNG is counter-based per (pixel, sample), so the sharded render is
    bit-identical in expectation to the single-device render and
    deterministic for a fixed mesh shape.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

from ..integrators.bdpt import (
    BDPTConfig,
    render_sample,
    render_sample_pool,
)
from ..scene.scene import SceneData


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Multi-host SPMD runtime init (SURVEY.md section 2.7, multi-node
    row — the replacement for the reference's single-process
    std::thread pool, parallelfor.h:39-48).

    Pass all three arguments: nothing in a plain GPU or CPU environment
    describes the cluster.  On GPUs the collectives are NCCL's (over
    NVLink between the cards of one host); CPU cross-process collectives
    (tests / local multi-process) use the Gloo backend —
    JAX_CPU_COLLECTIVES_IMPLEMENTATION=gloo, set here by default.
    After this returns, `jax.devices()` is the GLOBAL device list and
    `make_mesh` builds a global mesh.

    MUST run before any JAX device use in the process: the Gloo
    collectives setting is read once at CPU-backend initialization, so a
    backend initialized earlier would silently skip it (fails loudly
    here instead).
    """
    import os

    if getattr(getattr(jax._src, "xla_bridge", None), "_backends", None):
        raise RuntimeError(
            "init_distributed must be called before any JAX device use: "
            "the CPU backend is already initialized, so the Gloo "
            "collectives setting would be silently ignored.")
    os.environ.setdefault("JAX_CPU_COLLECTIVES_IMPLEMENTATION", "gloo")
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def make_mesh(n_dp: int = None, n_sp: int = 1, devices=None) -> Mesh:
    """('dp', 'sp') mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    if n_dp is None:
        n_dp = len(devices) // n_sp
    devices = np.asarray(devices[: n_dp * n_sp]).reshape(n_dp, n_sp)
    return Mesh(devices, ("dp", "sp"))


def render_chunk_sharded(scene: SceneData, cam_consts, cfg: BDPTConfig,
                         mesh: Mesh, key, spp_chunk: int,
                         fb_mode: str = "psum"):
    """Render `spp_chunk * n_sp` samples per pixel, sharded over the mesh.

    Pixel lanes are sharded on 'dp' (requires W*H divisible by the dp axis
    size); each 'sp' slice renders its own disjoint set of sample indices.
    Returns the framebuffer sum (weighted by 1/cfg.spp per sample,
    matching renderer.cpp:202) and the total ray count.

    fb_mode:
      * "psum" — every device ends with the full replicated (W*H, 3)
        buffer (one all-reduce; fine for small images);
      * "reduce_scatter" — the merge is a psum_scatter over 'dp', so each
        device keeps only its n_pix/n_dp pixel shard (the returned global
        jax.Array is sharded over 'dp').  This is the memory-scalable
        path for large framebuffers on many devices: per-device memory is
        O(n_pix/n_dp) instead of O(n_pix), and the collective moves half
        the bytes of an all-reduce.
    """
    if fb_mode not in ("psum", "reduce_scatter"):
        raise ValueError(f"unknown fb_mode {fb_mode!r}")
    w, h = cfg.width, cfg.height
    n_pix = w * h
    n_dp = mesh.shape["dp"]
    if n_pix % n_dp != 0:
        raise ValueError(
            f"pixel count {n_pix} must be divisible by dp axis {n_dp}"
        )
    pixel_idx = jnp.arange(n_pix, dtype=jnp.int32)
    fb_spec = P() if fb_mode == "psum" else P("dp")

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("dp"),),
        out_specs=(fb_spec, P()),
        check_vma=False,
    )
    def shard_fn(pix):
        sp_i = jax.lax.axis_index("sp")
        fb = jnp.zeros((n_pix, 3), jnp.float32)
        nrays = jnp.int32(0)

        def body(carry, s):
            fb, nrays = carry
            sample_idx = sp_i * spp_chunk + s
            k = jax.random.fold_in(key, sample_idx)
            fb_s, nr = render_sample(scene, cam_consts, cfg, k, pix)
            return (fb + fb_s, nrays + nr), None

        (fb, nrays), _ = jax.lax.scan(
            body, (fb, nrays), jnp.arange(spp_chunk))
        # The collective that replaces the reference's per-pixel mutexes
        # (light-subpath splats land on ANY pixel, so every device's
        # local buffer is a partial sum over the whole image).
        if fb_mode == "psum":
            fb = jax.lax.psum(fb, ("dp", "sp"))
        else:
            fb = jax.lax.psum_scatter(fb, "dp", scatter_dimension=0,
                                      tiled=True)
            fb = jax.lax.psum(fb, "sp")
        nrays = jax.lax.psum(nrays, ("dp", "sp"))
        return fb, nrays

    return shard_fn(pixel_idx)


def render_chunk_pool_ring(scene: SceneData, cam_consts, cfg: BDPTConfig,
                           mesh: Mesh, key, spp_chunk: int,
                           fb_mode: str = "psum"):
    """Pooled light transport with RING-ROTATED light-vertex shards
    (SURVEY §5 "long-context analog": the ring-attention pattern applied
    to BDPT's quadratic eye x light connect phase).

    cfg.light_pool light subpaths per sample are sharded over the 'dp'
    axis (alongside the pixel shards).  The s>=2 connect runs blockwise:
    each device connects its local eye vertices against the pool shard
    it currently holds, then `jax.lax.ppermute` rotates the shard to the
    next device — after n_dp steps every eye shard has connected against
    every light subpath WITHOUT ever gathering the pool to one device.
    Per-step traffic is one pool shard (O(pool/n_dp) vertices) around
    the ring, overlapping with each connect pass's trace work.

    RNG is keyed by GLOBAL pool index, so the estimate matches the
    single-device `render_sample_pool` exactly (up to reduction order) —
    tests/test_ring.py asserts it.

    Reference anchor: the all-pairs loop being distributed is
    src/integrators/bdpt.h:146-148."""
    if fb_mode not in ("psum", "reduce_scatter"):
        raise ValueError(f"unknown fb_mode {fb_mode!r}")
    if cfg.light_pool <= 0:
        raise ValueError("render_chunk_pool_ring needs cfg.light_pool > 0")
    w, h = cfg.width, cfg.height
    n_pix = w * h
    n_dp = mesh.shape["dp"]
    if n_pix % n_dp != 0:
        raise ValueError(
            f"pixel count {n_pix} must be divisible by dp axis {n_dp}")
    if cfg.light_pool % n_dp != 0:
        raise ValueError(
            f"light_pool {cfg.light_pool} must be divisible by dp axis "
            f"{n_dp}")
    pixel_idx = jnp.arange(n_pix, dtype=jnp.int32)
    pool_ids = jnp.arange(cfg.light_pool, dtype=jnp.int32)
    fb_spec = P() if fb_mode == "psum" else P("dp")

    ring = [(i, (i + 1) % n_dp) for i in range(n_dp)]

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("dp"), P("dp")),
        out_specs=(fb_spec, P()),
        check_vma=False,
    )
    def shard_fn(pix, pids):
        sp_i = jax.lax.axis_index("sp")

        def rotate(slots):
            return jax.tree_util.tree_map(
                lambda a: jax.lax.ppermute(a, "dp", ring), slots)

        fb = jnp.zeros((n_pix, 3), jnp.float32)
        nrays = jnp.int32(0)

        def body(carry, s):
            fb, nrays = carry
            sample_idx = sp_i * spp_chunk + s
            k = jax.random.fold_in(key, sample_idx)
            fb_s, nr = render_sample_pool(
                scene, cam_consts, cfg, k, pix, pids,
                rotate_fn=rotate if n_dp > 1 else None, n_ring=n_dp)
            return (fb + fb_s, nrays + nr), None

        (fb, nrays), _ = jax.lax.scan(
            body, (fb, nrays), jnp.arange(spp_chunk))
        if fb_mode == "psum":
            fb = jax.lax.psum(fb, ("dp", "sp"))
        else:
            fb = jax.lax.psum_scatter(fb, "dp", scatter_dimension=0,
                                      tiled=True)
            fb = jax.lax.psum(fb, "sp")
        nrays = jax.lax.psum(nrays, ("dp", "sp"))
        return fb, nrays

    return shard_fn(pixel_idx, pool_ids)


def render_image_sharded(scene: SceneData, camera, cfg: BDPTConfig,
                         mesh: Mesh, seed: int = 0,
                         fb_mode: str = "psum"):
    """Full sharded render: spp split across the 'sp' axis.

    With fb_mode="reduce_scatter" the framebuffer stays sharded over
    'dp' on device; the reshape below gathers it to the host once."""
    n_sp = mesh.shape["sp"]
    if cfg.spp % n_sp != 0:
        raise ValueError(f"spp {cfg.spp} must be divisible by sp axis {n_sp}")
    cam_consts = camera.device_constants()
    key = jax.random.key(seed)
    fn = partial(render_chunk_sharded, cfg=cfg, mesh=mesh,
                 spp_chunk=cfg.spp // n_sp, fb_mode=fb_mode)
    fb, nrays = jax.jit(fn)(scene, cam_consts, key=key)
    if not fb.is_fully_addressable:
        # Multi-host: each process holds only its own 'dp' shards; the
        # final host-side image needs a cross-process allgather.
        from jax.experimental import multihost_utils

        fb = multihost_utils.process_allgather(fb, tiled=True)
    fb = jax.device_get(fb)
    return fb.reshape(cfg.height, cfg.width, 3), int(nrays)
