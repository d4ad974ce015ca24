"""Worker for tests/test_multiprocess.py: one process of a 2-process
jax.distributed CPU run.

Each process owns 2 virtual CPU devices (4 global); the sharded render
runs over the GLOBAL mesh with the reduce_scatter framebuffer, so the
cross-process collective path (Gloo on CPU, NCCL on GPUs) is
actually executed.  Process 0 renders the same scene single-device and
asserts agreement, then prints MULTIPROCESS_OK.
"""
import os
import sys

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Distributed init MUST precede anything that initializes the XLA
# backend — importing bpt_tpu modules creates device constants.
os.environ.setdefault("JAX_CPU_COLLECTIVES_IMPLEMENTATION", "gloo")
jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=nproc, process_id=pid)
assert len(jax.devices()) == 2 * nproc, jax.devices()

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from bpt_tpu.parallel.mesh import (  # noqa: E402
    make_mesh,
    render_image_sharded,
)

import numpy as np  # noqa: E402

from bpt_tpu.integrators.bdpt import BDPTConfig, render_image  # noqa: E402
from bpt_tpu.scene.procedural import cornell_box_scene  # noqa: E402

W = H = 16
scene, meta, cam = cornell_box_scene(W, H)
cfg = BDPTConfig(W, H, spp=4, rr_depth=2)

mesh = make_mesh(n_dp=2 * nproc, n_sp=1)
img, nrays = render_image_sharded(scene, cam, cfg, mesh, seed=0,
                                  fb_mode="reduce_scatter")

if pid == 0:
    img_single, nrays_single = render_image(scene, cam, cfg, seed=0,
                                            spp_chunk=cfg.spp)
    np.testing.assert_allclose(np.asarray(img), np.asarray(img_single),
                               rtol=1e-4, atol=1e-5)
    assert nrays == nrays_single, (nrays, nrays_single)
    print("MULTIPROCESS_OK", flush=True)
