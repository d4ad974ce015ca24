"""Test configuration: the CPU backend, with 8 virtual devices, is the
default backend.

Multi-device sharding logic is tested on a virtual 8-device CPU mesh
(SURVEY.md section 4, item e); the GPU is exercised by chip_smoke.py and
the tests marked `gpu`, which run when a GPU platform is listed after the
CPU (`JAX_PLATFORMS=cpu,cuda python -m pytest -m gpu`) and skip otherwise.
XLA_FLAGS must be set before the CPU backend is first initialized.
"""
import os

_flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# The first platform listed is JAX's default backend: keep it the CPU.
_others = [p for p in os.environ.get("JAX_PLATFORMS", "").split(",")
           if p and p != "cpu"]
os.environ["JAX_PLATFORMS"] = ",".join(["cpu"] + _others)

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
