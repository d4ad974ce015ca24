"""The accelerator a measurement runs on.

Speed numbers come only from a GPU: a measurement that finds none fails
instead of timing the CPU.  Every number is printed beside the card's
name and power limit, because a card set below its maximum power runs
slower under load.
"""
from __future__ import annotations

import subprocess


def require_gpu():
    """Return jax.devices() when JAX's default devices are GPUs; raise
    RuntimeError otherwise."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default devices are {devs[0].platform} "
            f"({devs[0].device_kind}); this runs only on an NVIDIA GPU")
    return devs


def card_info() -> str:
    """`name, power.limit` per card, as nvidia-smi prints them.  Runs in a
    child process, which stays off JAX and the card's memory."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())
