"""bpt_tpu: a differentiable bidirectional path tracer in JAX.

A from-scratch JAX/XLA framework with the capabilities of the
reference C++ CPU renderer (JackMinn/Bidirectional-Path-Tracing): full BDPT
with VCM-style MIS weights, delta BSDFs (perfect mirror, glass), wavefront
formulation over ray SoA batches, multi-chip sharding via jax.sharding, and
end-to-end differentiability for inverse rendering.
"""

__version__ = "0.1.0"
