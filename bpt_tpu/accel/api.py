"""Scene-level tracing dispatch.

Scenes built by the assembler carry treelet tables and trace through the
binned XLA tracers (accel/binned.py); a scene without them falls back to
the stackless skip-link tracer (accel/traverse.py, the correctness
reference).  The choice depends on the scene alone.  Both implement
identical intersection semantics; tests/test_binned.py enforces agreement.
"""
from __future__ import annotations

from . import binned, traverse


def trace_closest(scene, o, d, min_t, max_t) -> traverse.Hit:
    if getattr(scene, "treelets", None) is not None:
        return binned.trace_closest_slots(scene.treelets, o, d, min_t,
                                          max_t)
    return traverse.trace_closest(scene.geom, o, d, min_t, max_t)


def trace_any(scene, o, d, min_t, max_t):
    if getattr(scene, "treelets", None) is not None:
        tg = getattr(scene, "treelets_any", None) or scene.treelets
        return binned.trace_any_binned(tg, o, d, min_t, max_t)
    return traverse.trace_any(scene.geom, o, d, min_t, max_t)
