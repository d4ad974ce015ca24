"""The dense binned tracers (the routed XLA fallbacks: per-ray slot
closest hit, tile-sweep any hit) must agree exactly with the skip-link
tracer (both implement the reference's intersection semantics)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bpt_tpu.accel.binned import trace_any_binned, trace_closest_slots
from bpt_tpu.accel.traverse import trace_any, trace_closest
from bpt_tpu.core.camera import generate_rays
from bpt_tpu.scene.procedural import cornell_box_scene


@pytest.fixture(scope="module")
def scene():
    s, meta, cam = cornell_box_scene(
        32, 32, right_object="glass_sphere", sphere_subdiv=2)
    return s, cam


def _ray_sets(scene, cam, b=2048):
    cc = cam.device_constants()
    pix = jnp.arange(b, dtype=jnp.int32) % (32 * 32)
    o1, d1 = generate_rays(cc, 32, 32, pix)
    rng = np.random.RandomState(3)
    o2 = jnp.asarray(rng.uniform([-1, 0.1, -1], [1, 1.9, 1],
                                 (b, 3)).astype(np.float32))
    d2 = rng.normal(size=(b, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    return [(o1, d1, 1.0, 1000.0), (o2, jnp.asarray(d2), 1e-8, 1e30),
            (o2, jnp.asarray(d2), 0.5, 2.0)]


def test_closest_slots_agrees(scene):
    s, cam = scene
    for (o, d, mn, mx) in _ray_sets(s, cam):
        h_ref = trace_closest(s.geom, o, d, mn, mx)
        h_bin = trace_closest_slots(s.treelets, o, d, mn, mx)
        np.testing.assert_array_equal(np.asarray(h_ref.valid),
                                      np.asarray(h_bin.valid))
        v = np.asarray(h_ref.valid)
        np.testing.assert_allclose(np.asarray(h_ref.t)[v],
                                   np.asarray(h_bin.t)[v], rtol=1e-5)
        # Triangle ids may differ on shared-edge ties (equal t); t and
        # validity above are the geometric ground truth.
        assert (np.asarray(h_ref.tri) == np.asarray(h_bin.tri)).mean() \
            > 0.98


def test_any_binned_agrees(scene):
    s, cam = scene
    for (o, d, mn, mx) in _ray_sets(s, cam):
        a_ref = trace_any(s.geom, o, d, mn, mx)
        a_bin = trace_any_binned(s.treelets, o, d, mn, mx, tile=256)
        np.testing.assert_array_equal(np.asarray(a_ref),
                                      np.asarray(a_bin))


def test_odd_batch_sizes(scene):
    """Padding path: batch not a multiple of the tile size."""
    s, cam = scene
    for b in (1, 7, 255, 300):
        (o, d, mn, mx) = _ray_sets(s, cam, b=max(b, 1))[1]
        o, d = o[:b], d[:b]
        h_ref = trace_closest(s.geom, o, d, mn, mx)
        h_bin = trace_closest_slots(s.treelets, o, d, mn, mx)
        np.testing.assert_array_equal(np.asarray(h_ref.valid),
                                      np.asarray(h_bin.valid))
        a_ref = trace_any(s.geom, o, d, 0.5, 2.0)
        a_bin = trace_any_binned(s.treelets, o, d, 0.5, 2.0, tile=256)
        np.testing.assert_array_equal(np.asarray(a_ref), np.asarray(a_bin))


# ---------------------------------------------------------------------------
# The routed tracers on a scene above 2,048 triangles (20,504): triangle ids
# and vertex coordinates beyond what a TF32 or bf16 fetch would keep exact.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def big_scene():
    s, meta, cam = cornell_box_scene(
        32, 32, right_object="glass_sphere", sphere_subdiv=5)
    assert meta.n_triangles > 2048
    return s, cam


def _big_rays(s, cam, kind, b=1024):
    rng = np.random.RandomState(5)
    if kind == "coherent":
        pix = jnp.arange(b, dtype=jnp.int32) % (32 * 32)
        jitter = jnp.asarray(rng.uniform(size=(b, 2)).astype(np.float32))
        return generate_rays(cam.device_constants(), 32, 32, pix, jitter)
    o = rng.uniform([-1, 0.1, -1], [1, 1.9, 1], (b, 3)).astype(np.float32)
    d = rng.normal(size=(b, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.mark.parametrize("kind", ["coherent", "incoherent"])
def test_big_scene_closest_exact(big_scene, kind):
    from bpt_tpu.accel import api

    s, cam = big_scene
    o, d = _big_rays(s, cam, kind)
    h_ref = trace_closest(s.geom, o, d, 1e-4, jnp.inf)
    h = api.trace_closest(s, o, d, 1e-4, jnp.inf)
    v = np.asarray(h_ref.valid)
    assert v.mean() > 0.5
    np.testing.assert_array_equal(np.asarray(h.valid), v)
    np.testing.assert_allclose(np.asarray(h.t)[v], np.asarray(h_ref.t)[v],
                               rtol=1e-5)
    # A different id is allowed only as a tie: an equally near triangle
    # across a shared edge.
    tie = np.asarray(h.tri) != np.asarray(h_ref.tri)
    assert tie.mean() <= 2e-3
    np.testing.assert_allclose(np.asarray(h.t)[tie],
                               np.asarray(h_ref.t)[tie], rtol=1e-6)


@pytest.mark.parametrize("kind", ["coherent", "incoherent"])
def test_big_scene_any_exact(big_scene, kind):
    from bpt_tpu.accel import api

    s, cam = big_scene
    o, d = _big_rays(s, cam, kind)
    seg = 4.0 if kind == "coherent" else 2.0  # the camera is 2.8 outside
    a_ref = np.asarray(trace_any(s.geom, o, d, 1e-4, seg))
    assert 0.05 < a_ref.mean() < 0.95
    np.testing.assert_array_equal(
        np.asarray(api.trace_any(s, o, d, 1e-4, seg)), a_ref)


def _eqns(jaxpr):
    """Every equation of a jaxpr, sub-jaxprs (loops, calls) included."""
    for eqn in jaxpr.eqns:
        yield eqn
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (tuple, list)) else (p,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _eqns(inner)


@pytest.mark.parametrize("query", ["closest", "any"])
def test_trace_route_is_exact(big_scene, query):
    """No matrix product below HIGHEST on the trace route (a GPU runs
    DEFAULT/HIGH f32 products in TF32), and no triangle id through a
    float: no int<->float conversion at all."""
    from bpt_tpu.accel import api

    s, cam = big_scene
    o, d = _big_rays(s, cam, "incoherent", b=256)
    fn = api.trace_closest if query == "closest" else api.trace_any
    closed = jax.make_jaxpr(lambda o, d: fn(s, o, d, 1e-4, jnp.inf))(o, d)
    for eqn in _eqns(closed.jaxpr):
        if eqn.primitive.name == "dot_general":
            prec = eqn.params["precision"]
            assert prec is not None and all(
                p == jax.lax.Precision.HIGHEST for p in prec), eqn
        if eqn.primitive.name == "convert_element_type":
            src = eqn.invars[0].aval.dtype
            dst = eqn.outvars[0].aval.dtype
            assert not (jnp.issubdtype(src, jnp.integer)
                        and jnp.issubdtype(dst, jnp.floating)), eqn
            assert not (jnp.issubdtype(src, jnp.floating)
                        and jnp.issubdtype(dst, jnp.integer)), eqn
    if query == "closest":
        assert closed.out_avals[1].dtype == jnp.int32  # Hit.tri


@pytest.mark.parametrize("path", ["render_chunk", "loss_and_grad"])
def test_render_path_has_no_matmul(scene, path):
    """No matrix product anywhere on the render path or its gradient:
    camera rays, splat projection and shading frames are elementwise
    sums, so no backend can run them in TF32."""
    from bpt_tpu.diff.grad import extract_params, loss_and_grad
    from bpt_tpu.integrators.bdpt import BDPTConfig, render_chunk

    s, cam = scene
    cc = cam.device_constants()
    cfg = BDPTConfig(32, 32, spp=1, rr_depth=3)
    key = jax.random.key(0)
    if path == "render_chunk":
        closed = jax.make_jaxpr(lambda: render_chunk(s, cc, cfg, key, 1))()
    else:
        target = jnp.zeros((32 * 32, 3), jnp.float32)
        closed = jax.make_jaxpr(lambda p: loss_and_grad(
            p, s, cc, cfg, key, 1, target))(extract_params(s))
    dots = [e for e in _eqns(closed.jaxpr)
            if e.primitive.name == "dot_general"]
    assert not dots, dots[0]


@pytest.mark.parametrize("has_treelets", [True, False])
def test_router_follows_scene(big_scene, monkeypatch, has_treelets):
    """The route depends on the scene alone, whatever the environment."""
    from bpt_tpu.accel import api, binned, traverse

    for var in ("BPT_COMPACT", "BPT_CLUSTER"):
        monkeypatch.setenv(var, "1")
    calls = []
    for mod, name in ((binned, "trace_closest_slots"),
                      (binned, "trace_any_binned"),
                      (traverse, "trace_closest"), (traverse, "trace_any")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _m=mod: calls.append(
            (_m.__name__.rsplit(".", 1)[-1], _n)))
    s, _ = big_scene
    if not has_treelets:
        s = s._replace(treelets=None, treelets_any=None)
    api.trace_closest(s, None, None, 0.0, 1.0)
    api.trace_any(s, None, None, 0.0, 1.0)
    mod = "binned" if has_treelets else "traverse"
    assert [c[0] for c in calls] == [mod, mod]


def test_exhausted_lanes_miss(big_scene):
    """Lanes with no treelet left (dead, or missing every box) read the
    zero fill block and report no hit."""
    s, _ = big_scene
    o = jnp.asarray([[0.0, 1.0, 0.0], [0.0, 1.0, 50.0], [0.0, 1.0, 0.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])
    max_t = jnp.asarray([-1.0, jnp.inf, jnp.inf])  # dead, misses, hits
    h = trace_closest_slots(s.treelets, o, d, 1e-4, max_t)
    np.testing.assert_array_equal(np.asarray(h.valid), [False, False, True])
    np.testing.assert_array_equal(np.asarray(h.tri)[:2], [-1, -1])
    assert np.isinf(np.asarray(h.t)[:2]).all()
