"""Fast import + trace-time smoke: catches undefined-symbol regressions.

Round 3 shipped a NameError (`_front_pack_slots`) that only fired at jit
trace time of the default-mode BDPT path — no test had run before the
commit.  This module is the `make quick` gate: it imports every package
module and traces/executes one tiny render in EVERY mode and layout
variant, so a symbol referenced-but-undefined anywhere on the hot path
fails in seconds.
"""
import importlib
import pkgutil

import numpy as np

import bpt_tpu


def test_import_all_modules():
    failures = []
    for m in pkgutil.walk_packages(bpt_tpu.__path__, "bpt_tpu."):
        if "libbpt" in m.name:  # ctypes .so, not a Python module
            continue
        try:
            importlib.import_module(m.name)
        except Exception as e:  # noqa: BLE001 - collect all failures
            failures.append((m.name, repr(e)))
    assert not failures, failures


def test_tiny_render_all_modes():
    from bpt_tpu.integrators.bdpt import BDPTConfig, render_image
    from bpt_tpu.scene.procedural import cornell_box_scene

    w = h = 8
    scene, meta, cam = cornell_box_scene(w, h)
    for mode in ("bdpt", "path_trace", "light_trace"):
        cfg = BDPTConfig(w, h, spp=1, rr_depth=3, mode=mode)
        img, nrays = render_image(scene, cam, cfg, seed=0, spp_chunk=1)
        img = np.asarray(img)
        assert np.isfinite(img).all(), mode
        assert int(nrays) > 0


def test_mega_connect_matches_per_depth(monkeypatch):
    """The mega-connect batch (one any-hit launch per sample) is a
    TRACE-BATCHING change only: identical RNG, identical segments —
    images must match the per-depth path to float-reassociation
    tolerance."""
    from bpt_tpu.integrators import bdpt as bd
    from bpt_tpu.scene.procedural import cornell_box_scene

    w = h = 12
    scene, meta, cam = cornell_box_scene(w, h)
    cfg = bd.BDPTConfig(w, h, spp=2, rr_depth=4)
    imgs = {}
    for mega in (True, False):
        monkeypatch.setattr(bd, "_MEGA", mega)
        bd.render_chunk.clear_cache()
        img, nr = bd.render_image(scene, cam, cfg, seed=3, spp_chunk=2)
        imgs[mega] = (np.asarray(img), int(nr))
    bd.render_chunk.clear_cache()
    np.testing.assert_allclose(imgs[True][0], imgs[False][0], rtol=2e-5,
                               atol=1e-6)
    assert imgs[True][1] == imgs[False][1]  # same rays traced


def test_tiny_render_connect_layouts(monkeypatch):
    """All BPT_CONNECT_LAYOUT variants must agree (layout-only).

    _MEGA is forced off: the mega-connect path never reads
    _CONNECT_LAYOUT, so without this the three 'variants' would all
    render the identical mega path and the per-depth layout code (the
    r3 NameError regression site) would have no coverage."""
    from bpt_tpu.integrators import bdpt as bd
    from bpt_tpu.scene.procedural import cornell_box_scene

    monkeypatch.setattr(bd, "_MEGA", False)
    w = h = 8
    scene, meta, cam = cornell_box_scene(w, h)
    cfg = bd.BDPTConfig(w, h, spp=2, rr_depth=3)
    imgs = {}
    for layout in ("plain", "pack", "sort"):
        monkeypatch.setattr(bd, "_CONNECT_LAYOUT", layout)
        bd.render_chunk.clear_cache()  # jit captured the prior layout
        img, _ = bd.render_image(scene, cam, cfg, seed=7, spp_chunk=2)
        imgs[layout] = np.asarray(img)
    bd.render_chunk.clear_cache()
    np.testing.assert_allclose(imgs["pack"], imgs["plain"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(imgs["sort"], imgs["plain"], rtol=1e-5,
                               atol=1e-6)


def test_chunked_mega_connect_matches_single_launch(monkeypatch):
    """When the pair grid exceeds the lane budget, _mega_connect chunks
    it over eye-depth rows (RR configs).  Chunking is launch-batching
    only: same segments, same shading — images must match the
    single-launch path to reassociation tolerance."""
    from bpt_tpu.integrators import bdpt as bd
    from bpt_tpu.scene.procedural import cornell_box_scene

    w = h = 12
    scene, meta, cam = cornell_box_scene(w, h)
    # RR mode with a small bounce cap: l = max_bounces = 5
    cfg = bd.BDPTConfig(w, h, spp=2, rr_depth=2, no_rr=False,
                        max_bounces=5)
    imgs = {}
    for budget in (1 << 30, 2 * 5 * 12 * 12):  # single launch vs C=2 rows
        monkeypatch.setattr(bd, "_MEGA_MAX_LANES", budget)
        bd.render_chunk.clear_cache()
        img, nr = bd.render_image(scene, cam, cfg, seed=5, spp_chunk=2)
        imgs[budget] = (np.asarray(img), int(nr))
    bd.render_chunk.clear_cache()
    a, b = imgs.values()
    np.testing.assert_allclose(a[0], b[0], rtol=2e-5, atol=1e-6)
    assert a[1] == b[1]  # same rays traced
