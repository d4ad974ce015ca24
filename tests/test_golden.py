"""Golden-image parity vs the reference's shipped EXRs (slow).

The reference's quality strategy is golden-image comparison (SURVEY.md
section 4 item 1); these tests compare block-mean luminance of our
renders against its artifacts with noise-aware bounds (the reference RNG
is racy — renderer.cpp:160 — so comparison is statistical, not bitwise).

Golden provenance (see benchmarks/golden_parity.py and
PARITY_IMAGES.md): `cbox_bdpt_final.exr` is a full-GI render from the
Russian-roulette build (NO_RR=0); the `cbox_bdpt_glass_*depth.exr`
series is NO_RR depth-bounded; `cbox_bdpt.exr`/`cbox_bdpt_direct_512.exr`
have an exactly-zero bottom half (partial artifacts) and are excluded.

Skipped when the reference assets are not mounted.
"""
import os

import numpy as np
import pytest

REF = "/root/reference/data/a5"
CBOX_TOML = f"{REF}/bonus_bdpt/tinyrender/cbox_bdpt.toml"
CBOX_GOLD = f"{REF}/bonus_bdpt/tinyrender/cbox_bdpt_final.exr"
GLASS_TOML = f"{REF}/cbox/tinyrender/cbox_bdpt_glass.toml"
GLASS_GOLD = f"{REF}/cbox/tinyrender/cbox_bdpt_glass_8depth.exr"

pytestmark = [
    pytest.mark.slow,
    pytest.mark.skipif(not os.path.exists(CBOX_TOML),
                       reason="reference assets not mounted"),
]

W, H = 80, 56
GRID = 4


def _render(toml, spp, rr_depth, no_rr, max_bounces=16):
    from bpt_tpu.core.camera import Camera
    from bpt_tpu.integrators.bdpt import BDPTConfig, render_image
    from bpt_tpu.scene.scene import load_scene
    from bpt_tpu.scene.toml_config import load_toml

    cfg_t = load_toml(toml)
    scene, meta = load_scene(cfg_t.obj_file)
    cam = Camera.make(o=cfg_t.camera.o, at=cfg_t.camera.at,
                      up=cfg_t.camera.up, fov=cfg_t.camera.fov,
                      width=W, height=H)
    cfg = BDPTConfig(width=W, height=H, spp=spp, rr_depth=rr_depth,
                     no_rr=no_rr, max_bounces=max_bounces)
    img, _ = render_image(scene, cam, cfg, seed=3, spp_chunk=spp)
    return np.asarray(img)


def _block_luma(a):
    h, w = a.shape[:2]
    b = a[: h // GRID * GRID, : w // GRID * GRID].reshape(
        GRID, h // GRID, GRID, w // GRID, 3).mean((1, 3))
    return b @ np.array([0.2126, 0.7152, 0.0722])


def _compare(img, gold_path, mean_tol, med_tol, p90_tol):
    from bpt_tpu.io.exr import read_exr

    ref = np.asarray(read_exr(gold_path))
    ratio = img.mean() / ref.mean()
    rl, ol = _block_luma(ref), _block_luma(img)
    rel = np.abs(ol - rl) / np.maximum(rl, 1e-3)
    assert abs(ratio - 1.0) < mean_tol, f"mean ratio {ratio:.4f}"
    assert np.median(rel) < med_tol, f"block median {np.median(rel):.4f}"
    assert np.quantile(rel, 0.9) < p90_tol, (
        f"block p90 {np.quantile(rel, 0.9):.4f}")


def test_glass_caustic_matches_reference_golden():
    """NO_RR rr_depth=8 vs cbox_bdpt_glass_8depth.exr.

    Gates at measured headroom (VERDICT r2 item 5): at this test config
    (80x56@8spp CPU) the measured stats are ratio 0.974, median 0.111,
    p90 0.184 — stable across spp 8/16, so the residual is the
    resolution-downsampling systematic, not noise.  A 5% radiance bias
    in any single technique now fails this gate."""
    img = _render(GLASS_TOML, spp=8, rr_depth=8, no_rr=True)
    _compare(img, GLASS_GOLD, mean_tol=0.06, med_tol=0.13, p90_tol=0.20)


def test_cbox_full_gi_matches_reference_golden():
    """RR mode vs cbox_bdpt_final.exr (full-GI RR build).

    Measured at this config (80x56@4spp CPU): ratio 0.902, median 0.106,
    p90 0.208.  The mean runs ~10% low at tiny spp because the RR-mode
    estimator is heavy-tailed (rare high-weight deep paths need more
    samples); at 200x152@64spp the ratio is 1.016
    (PARITY_IMAGES.md).  Gates set to measured low-spp headroom; the
    tight-mean gate lives in benchmarks/golden_parity.py."""
    img = _render(CBOX_TOML, spp=4, rr_depth=2, no_rr=False,
                  max_bounces=12)
    _compare(img, CBOX_GOLD, mean_tol=0.12, med_tol=0.13, p90_tol=0.28)


def test_glass_depth_series_convergence():
    """The reference ships a NO_RR depth series
    (cbox_bdpt_glass_{5,6,7,8}depth.exr, means 0.422 -> 0.441): our
    renders must track each golden's mean AND rise monotonically with
    rr_depth (VERDICT r2 item 5)."""
    from bpt_tpu.io.exr import read_exr

    means = {}
    for depth in (5, 6, 7):
        img = _render(GLASS_TOML, spp=8, rr_depth=depth, no_rr=True)
        gold = np.asarray(read_exr(
            f"{REF}/cbox/tinyrender/cbox_bdpt_glass_{depth}depth.exr"))
        ratio = img.mean() / gold.mean()
        assert abs(ratio - 1.0) < 0.06, f"depth {depth}: ratio {ratio:.4f}"
        means[depth] = img.mean()
    # Monotone convergence (small epsilon absorbs spp-8 noise).
    assert means[6] > means[5] - 0.002
    assert means[7] > means[6] - 0.002
