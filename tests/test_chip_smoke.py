"""chip_smoke.py's checks that need no card: the device gate, the
image-agreement comparator and the BDPT-vs-path-trace z statistic."""
import numpy as np
import pytest

import chip_smoke


def test_device_check_raises_without_gpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.check_device()


def _image(seed):
    rng = np.random.RandomState(seed)
    return rng.uniform(0.05, 1.0, (64, 64, 3)).astype(np.float32)


def _rerouted(img, share):
    """`share` of the pixels moved by +-10% (rerouted paths), the rest
    bit-equal; the image mean stays within 1e-3."""
    out = img.copy()
    rng = np.random.RandomState(1)
    n = int(share * img.shape[0] * img.shape[1])
    idx = rng.choice(img.shape[0] * img.shape[1], n, replace=False)
    out.reshape(-1, 3)[idx] *= np.where(np.arange(n) % 2, 0.9, 1.1)[:, None]
    return out


@pytest.mark.parametrize("case,expected", [
    ("ulp_ties", []),                   # 1% of pixels rerouted: accepted
    ("tf32_like", ["pixels off"]),      # 10% rerouted, mean and rays fine
    ("wholesale", ["pixels off", "image means"]),  # every pixel 1% off
    ("ray_drift", ["ray counts"]),      # same image, 1% more rays traced
    ("resampled", ["pixels off"]),      # an independent render
])
def test_compare_images(case, expected):
    ref = _image(0)
    rays = 1_000_000
    got, got_rays = {
        "ulp_ties": (_rerouted(ref, 0.01), rays),
        "tf32_like": (_rerouted(ref, 0.10), rays),
        "wholesale": (ref * 1.01, rays),
        "ray_drift": (ref, rays + 10_000),
        "resampled": (_image(2), rays),
    }[case]
    fails = chip_smoke.compare_images(got, ref, got_rays, rays)
    for kind in expected:
        assert any(kind in f for f in fails), (kind, fails)
    if case != "resampled":  # its mean may or may not drift by 1e-3
        assert len(fails) == len(expected), fails


@pytest.mark.gpu
def test_tracers_on_card():
    """Phase 2 of chip_smoke at 2^16 rays: the routed tracers against
    traverse.py on the 20,504-triangle scene, on an NVIDIA GPU."""
    import jax

    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs an NVIDIA GPU; JAX found none")
    from bpt_tpu.scene.procedural import cornell_box_scene

    with jax.default_device(gpus[0]):
        scene, _, cam = cornell_box_scene(64, 64, **chip_smoke.SCENE)
        chip_smoke.check_tracers(scene, cam, w=64, h=64, n=1 << 16)


@pytest.mark.parametrize("bias,passes", [(1.0, True), (1.05, False)])
def test_paired_z(bias, passes):
    """Two noisy renders of one image agree; a 5% bias does not."""
    truth = np.linspace(0.1, 1.0, 96 * 128 * 3).reshape(96, 128, 3)
    rng = np.random.RandomState(7)
    a = truth + rng.normal(0, 0.3, truth.shape)
    b = truth * bias + rng.normal(0, 0.3, truth.shape)
    assert (chip_smoke.paired_z(a, b) < chip_smoke.Z_GATE) == passes
