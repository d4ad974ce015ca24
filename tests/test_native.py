"""Native (C++) BVH builder, compiled from source at first use, must
produce a bit-identical FlatBVH to the numpy reference builder."""
import numpy as np
import pytest

from bpt_tpu.accel.build import build_bvh
from bpt_tpu.native.native import build_bvh_native


@pytest.mark.parametrize("t", [1, 4, 5, 64, 1000])
def test_native_matches_numpy(t):
    rng = np.random.RandomState(t)
    v0 = rng.uniform(-2, 2, (t, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.5, 0.5, (t, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.5, 0.5, (t, 3)).astype(np.float32)
    a = build_bvh(v0, v1, v2, use_native=False)
    b = build_bvh_native(v0, v1, v2)
    assert b is not None, "native builder did not build (no g++?)"
    np.testing.assert_array_equal(a.miss, b.miss)
    np.testing.assert_array_equal(a.start, b.start)
    np.testing.assert_array_equal(a.count, b.count)
    np.testing.assert_array_equal(a.prim_order, b.prim_order)
    np.testing.assert_allclose(a.bmin, b.bmin, rtol=1e-6)
    np.testing.assert_allclose(a.bmax, b.bmax, rtol=1e-6)


@pytest.mark.parametrize("compiler", [True, False])
def test_build_from_source_or_numpy(monkeypatch, tmp_path, compiler):
    """The library is compiled from bvh_builder.cpp at first use; with no
    C++ compiler, build_bvh falls back to the identical numpy build."""
    from bpt_tpu.native import native

    monkeypatch.setattr(native, "LIB_PATH", str(tmp_path / "lib.so"))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    if not compiler:
        monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert native.available() == compiler
    assert (tmp_path / "lib.so").exists() == compiler
    rng = np.random.RandomState(9)
    v0 = rng.uniform(-2, 2, (300, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.5, 0.5, (300, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.5, 0.5, (300, 3)).astype(np.float32)
    a = build_bvh(v0, v1, v2, use_native=False)
    b = build_bvh(v0, v1, v2)
    np.testing.assert_array_equal(a.miss, b.miss)
    np.testing.assert_array_equal(a.prim_order, b.prim_order)
