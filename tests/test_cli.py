"""CLI end-to-end: TOML+OBJ -> render -> EXR, with checkpoint/resume.

Exercises the reference CLI shape (main.cpp:160-181) on an exported
procedural scene, plus the round-trip property scene export -> load."""
import os

import numpy as np
import pytest

from bpt_tpu.cli import main as cli_main
from bpt_tpu.io.exr import read_exr
from bpt_tpu.scene.export import export_cornell_box
from bpt_tpu.scene.scene import load_scene


def test_export_roundtrip(tmp_path):
    toml_path = export_cornell_box(str(tmp_path), width=16, height=16,
                                   spp=2, rr_depth=2)
    scene, meta = load_scene(str(tmp_path / "cbox.obj"))
    assert meta.n_emitters == 1
    assert meta.n_triangles > 10
    from bpt_tpu.scene.procedural import cornell_box
    from bpt_tpu.scene.scene import build_scene

    ref_scene, ref_meta = build_scene(cornell_box())
    assert meta.n_triangles == ref_meta.n_triangles
    np.testing.assert_allclose(
        np.asarray(scene.emitters.area), np.asarray(ref_scene.emitters.area),
        rtol=1e-4)


@pytest.mark.parametrize("integrator,extra", [
    ("bdpt", {}),
    ("path", {}),
    ("normal", {}),
])
def test_cli_renders_exr(tmp_path, integrator, extra):
    toml_path = export_cornell_box(
        str(tmp_path / integrator), width=16, height=16, spp=2, rr_depth=2,
        integrator=integrator)
    out = str(tmp_path / f"{integrator}.exr")
    rc = cli_main([toml_path, "--out", out, "--spp-chunk", "2"])
    assert rc == 0
    img = read_exr(out)
    assert img.shape == (16, 16, 3)
    assert np.isfinite(img).all()
    if integrator != "normal":
        assert img.max() > 0.01


def test_cli_checkpoint_resume(tmp_path):
    toml_path = export_cornell_box(str(tmp_path), width=16, height=16,
                                   spp=4, rr_depth=2)
    ck = str(tmp_path / "render.ckpt")
    out1 = str(tmp_path / "a.exr")
    rc = cli_main([toml_path, "--out", out1, "--spp-chunk", "2",
                   "--checkpoint", ck])
    assert rc == 0 and os.path.exists(ck)
    # Resuming a finished render does no extra work and writes the same
    # image.
    out2 = str(tmp_path / "b.exr")
    rc = cli_main([toml_path, "--out", out2, "--spp-chunk", "2",
                   "--checkpoint", ck])
    assert rc == 0
    np.testing.assert_array_equal(read_exr(out1), read_exr(out2))
    # Metadata is written alongside the EXR (SURVEY.md section 5).
    import json

    with open(out2 + ".meta.json") as f:
        meta = json.load(f)
    assert meta["spp"] == 4 and meta["width"] == 16


def test_cli_checkpoint_guards(tmp_path):
    """Resuming with a different --seed or config must hard-error, not
    silently blend sample streams (VERDICT r1 weak item 4)."""
    from bpt_tpu.io.checkpoint import CheckpointMismatch

    toml_path = export_cornell_box(str(tmp_path), width=16, height=16,
                                   spp=4, rr_depth=2)
    ck = str(tmp_path / "render.ckpt")
    out = str(tmp_path / "a.exr")
    rc = cli_main([toml_path, "--out", out, "--spp-chunk", "2",
                   "--checkpoint", ck, "--seed", "1"])
    assert rc == 0
    with pytest.raises(CheckpointMismatch):
        cli_main([toml_path, "--out", out, "--spp-chunk", "2",
                  "--checkpoint", ck, "--seed", "2"])


def test_checkpoint_partial_resume_matches_straight_run(tmp_path,
                                                        monkeypatch):
    """A render interrupted mid-way and resumed produces the same image
    as an uninterrupted run (sample keys depend on (pixel, sample) ids,
    not on chunking)."""
    toml_path = export_cornell_box(str(tmp_path), width=16, height=16,
                                   spp=4, rr_depth=2)
    out1 = str(tmp_path / "straight.exr")
    rc = cli_main([toml_path, "--out", out1, "--spp-chunk", "4",
                   "--seed", "3"])
    assert rc == 0

    # Simulate a crash after the first checkpointed chunk.
    ck = str(tmp_path / "part.ckpt")

    class Crash(Exception):
        pass

    from bpt_tpu.io import checkpoint as ck_mod

    orig = ck_mod.save_checkpoint
    calls = {"n": 0}

    def crashing_save(*a, **kw):
        orig(*a, **kw)
        calls["n"] += 1
        if calls["n"] == 1:
            raise Crash()

    monkeypatch.setattr(ck_mod, "save_checkpoint", crashing_save)
    with pytest.raises(Crash):
        cli_main([toml_path, "--out", str(tmp_path / "dead.exr"),
                  "--spp-chunk", "2", "--checkpoint", ck, "--seed", "3"])
    monkeypatch.setattr(ck_mod, "save_checkpoint", orig)

    out2 = str(tmp_path / "resumed.exr")
    rc = cli_main([toml_path, "--out", out2, "--spp-chunk", "2",
                   "--checkpoint", ck, "--seed", "3"])
    assert rc == 0
    np.testing.assert_allclose(read_exr(out1), read_exr(out2), atol=1e-6)


@pytest.mark.parametrize("pass_type", ["gi", "ssao", "normal"])
def test_cli_realtime_progressive(tmp_path, pass_type):
    """realtime=true scenes run the progressive-refinement frame loop
    (the batch renderer's analog of the reference's SDL/GL renderpass loop,
    renderpass.cpp:65-137); the EXR is written from frame 1 onward."""
    toml_path = export_cornell_box(
        str(tmp_path / pass_type), width=16, height=16, spp=4, rr_depth=2,
        integrator=pass_type, realtime=True)
    out = str(tmp_path / f"{pass_type}.exr")
    rc = cli_main([toml_path, "--out", out, "--frames", "2"])
    assert rc == 0
    img = read_exr(out)
    assert img.shape == (16, 16, 3)
    assert np.isfinite(img).all()


def test_cli_bdpt_ablation_flags(tmp_path):
    """--mode / --rr / --samples-per-batch reach BDPTConfig (VERDICT r2
    item 6: the reference's LIGHT_TRACING/PATH_TRACING/NO_RR switches,
    bdpt.h:16-18, must be reachable from the command line)."""
    import json

    toml_path = export_cornell_box(str(tmp_path), width=16, height=16,
                                   spp=2, rr_depth=2)
    out_full = str(tmp_path / "full.exr")
    rc = cli_main([toml_path, "--out", out_full])
    assert rc == 0
    out_lt = str(tmp_path / "lt.exr")
    rc = cli_main([toml_path, "--out", out_lt, "--mode", "light_trace",
                   "--samples-per-batch", "2"])
    assert rc == 0
    with open(out_lt + ".meta.json") as f:
        meta = json.load(f)
    assert meta["mode"] == "light_trace" and meta["no_rr"] is True
    # the ablation renders a genuinely different estimator
    assert not np.allclose(read_exr(out_full), read_exr(out_lt))

    out_rr = str(tmp_path / "rr.exr")
    rc = cli_main([toml_path, "--out", out_rr, "--rr"])
    assert rc == 0
    with open(out_rr + ".meta.json") as f:
        meta = json.load(f)
    assert meta["no_rr"] is False
    # RR mode walks deeper than the NO_RR hard bound -> different image
    assert not np.allclose(read_exr(out_full), read_exr(out_rr))


def test_toml_bdpt_ablation_keys(tmp_path):
    """bdptMode / noRR / samplesPerBatch TOML keys parse (extensions
    over the reference schema, documented in toml_config.py)."""
    from bpt_tpu.scene.toml_config import load_toml

    toml_path = export_cornell_box(str(tmp_path), width=16, height=16,
                                   spp=2, rr_depth=2)
    with open(toml_path) as f:
        text = f.read()
    text = text.replace(
        'type = "bdpt"',
        'type = "bdpt"\nbdptMode = "path_trace"\nnoRR = false\n'
        'samplesPerBatch = 2')
    with open(toml_path, "w") as f:
        f.write(text)
    cfg = load_toml(toml_path)
    assert cfg.bdpt_mode == "path_trace"
    assert cfg.no_rr is False
    assert cfg.samples_per_batch == 2


def test_cli_realtime_rejects_offline_integrator(tmp_path, capsys):
    """ADVICE r2: realtime=true with an unsupported pass type must fail
    with a clear error, not a bare ValueError from deep inside."""
    toml_path = export_cornell_box(str(tmp_path), width=16, height=16,
                                   spp=2, rr_depth=2, integrator="bdpt",
                                   realtime=True)
    rc = cli_main([toml_path, "--out", str(tmp_path / "x.exr"),
                   "--frames", "1"])
    assert rc == 1
    assert "realtime mode supports" in capsys.readouterr().err


def test_cli_realtime_writes_meta(tmp_path):
    """Realtime renders get the same .meta.json sidecar as offline ones
    (VERDICT r2 item 6)."""
    import json

    toml_path = export_cornell_box(str(tmp_path), width=16, height=16,
                                   spp=2, rr_depth=2, integrator="normal",
                                   realtime=True)
    out = str(tmp_path / "rt.exr")
    rc = cli_main([toml_path, "--out", out, "--frames", "2"])
    assert rc == 0
    with open(out + ".meta.json") as f:
        meta = json.load(f)
    assert meta["realtime"] is True and meta["frames"] == 2
    assert meta["rays"] > 0
