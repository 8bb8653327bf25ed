"""chip_smoke.py's phases at tiny sizes on the CPU (the card runs them at
full size): each must run its path end to end and check what it checks.
main() itself must refuse to run without a GPU."""

from __future__ import annotations

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_main_fails_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out  # no result line


def test_phase_device():
    info = chip_smoke.phase_device()
    assert info["platform"] == "cpu" and info["count"] >= 1
    assert isinstance(info["native_sah"], bool)


def test_phase_golden_one_scene():
    (r,) = chip_smoke.phase_golden(("mix",))
    assert r["ok"] and r["name"] == "mix"


def test_phase_cornell_tiny(tmp_path, monkeypatch):
    # render.py turns on the persistent compile cache; with the variable
    # set, JAX (which reads it only at start-up) leaves it off here
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    res = chip_smoke.phase_cornell(size=16, depth=2, spp=3, render_spp=2,
                                   out_dir=str(tmp_path))
    for key in ("scene_file", "hand_built"):
        r = res[key]
        assert r["path"] == "xla"  # the kernel is GPU-only
        assert r["spp"] == 3 and r["timed_passes"] == 3
        assert r["rays_per_pass"] >= 16 * 16 and r["image_mean"] > 0
    assert os.path.exists(tmp_path / "cornell.ppm")
    assert [t["rows"] for t in res["take_rows"]] == [20, 1024]


def test_phase_megakernel_tiny():
    (r,) = chip_smoke.phase_megakernel(("cornell",), size=16, depth=3,
                                       interpret=True)
    # interpret mode reproduces the XLA path per lane
    assert r["lanes_agree"] == 1.0 and r["rays_rel_diff"] == 0.0


def test_phase_mesh_tiny(tmp_path):
    r = chip_smoke.phase_mesh(tris=1280, width=32, height=16, depth=2,
                              out_dir=str(tmp_path))
    assert r["tris"] == 1280 and r["rays_per_pass"] >= 32 * 16
    assert os.path.exists(tmp_path / "bench_mesh.obj")


def test_phase_four_tiny():
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 (virtual) devices")
    res = chip_smoke.phase_four(size=16, train_size=8, depth=2,
                                train_depth=2)
    assert all(v["ok"] for v in res.values())
