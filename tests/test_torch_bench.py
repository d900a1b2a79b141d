"""The port's benchmark (tools/bench.py) and its frame tools
(tools/whitted_bench.py, tools/verify_drive.py) on the CPU: the no-card
failure line, the gates, the line's keys and types, a secondary metric's
error boundary, and verify_drive's Cornell image against the JAX
package's ``render_whitted`` (brute force on both sides, the same scene).

Tolerance of that image: within 2 u8 levels on >= 99% of pixels, the
Whitted frame gate of tests/test_torch_whitted.py (a pixel on a triangle
seam may take either triangle)."""

import json
import os
import re
import subprocess
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

from directx_raytracer_tpu import testscenes as jts
from directx_raytracer_tpu.models.scene import build_device_scene as j_build
from directx_raytracer_tpu.render import render_whitted as j_whitted
from directx_raytracer_tpu.utils.image import to_u8 as j_to_u8
from directx_raytracer_tpu_torch import testscenes
from directx_raytracer_tpu_torch.io import crtscene
from directx_raytracer_tpu_torch.render.renderer import Renderer
from directx_raytracer_tpu_torch.tools import bench, verify_drive, whitted_bench
from directx_raytracer_tpu_torch.utils.image import read_png, to_u8

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
PIXEL_LEVELS, PIXEL_AGREE = 2, 0.99
NEW_TOOLS = ("bench", "exec_stats", "kernel_micro", "whitted_bench",
             "cull_stats", "verify_drive")


def test_no_card_prints_the_fail_line():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "-m", "directx_raytracer_tpu_torch.tools.bench"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metric"] == "primary_rays_1080p_100k_tris"
    assert line["value"] is None and line["unit"] == "Mrays/s/chip"
    assert "no CUDA device" in line["error"]


def test_new_tools_import_no_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {NEW_TOOLS!r}:\n"
        "    importlib.import_module('directx_raytracer_tpu_torch.tools.' + name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.split('.')[0] == 'directx_raytracer_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_kernel_smoke_passes_on_the_cpu():
    got = bench.kernel_smoke(device="cpu")
    assert got["hit_agree"] >= bench.HIT_AGREE
    assert got["occluded_agree"] >= bench.OCC_AGREE


def test_kernel_smoke_fails_a_query_that_loses_hits(monkeypatch):
    """A query that drops every tenth hit trips the gate."""
    real = bench.intersect_fused

    def lossy(*args, **kwargs):
        hit = real(*args, **kwargs)
        lost = torch.arange(hit.tri.shape[0]) % 10 == 0
        hit.tri = torch.where(lost, -1, hit.tri)
        return hit

    monkeypatch.setattr(bench, "intersect_fused", lossy)
    with pytest.raises(bench.GateError, match="hit/miss"):
        bench.kernel_smoke(device="cpu")


def test_golden_gate_skips_without_the_asset(tmp_path):
    assert bench.golden_tile_gate("cpu") is None
    assert bench.golden_tile_gate("cpu", dragon=str(tmp_path / "none"),
                                  goldens=tmp_path / "none.npz") is None


def test_golden_gate_reads_and_judges_the_golden(tmp_path):
    """A scene file and a golden made from the port's own frames pass; a
    golden with one mode shifted by 10 levels fails."""
    path = str(tmp_path / "scene.crtscene")
    crtscene.dump(testscenes.bench_scene(3_000, 192, 108), path)
    r = Renderer(crtscene.load(path), 192, 108, device="cpu")
    gold = {f"debug{m}": to_u8(r.render_frame(m)) for m in (3, 4, 5, 6)}
    np.savez(tmp_path / "gold.npz", **gold)
    off = bench.golden_tile_gate("cpu", dragon=path, goldens=tmp_path / "gold.npz")
    assert off == {3: 0.0, 4: 0.0, 5: 0.0, 6: 0.0}
    gold["debug4"] = np.clip(gold["debug4"].astype(int) + 10, 0, 255).astype(np.uint8)
    np.savez(tmp_path / "bad.npz", **gold)
    with pytest.raises(bench.GateError, match="mode 4"):
        bench.golden_tile_gate("cpu", dragon=path, goldens=tmp_path / "bad.npz")


@pytest.fixture(scope="module")
def small():
    return Renderer(testscenes.bench_scene(3_000, 64, 32), 64, 32,
                    device="cpu", use_kernels=True)


def test_measure_line_has_every_key(small):
    out = bench.measure(small, frames=3, whitted_frames=2, huge=lambda: small,
                        huge_frames=2, warmup=1)
    assert out["metric"] == bench.METRIC and out["unit"] == "Mrays/s/chip"
    for key in ("value", "vs_baseline", "pairs_per_ray", "est_mfu",
                "whitted_1080p_ms", "mrays_1m_tris"):
        assert isinstance(out[key], float) and out[key] > 0, key
    assert out["vs_baseline"] == pytest.approx(out["value"] / 500.0)
    assert out["device"] == "cpu"
    assert not [k for k in out if k.endswith("_error")]
    assert "est_mfu_useful" not in out and "vpu_tail_gops" not in out
    b = out["breakdown_ms"]
    assert out["frames"] == {bench.METRIC: 3, "whitted_1080p_ms": 2,
                             "mrays_1m_tris": 2}
    for metric in out["frames"]:
        assert 0 < b[f"{metric}_min"] <= b[f"{metric}_max"]
    assert b[f"{bench.METRIC}_min"] <= b["frame_ms"] <= b[f"{bench.METRIC}_max"]
    assert out["value"] == pytest.approx(64 * 32 / b["frame_ms"] / 1e3)
    json.dumps(out)


def test_measure_reports_a_failed_secondary_metric(small, monkeypatch):
    def broken():
        raise RuntimeError("no 1M scene")

    monkeypatch.setattr(small, "render_whitted_frame",
                        lambda *a: (_ for _ in ()).throw(ValueError("bad")))
    out = bench.measure(small, frames=1, whitted_frames=1, huge=broken, warmup=0)
    assert out["whitted_1080p_ms"] is None
    assert out["whitted_error"] == "ValueError: bad"
    assert out["mrays_1m_error"] == "RuntimeError: no 1M scene"
    assert "mrays_1m_tris" not in out and out["value"] > 0


def test_whitted_bench_on_the_cpu(small, capsys):
    out = whitted_bench.run(small, depth=2, frames=2)
    assert out["frames"] == 2 and out["min_ms"] <= out["ms"] <= out["max_ms"]
    assert re.match(r"whitted 64x32 depth=2 spp=1 tris=\d+: \d+\.\d{4} ms/frame "
                    r"median of 2 \(min [\d.]+, max [\d.]+\) \([\d.]+ FPS, "
                    r"[\d.]+ Mprimary/s\) \[cpu\]", capsys.readouterr().out)
    assert whitted_bench.main(["--device", "cpu", "--tris", "3000", "--width",
                               "64", "--height", "32", "--frames", "1"]) == 0


def test_whitted_bench_bounce_tile():
    """--isect-tile-r reaches the bounce passes; the primary keeps its own."""
    seen = []
    r = Renderer(testscenes.bench_scene(3_000, 64, 32), 64, 32, device="cpu",
                 use_kernels=True)
    inner = r.intersect_fn

    def spy(o, d, geo, tile_r=None):
        seen.append(tile_r)
        return inner(o, d, geo, tile_r=tile_r)

    r.intersect_fn = spy
    whitted_bench.bounce_tile(r, 128)
    r.render_whitted_frame(2)
    assert seen[0] != 128 and seen[1:] == [128]


def test_verify_drive_cornell_matches_jax():
    w, h = 64, 48
    scene = jts.cornell_box(w, h)
    for m in scene.materials:
        if int(m.type) == 1:
            m.specular, m.shininess = 0.6, 24.0
    d = j_build(scene)
    assert d.has_specular
    want, _ = j_whitted(d, scene.camera.position, scene.camera.rotation, w, h,
                        max_depth=3, spp=1)
    got = verify_drive.cornell_specular(w, h, spp=1, device="cpu")
    diff = np.abs(to_u8(got).astype(int) - j_to_u8(np.asarray(want)).astype(int))
    assert (diff <= PIXEL_LEVELS).all(axis=-1).mean() >= PIXEL_AGREE


def test_verify_drive_writes_its_pngs(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(verify_drive, "cornell_specular",
                        partial(verify_drive.cornell_specular, 40, 30, 2))
    monkeypatch.setattr(verify_drive, "const_color",
                        partial(verify_drive.const_color, 32, 32))
    assert verify_drive.main(["--out", str(tmp_path), "--device", "cpu"]) == 0
    for name in ("verify_cornell_bp_spp9.png", "verify_const_color.png"):
        img = read_png(os.path.join(tmp_path, name))
        assert img.max() > 0, name
    flat = read_png(os.path.join(tmp_path, "verify_const_color.png"))
    # const_color is an exact albedo fill: backdrop, triangle, background.
    assert {tuple(p) for p in flat.reshape(-1, 3)} <= {
        tuple(to_u8(np.array(c, np.float32)))
        for c in ([0.1, 0.35, 0.1], [1.0, 0.45, 0.1], [0.0, 0.0, 0.25])}
    assert "dragon: skipped" in capsys.readouterr().out
