"""CPU tests of the dielectric cell, ``whitted_glass_100k``, at a tiny size.

    python -m pytest benchmark/tests/test_glass_cell.py -p no:cacheprovider

A copy of the benchmark gains a tiny configuration (the cell's own with a
20,000-triangle scene, 12 of its 24 spheres glass, at 48 x 32), a traffic
mix with the cell's frame and frame arguments (depth 5, spp 4) and fewer
frames warmed up and traced, and a cell on them with the cell's pixel
sample, its per-layer metrics and a tight limit (0.1, as the harness's own
tiny cells).  The run on the port's plain CPU path is correct; a run whose
refraction is broken underneath is not: the index of refraction inverted,
or the refractive surfaces' Fresnel reflections (branch B) never made
live.  So the judge sees the refraction and the split.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

TINY = {"n_tris": 20_000, "width": 48, "height": 32}
CELL = "tiny_glass"


def tiny_glass_tree(tmp_path: Path) -> tuple[Path, dict]:
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "bench_scene_100k_glass.json").read_text())
    cfg.update(name="tiny_glass", args=TINY)
    (bench / "configs" / "tiny_glass.json").write_text(json.dumps(cfg))
    spec["configs"].append({"name": "tiny_glass", "source": "a test", "reduced": [],
                            "file": "benchmark/configs/tiny_glass.json", "why": "a test"})
    # A CPU frame takes seconds: two warm-up poses and one traced frame.
    traffic = dict(json.loads((bench / "traffic" / "whitted_glass_orbit.json").read_text()),
                   warmup_frames=2, trace_frames=1)
    (bench / "traffic" / "tiny_glass_orbit.json").write_text(json.dumps(traffic))
    spec["workloads"].append({"name": CELL, "config": "tiny_glass",
                              "traffic": "tiny_glass_orbit", "chips": 1,
                              "why": "a tiny dielectric cell for CPU tests"})
    # The port's plain CPU path reads no off pixel at this size: a tight
    # limit, as the harness's tiny cells have, so that a fault reads over it.
    check = dict(json.loads((bench / "cells" / "whitted_glass_100k.json").read_text()),
                 frames=2, limits={"off_pct": 0.1})
    (bench / "cells" / f"{CELL}.json").write_text(json.dumps(check))
    for m in spec["per_layer"]:
        if "whitted_glass_100k" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench, spec


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_glass_cell_is_correct_on_the_cpu(tmp_path, trace):
    bench, spec = tiny_glass_tree(tmp_path)
    out = harness.run_cell(spec, CELL, 2**31 + 11, 0.5, trace, device="cpu", root=bench)
    assert out["attempted"] >= 1 and out["failed"] == 0 and out["correct"]
    assert out["checks"]["off_pct"]["value"] == 0.0
    if trace:
        # The counters are read: 4 primary rays a pixel and the bounces.
        assert 4.0 < out["metrics"]["whitted_rays_per_pixel"]["value"] <= 4.0 * 5
        assert out["metrics"]["split_rays_per_pixel"]["value"] > 0.0
    else:
        assert set(out["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}


def ior_inverted(frame):
    """Every refraction computed with 1 / ior in place of ior."""
    from directx_raytracer_tpu_torch.render import whitted

    def broken(pose):
        real = whitted.refract_fresnel
        whitted.refract_fresnel = lambda d, n, ior: real(d, n, 1.0 / ior)
        try:
            return frame(pose)
        finally:
            whitted.refract_fresnel = real
    return broken


def split_never_live(frame):
    """The refractive surfaces' Fresnel reflections (branch B) never enter
    the compaction."""
    from directx_raytracer_tpu_torch.render import whitted

    def broken(pose):
        real = whitted._shade_hits

        def shade(*args, **kwargs):
            contrib, branches = real(*args, **kwargs)
            if branches is not None:
                branches[1]["active"] = branches[1]["active"] & False
            return contrib, branches

        whitted._shade_hits = shade
        try:
            return frame(pose)
        finally:
            whitted._shade_hits = real
    return broken


@pytest.mark.parametrize("fault", [ior_inverted, split_never_live],
                         ids=lambda f: f.__name__)
def test_broken_refraction_is_not_correct(tmp_path, fault):
    bench, spec = tiny_glass_tree(tmp_path)
    out = harness.run_cell(spec, CELL, 77, 0.5, False, device="cpu", root=bench,
                           frame_hook=fault)
    assert out["attempted"] >= 1
    assert not out["correct"]


def test_the_glass_reference_imports_no_program_and_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.whitted_glass\n"
            "import torch\n"
            "assert not torch.backends.cuda.matmul.allow_tf32\n"
            "assert not torch.backends.cudnn.allow_tf32\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    loaded = set(eval(r.stdout.strip().splitlines()[-1]))
    assert "torch" in loaded
    for name in ("directx_raytracer_tpu_torch", "directx_raytracer_tpu", "jax", "jaxlib"):
        assert name not in loaded


def test_glass_metrics_arithmetic_and_silence():
    """The two readers on made-up counts, and None where the program has no
    such counter (the parent's program) or counted nothing."""
    rays = harness.load_module(ROOT / "benchmark", "metrics", "whitted_rays_per_pixel")
    split = harness.load_module(ROOT / "benchmark", "metrics", "split_rays_per_pixel")
    trace = harness.Trace(kernels=[("any_hit_kernel", 0, 10)], window_us=100,
                          frames=2, host=[])
    scene = {"width": 1920, "height": 1080}
    n = 2 * 1920 * 1080
    ctx = harness.Context(None, scene, None, None, trace,
                          {"whitted_rays_per_pixel": {"delta": 8 * n},
                           "split_rays_per_pixel": {"delta": n // 2}})
    assert rays.read(ctx) == pytest.approx(8.0)
    assert split.read(ctx) == pytest.approx(0.5)
    for watched in ({}, {"whitted_rays_per_pixel": None, "split_rays_per_pixel": None},
                    {"whitted_rays_per_pixel": {"delta": 0},
                     "split_rays_per_pixel": {"delta": 0}}):
        silent = harness.Context(None, scene, None, None, trace, watched)
        assert rays.read(silent) is None and split.read(silent) is None
    with rays.watch(None) as seen_rays, split.watch(None) as seen_split:
        pass
    assert seen_rays["delta"] == 0 and seen_split["delta"] == 0
