"""CPU tests of the benchmark's harness, at a tiny size.

    python -m pytest benchmark/tests -p no:cacheprovider

The tests marked ``gpu`` need a CUDA device and skip without one; on the
card they run the control of each cell at the cell's own size.
"""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark.traffic import CameraPath  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TINY = {"n_tris": 3000, "width": 64, "height": 48}


def tiny_tree(tmp_path: Path) -> tuple[Path, dict]:
    """A copy of the benchmark with a tiny configuration and a cell of
    each frame kind on it, added as new files and BENCHMARK.json entries."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "bench_scene_100k.json").read_text())
    cfg.update(name="tiny", args=TINY)
    (bench / "configs" / "tiny.json").write_text(json.dumps(cfg))
    spec["configs"].append(dict(spec["configs"][0], name="tiny",
                                file="benchmark/configs/tiny.json"))
    # The port's plain CPU path reads no off pixel at this size: a tight
    # limit, so that a fault reads over it however little the view moves.
    check = dict(json.loads((bench / "cells" / "debug_100k.json").read_text()),
                 limits={"off_pct": 0.1})
    for traffic in ("debug_orbit", "whitted_orbit"):
        name = "tiny_" + traffic.split("_")[0]
        spec["workloads"].append({"name": name, "config": "tiny", "traffic": traffic,
                                  "chips": 1, "why": "a tiny cell for CPU tests"})
        (bench / "cells" / f"{name}.json").write_text(json.dumps(check))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench, spec


def tree_digest(path: Path) -> dict:
    return {str(p.relative_to(path)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(path.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_spec_follows_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    bench = ROOT / "benchmark"
    configs = {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert (ROOT / c["file"]).exists() and len(c["source"]) <= 200
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs and w["chips"] == 1
        assert len(w["why"]) <= 200 and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
        assert (bench / "frames" / f"{traffic['frame']}.py").exists()
        assert (bench / "reference" / f"{traffic['frame']}.py").exists()
        assert (bench / "cells" / f"{w['name']}.json").exists()
    assert {c["config"] for c in SPEC["workloads"]} == configs
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert {"frame_ms", "frame_p95_ms", "setup_s"} <= e2e
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (bench / "metrics" / f"{m['name']}.py").exists()
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        assert set(m.get("workloads", [])) <= {w["name"] for w in SPEC["workloads"]}


def test_scene_and_orbit_follow_the_seed():
    bench = ROOT / "benchmark"
    build = harness.load_module(bench, "scenes", "bench_scene").build
    a, b, c = build(5, **TINY), build(5, **TINY), build(2**33 + 1, **TINY)
    assert np.array_equal(a["meshes"][1]["vertices"], b["meshes"][1]["vertices"])
    assert not np.array_equal(a["meshes"][1]["vertices"], c["meshes"][1]["vertices"])
    params = {"step_deg": [0.5, 2.0]}

    def poses(seed):
        p = CameraPath(a["camera"], params, np.random.default_rng(seed))
        return np.stack([p.pose(i)[0] for i in range(20)])

    assert np.array_equal(poses(3), poses(3))
    assert not np.allclose(poses(3), poses(4))
    path = CameraPath(a["camera"], params, np.random.default_rng(3))
    steps = np.diff([path.angle(i) for i in range(50)])
    assert steps.min() >= 0.5 and steps.max() <= 2.0
    # The camera keeps facing the target all around the orbit.
    for deg in (0.0, 90.0, 180.0, 270.0):
        pos, rot = path.pose_at(deg)
        to_target = -pos / np.linalg.norm(pos)
        assert float(-rot[:, 2] @ to_target) > 0.98


def test_busy_roofline_and_pairs_arithmetic():
    assert harness.busy_us([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17
    roof = harness.load_module(ROOT / "benchmark", "metrics", "closest_query_roofline_pct")
    n_tris, n_rays = 99_202, 1920 * 1080
    want_bytes = n_tris * 36 + n_rays * 32
    assert roof.least_seconds(n_tris, n_rays) == pytest.approx(want_bytes / 3.35e12)
    assert roof.least_seconds(0, 10**6) == pytest.approx(max(32e6 / 3.35e12, 46e6 / 67e12))
    trace = harness.Trace(kernels=[("void closest_hit_kernel<3, false>", 0, 1000),
                                   ("bin_lists_kernel", 1000, 1100),
                                   ("void at::elementwise_kernel", 1100, 1500),
                                   ("any_hit_kernel", 1600, 1800)],
                          window_us=4000, frames=2, host=[])
    scene = {"meshes": [{"indices": np.zeros(3 * n_tris)}], "width": 1920, "height": 1080}
    ctx = harness.Context(None, scene, None, None, trace)
    assert roof.read(ctx) == pytest.approx(100 * want_bytes / 3.35e12 / 550e-6)
    load = lambda n: harness.load_module(ROOT / "benchmark", "metrics", n).read(ctx)  # noqa: E731
    assert load("device_idle_pct") == pytest.approx(100 * (1 - 1700 / 4000))
    assert load("launches_per_frame") == 2
    assert load("torch_kernels_ms") == pytest.approx(0.2)
    assert load("any_hit_ms") == pytest.approx(0.1)
    pairs = harness.load_module(ROOT / "benchmark", "metrics", "pairs_per_ray")
    # Two frames' queries: 8,840 and 9,000 clusters listed over 2,700 tiles.
    first, second = torch.full((2700,), 3), torch.full((2700,), 3)
    first[:740] += 1
    second[:900] += 1
    ctx = harness.Context(None, scene, None, None, None,
                          {"pairs_per_ray": [(first, 128), (second, 128)]})
    assert pairs.read(ctx) == pytest.approx((8840 + 9000) / 5400 * 128)
    empty = harness.Context(None, scene, None, None, None)
    for name in ("device_idle_pct", "launches_per_frame", "torch_kernels_ms",
                 "any_hit_ms", "closest_query_roofline_pct", "pairs_per_ray"):
        assert harness.load_module(ROOT / "benchmark", "metrics", name).read(empty) is None


@pytest.mark.parametrize("cell", ["tiny_debug", "tiny_whitted"])
@pytest.mark.parametrize("trace", [False, True])
def test_run_on_the_cpu_agrees_with_the_reference(tmp_path, cell, trace):
    """A whole run of a tiny cell on the port's plain CPU path: the last
    line's keys, and the reference's agreement with the port."""
    bench, spec = tiny_tree(tmp_path)
    out = harness.run_cell(spec, cell, 2**31 + 11, 0.5, trace, device="cpu", root=bench)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert out["attempted"] >= 1 and out["failed"] == 0 and out["correct"]
    assert out["checks"]["off_pct"]["value"] == 0.0
    if trace:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(out["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}
        assert all(m["value"] > 0 for m in out["metrics"].values())


def stale(frame):
    last = []

    def broken(pose):
        last.append(frame(pose))
        return last[-2] if len(last) > 1 else last[-1]
    return broken


def half(frame):
    def broken(pose):
        img = frame(pose).clone()
        img[img.shape[0] // 2:] = 0
        return img
    return broken


def altered(frame):
    def broken(pose):
        img = frame(pose).clone()
        img[::7, ::5, 0] = 255 - img[::7, ::5, 0]
        return img
    return broken


@pytest.mark.parametrize("cell", ["tiny_debug", "tiny_whitted"])
@pytest.mark.parametrize("fault", [stale, half, altered], ids=lambda f: f.__name__)
def test_broken_frames_are_not_correct(tmp_path, cell, fault):
    """The run with its timed path broken underneath: a frame that returns
    the image of the call before (the state unchanged: the window's first
    frame shows the last warm-up view), half of the image left out, some
    pixels altered where they are produced."""
    bench, spec = tiny_tree(tmp_path)
    out = harness.run_cell(spec, cell, 77, 1.0, False, device="cpu", root=bench,
                           frame_hook=fault)
    assert out["attempted"] >= 1
    assert not out["correct"]


def test_new_cell_and_metric_are_new_files_only(tmp_path):
    bench, spec = tiny_tree(tmp_path)
    before = tree_digest(bench)
    (bench / "metrics" / "frames_seen.v2.py").write_text(
        "def read(ctx):\n    return ctx.trace.frames if ctx.trace else None\n")
    spec["per_layer"].append({"name": "frames_seen.v2", "unit": "frames", "better": "higher",
                              "source": "device_trace", "layer": "device",
                              "moves": "frame_ms", "workloads": ["tiny_debug"]})
    out = harness.run_cell(spec, "tiny_debug", 9, 0.3, True, device="cpu", root=bench)
    assert out["metrics"]["frames_seen.v2"]["value"] >= 1
    after = tree_digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before


def test_pairs_per_ray_reads_the_queries_the_frame_runs():
    """The counter records the visit lists of the queries the program
    itself runs (here the plain path of its fused query on the CPU), and
    puts the program's function back on close."""
    from directx_raytracer_tpu_torch.bvh import build_bvh
    from directx_raytracer_tpu_torch.bvh import cuda_intersect as ci
    from directx_raytracer_tpu_torch.ops.rays import generate_rays_tiled, pick_schedule

    from benchmark import port

    data = harness.load_module(ROOT / "benchmark", "scenes", "bench_scene").build(5, **TINY)
    r = port.renderer(data, "cpu")
    bvh = build_bvh(r.dscene.geometry) if r.bvh is None else r.bvh
    tile, tile_r = pick_schedule(r.height, r.width)
    o, d = generate_rays_tiled(data["camera"]["position"], data["camera"]["rotation"],
                               r.width, r.height, *tile, device="cpu")
    before = ci.closest_query
    pairs = harness.load_module(ROOT / "benchmark", "metrics", "pairs_per_ray")
    with pairs.watch(None) as seen:
        ci.intersect_fused(o, d, bvh.clusters, bvh.wrows, tile_r, plain=True,
                           srows=bvh.srows)
    assert ci.closest_query is before
    q = ci.closest_query(o, d, bvh.clusters, bvh.wrows, tile_r, plain=True,
                         srows=bvh.srows)
    assert len(seen) == 1 and torch.equal(seen[0][0], q.counts)
    ctx = harness.Context(None, data, None, None, None, {"pairs_per_ray": seen})
    assert pairs.read(ctx) == pytest.approx(
        int(q.counts.sum()) / q.counts.shape[0] * q.wrows.shape[1])


def test_a_forbidden_module_loaded_after_the_window_prints_no_result(tmp_path):
    """The look for JAX in ``sys.modules`` comes after everything the run
    loads, metric readers and the reference among them."""
    bench, spec = tiny_tree(tmp_path)
    (bench / "metrics" / "loads_jax.py").write_text(
        "import sys, types\n\n"
        "def read(ctx):\n"
        "    sys.modules['jax.numpy'] = types.ModuleType('jax.numpy')\n"
        "    return None\n")
    spec["end_to_end"].append({"name": "loads_jax", "unit": "ms", "better": "lower",
                               "bound": 0.25, "source": "host_clock",
                               "workloads": ["tiny_debug"]})
    try:
        with pytest.raises(harness.ForbiddenImport, match="jax"):
            harness.run_cell(spec, "tiny_debug", 9, 0.2, False, device="cpu", root=bench)
    finally:
        sys.modules.pop("jax.numpy", None)


def run_script(args, cwd):
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True,
                          text=True, timeout=300)


def test_no_card_or_no_program_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    r = run_script(["benchmark/run.py", "--workload", "debug_100k", "--seed", "1",
                    "--seconds", "1", "--trace", "0"], ROOT)
    assert r.returncode != 0 and r.stdout.strip() == "" and "CUDA" in r.stderr
    alone = tmp_path / "alone"
    shutil.copytree(ROOT / "benchmark", alone / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", alone)
    r = run_script(["benchmark/run.py", "--workload", "debug_100k", "--seed", "1",
                    "--seconds", "1", "--trace", "0"], alone)
    assert r.returncode != 0 and r.stdout.strip() == "" and "missing" in r.stderr


GUARD = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark import harness
from benchmark.reference import camera, geometry
bench = harness.BENCH_DIR
for kind in ("reference",):
    for p in sorted((bench / kind).glob("*.py")):
        harness.load_module(bench, kind, p.stem)
ref_only = sorted({{m.split(".")[0] for m in sys.modules}})
import runpy
run = runpy.run_path(str(bench / "run.py"), run_name="benchmark_run")
for kind in ("scenes", "frames", "metrics", "reference"):
    for p in sorted((bench / kind).glob("*.py")):
        harness.load_module(bench, kind, p.stem)
import benchmark.control, benchmark.port
print(json.dumps([ref_only, sorted({{m.split(".")[0] for m in sys.modules}})]))
"""


def test_nothing_loads_jax_and_the_reference_loads_no_program():
    r = run_script(["-c", GUARD.format(root=str(ROOT))], ROOT)
    assert r.returncode == 0, r.stderr
    ref_only, everything = json.loads(r.stdout.strip().splitlines()[-1])
    assert "directx_raytracer_tpu_torch" not in ref_only
    assert "directx_raytracer_tpu_torch" in everything  # the harness did load it
    for name in ("jax", "jaxlib", "flax", "directx_raytracer_tpu"):
        assert name not in everything


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_control_is_not_correct(cell):
    """The plain reference in TF32 in the program's place, at the cell's own
    size, on three seeds: each reads over the cell's limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from benchmark import control

    limits = json.loads((ROOT / "benchmark" / "cells" / f"{cell}.json").read_text())["limits"]
    for seed in (101, 202, 303):
        numbers = control.readings(SPEC, cell, seed, "cuda")["numbers"]
        assert any(numbers[k] > limits[k] for k in limits)
