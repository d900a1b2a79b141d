"""The port's spans and counters (``utils/trace.py``).

On the CPU: spans are a shared null context without a profiler; under
torch.profiler a debug frame, a depth-3 Whitted frame and a path-traced
sample of a small scene open every span, nested as documented, each a
plain ``cpu_op``; the ``sync.*`` counts of a frame equal its sites; the
``launch.*`` counts never move for the plain versions.  A renderer with
``use_kernels=True`` runs the fused query's plain versions here.

Marked ``gpu`` (skip without a card): under
``torch.cuda.set_sync_debug_mode("warn")`` a frame's sync warnings equal
its ``sync.*`` count, and a CUDA profile of a frame holds no device record
with a ``dxrt.`` name.  This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_trace.py
"""

import warnings

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from directx_raytracer_tpu_torch import testscenes
from directx_raytracer_tpu_torch.bvh import cuda_intersect as ci
from directx_raytracer_tpu_torch.render.pathtrace import PathTracer
from directx_raytracer_tpu_torch.render.renderer import Renderer
from directx_raytracer_tpu_torch.tools import precision_micro as pm
from directx_raytracer_tpu_torch.utils import checks, trace

W, H = 64, 48
DEPTH = 3

# Each span's documented parents (the nearest dxrt. span above it).
PARENTS = {
    "dxrt.frame.debug": {None},
    "dxrt.frame.whitted": {None},
    "dxrt.frame.pathtrace": {None},
    "dxrt.to_u8": {None},
    "dxrt.pass": {"dxrt.frame.whitted", "dxrt.frame.pathtrace"},
    "dxrt.raygen": {"dxrt.frame.debug", "dxrt.frame.whitted",
                    "dxrt.frame.pathtrace"},
    "dxrt.query": {"dxrt.frame.debug", "dxrt.pass"},
    "dxrt.query.stage": {"dxrt.query"},
    "dxrt.query.bin": {"dxrt.query"},
    "dxrt.query.walk": {"dxrt.query"},
    "dxrt.hit_record": {"dxrt.frame.debug", "dxrt.pass"},
    "dxrt.shade": {"dxrt.frame.debug", "dxrt.pass"},
    "dxrt.shade.draw": {"dxrt.shade"},
    "dxrt.occluder": {"dxrt.shade"},
    "dxrt.occluder.stage": {"dxrt.occluder"},
    "dxrt.occluder.bin": {"dxrt.occluder"},
    "dxrt.occluder.walk": {"dxrt.occluder"},
    "dxrt.occluder.items": {"dxrt.occluder.walk"},
    "dxrt.compact": {"dxrt.pass"},
    "dxrt.commit": {"dxrt.frame.debug", "dxrt.pass", "dxrt.frame.whitted",
                    "dxrt.frame.pathtrace"},
}
KERNEL_ONLY = {"dxrt.occluder.items"}  # the any-hit kernel's work items


def make_renderer(device):
    return Renderer(testscenes.bench_scene(3_000, W, H), W, H, device=device,
                    use_kernels=True)


@pytest.fixture(scope="module")
def renderer():
    torch.set_num_threads(2)
    return make_renderer("cpu")


def debug_frame(r, mode=5):
    return r.to_u8_device(r.render_frame(mode))


def whitted_frame(r):
    img, stats = r.render_whitted_frame(DEPTH, 1)
    r.to_u8_device(img)
    return stats


def pt_sample(r):
    pt = PathTracer(r.dscene, W, H, max_depth=2, intersect_fn=r.intersect_fn,
                    occluder_factory=r.occluder_factory, seed=3)
    pt.step(r.camera.position, r.camera.rotation)


def syncs_of(fn, *args):
    before = dict(trace.COUNTS)
    out = fn(*args)
    made = {k: v - before.get(k, 0) for k, v in trace.COUNTS.items()
            if k.startswith("sync.") and v != before.get(k, 0)}
    return made, out


def whitted_sites(alive, kernels: bool) -> dict:
    """A Whitted frame's documented sync sites from its per-pass alive
    counts: a pass shades when it is the first or the pass before left
    rays alive; every shading pass runs one closest-hit and one occluder
    query (two width reads, and on the kernel path the any-hit items'
    read), every shading pass but the last a compaction (its count and
    its parked row)."""
    shading = 1 + sum(int(a) > 0 for a in alive[:DEPTH - 1])
    compacting = shading - (shading == DEPTH)
    want = {"sync.camera": 2, "sync.offset": 1, "sync.bin_width": 2 * shading,
            "sync.compact_count": compacting, "sync.park_row": compacting}
    if kernels:
        want["sync.anyhit_items"] = shading
    return {k: v for k, v in want.items() if v}


DEBUG_SITES = {"sync.camera": 2, "sync.offset": 1, "sync.bin_width": 1,
               "sync.miss_color": 1}


def dxrt_events(prof):
    return [e for e in prof.events() if e.name.startswith("dxrt.")]


def nearest_dxrt_parent(e):
    p = e.cpu_parent
    while p is not None and not p.name.startswith("dxrt."):
        p = p.cpu_parent
    return None if p is None else p.name


def test_span_is_one_null_context_without_a_profiler(monkeypatch):
    assert not torch.autograd.profiler._is_profiler_enabled

    def boom(name):
        raise AssertionError("a span was recorded without a profiler")

    monkeypatch.setattr(trace, "_FAST", boom)
    a, b = trace.span("dxrt.a"), trace.span("dxrt.b")
    assert a is b
    with a, b:
        pass


def test_a_frame_without_a_profiler_opens_no_span(renderer, monkeypatch):
    def boom(name):
        raise AssertionError("a span was recorded without a profiler")

    monkeypatch.setattr(trace, "_FAST", boom)
    debug_frame(renderer)
    whitted_frame(renderer)


@pytest.fixture(scope="module")
def profiled(renderer):
    """The dxrt. events of a debug frame, a depth-3 Whitted frame and a
    path-traced sample under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        debug_frame(renderer)
        whitted_frame(renderer)
        pt_sample(renderer)
    return dxrt_events(prof)


def test_every_span_is_recorded(profiled):
    assert {e.name for e in profiled} == set(PARENTS) - KERNEL_ONLY


def test_spans_nest_as_documented(profiled):
    for e in profiled:
        assert nearest_dxrt_parent(e) in PARENTS[e.name], e.name
    tops = [e.name for e in profiled if nearest_dxrt_parent(e) is None]
    assert tops.count("dxrt.frame.debug") == 1
    assert tops.count("dxrt.frame.whitted") == 1
    assert tops.count("dxrt.frame.pathtrace") == 1


def test_spans_are_plain_cpu_ops(profiled):
    for e in profiled:
        assert e.device_type == DeviceType.CPU
        assert not e.is_user_annotation, e.name
        assert e.time_range.end >= e.time_range.start


def test_whitted_frame_has_one_pass_span_a_pass(renderer):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        stats = whitted_frame(renderer)
    names = [e.name for e in dxrt_events(prof)]
    shading = 1 + sum(int(a) > 0 for a in stats["alive"][:DEPTH - 1])
    assert names.count("dxrt.pass") == DEPTH
    assert names.count("dxrt.query") == shading
    assert names.count("dxrt.occluder.bin") == shading


def test_debug_frame_syncs_at_its_sites(renderer):
    made, _ = syncs_of(debug_frame, renderer)
    assert made == DEBUG_SITES


def test_whitted_frame_syncs_at_its_sites(renderer):
    made, stats = syncs_of(whitted_frame, renderer)
    assert len(stats["alive"]) == DEPTH and int(stats["alive"][0]) > 0
    assert made == whitted_sites(stats["alive"], kernels=False)


def test_armed_guards_count_one_sync_each(renderer):
    with checks.armed():
        made, stats = syncs_of(whitted_frame, renderer)
    shading = 1 + sum(int(a) > 0 for a in stats["alive"][:DEPTH - 1])
    # The primary pass guards its contribution and its pixel ids, a bounce
    # pass its contribution and its commit.
    assert made.pop("sync.check") == 2 * shading
    assert made == whitted_sites(stats["alive"], kernels=False)


def test_path_traced_sample_reads_no_seed_from_the_device(renderer):
    made, _ = syncs_of(pt_sample, renderer)
    # The sub-pixel jitter is drawn on the render device: no offset copy.
    assert "sync.offset" not in made and made["sync.camera"] == 2


def test_upload_counts_host_values_only():
    trace.reset()
    t = trace.upload(np.array([1.0, 2.0]), "cpu", "site")
    assert t.dtype == torch.float32 and trace.COUNTS["sync.site"] == 1
    trace.upload((0.5, 0.5), "cpu", "site")
    trace.upload(torch.ones(2), "cpu", "site")  # already on the device
    assert trace.COUNTS["sync.site"] == 2 and trace.syncs() == 2


def test_counts_and_reset():
    trace.reset()
    assert trace.COUNTS["launch.any_hit"] == 0 and not trace.COUNTS
    trace.count("launch.any_hit")
    trace.count("launch.precision_micro.split3", 2)
    trace.count("sync.bin_width", 3)
    assert trace.launches() == {"any_hit": 1, "precision_micro.split3": 2}
    assert trace.syncs() == 3
    trace.reset()
    assert not trace.COUNTS and trace.launches() == {}


def test_plain_versions_never_count_a_launch(renderer):
    bvh = renderer.bvh
    o = torch.zeros((768, 3))
    d = torch.nn.functional.normalize(torch.randn(768, 3,
                                                  generator=torch.Generator().manual_seed(1)),
                                      dim=1)
    before = trace.launches()
    ci.intersect_fused(o, d, bvh.clusters, bvh.wrows, 256, srows=bvh.srows,
                       crows=bvh.crows)
    ci.occluded_fused(o, d, bvh.clusters, bvh.wrows, bvh.crows,
                      torch.full((768,), 5.0), srows=bvh.srows)
    w, rays = pm.make_inputs(2, "cpu")
    for variant in pm.VARIANTS:
        pm.precision_fold(variant, w, rays)
    debug_frame(renderer)
    whitted_frame(renderer)
    assert trace.launches() == before


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card_renderer():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = make_renderer("cuda")
    debug_frame(r)  # builds and loads the kernels, warms the allocator
    whitted_frame(r)
    torch.cuda.synchronize()
    return r


def sync_warnings(fn, *args):
    """fn's result, its sync.* delta and the sync warnings it raised under
    ``set_sync_debug_mode("warn")``."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            before = trace.syncs()
            out = fn(*args)
            made = trace.syncs() - before
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, made, sum("synchroniz" in str(w.message) for w in caught)


@pytest.mark.gpu
def test_card_debug_frame_syncs_equal_its_count(card_renderer):
    _, made, warned = sync_warnings(debug_frame, card_renderer)
    assert made == sum(DEBUG_SITES.values()) and warned == made


@pytest.mark.gpu
def test_card_whitted_frame_syncs_equal_its_count(card_renderer):
    stats, made, warned = sync_warnings(whitted_frame, card_renderer)
    assert made == sum(whitted_sites(stats["alive"], kernels=True).values())
    assert warned == made


@pytest.mark.gpu
def test_card_profile_holds_no_device_record_named_dxrt(card_renderer):
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        debug_frame(card_renderer)
        whitted_frame(card_renderer)
        torch.cuda.synchronize()
    events = prof.events()
    assert any(e.device_type == DeviceType.CUDA for e in events)
    assert not [e.name for e in events
                if e.device_type == DeviceType.CUDA and e.name.startswith("dxrt.")]
    names = {e.name for e in events if e.name.startswith("dxrt.")}
    assert names == set(PARENTS) - {"dxrt.frame.pathtrace", "dxrt.shade.draw"}
