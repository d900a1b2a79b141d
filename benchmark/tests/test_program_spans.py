"""CPU tests of the readers of the program's spans and sync counters
(``metrics/program_spans.py`` and the metrics built on it,
``metrics/host_syncs_per_frame.py``), on synthetic traces.

    python -m pytest benchmark/tests -p no:cacheprovider
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

IDLE = ("renderer_idle_ms", "query_idle_ms", "occluder_idle_ms",
        "wavefront_idle_ms")


def metric(name):
    return harness.load_module(ROOT / "benchmark", "metrics", name)


def read_all(trace):
    ctx = harness.Context(None, None, None, None, trace)
    return {name: metric(name).read(ctx) for name in IDLE}


def make_trace(kernels, host, window_us, frames=1):
    """A Trace whose window starts at 0: ``kernels`` (start, end),
    ``host`` (start, end, name)."""
    return harness.Trace([("k", s, e) for s, e in kernels], window_us, frames,
                         sorted(host))


def total_idle_ms(trace):
    return (trace.window_us - trace.busy_us()) / 1e3 / trace.frames


def test_a_gap_across_two_spans_is_split_at_their_bound():
    t = make_trace([(0, 150), (250, 400)],
                   [(100, 200, "dxrt.query"), (200, 300, "dxrt.shade")], 400)
    got = read_all(t)
    assert got["query_idle_ms"] == pytest.approx(0.050)
    assert got["wavefront_idle_ms"] == pytest.approx(0.050)
    assert got["renderer_idle_ms"] == 0 and got["occluder_idle_ms"] == 0


def test_nested_spans_give_the_idle_to_the_inner_one():
    t = make_trace([(0, 150), (450, 1000)],
                   [(0, 1000, "dxrt.frame.whitted"), (50, 900, "dxrt.pass"),
                    (100, 600, "dxrt.shade"), (200, 400, "dxrt.occluder"),
                    (250, 300, "dxrt.occluder.bin")], 1000)
    got = read_all(t)
    # 150-200 and 400-450 under shade, 200-400 under the occluder (its bin
    # part included): the pass and the frame get nothing.
    assert got["wavefront_idle_ms"] == pytest.approx(0.100)
    assert got["occluder_idle_ms"] == pytest.approx(0.200)
    assert got["renderer_idle_ms"] == 0 and got["query_idle_ms"] == 0


def test_idle_under_no_layer_span_goes_to_the_renderer():
    t = make_trace([(0, 100), (300, 350), (600, 700)],
                   [(0, 100, "aten::add"), (100, 200, "dxrt.frame.debug"),
                    (120, 180, "cudaLaunchKernel"), (350, 500, "dxrt.pass"),
                    (500, 550, "other.span")], 800, frames=2)
    got = read_all(t)
    # 100-300 (a frame's own code, then no span), 350-600 (a pass, then
    # none) and 700-800 (past the last record).
    assert got["renderer_idle_ms"] == pytest.approx(0.550 / 2)
    assert sum(got.values()) == pytest.approx(total_idle_ms(t))


def test_the_four_add_up_to_the_window_idle():
    host = [(0, 5000, "dxrt.frame.whitted"), (10, 900, "dxrt.raygen"),
            (900, 4000, "dxrt.pass"), (950, 1500, "dxrt.query"),
            (1000, 1200, "dxrt.query.bin"), (1500, 3000, "dxrt.shade"),
            (1700, 2500, "dxrt.occluder"), (1800, 2000, "dxrt.occluder.walk"),
            (1850, 1950, "dxrt.occluder.items"), (3000, 3500, "dxrt.compact"),
            (3500, 3900, "dxrt.commit"), (5100, 5300, "dxrt.to_u8")]
    kernels = [(20, 80), (50, 120), (1100, 1300), (1900, 2300), (3200, 3300),
               (4800, 5150), (5250, 5400)]
    t = make_trace(kernels, host, 6000, frames=3)
    got = read_all(t)
    assert all(v > 0 for v in got.values())
    assert sum(got.values()) == pytest.approx(total_idle_ms(t))
    assert 100 * sum(got.values()) * 3 / 6.0 == pytest.approx(
        metric("device_idle_pct").read(harness.Context(None, None, None, None, t)))


def test_a_trace_without_program_spans_reports_nothing():
    plain = make_trace([(0, 100)], [(0, 50, "aten::mul"), (60, 90, "cudaMemcpy")], 400)
    for trace in (plain, None, make_trace([], [(0, 50, "dxrt.query")], 400)):
        assert set(read_all(trace).values()) == {None}


def test_host_syncs_per_frame_reads_the_counters_over_the_window():
    from directx_raytracer_tpu_torch.utils import trace as program_trace

    syncs = metric("host_syncs_per_frame")
    with syncs.watch(None) as seen:
        for _ in range(4):
            program_trace.count("sync.camera", 2)
            program_trace.count("sync.bin_width")
        program_trace.count("launch.closest_hit")
    t = make_trace([(0, 10)], [], 100, frames=4)
    ctx = harness.Context(None, None, None, None, t, {"host_syncs_per_frame": seen})
    assert syncs.read(ctx) == 3
    for watched, tr in (({}, t), ({"host_syncs_per_frame": None}, t),
                        ({"host_syncs_per_frame": seen}, None)):
        assert syncs.read(harness.Context(None, None, None, None, tr, watched)) is None


def test_host_syncs_watch_of_a_program_without_counters_yields_nothing(monkeypatch):
    import directx_raytracer_tpu_torch.utils as utils

    # A program from before the counters: no utils.trace to import.
    monkeypatch.setitem(sys.modules, "directx_raytracer_tpu_torch.utils.trace", None)
    monkeypatch.delattr(utils, "trace", raising=False)
    with metric("host_syncs_per_frame").watch(None) as seen:
        pass
    assert seen is None
