"""The port's frame profiler (tools/profile_frames.py) on the CPU: its
interval union and its layer grouping, and that it refuses to run without
a CUDA device (a CPU profile says nothing of the card).  The path tracer's
timing tool (tools/pt_bench.py): the same refusal, its ``--device cpu`` run
at a small size, and ``--dragon`` without the asset."""

import re

import pytest
import torch

from directx_raytracer_tpu_torch import testscenes
from directx_raytracer_tpu_torch.render.renderer import Renderer
from directx_raytracer_tpu_torch.tools import profile_frames as pf
from directx_raytracer_tpu_torch.tools import pt_bench


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0, 2), (1, 3)], 3.0),  # overlapping
    ([(5, 6), (0, 2)], 3.0),  # disjoint, out of order
    ([(0, 10), (2, 3), (4, 5)], 10.0),  # nested
])
def test_busy_is_the_union_of_kernel_intervals(intervals, want):
    assert pf.busy_us(intervals) == want


def test_layers_group_the_hand_written_kernels():
    assert pf.layer_of("void (anonymous namespace)::closest_hit_kernel<3>(...)") \
        == "closest_hit kernel"
    assert pf.layer_of("any_hit_kernel(float const*, ...)") == "any_hit kernel"
    assert pf.layer_of("void (anonymous namespace)::bin_lists_kernel<true>(...)") \
        == "bin_lists kernel"
    assert pf.layer_of("void at::native::elementwise_kernel<128, 2>").startswith(
        "torch: ")


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert pf.main(["--frames", "1"]) == 1


def test_pt_frame_kind_takes_one_sample_a_call():
    r = Renderer(testscenes.cornell_box(32, 24), 32, 24, device="cpu")
    frame = pf.pt_sample(r, max_depth=2)
    assert frame().n_samples == 1 and frame().n_samples == 2


def test_pt_bench_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert pt_bench.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_pt_bench_runs_on_the_cpu(capsys):
    assert pt_bench.main(["--device", "cpu", "--tris", "3000", "--width", "96",
                          "--height", "48", "--depth", "2", "--samples", "2"]) == 0
    assert re.fullmatch(
        r"pt 3000tris 96x48 depth=2: \d+\.\d{4} ms/sample \(mean of 2\) \[cpu\]",
        capsys.readouterr().out.strip())


def test_pt_bench_dragon_needs_the_asset(capsys):
    assert pt_bench.main(["--device", "cpu", "--dragon"]) == 1
    assert "Dragon.crtscene" in capsys.readouterr().err
