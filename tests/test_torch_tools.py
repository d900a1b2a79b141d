"""The port's frame profiler (tools/profile_frames.py) on the CPU: its
interval union and its layer grouping, and that it refuses to run without
a CUDA device (a CPU profile says nothing of the card)."""

import pytest
import torch

from directx_raytracer_tpu_torch.tools import profile_frames as pf


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
